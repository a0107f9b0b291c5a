"""The rank mesh and its collectives.

Counterpart of ``pcgnn_tpu/parallel/mesh.py``.  The JAX package drives a
mesh of devices from one process; the port runs one ``torch.distributed``
rank per process, one device per rank, and arranges the world's ranks as a
mesh with 'graph' innermost:

  * ``graph`` — the node-row partition: ranks ``base .. base + dg - 1`` of
    one host each hold one row block of the features and the structure;
  * ``data``  — batch sharding within a host;
  * ``dcn``   — one slot per host (``parallel.distributed``).  A host's
    ranks form one contiguous (data, graph) tile, so a graph group never
    crosses hosts.

Rank ``r`` sits at host ``r // per_host``, data ``(r % per_host) // dg``,
graph ``r % dg``.  The batch splits into contiguous blocks over the data
axes in (dcn, data) order.

The collectives are plain ``torch.distributed`` calls, outside autograd:
no collective carries a gradient in the sharded step (``parallel.spmd``).
Each is an identity that issues no call when its axis has extent 1, the
trace-time specialisation of the JAX package's ``_graph_collectives`` and
``_data_psum``.  The sums and owner picks are all-reduces (an owner pick
sums an owner-placed, otherwise zero tensor, which is exact); the graph
gather is an ``all_gather_into_tensor`` of the blocks (JAX ``all_gather(...,
tiled=True)``).

Every collective has an async form (``*_async``) that returns a
:class:`Pending` handle; ``wait()`` returns the finished tensor.  With
``RankMesh.overlap`` (the default, ``parallel.distributed``) the call is
issued with ``async_op=True``: NCCL runs it on the communicator's own
stream and the compute stream waits for it only at ``wait()``, gloo runs
it on its own thread, so the kernels launched between issue and wait run
under it.  Without ``overlap`` the call completes where it is issued (the
blocking schedule).  The blocking methods are ``*_async(...).wait()``.

A mesh is immutable: its schedule is fixed when it is built (the process
setting, ``parallel.distributed``), and a mesh with the other schedule is
another object (``dataclasses.replace(mesh, overlap=False)``, the blocking
reference the tests compare against).

``RankMesh.stats`` counts calls and bytes by axis (async ones apart as
well), the calls that go through host memory (every gloo collective on a
CUDA tensor copies it to the host and back, and the thread that waits for
it waits for that), and, for each handle, how many collectives and noted
operations (``RankMesh.note``) were issued between its issue and its
completion: the schedule a test reads.  Under an enabled profiler each
issue and each wait also leaves a zero-length range,
``collective_issue:<name>`` and ``collective_wait:<name>``, so a trace
shows which kernels were launched in between.

Cut points.  Every collective passes through ``RankMesh._issue`` and its
handle's ``wait``.  While a :class:`CutRecorder` is active
(:func:`recording`: a capture of the sharded step, ``train.capture``),
each issue and each wait of a collective is a cut point: the recorder is
told of it and of the collective, a :class:`Collective` that can be issued
again on the same tensors.  A collective of extent 1 issues nothing and is
no cut.  Outside a recording nothing changes: the eager schedule and
``CollectiveStats`` are as described above.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from pcgnn_tpu_torch.utils import profiling


def factor_mesh(n_devices: int) -> tuple:
    """Default (data, graph) factorization for n devices: graph axis gets 2
    when possible, the rest goes to data."""
    graph = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return n_devices // graph, graph


# completed handles CollectiveStats keeps in its schedule
SCHEDULE_KEPT = 64
# the collective schedule of the RankMeshes this process builds
# (``rank_mesh``); ``parallel.distributed`` sets it before the group exists
_overlap = True
# the recorder of the capture in progress in this process (``recording``)
_recorder = None


def set_collective_overlap(on: bool) -> None:
    """Choose the schedule of the meshes :func:`rank_mesh` builds: async
    collectives waited at first use (``True``) or blocking ones.  Raises
    once this process is in a group, as the JAX package's
    ``enable_collective_overlap`` raises once a backend exists: a setting
    that could no longer take effect must not pass silently."""
    global _overlap
    if dist.is_initialized():
        raise RuntimeError(
            "the collective schedule is chosen before the process group "
            "exists (parallel.distributed.init_distributed / "
            "enable_collective_overlap); this process is already in one")
    _overlap = bool(on)


def collective_overlap() -> bool:
    """The schedule :func:`rank_mesh` gives its meshes."""
    return _overlap


@dataclasses.dataclass
class CollectiveStats:
    """Collective calls and bytes by axis ('graph', 'data'), the async ones
    among them, the calls that went through host memory (``host_syncs``),
    and the schedule: for each completed handle (in completion order) its
    name and the numbers of collectives and of noted operations issued
    between its issue and its completion (``waits``; the last
    ``SCHEDULE_KEPT``, so a long run holds a bounded record)."""

    calls: dict = dataclasses.field(
        default_factory=lambda: {"graph": 0, "data": 0})
    bytes: dict = dataclasses.field(
        default_factory=lambda: {"graph": 0, "data": 0})
    async_calls: dict = dataclasses.field(
        default_factory=lambda: {"graph": 0, "data": 0})
    host_syncs: int = 0
    issued: int = 0          # collectives issued
    noted: int = 0           # operations noted
    waits: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=SCHEDULE_KEPT))

    def reset(self) -> None:
        self.calls = {"graph": 0, "data": 0}
        self.bytes = {"graph": 0, "data": 0}
        self.async_calls = {"graph": 0, "data": 0}
        self.host_syncs = 0
        self.issued = 0
        self.noted = 0
        self.waits.clear()

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "async_calls": dict(self.async_calls),
                "host_syncs": self.host_syncs,
                "waits": [dict(w) for w in self.waits]}


class Pending:
    """A collective that was issued: :meth:`wait` returns its finished
    tensor (the same one on every call)."""

    def __init__(self, stats: Optional[CollectiveStats], name: str,
                 out: torch.Tensor, work=None, keep=None):
        self._stats = stats
        self._name = name
        self._out = out
        self._work = work
        self._keep = keep   # holds the inputs until the collective completes
        self._mark = None if stats is None else (stats.issued, stats.noted)
        if work is None:
            self._done()

    def _done(self) -> None:
        st = self._stats
        if st is not None:
            n0, k0 = self._mark
            st.waits.append({"name": self._name,
                             "collectives_between": st.issued - n0,
                             "ops_between": st.noted - k0})
        self._stats = None

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            _marker("collective_wait", self._name)
            self._work.wait()
            self._work = self._keep = None
            self._done()
        return self._out


class Collective:
    """One collective of a mesh on fixed tensors: ``call(async_op)``
    leaves its result in ``out``.  :meth:`start` counts and issues it on
    the mesh's schedule; a capture keeps it to issue again at each replay
    (``train.capture``)."""

    def __init__(self, mesh: "RankMesh", name: str, axis: str,
                 out: torch.Tensor, call, nbytes: int):
        self.mesh, self.name, self.axis = mesh, name, axis
        self.out, self.call, self.nbytes = out, call, nbytes

    def start(self):
        """Issue it: the work handle under ``mesh.overlap``, else None (it
        completed where it was issued)."""
        st = self.mesh.stats
        st.calls[self.axis] += 1
        st.bytes[self.axis] += self.nbytes
        if self.mesh.backend == "gloo" and self.out.device.type == "cuda":
            st.host_syncs += 1
        if not self.mesh.overlap:
            self.call(False)
            st.issued += 1
            return None
        st.async_calls[self.axis] += 1
        _marker("collective_issue", self.name)
        work = self.call(True)
        st.issued += 1
        return work


class CutRecorder:
    """What happens at the cut points of a recording (:func:`recording`).
    This base captures nothing: it logs each cut, ``(kind, name, axis)``
    with kind ``issue`` (async), ``call`` (blocking) or ``wait``, and
    runs the collective where it stands -- the dry mode, which also runs
    on the CPU.  ``train.capture.PieceGraph`` ends a CUDA graph at each
    cut instead and keeps the collective for its replays."""

    def __init__(self):
        self.cuts = []

    def issue(self, op: Collective):
        """A collective is issued: returns its work handle (None when it
        completed)."""
        self.cuts.append(("issue" if op.mesh.overlap else "call", op.name,
                          op.axis))
        return op.start()

    def wait(self, op: Collective, work) -> None:
        """The step waits for a collective ``issue`` returned ``work``
        for."""
        self.cuts.append(("wait", op.name, op.axis))
        work.wait()


class _Cut:
    """The work handle of a recorded collective: its wait is a cut."""

    def __init__(self, recorder: CutRecorder, op: Collective, work):
        self.recorder, self.op, self.work = recorder, op, work

    def wait(self) -> None:
        self.recorder.wait(self.op, self.work)


@contextlib.contextmanager
def recording(recorder: CutRecorder):
    """Make ``recorder`` the process's recorder for the block: every
    collective issued and waited in it is a cut point.  One at a time."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recording is already in progress")
    _recorder = recorder
    try:
        yield recorder
    finally:
        _recorder = None


def _marker(kind: str, name: str) -> None:
    """A zero-length profiler range, only when a profiler records."""
    profiling.marker(f"{kind}:{name}")


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place in the (dcn, data, graph) mesh, the process groups
    of its graph and data axes (None where the axis has extent 1), and the
    collective schedule (``overlap``: async collectives waited at first
    use; False: blocking), fixed when the mesh is built."""

    shape: dict                  # {"dcn": h, "data": d, "graph": g}
    rank: int
    host: int
    data_index: int              # within the host
    graph_index: int
    graph_group: Optional[object] = None
    data_group: Optional[object] = None
    backend: Optional[str] = None
    overlap: bool = True
    stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)

    @property
    def dg(self) -> int:
        return self.shape["graph"]

    @property
    def dd(self) -> int:
        """Extent of the data axes, (dcn ×) data."""
        return self.shape["dcn"] * self.shape["data"]

    @property
    def size(self) -> int:
        return self.dd * self.dg

    @property
    def data_rank(self) -> int:
        """This rank's batch block over the data axes, (dcn, data) order."""
        return self.host * self.shape["data"] + self.data_index

    def note(self) -> None:
        """Count one halo-independent operation of the step (the schedule
        in ``stats.waits``)."""
        self.stats.noted += 1

    # --------------------------------------------------------- collectives

    def _issue(self, name: str, axis: str, out: torch.Tensor, call,
               nbytes: int) -> Pending:
        """Count and issue one collective, ``call(async_op)``, which leaves
        its result in ``out``; while a recording is active, hand it to the
        recorder instead (a cut point)."""
        op = Collective(self, name, axis, out, call, nbytes)
        rec = _recorder
        if rec is not None:
            work = rec.issue(op)
            return Pending(None, name, out,
                           None if work is None else _Cut(rec, op, work),
                           keep=op)
        work = op.start()
        return Pending(self.stats, name, out, work,
                       keep=None if work is None else call)

    def _sum_async(self, t: torch.Tensor, group, axis: str,
                   name: str) -> Pending:
        """Sum a contiguous ``t`` over ``group`` in place."""
        return self._issue(
            name, axis, t,
            lambda a: dist.all_reduce(t, group=group, async_op=a),
            t.numel() * t.element_size())

    def graph_sum_async(self, t: torch.Tensor,
                        name: str = "graph_sum") -> Pending:
        """Sum over the graph axis (JAX ``psum`` over 'graph'); reduces a
        contiguous ``t`` in place."""
        if self.dg == 1:
            return Pending(None, name, t)
        return self._sum_async(t.contiguous(), self.graph_group, "graph",
                               name)

    def graph_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.graph_sum_async(t).wait()

    def owner_pick_async(self, mine: torch.Tensor, values: torch.Tensor,
                         name: str = "owner_pick") -> Pending:
        """Rows each held by exactly one graph rank, published to all: zero
        the rows this rank does not own, then sum over the graph axis.  At
        dg == 1 the zeroing stays and the sum is elided."""
        m = mine if values.dim() == 1 else mine[:, None]
        return self.graph_sum_async(
            torch.where(m, values, values.new_zeros(())), name)

    def owner_pick(self, mine: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
        return self.owner_pick_async(mine, values).wait()

    def graph_gather_async(self, t: torch.Tensor,
                           name: str = "graph_gather") -> Pending:
        """[block, ...] -> [dg * block, ...], graph rank g's block at rows
        g * block (JAX ``all_gather(..., tiled=True)`` over 'graph'): the
        blocks are copied, so every value arrives bit for bit."""
        if self.dg == 1:
            return Pending(None, name, t)
        t = t.contiguous()
        full = t.new_empty((self.dg * t.shape[0],) + tuple(t.shape[1:]))
        return self._issue(
            name, "graph", full,
            lambda a: dist.all_gather_into_tensor(
                full, t, group=self.graph_group, async_op=a),
            full.numel() * full.element_size())

    def graph_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.graph_gather_async(t).wait()

    def data_sum_async(self, t: torch.Tensor,
                       name: str = "data_sum") -> Pending:
        """Sum over the data axes (JAX ``_data_psum``); in place."""
        if self.dd == 1:
            return Pending(None, name, t)
        return self._sum_async(t.contiguous(), self.data_group, "data", name)

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.data_sum_async(t).wait()

    def data_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[Bd, ...] -> [B, ...] over the data axes, block i at rows
        i * Bd."""
        if self.dd == 1:
            return t
        bd = t.shape[0]
        full = t.new_zeros((self.dd * bd,) + tuple(t.shape[1:]))
        full[self.data_rank * bd:(self.data_rank + 1) * bd] = t
        return self._sum_async(full, self.data_group, "data",
                               "data_gather").wait()

    def batch_block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of a [B, ...] batch array (JAX
        ``shard_batch``: ``P(daxes)``); B must divide by ``dd``."""
        b = t.shape[0]
        if b % self.dd:
            raise ValueError(f"batch of {b} does not divide over the "
                             f"{self.dd} data ranks")
        bd = b // self.dd
        return t[self.data_rank * bd:(self.data_rank + 1) * bd]


def single_rank_mesh() -> RankMesh:
    """The 1 x 1 mesh of a process that is not part of a group: every
    collective is elided."""
    return RankMesh(shape={"dcn": 1, "data": 1, "graph": 1}, rank=0, host=0,
                    data_index=0, graph_index=0)


def rank_mesh(graph: int = 1, data: Optional[int] = None,
              ranks_per_host: Optional[int] = None) -> RankMesh:
    """Arrange the initialized ``torch.distributed`` world as a mesh.

    ``ranks_per_host`` (default: the whole world, one host) sizes each
    host's (data, graph) tile; ``graph`` must divide it and ``data``
    defaults to the rest.  Every rank must call this with the same
    arguments: the process groups are created in the same order
    everywhere."""
    if not dist.is_initialized():
        if graph == 1 and data in (None, 1):
            return single_rank_mesh()
        raise RuntimeError("rank_mesh: torch.distributed is not "
                           "initialized (parallel.distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    per_host = world if ranks_per_host is None else int(ranks_per_host)
    if per_host <= 0 or world % per_host:
        raise ValueError(f"{world} ranks not even over hosts of {per_host}")
    if per_host % graph:
        raise ValueError(f"graph={graph} does not divide the {per_host} "
                         f"ranks per host")
    if data is None:
        data = per_host // graph
    if data * graph != per_host:
        raise ValueError(f"mesh {data}x{graph} != {per_host} ranks per host")
    hosts = world // per_host
    local = rank % per_host
    # every rank creates every group, in the same order
    graph_group = data_group = None
    if graph > 1:
        for base in range(0, world, graph):
            grp = dist.new_group(list(range(base, base + graph)))
            if base <= rank < base + graph:
                graph_group = grp
    if hosts * data > 1:
        for g in range(graph):
            ranks = [h * per_host + d * graph + g
                     for h in range(hosts) for d in range(data)]
            grp = dist.new_group(ranks)
            if rank in ranks:
                data_group = grp
    return RankMesh(shape={"dcn": hosts, "data": data, "graph": graph},
                    rank=rank, host=rank // per_host,
                    data_index=local // graph, graph_index=local % graph,
                    graph_group=graph_group, data_group=data_group,
                    backend=dist.get_backend(), overlap=_overlap)


def make_mesh(data: Optional[int] = None, graph: int = 1) -> RankMesh:
    """The ('data', 'graph') mesh of one host's ranks."""
    return rank_mesh(graph=graph, data=data)
