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
``_data_psum``.  Every call is an all-reduce (sum): an all-gather is
written as the all-reduce of an owner-placed, otherwise zero tensor, which
is exact.  ``RankMesh.stats`` counts calls and bytes by axis, and the calls
that go through host memory: every gloo collective on a CUDA tensor copies
it to the host and back, and the calling thread waits for that.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


def factor_mesh(n_devices: int) -> tuple:
    """Default (data, graph) factorization for n devices: graph axis gets 2
    when possible, the rest goes to data."""
    graph = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return n_devices // graph, graph


@dataclasses.dataclass
class CollectiveStats:
    """Collective calls and bytes by axis ('graph', 'data'), and the calls
    that went through host memory (``host_syncs``)."""

    calls: dict = dataclasses.field(
        default_factory=lambda: {"graph": 0, "data": 0})
    bytes: dict = dataclasses.field(
        default_factory=lambda: {"graph": 0, "data": 0})
    host_syncs: int = 0

    def reset(self) -> None:
        self.calls = {"graph": 0, "data": 0}
        self.bytes = {"graph": 0, "data": 0}
        self.host_syncs = 0

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "host_syncs": self.host_syncs}


@dataclasses.dataclass
class RankMesh:
    """This rank's place in the (dcn, data, graph) mesh and the process
    groups of its graph and data axes (None where the axis has extent 1)."""

    shape: dict                  # {"dcn": h, "data": d, "graph": g}
    rank: int
    host: int
    data_index: int              # within the host
    graph_index: int
    graph_group: Optional[object] = None
    data_group: Optional[object] = None
    backend: Optional[str] = None
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

    # --------------------------------------------------------- collectives

    def _all_reduce(self, t: torch.Tensor, group, axis: str) -> torch.Tensor:
        """Sum ``t`` over ``group`` in place; returns ``t``."""
        self.stats.calls[axis] += 1
        self.stats.bytes[axis] += t.numel() * t.element_size()
        if self.backend == "gloo" and t.device.type == "cuda":
            self.stats.host_syncs += 1
        dist.all_reduce(t, group=group)
        return t

    def graph_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the graph axis (JAX ``psum`` over 'graph'); reduces a
        contiguous ``t`` in place."""
        if self.dg == 1:
            return t
        return self._all_reduce(t.contiguous(), self.graph_group, "graph")

    def owner_pick(self, mine: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
        """Rows each held by exactly one graph rank, published to all: zero
        the rows this rank does not own, then sum over the graph axis.  At
        dg == 1 the zeroing stays and the sum is elided."""
        m = mine if values.dim() == 1 else mine[:, None]
        return self.graph_sum(torch.where(m, values, values.new_zeros(())))

    def graph_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[block, ...] -> [dg * block, ...], graph rank g's block at rows
        g * block (JAX ``all_gather(..., tiled=True)`` over 'graph')."""
        if self.dg == 1:
            return t
        block = t.shape[0]
        full = t.new_zeros((self.dg * block,) + tuple(t.shape[1:]))
        full[self.graph_index * block:(self.graph_index + 1) * block] = t
        return self._all_reduce(full, self.graph_group, "graph")

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the data axes (JAX ``_data_psum``); in place."""
        if self.dd == 1:
            return t
        return self._all_reduce(t.contiguous(), self.data_group, "data")

    def data_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[Bd, ...] -> [B, ...] over the data axes, block i at rows
        i * Bd."""
        if self.dd == 1:
            return t
        bd = t.shape[0]
        full = t.new_zeros((self.dd * bd,) + tuple(t.shape[1:]))
        full[self.data_rank * bd:(self.data_rank + 1) * bd] = t
        return self._all_reduce(full, self.data_group, "data")

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
    mesh = RankMesh(shape={"dcn": hosts, "data": data, "graph": graph},
                    rank=rank, host=rank // per_host,
                    data_index=local // graph, graph_index=local % graph,
                    backend=dist.get_backend())
    # every rank creates every group, in the same order
    if graph > 1:
        for base in range(0, world, graph):
            grp = dist.new_group(list(range(base, base + graph)))
            if base <= rank < base + graph:
                mesh.graph_group = grp
    if hosts * data > 1:
        for g in range(graph):
            ranks = [h * per_host + d * graph + g
                     for h in range(hosts) for d in range(data)]
            grp = dist.new_group(ranks)
            if rank in ranks:
                mesh.data_group = grp
    return mesh


def make_mesh(data: Optional[int] = None, graph: int = 1) -> RankMesh:
    """The ('data', 'graph') mesh of one host's ranks."""
    return rank_mesh(graph=graph, data=data)
