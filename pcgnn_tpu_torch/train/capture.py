"""Epochs of training steps, and evaluations, with no host in their loop.

Counterpart of the JAX Trainer's compiled epoch (``pcgnn_tpu/train/
trainer.py``: ``_epoch``, a jitted ``lax.scan`` of loss -> grad -> Adam
over the epoch's batches, on one device or over the SPMD graph;
``_epoch_block``; ``_step1``) and of its compiled forward (``_predict`` /
``predict_jit``, and the sharded ``spmd_predict``).  ``StepRunner`` runs a
stack of training steps for one (model, optimizer) pair,
``PredictRunner`` a stack of forwards for one model, each in one of two
ways, with the same arithmetic:

  * captured (the default on CUDA): one step -- forward, backward and
    Adam -- or one forward is captured once as a CUDA graph and replayed
    once per batch, the counterpart of the scan body or of one call of
    ``predict_jit``.  The graph reads its batch (and the step its labels
    and weights) from static [n, B] buffers at a device counter, writes
    its output (the loss, or the [B, 2] probabilities) into an [n, ...]
    buffer at the counter and advances it, so a replay needs no copy and
    no read-back;
  * eager (the CPU, and the card when asked): the same function per batch.

Both take the hub lane's chunks from one plan for the whole stack
(``ops.hub.epoch_hub_plans``; sharded, ``parallel.spmd.
spmd_epoch_hub_plans``), read back in one copy, so a batch's shapes are
fixed and nothing in a replay reads from the card.  A runner keeps the
largest plan it has seen (``plan_union``), so both ways run every batch at
the same widths; the graph is captured again only when a stack's plan
exceeds the captured one (``captures`` counts them).

Capture follows PyTorch's whole-network recipe: the first batch of a
capture runs eagerly on a side stream (the warm-up; for the step it creates
Adam's state, so it is the run's own step, not an extra one), then the same
body is captured with ``torch.cuda.graph``.  The optimizer must be
``torch.optim.Adam(capturable=True)`` (``trainer.make_optimizer`` on
CUDA).  GraphSAGE's draws come from one CUDA generator registered with the
graph and seeded before each batch, as the eager path seeds a fresh
generator: from (seed, epoch, step) for a step, with 0 for a forward.  A
capture that fails raises: there is no eager fallback on the card.  A graph
reads the model's parameters where they were at its capture, so they must
be updated in place (Adam, ``load_state_dict``), never replaced.

A sharded body (``parallel.spmd``) runs collectives, which a graph cannot
hold here: gloo's go through the host, and NCCL's, captured, would need a
card a rank.  So the body is captured as pieces (``PieceGraph``): CUDA
graphs cut at each collective's issue and wait (``parallel.mesh``'s cut
points), captured in order on one stream into one memory pool, and
replayed in that order with the collectives issued and waited between
them, on the tensors they had at the capture.  Under the async schedule a
collective is issued after the piece that made its input and waited
before the piece that first reads it, so the work between still runs
under it.  The capture itself runs no collective (the warm-up step before
it does), so ranks that capture at different steps still issue the same
collectives in the same order; every rank of a graph group plans alike
and so recaptures at the same step.  A body with no collective (one
device, or a mesh whose every axis has extent 1) is one piece.
"""

from __future__ import annotations

import ctypes
import gc
import time
import warnings
from typing import Optional

import torch

from pcgnn_tpu_torch.ops.hub import epoch_hub_plans, plan_covers, plan_union
from pcgnn_tpu_torch.parallel.mesh import Collective, CutRecorder, recording
from pcgnn_tpu_torch.utils import profiling
from pcgnn_tpu_torch.utils.profiling import section, span


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name; the window
    gathers with ``active`` (kernel 1c, the sharded store lane) also
    apart, as ``window_gather_masked``, and the choose kernel's ids source
    (the lanes without stores) and score kernel (``selection_score``) as
    ``choose_window_ids`` and ``selection_score``."""
    from pcgnn_tpu_torch.ops import (choose_window, mask_build,
                                     oversample_minors, ragged_gather,
                                     window_gather)
    return {"window_gather": window_gather.launches,
            "window_gather_masked": window_gather.masked_launches,
            "ragged_gather": ragged_gather.launches,
            "mask_build": mask_build.launches,
            "choose_window": choose_window.launches,
            "choose_window_ids": choose_window.ids_launches,
            "selection_score": choose_window.score_launches,
            "oversample_minors": oversample_minors.launches}


# libcuda, for the node count of a capture in progress
_libcuda = None


def _capture_nodes(stream: torch.cuda.Stream) -> int:
    """The nodes captured so far into the graph that ``stream`` is
    capturing (``libcuda.so.1``: ``cuStreamGetCaptureInfo_v2``,
    ``cuGraphGetNodes``).  Raises when the stream is not capturing."""
    global _libcuda
    if _libcuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuStreamGetCaptureInfo_v2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.c_void_p]
        lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
        lib.cuStreamGetCaptureInfo_v2.restype = ctypes.c_int
        lib.cuGraphGetNodes.restype = ctypes.c_int
        _libcuda = lib
    status, graph, n = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_size_t()
    rc = _libcuda.cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status), None,
        ctypes.byref(graph), None, None)
    # CU_STREAM_CAPTURE_STATUS_ACTIVE is 1
    if rc != 0 or status.value != 1:
        raise RuntimeError(f"the capture stream is not capturing (CUresult "
                           f"{rc}, capture status {status.value})")
    rc = _libcuda.cuGraphGetNodes(graph, None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with status {rc}")
    return n.value


def sections_marker(sections: dict) -> str:
    """The name of the zero-length range a replay leaves while a profiler
    records: ``pcgnn.runner.sections:<nodes>:<name>=<first>-<end>,...``,
    the section map of the graph it replays, so a reader of the trace
    finds each replay's map beside it."""
    runs = ",".join(f"{name}={first}-{end}"
                    for name, first, end in sections["runs"])
    return f"pcgnn.runner.sections:{sections['nodes']}:{runs}"


class PieceGraph(CutRecorder):
    """A body captured as CUDA graphs cut at its collectives (module
    docstring).  ``items`` is the replay schedule: ``("graph", g)``,
    ``("start", collective)`` and ``("wait", collective)`` in capture
    order.  A cut with no node captured since the last one adds no graph
    (the cuts merge).  ``generator`` (GraphSAGE's draws) is registered
    with every piece, so each replay draws from its seed and offset.
    ``sections`` is the capture's section map (``utils.profiling.
    SectionMap.close``) over the pieces' nodes in replay order: kernel and
    copy nodes, each one operation in a replay's device trace."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.items: list = []
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.generator = generator
        self.sections: Optional[dict] = None
        self._open = None               # the piece being captured
        self._nodes_done = 0            # nodes of the ended pieces

    @property
    def pieces(self) -> int:
        return sum(kind == "graph" for kind, _ in self.items)

    @property
    def collectives(self) -> int:
        return sum(kind == "start" for kind, _ in self.items)

    def nodes(self) -> int:
        """Nodes captured so far, over the pieces."""
        if self._open is None:
            return self._nodes_done
        return self._nodes_done + _capture_nodes(self.stream)

    def capture(self, body) -> None:
        """Capture ``body()`` (its collectives are cut points, and none
        runs), recording its section map."""
        with torch.cuda.stream(self.stream), recording(self), \
                profiling.recording_sections(self.nodes) as sections:
            self._begin()
            try:
                body()
                self._end(keep_empty=self.pieces == 0)
                self.sections = sections.close()
            except BaseException:
                if self._open is not None:
                    # leave the stream out of capture mode; the body's own
                    # error is the one raised
                    try:
                        self._open.capture_end()
                    except RuntimeError:
                        pass
                    self._open = None
                raise

    def _begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        if self.generator is not None:
            g.register_generator_state(self.generator)
        # thread_local: a gloo thread may touch the card while this one
        # captures; nothing of it enters the graph
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._open = g

    def _end(self, keep_empty: bool = False) -> None:
        nodes = _capture_nodes(self.stream)
        self._nodes_done += nodes
        g, self._open = self._open, None
        if nodes == 0 and not keep_empty:
            # nothing to replay: the piece is dropped
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                g.capture_end()
            return
        g.capture_end()
        self.items.append(("graph", g))

    def _cut(self) -> None:
        if _capture_nodes(self.stream):
            self._end()
            self._begin()

    def issue(self, op: Collective):
        self._cut()
        self.items.append(("start", op))
        return op if op.mesh.overlap else None

    def wait(self, op: Collective, work) -> None:
        self._cut()
        self.items.append(("wait", op))

    def replay(self) -> None:
        """The pieces in capture order, each collective issued and waited
        where the capture cut."""
        works = {}
        for kind, x in self.items:
            if kind == "graph":
                x.replay()
            elif kind == "start":
                works[x] = x.start()
            else:
                works.pop(x).wait()


class GraphRunner:
    """Runs ``fn(*inputs, generator, hub_plans)`` over stacks of batches,
    captured or eager (module docstring); ``StepRunner`` and
    ``PredictRunner`` say what ``fn`` is and what it returns.
    ``relations`` are the ones the model's hub lanes plan
    (``model.hub_relations``), or ``planner(batches)`` gives the plans of
    a stack (the sharded ``spmd_epoch_hub_plans``); ``rows``, the batches
    the static buffers hold at least (a longer stack allocates them at its
    length)."""

    # what the capture message calls one run of ``fn``
    what = "the function"

    def __init__(self, fn, relations, device: torch.device, *,
                 capture: bool, draws: bool, rows: int = 0, planner=None):
        if capture and device.type != "cuda":
            raise ValueError(f"capturing {self.what} needs a CUDA device, "
                             f"got {device}")
        self.fn = fn
        self.relations = tuple(relations)
        self.planner = planner or (
            lambda batches: epoch_hub_plans(self.relations, batches))
        self.device = device
        self.capture = capture
        self.rows = rows
        self.plans: Optional[tuple] = None
        # one generator for every batch's draws, seeded before each batch
        self.generator = (torch.Generator(device=device) if draws else None)
        self.graph: Optional[PieceGraph] = None
        self.graph_plans: Optional[tuple] = None
        self.bufs = None                       # (*inputs, outputs)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        # what the runs did: captures, replays, eager runs (every batch on
        # CPU; the warm-up of each capture on the card), seconds spent
        # capturing, the graph pool's bytes, the pieces and collectives of
        # one replay (1 and 0 without collectives); the wrapper launch
        # counts of
        # the last capture (the kernels one replay launches), summed over
        # every capture (recorded, not run) and over every replay (run on
        # the card, not counted by the wrappers)
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.pieces = 0
        self.collectives = 0
        self.replay_launches: dict = {}
        self.captured_launches = dict.fromkeys(launch_counts(), 0)
        self.replayed_launches = dict.fromkeys(launch_counts(), 0)
        # the section map of the current capture (``PieceGraph.sections``)
        # with the marker each replay leaves while a profiler records
        self.sections: Optional[dict] = None
        self.sections_marker = ""
        # called as step_hook("start") and step_hook("end") around each
        # batch, when set (a caller's timer)
        self.step_hook = None

    def plan(self, batches: torch.Tensor) -> tuple:
        """The hub plan for a stack of batches [n, B]: the stack's own
        (one read-back; none on a graph without hubs), grown to the
        largest this runner has seen."""
        with span("pcgnn.runner.plan"):
            plans = self.planner(batches)
        self.plans = plans if self.plans is None else plan_union(self.plans,
                                                                 plans)
        return self.plans

    def _run(self, inputs: tuple, seeds) -> torch.Tensor:
        """``fn`` over the rows of ``inputs`` ([n, B] each) in order
        (``seeds[i]`` seeds row i's draws); returns the [n, ...] outputs,
        on the device.  Plans first (``plan``), then makes no read-back."""
        plans = self.plan(inputs[0])
        n, b = inputs[0].shape
        hook = self.step_hook or (lambda what: None)
        if not self.capture:
            outs = []
            for i in range(n):
                hook("start")
                with span("pcgnn.runner.step"):
                    outs.append(self.fn(*(x[i] for x in inputs),
                                        self._seeded(seeds, i), plans))
                hook("end")
                self.eager_steps += 1
            return torch.stack(outs)
        # a stack longer than the static buffers runs in blocks of their
        # length (one copy a block), so it needs no new capture
        rows = n
        if self.bufs is not None and self.bufs[0].shape[1] == b:
            rows = self.bufs[0].shape[0]
        outs = []
        for lo in range(0, n, rows):
            m = min(rows, n - lo)
            with span("pcgnn.runner.load"):
                self._load([x[lo: lo + m] for x in inputs], plans)
            for i in range(lo, lo + m):
                self._seeded(seeds, i)
                hook("start")
                with span("pcgnn.runner.step"):
                    if self.graph is None:
                        with span("pcgnn.runner.capture"):
                            self._warm_up_and_capture(plans)
                    else:
                        profiling.marker(self.sections_marker)
                        self.graph.replay()
                        self.replays += 1
                        for k, c in self.replay_launches.items():
                            self.replayed_launches[k] += c
                hook("end")
            outs.append(self.bufs[-1][:m].clone())
        return torch.cat(outs)

    def _seeded(self, seeds, i: int):
        if self.generator is None:
            return None
        self.generator.manual_seed(int(seeds[i]))
        return self.generator

    def _outputs(self, n: int, b: int) -> torch.Tensor:
        """The static buffer of ``n`` batches' outputs, for batches of
        ``b``."""
        raise NotImplementedError

    def _load(self, inputs, plans) -> None:
        """Copy a stack into the static buffers (allocated at the larger
        of the stack's length and ``rows``; the graph is dropped when they
        are reallocated) and set the counter to 0; drop the graph when
        ``plans`` exceeds its plan."""
        n, b = inputs[0].shape
        if self.bufs is None or self.bufs[0].shape[0] < n \
                or self.bufs[0].shape[1] != b:
            self.graph = None
            rows = max(n, self.rows)
            self.bufs = (*(torch.zeros((rows, b), dtype=x.dtype,
                                       device=self.device) for x in inputs),
                         self._outputs(rows, b))
        if self.graph is not None and not plan_covers(self.graph_plans,
                                                      plans):
            self.graph = None
        for buf, src in zip(self.bufs, inputs):
            buf[:n].copy_(src)
        self.counter.zero_()

    def _body(self, plans) -> None:
        """One batch at the counter: the captured work.  Its reads and
        writes of the static buffers are section ``io``; ``fn`` marks its
        own sections."""
        *inputs, outs = self.bufs
        at = self.counter.view(1)
        section("io")
        args = [x.index_select(0, at)[0] for x in inputs]
        section(None)
        out = self.fn(*args, self.generator, plans)
        section("io")
        outs.index_copy_(0, at, out[None].to(outs.dtype))
        self.counter.add_(1)
        section(None)

    def _warm_up_and_capture(self, plans) -> None:
        """Run this batch eagerly on a side stream (the warm-up), then
        capture the same body as the graph that the next batches
        replay."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._body(plans)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.eager_steps += 1
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        # the captured draws read the generator's seed and offset at each
        # replay, as a fresh generator of that seed would draw
        graph = PieceGraph(self.device, self.generator)
        before = launch_counts()
        # a dead reference cycle that holds another graph or an event must
        # not be collected while this one captures: freeing it is a CUDA
        # call the capture does not permit
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph.capture(lambda: self._body(plans))
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        self.graph, self.graph_plans = graph, plans
        self.pieces, self.collectives = graph.pieces, graph.collectives
        self.sections = graph.sections
        self.sections_marker = sections_marker(graph.sections)
        self.replay_launches = {k: after[k] - before[k] for k in after}
        for k, c in self.replay_launches.items():
            self.captured_launches[k] += c
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        shape = ("a CUDA graph" if graph.pieces == 1 else
                 f"{graph.pieces} CUDA graphs cut at "
                 f"{graph.collectives} collectives")
        print(f"Captured {self.what} as {shape} (capture "
              f"{self.captures}, hub plan {plans}, "
              f"{time.perf_counter() - t0:.2f} s)")

    def card_launches(self, counts: dict) -> dict:
        """The kernel launches the card ran, from the wrappers' ``counts``
        over this runner's runs: less what was recorded at a capture,
        plus what every replay ran."""
        return {k: counts[k] - self.captured_launches.get(k, 0)
                + self.replayed_launches.get(k, 0) for k in counts}

    def stats(self) -> dict:
        """What the runs did, by name (the attributes above)."""
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "pieces": self.pieces, "collectives": self.collectives,
                "replay_launches": dict(self.replay_launches),
                "plans": self.plans, "sections": self.sections}


class StepRunner(GraphRunner):
    """Training steps of one (model, optimizer) pair over stacks of
    batches, captured or eager (module docstring).

    ``step_fn(batch, y, w, generator, hub_plans)`` is one optimizer step
    returning the loss (``trainer.train_step`` bound to the model, the
    optimizer, the graph and the constants).
    """

    what = "the training step"

    def run(self, batches: torch.Tensor, ys: torch.Tensor,
            weights: torch.Tensor, seeds=None) -> torch.Tensor:
        """Steps over the rows of ``batches`` / ``ys`` / ``weights`` [n, B]
        in order (``seeds[i]`` seeds step i's draws); returns the [n]
        losses, on the device.  Plans first (``plan``), then makes no
        read-back."""
        return self._run((batches, ys, weights), seeds)

    def _outputs(self, n: int, b: int) -> torch.Tensor:
        return torch.zeros((n,), dtype=torch.float32, device=self.device)


class PredictRunner(GraphRunner):
    """Forwards of one model over stacks of batches, captured or eager
    (module docstring): the counterpart of the JAX Trainer's
    ``predict_jit``, one call a batch.

    ``predict_fn(batch, generator, hub_plans)`` returns the batch's [B, 2]
    float32 probabilities, with no gradient (``Trainer.predict_runner``
    binds ``model.to_prob``).  GraphSAGE's draws are seeded with 0 before
    every batch, as its eager forward seeds a fresh generator.
    """

    what = "the forward"

    def run(self, batches: torch.Tensor) -> torch.Tensor:
        """Forwards over the rows of ``batches`` [n, B] in order; returns
        the [n, B, 2] probabilities, on the device.  Plans first
        (``plan``), then makes no read-back."""
        return self._run((batches,), [0] * batches.shape[0])

    def _outputs(self, n: int, b: int) -> torch.Tensor:
        return torch.zeros((n, b, 2), dtype=torch.float32,
                           device=self.device)
