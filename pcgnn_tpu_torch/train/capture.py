"""Epochs of training steps, and evaluations, with no host in their loop.

Counterpart of the JAX Trainer's compiled epoch (``pcgnn_tpu/train/
trainer.py``: ``_epoch``, a jitted ``lax.scan`` of loss -> grad -> Adam
over the epoch's batches; ``_epoch_block``; ``_step1``) and of its compiled
forward (``_predict`` / ``predict_jit``).  ``StepRunner`` runs a stack of
training steps for one (model, optimizer) pair, ``PredictRunner`` a stack
of forwards for one model, each in one of two ways, with the same
arithmetic:

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
(``ops.hub.epoch_hub_plans``), read back in one copy, so a batch's shapes
are fixed and nothing in a replay reads from the card.  A runner keeps the
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
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import torch

from pcgnn_tpu_torch.ops.hub import epoch_hub_plans, plan_covers, plan_union


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from pcgnn_tpu_torch.ops import mask_build, ragged_gather, window_gather
    return {"window_gather": window_gather.launches,
            "ragged_gather": ragged_gather.launches,
            "mask_build": mask_build.launches}


class GraphRunner:
    """Runs ``fn(*inputs, generator, hub_plans)`` over stacks of batches,
    captured or eager (module docstring); ``StepRunner`` and
    ``PredictRunner`` say what ``fn`` is and what it returns.
    ``relations`` are the ones the model's hub lanes plan
    (``model.hub_relations``); ``rows``, the batches the static buffers
    hold at least (a longer stack allocates them at its length)."""

    # what the capture message calls one run of ``fn``
    what = "the function"

    def __init__(self, fn, relations, device: torch.device, *,
                 capture: bool, draws: bool, rows: int = 0):
        if capture and device.type != "cuda":
            raise ValueError(f"capturing {self.what} needs a CUDA device, "
                             f"got {device}")
        self.fn = fn
        self.relations = tuple(relations)
        self.device = device
        self.capture = capture
        self.rows = rows
        self.plans: Optional[tuple] = None
        # one generator for every batch's draws, seeded before each batch
        self.generator = (torch.Generator(device=device) if draws else None)
        self.graph = None
        self.graph_plans: Optional[tuple] = None
        self.bufs = None                       # (*inputs, outputs)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        # what the runs did: captures, replays, eager runs (every batch on
        # CPU; the warm-up of each capture on the card), seconds spent
        # capturing, the graph pool's bytes; the wrapper launch counts of
        # the last capture (the kernels one replay launches), summed over
        # every capture (recorded, not run) and over every replay (run on
        # the card, not counted by the wrappers)
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replay_launches: dict = {}
        self.captured_launches = dict.fromkeys(launch_counts(), 0)
        self.replayed_launches = dict.fromkeys(launch_counts(), 0)
        # called as step_hook("start") and step_hook("end") around each
        # batch, when set (a caller's timer)
        self.step_hook = None

    def plan(self, batches: torch.Tensor) -> tuple:
        """The hub plan for a stack of batches [n, B]: the stack's own
        (one read-back; none on a graph without hubs), grown to the
        largest this runner has seen."""
        plans = epoch_hub_plans(self.relations, batches)
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
            self._load([x[lo: lo + m] for x in inputs], plans)
            for i in range(lo, lo + m):
                self._seeded(seeds, i)
                hook("start")
                if self.graph is None:
                    self._warm_up_and_capture(plans)
                else:
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
        """One batch at the counter: the captured work."""
        *inputs, outs = self.bufs
        at = self.counter.view(1)
        out = self.fn(*(x.index_select(0, at)[0] for x in inputs),
                      self.generator, plans)
        outs.index_copy_(0, at, out[None].to(outs.dtype))
        self.counter.add_(1)

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
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            # the captured draws read the generator's seed and offset at
            # each replay, as a fresh generator of that seed would draw
            graph.register_generator_state(self.generator)
        before = launch_counts()
        # a dead reference cycle that holds another graph or an event must
        # not be collected while this one captures: freeing it is a CUDA
        # call the capture does not permit
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._body(plans)
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        self.graph, self.graph_plans = graph, plans
        self.replay_launches = {k: after[k] - before[k] for k in after}
        for k, c in self.replay_launches.items():
            self.captured_launches[k] += c
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        print(f"Captured {self.what} as a CUDA graph (capture "
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
                "replay_launches": dict(self.replay_launches),
                "plans": self.plans}


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
