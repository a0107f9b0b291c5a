"""Epochs of training steps with no host in their loop.

Counterpart of the JAX Trainer's compiled epoch (``pcgnn_tpu/train/
trainer.py``: ``_epoch``, a jitted ``lax.scan`` of loss -> grad -> Adam
over the epoch's batches; ``_epoch_block``; ``_step1``).  ``StepRunner``
runs a stack of steps for one (model, optimizer) pair in one of two ways,
with the same arithmetic:

  * captured (the default on CUDA): one training step -- forward, backward
    and Adam -- is captured once as a CUDA graph and replayed once per
    step, the counterpart of the scan body.  The graph reads its batch,
    labels and weights from static [n, B] buffers at a device step
    counter, writes the loss into a [n] buffer at the counter and advances
    it, so a replay needs no copy and no read-back;
  * eager (the CPU, and the card when asked): ``train_step`` per step.

Both take the hub lane's chunks from one plan for the whole stack
(``ops.hub.epoch_hub_plans``), read back in one copy, so a step's shapes
are fixed and nothing in a step reads from the card.  The runner keeps the
largest plan it has seen (``plan_union``), so both ways run every step at
the same widths; the graph is captured again only when a stack's plan
exceeds the captured one (``captures`` counts them).

Capture follows PyTorch's whole-network recipe: the first step of a
capture runs eagerly on a side stream (the warm-up; it creates Adam's
state, so it is the run's own step, not an extra one), then the same step
body is captured with ``torch.cuda.graph``.  The optimizer must be
``torch.optim.Adam(capturable=True)`` (``trainer.make_optimizer`` on
CUDA).  GraphSAGE's draws come from one CUDA generator registered with the
graph and seeded from (seed, epoch, step) before each step, as the eager
path seeds a fresh generator.  A capture that fails raises: there is no
eager fallback on the card.
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


class StepRunner:
    """Training steps of one (model, optimizer) pair over stacks of
    batches, captured or eager (module docstring).

    ``step_fn(batch, y, w, generator, hub_plans)`` is one optimizer step
    returning the loss (``trainer.train_step`` bound to the model, the
    optimizer, the graph and the constants); ``relations`` are the ones the
    model's hub lanes plan (``model.hub_relations``).
    """

    def __init__(self, step_fn, relations, device: torch.device, *,
                 capture: bool, draws: bool):
        if capture and device.type != "cuda":
            raise ValueError(f"a captured step needs a CUDA device, got "
                             f"{device}")
        self.step_fn = step_fn
        self.relations = tuple(relations)
        self.device = device
        self.capture = capture
        self.plans: Optional[tuple] = None
        # one generator for every step's draws, seeded before each step
        self.generator = (torch.Generator(device=device) if draws else None)
        self.graph = None
        self.graph_plans: Optional[tuple] = None
        self.bufs = None                       # (ids, y, w, losses)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        # what the runs did: captures, replays, eager steps (every eager
        # step on CPU; the warm-up of each capture on the card), seconds
        # spent capturing, the graph pool's bytes; the wrapper launch
        # counts of the last capture (the kernels one replay launches),
        # summed over every capture (recorded, not run) and over every
        # replay (run on the card, not counted by the wrappers)
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replay_launches: dict = {}
        self.captured_launches = dict.fromkeys(launch_counts(), 0)
        self.replayed_launches = dict.fromkeys(launch_counts(), 0)
        # called as step_hook("start") and step_hook("end") around each
        # step, when set (a caller's timer)
        self.step_hook = None

    def plan(self, batches: torch.Tensor) -> tuple:
        """The hub plan for a stack of batches [n, B]: the stack's own
        (one read-back; none on a graph without hubs), grown to the
        largest this runner has seen."""
        plans = epoch_hub_plans(self.relations, batches)
        self.plans = plans if self.plans is None else plan_union(self.plans,
                                                                 plans)
        return self.plans

    def run(self, batches: torch.Tensor, ys: torch.Tensor,
            weights: torch.Tensor, seeds=None) -> torch.Tensor:
        """Steps over the rows of ``batches`` / ``ys`` / ``weights`` [n, B]
        in order (``seeds[i]`` seeds step i's draws); returns the [n]
        losses, on the device.  Plans first (``plan``), then makes no
        read-back."""
        plans = self.plan(batches)
        n = batches.shape[0]
        hook = self.step_hook or (lambda what: None)
        if not self.capture:
            losses = []
            for i in range(n):
                hook("start")
                losses.append(self.step_fn(batches[i], ys[i], weights[i],
                                           self._seeded(seeds, i), plans))
                hook("end")
                self.eager_steps += 1
            return torch.stack(losses)
        # a stack longer than the static buffers runs in blocks of their
        # length (one copy a block), so it needs no new capture
        rows = n
        if self.bufs is not None and self.bufs[0].shape[1] == batches.shape[1]:
            rows = self.bufs[0].shape[0]
        losses = []
        for lo in range(0, n, rows):
            m = min(rows, n - lo)
            self._load(batches[lo: lo + m], ys[lo: lo + m],
                       weights[lo: lo + m], plans)
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
            losses.append(self.bufs[3][:m].clone())
        return torch.cat(losses)

    def _seeded(self, seeds, i: int):
        if self.generator is None:
            return None
        self.generator.manual_seed(int(seeds[i]))
        return self.generator

    def _load(self, batches, ys, weights, plans) -> None:
        """Copy a stack into the static buffers (allocated at the first
        stack's shape; the graph is dropped when they are reallocated) and
        set the counter to 0; drop the graph when ``plans`` exceeds its
        plan."""
        n, b = batches.shape
        if self.bufs is None or self.bufs[0].shape[0] < n \
                or self.bufs[0].shape[1] != b:
            self.graph = None
            dev = self.device
            self.bufs = (torch.zeros((n, b), dtype=batches.dtype, device=dev),
                         torch.zeros((n, b), dtype=ys.dtype, device=dev),
                         torch.zeros((n, b), dtype=weights.dtype, device=dev),
                         torch.zeros((n,), dtype=torch.float32, device=dev))
        if self.graph is not None and not plan_covers(self.graph_plans,
                                                      plans):
            self.graph = None
        for buf, src in zip(self.bufs, (batches, ys, weights)):
            buf[:n].copy_(src)
        self.counter.zero_()

    def _body(self, plans) -> None:
        """One step at the counter: the captured work."""
        ids, ys, ws, losses = self.bufs
        at = self.counter.view(1)
        loss = self.step_fn(ids.index_select(0, at)[0],
                            ys.index_select(0, at)[0],
                            ws.index_select(0, at)[0], self.generator, plans)
        losses.index_copy_(0, at, loss.view(1).to(losses.dtype))
        self.counter.add_(1)

    def _warm_up_and_capture(self, plans) -> None:
        """Run this step eagerly on a side stream (the warm-up), then
        capture the same step body as the graph that the next steps
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
        print(f"Captured the training step as a CUDA graph (capture "
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
