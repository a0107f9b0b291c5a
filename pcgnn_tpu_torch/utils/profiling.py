"""Tracing and timing utilities.

Counterpart of ``pcgnn_tpu/utils/profiling.py``:
  * ``trace`` — a context manager around ``torch.profiler`` that writes a
    Chrome trace (``chrome://tracing``, Perfetto) of the enclosed block;
  * ``annotate`` — a named range in that trace
    (``torch.profiler.record_function``);
  * ``StepTimer`` — wall-clock time per step with edges/s accounting;
  * ``trace_kernels`` — the card's kernels in a written trace, by name.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from datetime import datetime
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device=None):
    """Profile the enclosed block: host operators, and on a CUDA ``device``
    the card's kernels too.  On exit (after synchronizing the card) the
    trace is written to ``<log_dir>/trace-<time>.json``; the context value
    is the profiler, whose ``trace_path`` is set then."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "pcgnn_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    on_card = device is not None and torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if on_card:
                torch.cuda.synchronize(device)
    stamp = datetime.now().strftime("%y%m%d-%H%M%S-%f")
    prof.trace_path = os.path.join(log_dir, f"trace-{stamp}.json")
    prof.export_chrome_trace(prof.trace_path)


def trace_kernels(path: str) -> collections.Counter:
    """Launches of each card kernel in a Chrome trace that ``trace``
    wrote, by kernel name (empty for a trace of the CPU alone)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(e["name"] for e in events
                               if e.get("cat") == "kernel")


def annotate(name: str):
    """Named range that shows up in the trace."""
    return record_function(name)


@dataclass
class StepTimer:
    """Accumulates per-step wall time and derived throughput counters.
    Given a CUDA ``device``, each step's time ends in a synchronize of
    that device, so it holds the card's work and not only its launch."""

    edges_per_step: float = 0.0
    times: List[float] = field(default_factory=list)
    device: Optional[torch.device] = None
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if (self.device is not None
                and torch.device(self.device).type == "cuda"):
            torch.cuda.synchronize(self.device)
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def mean_s(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def edges_per_s(self) -> float:
        return self.edges_per_step / self.mean_s if self.mean_s else 0.0

    def summary(self) -> dict:
        return {"steps": len(self.times), "mean_step_ms": self.mean_s * 1e3,
                "edges_per_s": self.edges_per_s}
