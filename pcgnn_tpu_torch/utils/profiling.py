"""Tracing utilities: spans and the section map of a capture.

Counterpart of ``pcgnn_tpu/utils/profiling.py``:
  * ``trace`` — a context manager around ``torch.profiler`` that writes a
    Chrome trace (``chrome://tracing``, Perfetto) of the enclosed block;
  * ``trace_kernels`` — the card's kernels in a written trace, by name;
  * ``span`` — a named range of the program (``pcgnn.*``), on the clock
    the profiler gives the card's operations, and nothing while no
    profiler records;
  * ``section`` — which layer the graph nodes a capture in progress makes
    belong to (``recording_sections``, ``SectionMap``).

A span is an operator range (``torch._C._profiler._RecordFunctionFast``,
a private class, chosen on purpose and checked on torch 2.11 and 2.13),
not a user annotation as ``torch.profiler.record_function`` makes: a
reader of the profiler's events finds it among the host's operators, as
it finds aten's, and it nests in the call tree, so the span that caused a
span is the one that encloses it.  A deliberate device-to-host copy is a
span named ``pcgnn.<layer>.readback``: counting them counts the copies.

A replay of a captured graph runs no Python, so no span can see inside
it: the capture records instead which of its nodes each layer made
(``section``), and a replay's k-th device operation is its graph's k-th
node (a one-stream capture is a chain).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import tempfile
from datetime import datetime
from typing import Callable, Optional

import torch
from torch.profiler import ProfilerActivity, profile

# one shared context for every span while no profiler records
_NULL = contextlib.nullcontext()

# the SectionMap of the capture in progress (``recording_sections``)
_sections: Optional["SectionMap"] = None


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


def span(name: str):
    """A named range while a profiler records (an operator range on the
    profiler's clock); otherwise one shared null context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


def marker(name: str) -> None:
    """A zero-length range, only while a profiler records."""
    if torch.autograd._profiler_enabled():
        with torch._C._profiler._RecordFunctionFast(name):
            pass


class SectionMap:
    """The graph nodes that each section made during one capture.
    ``count()`` reads the nodes captured so far; ``runs`` holds ``(name,
    first, end)``, node ``first`` up to (not including) node ``end``, in
    capture order, consecutive runs of one name merged.  A name may recur;
    nodes made outside every section are in no run."""

    def __init__(self, count: Callable[[], int]):
        self.count = count
        self.runs: list = []
        self.current: Optional[str] = None
        self._since = count()

    def switch(self, name: Optional[str]) -> Optional[str]:
        """Close the current section's run here and open ``name``'s (None:
        no section); returns the section it replaced."""
        now = self.count()
        if self.current is not None and now > self._since:
            last = self.runs[-1] if self.runs else None
            if last and last[0] == self.current and last[2] == self._since:
                self.runs[-1] = (self.current, last[1], now)
            else:
                self.runs.append((self.current, self._since, now))
        prev, self.current, self._since = self.current, name, now
        return prev

    def close(self) -> dict:
        """{"nodes": the capture's node count, "runs": [(name, first,
        end)]}."""
        self.switch(None)
        return {"nodes": self.count(), "runs": list(self.runs)}


@contextlib.contextmanager
def recording_sections(count: Callable[[], int]):
    """Make a ``SectionMap`` over ``count`` the process's map for the
    block, so that ``section`` markers record into it.  One at a time."""
    global _sections
    if _sections is not None:
        raise RuntimeError("a section map is already recording")
    _sections = SectionMap(count)
    try:
        yield _sections
    finally:
        _sections = None


def section(name: Optional[str]) -> Optional[str]:
    """From here on, the nodes a capture in progress makes belong to
    section ``name`` (None: to none); returns the section it replaced.
    Outside a capture it does nothing and returns None."""
    rec = _sections
    if rec is None:
        return None
    return rec.switch(name)


def in_section(name: str):
    """Decorate a function so that the nodes it makes belong to section
    ``name``, and those after it to the caller's section again."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            prev = section(name)
            try:
                return fn(*args, **kwargs)
            finally:
                section(prev)
        return run
    return wrap


def node_sections(sections: dict) -> list:
    """Each node's section name (``other`` outside every run) of a map
    ``SectionMap.close`` returned."""
    names = ["other"] * sections["nodes"]
    for name, first, end in sections["runs"]:
        names[first:end] = [name] * (end - first)
    return names
