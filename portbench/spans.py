"""The program's own spans and section maps in a traced slice's record.

The port's spans (``pcgnn_tpu_torch/utils/profiling.py``: ``pcgnn.*``)
are operator ranges, so ``trace.events`` keeps them among the host's
operators (``cpu_ops``), on the clock of the card's operations.  A
replay of the captured step runs no Python; while a profiler records it
leaves a zero-length marker, ``pcgnn.runner.sections:<nodes>:<name>=
<first>-<end>,...``, the section map of the graph it replays, just before
its ``cudaGraphLaunch``.

``find_replays`` finds the device operations of each replay in the
benchmark's epoch spans.  The record carries no correlation between a
launch and its operations, and the card's clock drifts from the host's
by up to a few hundred microseconds over a slice, more than the host
spends between two epochs, so the operations are not cut by time.  They
are found by count over the whole slice instead: the card runs one
stream in launch order, each launch call of the host starts one
operation and a graph launch its map's nodes.  A count can slip (the
profiler may miss the first operations after it starts), so a replay is
the run of operations within ``SLIP`` places of where its count puts it
that bears the kernel names every replay of its map bears there.  Where
one replay is not found, or the names are not one run's, nothing is
read: no section's time rests on part of the replays."""

from __future__ import annotations

from portbench.stats import clip, covered, median

EPOCH = "pcgnn.epoch"
MARKER = "pcgnn.runner.sections:"
GRAPH_LAUNCH = "cudaGraphLaunch"
# places a replay's operations may lie from where the count puts them
SLIP = 8
# host calls that start one operation on the card
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy",
            "cudaMemsetAsync", "cudaMemset", "cudaMemcpy2DAsync",
            "cudaLaunchCooperativeKernel")


def named(t: dict, name: str) -> list:
    """(start, end) of the program's spans called ``name``."""
    return [(s, e) for n, s, e in t.get("cpu_ops", ()) if n == name]


def _starting_in(items: list, outer: tuple) -> list:
    return [x for x in items if outer[0] <= x[0] <= outer[1]]


def epoch_sums(t: dict, name: str) -> list | None:
    """Per ``pcgnn.epoch`` span, the ms of the ``name`` spans that start in
    it; None when the program leaves no epoch span."""
    epochs = named(t, EPOCH)
    if not epochs:
        return None
    spans = named(t, name)
    return [sum(e - s for s, e in _starting_in(spans, ep)) / 1e3
            for ep in epochs]


def epoch_median_ms(t: dict, name: str) -> float | None:
    sums = epoch_sums(t, name)
    return None if sums is None else median(sums)


def epoch_idle_ms(t: dict) -> float | None:
    """Mean ms an epoch span in which no operation ran on the card."""
    epochs = named(t, EPOCH)
    ops = [(o[1], o[2]) for o in t["device_ops"]]
    if not epochs or not ops:
        return None
    idle = [(hi - lo) - covered(clip(ops, lo, hi)) for lo, hi in epochs]
    return sum(idle) / len(idle) / 1e3


def epoch_readbacks(t: dict) -> float | None:
    """The program's read-back spans (``*.readback``) in the epoch spans,
    per epoch."""
    epochs = named(t, EPOCH)
    if not epochs:
        return None
    marks = [(s, e) for n, s, e in t["cpu_ops"]
             if n.startswith("pcgnn.") and n.endswith(".readback")]
    return sum(len(_starting_in(marks, ep)) for ep in epochs) / len(epochs)


def parse_marker(name: str) -> list:
    """Each node's section (``other`` outside every run) of a replay's
    marker."""
    nodes, runs = name[len(MARKER):].split(":", 1)
    out = ["other"] * int(nodes)
    for run in filter(None, runs.split(",")):
        sec, span = run.rsplit("=", 1)
        first, end = (int(x) for x in span.split("-"))
        out[first:end] = [sec] * (end - first)
    return out


def _base(name: str) -> str:
    """A runtime call's name without CUPTI's version suffix."""
    head, _, tail = name.rpartition("_v")
    return head if head and tail.isdigit() else name


def _graph_launches(t: dict) -> list | None:
    """[(host start, marker, place)] of every graph launch in the slice:
    the map beside it, and where its operations start in the card's
    operations by count.  None where a graph launch has no marker (a
    program that leaves none, or a graph of several pieces)."""
    calls = sorted((s, n) for n, s, _ in t["cpu_ops"]
                   if n.startswith(MARKER)
                   or _base(n) in LAUNCHES + (GRAPH_LAUNCH,))
    out, at, marker = [], 0, None
    for s, name in calls:
        if name.startswith(MARKER):
            marker = name
        elif _base(name) != GRAPH_LAUNCH:
            at += 1
        elif marker is None:
            return None
        else:
            out.append((s, marker, at))
            at += len(parse_marker(marker))
            marker = None
    return out


def _near(names: list, at: int, n: int) -> dict:
    """{the n names from place p: p} for the places within ``SLIP`` of
    ``at``, the nearest place kept."""
    out: dict = {}
    for p in sorted(range(max(at - SLIP, 0), at + SLIP + 1),
                    key=lambda p: abs(p - at)):
        if p + n <= len(names):
            out.setdefault(tuple(names[p: p + n]), p)
    return out


def find_replays(t: dict) -> list | None:
    """[(marker, device ops)] of every replay in the benchmark's epoch
    spans, or None unless each is found (module docstring)."""
    launches = _graph_launches(t)
    epochs = t["spans"]["portbench.epoch"]
    if not launches:
        return None
    ops = sorted(t["device_ops"], key=lambda o: o[1])
    names = [o[0] for o in ops]
    mine = [(m, at) for s, m, at in launches
            if any(lo <= s <= hi for lo, hi in epochs)]
    if not mine:
        return None
    # each map's names: the one run that every replay of it bears near
    # its place (several: the replays' neighbours hide where they start)
    refs = {}
    for m in {m for m, _ in mine}:
        n = len(parse_marker(m))
        near = [_near(names, at, n) for mm, at in mine if mm == m]
        every = set(near[0]).intersection(*near[1:])
        if len(every) != 1:
            return None
        (refs[m],) = every
    out, shift = [], 0
    for m, at in mine:
        n = len(parse_marker(m))
        # the count resumes where the last replay was found
        p = _near(names, at + shift, n).get(refs[m])
        if p is None:
            return None
        shift = p - at
        out.append((m, ops[p: p + n]))
    return out


def replay_sections(t: dict) -> dict | None:
    """{section: device ms a replay} over the replays of the benchmark's
    epoch spans; None unless every one is found."""
    replays = find_replays(t)
    if replays is None:
        return None
    total: dict = {}
    for marker, block in replays:
        for sec, op in zip(parse_marker(marker), block):
            total[sec] = total.get(sec, 0.0) + (op[2] - op[1])
    return {sec: us / 1e3 / len(replays) for sec, us in total.items()}


def section_ms(t: dict, *names: str) -> float | None:
    """Device ms a replay of ``names``' sections together."""
    sec = replay_sections(t)
    return None if sec is None else sum(sec.get(n, 0.0) for n in names)
