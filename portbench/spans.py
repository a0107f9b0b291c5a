"""The program's own spans and section maps in a traced slice's record.

The port's spans (``pcgnn_tpu_torch/utils/profiling.py``: ``pcgnn.*``)
are operator ranges, so ``trace.events`` keeps them among the host's
operators (``cpu_ops``), on the clock of the card's operations.  A
replay of the captured step runs no Python; while a profiler records it
leaves a zero-length marker, ``pcgnn.runner.sections:<nodes>:<name>=
<first>-<end>,...``, the section map of the graph it replays, just before
its ``cudaGraphLaunch``.

``find_replays`` finds the device operations of each replay in the
benchmark's epoch spans by the graph launch's correlation id, which every
operation of the replay carries (``trace.events``), and orders them by
their start on the card, the order of the map's nodes on the one stream.
The card's clock drifts from the host's by up to a few hundred
microseconds over a slice, so the operations are not cut by time.  Where
one replay is not found whole (a graph launch with no map beside it, or
an operation the profiler lost), nothing is read: no section's time
rests on part of the replays."""

from __future__ import annotations

import collections

from portbench.stats import clip, covered, median

EPOCH = "pcgnn.epoch"
MARKER = "pcgnn.runner.sections:"


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


def _graph_launches(t: dict) -> list:
    """[(host start, marker, correlation id)] of every graph launch, with
    the map just before it (None where there is none: a program that
    leaves no marker)."""
    calls = sorted([(s, 0, n) for n, s, _ in t["cpu_ops"]
                    if n.startswith(MARKER)]
                   + [(s, 1, c) for s, c in t.get("graph_launches", ())])
    out, marker = [], None
    for s, is_launch, what in calls:
        if not is_launch:
            marker = what
        else:
            out.append((s, marker, what))
            marker = None
    return out


def find_replays(t: dict) -> list | None:
    """[(marker, device ops)] of every replay in the benchmark's epoch
    spans, or None unless each is found whole (module docstring)."""
    epochs = t["spans"]["portbench.epoch"]
    by_id = collections.defaultdict(list)
    for op in t["device_ops"]:
        if len(op) > 4:
            by_id[op[4]].append(op)
    out = []
    for s, marker, cid in _graph_launches(t):
        if not any(lo <= s <= hi for lo, hi in epochs):
            continue
        if marker is None:
            return None
        ops = sorted(by_id.get(cid, ()), key=lambda o: o[1])
        if len(ops) != len(parse_marker(marker)):
            return None
        out.append((marker, ops))
    return out or None


def replay_sections(t: dict) -> dict | None:
    """{section: device ms a replay} over the replays of the benchmark's
    epoch spans; None unless every one is found whole."""
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
