"""The traced slice's events, from ``torch.profiler``'s results in memory
(no trace file): the card's operations, the host's operators and the
benchmark's spans, as plain tuples in microseconds on the profiler's
clock, and the breakdown the result line carries."""

from __future__ import annotations

import collections

from portbench.stats import clip, union

SPANS = ("portbench.epoch", "portbench.validate")
# the runtime call that replays a captured graph (CUPTI may add a version
# suffix, ``cudaGraphLaunch_v10000``)
GRAPH_LAUNCH = "cudaGraphLaunch"


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def events(prof) -> dict:
    """{"device_ops": [(name, start, end, kind, correlation id)],
    "cpu_ops": [(name, start, end)], "graph_launches": [(start,
    correlation id)], "spans": {span: [(start, end)]}} of a finished
    ``torch.profiler.profile``.  A device operation's correlation id is
    the one of the host call that launched it: a graph launch's for every
    operation of its replay."""
    dev, cpu, launches = [], [], []
    spans = {s: [] for s in SPANS}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        name = e.name()
        if e.device_type().name == "CPU":
            if name in spans:
                spans[name].append((start, end))
            elif not e.is_user_annotation():
                cpu.append((name, start, end))
                if name.startswith(GRAPH_LAUNCH):
                    launches.append((start, e.correlation_id()))
        elif not e.is_user_annotation() and name not in spans:
            dev.append((name, start, end, _kind(name), e.correlation_id()))
    return {"device_ops": dev, "cpu_ops": cpu, "graph_launches": launches,
            "spans": spans}


def wall(spans: dict) -> tuple:
    """(first span's start, last span's end)."""
    allsp = [x for v in spans.values() for x in v]
    return min(s for s, _ in allsp), max(e for _, e in allsp)


def _host_at(t: float, spans: dict, cpu_ops: list) -> str:
    """What the host was doing at ``t``: the span, and the innermost host
    operator running then."""
    where = next((k for k, v in spans.items()
                  if any(s <= t <= e for s, e in v)), "outside spans")
    inner = [o for o in cpu_ops if o[1] <= t < o[2]]
    op = max(inner, key=lambda o: o[1])[0] if inner else "no operator"
    return f"{where}: {op}"


def breakdown(ev: dict, lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps of the card, by what the host was doing when each began
    (seconds)."""
    by_name = collections.Counter()
    for name, s, e, *_ in ev["device_ops"]:
        by_name[name[:160]] += (e - s) / 1e6
    busy = union(clip([(o[1], o[2]) for o in ev["device_ops"]], lo, hi))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    return {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
            "idle_gaps": [[_host_at(t, ev["spans"], ev["cpu_ops"]),
                           g / 1e6] for g, t in gaps]}
