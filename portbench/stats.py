"""Order statistics and interval arithmetic shared by the readers."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile of every value, linear between the two
    nearest ranks (numpy's default); None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> float | None:
    return percentile(values, 50.0)


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float) -> list:
    """The intervals cut to [lo, hi]; the empty ones dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def within(ops, spans) -> list:
    """The ops (name, start, end) that start inside one of ``spans``
    (start, end): the device work of those spans, each of which ends on a
    read-back."""
    spans = sorted(spans)
    out, j = [], 0
    for op in sorted(ops, key=lambda o: o[1]):
        while j < len(spans) and spans[j][1] < op[1]:
            j += 1
        if j < len(spans) and spans[j][0] <= op[1] <= spans[j][1]:
            out.append(op)
    return out
