"""Percent of the traced slice's wall in which no operation ran on the
card: 100 less the union of the device operations' intervals."""

from portbench.stats import clip, covered


def read(rec):
    t = rec["trace"]
    lo, hi = t["wall"]
    busy = covered(clip([(o[1], o[2]) for o in t["device_ops"]], lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo)) if busy > 0 else None
