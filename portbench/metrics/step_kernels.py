"""Kernels the card ran inside the epoch spans, over the steps."""

from portbench.stats import within


def read(rec):
    t = rec["trace"]
    ops = [o for o in within(t["device_ops"], t["spans"]["portbench.epoch"])
           if o[3] == "kernel"]
    return len(ops) / t["steps"] if ops and t["steps"] else None
