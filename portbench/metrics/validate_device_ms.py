"""Milliseconds of device operations inside the validation spans, per
validation."""

from portbench.stats import within


def read(rec):
    t = rec["trace"]
    spans = t["spans"]["portbench.validate"]
    ops = within(t["device_ops"], spans)
    return sum(o[2] - o[1] for o in ops) / 1e3 / len(spans) if ops else None
