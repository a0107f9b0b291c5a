"""Median host ms a validation in the program's metrics span
(``pcgnn.evaluate.metrics``: ``evaluate_probs`` on the host)."""

from portbench.spans import named
from portbench.stats import median


def read(rec):
    spans = named(rec["trace"], "pcgnn.evaluate.metrics")
    return median([(e - s) / 1e3 for s, e in spans]) if spans else None
