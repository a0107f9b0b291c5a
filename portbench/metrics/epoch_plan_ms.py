"""Median host ms an epoch in the runner's plan span inside the epoch
span (``pcgnn.runner.plan``: the hub planner and its read-back, the
wait for the card included)."""

from portbench.spans import epoch_median_ms


def read(rec):
    return epoch_median_ms(rec["trace"], "pcgnn.runner.plan")
