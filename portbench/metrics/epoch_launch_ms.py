"""Median host ms an epoch in the runner's step spans
(``pcgnn.runner.step``: each replay's launch)."""

from portbench.spans import epoch_median_ms


def read(rec):
    return epoch_median_ms(rec["trace"], "pcgnn.runner.step")
