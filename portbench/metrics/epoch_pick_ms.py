"""Median host ms an epoch in the program's pick span
(``pcgnn.epoch.pick``: ``epoch_plan``, the labels' gather, the seeds)."""

from portbench.spans import epoch_median_ms


def read(rec):
    return epoch_median_ms(rec["trace"], "pcgnn.epoch.pick")
