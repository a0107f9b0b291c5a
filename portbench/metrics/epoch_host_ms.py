"""Median host milliseconds inside an epoch span before ``run_epoch``
returns: the pick, the hub plan's read-back and the replays' launches."""

from portbench.stats import median


def read(rec):
    return median(rec["trace"]["epoch_host_ms"])
