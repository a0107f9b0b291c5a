"""95th percentile over every epoch of the window, from the ``run_epoch``
call to its loss on the host."""

from portbench.stats import percentile


def read(rec):
    return percentile(rec["window"]["epoch_ms"], 95)
