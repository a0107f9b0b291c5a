"""Kernel 1's share of its copy bound in the training step: the batches'
fused records read and written once at bfloat16 (``counts.window_gather``)
over 3.35 TB/s, against kernel 1's device time inside the epoch spans."""

from portbench.counts import window_gather
from portbench.stats import within


def read(rec):
    t = rec["trace"]
    ops = [o for o in within(t["device_ops"], t["spans"]["portbench.epoch"])
           if window_gather.KERNEL in o[0]]
    us = sum(o[2] - o[1] for o in ops)
    if not ops or us <= 0 or rec["peaks"] is None:
        return None
    b = window_gather.copy_bytes(t["rows"], t["record_width"])
    return 100.0 * (b / rec["peaks"][0] * 1e6) / us
