"""Kernel 2's share of its bound in the hub lane of the training step:
the real hub rows' neighbor ids read and written once
(``counts.ragged_gather``), against kernel 2's device time inside the
epoch spans."""

from portbench.counts import ragged_gather
from portbench.stats import within


def read(rec):
    t = rec["trace"]
    ops = [o for o in within(t["device_ops"], t["spans"]["portbench.epoch"])
           if ragged_gather.KERNEL in o[0]]
    us = sum(o[2] - o[1] for o in ops)
    if not ops or us <= 0 or not t["hub_neighbors"] or rec["peaks"] is None:
        return None
    b = ragged_gather.id_bytes(t["hub_neighbors"])
    return 100.0 * (b / rec["peaks"][0] * 1e6) / us
