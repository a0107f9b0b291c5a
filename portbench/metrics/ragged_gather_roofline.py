"""Kernel 2's share of its bound in the training step: the neighbor ids
it fetches from the CSR, read and written once (``counts.ragged_gather``)
— the real hub rows' in a lane with stores, every real row's in every
relation in the CSR lane (no store, no dense table) — against kernel 2's
device time inside the epoch spans."""

from portbench.counts import ragged_gather
from portbench.stats import within


def read(rec):
    t = rec["trace"]
    ops = [o for o in within(t["device_ops"], t["spans"]["portbench.epoch"])
           if ragged_gather.KERNEL in o[0]]
    us = sum(o[2] - o[1] for o in ops)
    ids = t["hub_neighbors"] if t["stores"] else t["neighbors"]
    if not ops or us <= 0 or not ids or rec["peaks"] is None:
        return None
    return 100.0 * (ragged_gather.id_bytes(ids) / rec["peaks"][0] * 1e6) / us
