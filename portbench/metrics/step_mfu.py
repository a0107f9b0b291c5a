"""The training step's share of the card's peak: its least time (the
larger of its counted bytes over the memory rate and its counted
operations over the float32 rate, ``counts.step``; TF32 is off) over
the time the epoch spans took, step for step."""

from portbench.counts import step


def read(rec):
    t = rec["trace"]
    if rec["peaks"] is None or not t["steps"]:
        return None
    bytes_ = sum(step.byte_terms(
        rows=t["rows"], steps=t["steps"], feat_dim=t["feat_dim"],
        record_width=t["record_width"], train_pos=t["train_pos"],
        hub_neighbors=t["hub_neighbors"], params=t["params"],
        neighbors=None if t["stores"] else t["neighbors"]).values())
    fl = step.flops(rows=t["rows"], feat_dim=t["feat_dim"], emb=t["emb"],
                    relations=t["relations"])
    spent_us = sum(e - s for s, e in t["spans"]["portbench.epoch"])
    return 100.0 * step.least_seconds(bytes_, fl, rec["peaks"]) * 1e6 / spent_us
