"""The training step's share of the card's peak: its least time (the
larger of its counted bytes over the memory rate and its counted
operations over the float32 rate, by the count of the configuration's
reference, ``counts.step``; TF32 is off) over the time the epoch spans
took, step for step."""

from portbench.counts import step


def read(rec):
    t = rec["trace"]
    if rec["peaks"] is None or not t["steps"]:
        return None
    terms, fl = step.count(t)
    spent_us = sum(e - s for s, e in t["spans"]["portbench.epoch"])
    return (100.0 * step.least_seconds(sum(terms.values()), fl, rec["peaks"])
            * 1e6 / spent_us)
