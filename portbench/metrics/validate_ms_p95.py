"""95th percentile over every validation of the window: one
``Trainer.evaluate`` of the validation split, probabilities read back and
metrics computed."""

from portbench.stats import percentile


def read(rec):
    return percentile(rec["window"]["validate_ms"], 95)
