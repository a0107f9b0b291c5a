"""Mean ms an epoch in which no operation ran on the card, inside the
program's epoch spans (``pcgnn.epoch``)."""

from portbench.spans import epoch_idle_ms


def read(rec):
    return epoch_idle_ms(rec["trace"])
