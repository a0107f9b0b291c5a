"""The program's deliberate read-backs an epoch: its ``*.readback``
spans (``pcgnn.hub.readback``, the hub plan's copy), one a copy, inside
the epoch spans."""

from portbench.spans import epoch_readbacks


def read(rec):
    return epoch_readbacks(rec["trace"])
