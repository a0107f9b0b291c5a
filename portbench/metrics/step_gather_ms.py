"""Device ms a replay of the captured step in section ``gather`` (the
centers' rows and, in the CSR lane, each relation's neighbor ids through
kernel 2 and their clamped float32 rows)."""

from portbench.spans import section_ms


def read(rec):
    return section_ms(rec["trace"], "gather")
