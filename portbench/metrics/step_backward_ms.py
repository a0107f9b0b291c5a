"""Device ms a replay of the captured step in sections ``backward`` and
``adam``."""

from portbench.spans import section_ms


def read(rec):
    return section_ms(rec["trace"], "backward", "adam")
