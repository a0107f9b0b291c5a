"""Device ms a replay of the captured step in section ``oversample``
(the candidates, the hub minors' sort, the keep, the dedup, the minor
sums)."""

from portbench.spans import section_ms


def read(rec):
    return section_ms(rec["trace"], "oversample")
