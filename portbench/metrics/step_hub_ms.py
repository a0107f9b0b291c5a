"""Device ms a replay of the captured step in section ``hub`` (the hub
lane: its table, ``hub_choose_sum`` with kernel 2, the merge)."""

from portbench.spans import section_ms


def read(rec):
    return section_ms(rec["trace"], "hub")
