"""Device ms a replay of the captured step in section ``choose``
(selection scores, distances, ``keep_nearest``, the window sum)."""

from portbench.spans import section_ms


def read(rec):
    return section_ms(rec["trace"], "choose")
