"""Captures of the training step during the traced slice
(``StepRunner.stats()["captures"]``, the warm-up's left out): each is a
plan that outgrew the captured one."""


def read(rec):
    return rec["trace"]["captures"]
