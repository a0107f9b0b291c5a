"""Seconds from the start of the process to the first timed epoch: the
draws, the program's graph, stores and trainer, the kernels' builds, the
warm-up epoch with the step's capture and the warm-up validation with the
forward's."""


def read(rec):
    return rec["window"]["setup_s"]
