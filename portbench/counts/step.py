"""The training step's least work, by the configuration's reference: the
module of the reference's name under ``counts/`` (``pcgnn``, ``gcn``),
whose ``count(t)`` gives (bytes by term, operations) of a traced slice's
record ``t``.  A new reference brings its count as a new file."""

import importlib


def count(t: dict) -> tuple:
    """(bytes by term, operations) of the record ``t``, by the count of
    its ``reference``."""
    return importlib.import_module(
        f"portbench.counts.{t['reference']}").count(t)


def least_seconds(bytes_: float, flops_: float, peaks) -> float:
    bw, peak_flops = peaks
    return max(bytes_ / bw, flops_ / peak_flops)
