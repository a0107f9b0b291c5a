"""Measurement scripts: the counterparts of the repository's
``benchmarks/``, each named after its JAX script and run as
``python -m pcgnn_tpu_torch.benchmarks.<name>``.

Each takes the JAX script's flags and defaults, runs on ``cuda`` unless
``--device cpu`` is passed (the timing, ``utils.roofline``, refuses the
CPU), and prints the JAX script's lines plus the card's name and power
limit.  ``measure_reference`` times the reference algorithm on the host
CPU by definition.
"""

from __future__ import annotations

import subprocess

import torch


def card_line(device) -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; None for a CPU
    device.  Raises when a CUDA device has no ``nvidia-smi`` beside it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[dev.index or 0].strip()
