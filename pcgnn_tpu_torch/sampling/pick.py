"""The *pick* step: label-balanced, degree-weighted node sampling.

  P(v) ∝ deg_homo(v) / LF(v),   LF(v) = |train| if y_v = 0, |train_pos| if 1

and 2·|train_pos| nodes are drawn with replacement per epoch, by inverse-CDF
sampling in float32.  The random stream is a ``torch.Generator``'s, so parity
with the JAX package is statistical.
"""

from __future__ import annotations

import torch


def pick_probs(deg_train: torch.Tensor, y_train: torch.Tensor) -> torch.Tensor:
    """Unnormalized sampling weights of the training nodes ([T] homo
    degrees, [T] labels in {0, 1})."""
    y = y_train.to(torch.float32)
    n = float(y_train.shape[0])
    lf = (y.sum() - n) * y + n          # y=0 -> |train|, y=1 -> |train_pos|
    return deg_train.to(torch.float32) / lf


def pick_step(generator: torch.Generator, idx_train: torch.Tensor,
              weights: torch.Tensor, size: int) -> torch.Tensor:
    """Draw ``size`` training node ids with replacement, P ∝ weights."""
    cdf = torch.cumsum(weights.to(torch.float32), dim=0)
    u = torch.rand(size, generator=generator, device=cdf.device,
                   dtype=torch.float32) * cdf[-1]
    draws = torch.searchsorted(cdf, u, right=True)
    draws = draws.clamp(max=weights.shape[0] - 1)
    return idx_train[draws]
