"""The *pick* step: label-balanced, degree-weighted node sampling.

  P(v) ∝ deg_homo(v) / LF(v),   LF(v) = |train| if y_v = 0, |train_pos| if 1

and 2·|train_pos| nodes are drawn with replacement per epoch, by inverse-CDF
sampling in float64 (``pick_cdf``).  The random stream is a
``torch.Generator``'s, so parity with the JAX package is statistical.
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


def pick_cdf(weights: torch.Tensor) -> torch.Tensor:
    """The weights' float64 CDF, summed on the host in index order and
    returned on the weights' device.  A card's parallel scan sums in an
    order that changes from call to call (20 float32 cumsums of
    stress-1m's 400,000 weights gave 20 distinct CDFs), which moved draws
    that fell near a boundary, so a seeded epoch plan did not repeat."""
    cdf = torch.cumsum(weights.detach().to("cpu", torch.float64), dim=0)
    return cdf.to(weights.device)


def pick_step(generator: torch.Generator, idx_train: torch.Tensor,
              cdf: torch.Tensor, size: int) -> torch.Tensor:
    """Draw ``size`` training node ids with replacement, P ∝ weights, from
    the weights' float64 CDF (``pick_cdf``)."""
    u = torch.rand(size, generator=generator, device=cdf.device,
                   dtype=torch.float64) * cdf[-1]
    draws = torch.searchsorted(cdf, u, right=True)
    draws = draws.clamp(max=cdf.shape[0] - 1)
    return idx_train[draws]
