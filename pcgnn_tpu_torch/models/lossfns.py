"""Loss primitives shared by the model heads."""

from __future__ import annotations

import torch


def int_label_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[B] cross-entropy of integer ``labels`` under ``logits`` [B, C]:
    logsumexp(logits) - logits[label]."""
    picked = logits.gather(1, labels.to(torch.int64)[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - picked
