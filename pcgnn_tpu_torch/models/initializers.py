"""Parameter initializers with the reference's torch init statistics:
Xavier-uniform for the aggregation weights and the ``nn.Linear`` default,
U[-1/sqrt(fan_in), 1/sqrt(fan_in)] for weight and bias, for ``label_clf``.
Weights are laid out [in, out], as in the JAX package."""

from __future__ import annotations

import math

import torch


def xavier_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def torch_linear(in_dim: int, out_dim: int, generator: torch.Generator):
    """(weight [in, out], bias [out]) with nn.Linear default statistics."""
    bound = 1.0 / math.sqrt(in_dim)
    w = torch.empty(in_dim, out_dim).uniform_(-bound, bound,
                                              generator=generator)
    b = torch.empty(out_dim).uniform_(-bound, bound, generator=generator)
    return w, b
