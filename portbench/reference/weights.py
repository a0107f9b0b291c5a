"""The model's initial weights, drawn on the device from the seed.

One uniform draw for every leaf, with a ``torch.Generator`` on the run's
device, scaled per leaf to the initializer's bounds (``draw``).  PC-GNN:
Xavier-uniform for the relation, inter-relation and head weights,
``nn.Linear``'s default U(-1/sqrt(F), 1/sqrt(F)) for the label
classifier.  The program and the reference both start from them."""

from __future__ import annotations

import math

import torch


def xavier(fan_in: int, fan_out: int) -> tuple:
    """(shape, bound) of a Xavier-uniform [fan_in, fan_out] weight."""
    return (fan_in, fan_out), math.sqrt(6.0 / (fan_in + fan_out))


def shapes(feat_dim: int, emb: int, num_relations: int,
           num_classes: int = 2) -> dict:
    """Leaf name -> (shape, bound), in the program's parameter names."""
    f, e, r = feat_dim, emb, num_relations
    out = {"label_clf.w": ((f, num_classes), 1.0 / math.sqrt(f)),
           "label_clf.b": ((num_classes,), 1.0 / math.sqrt(f))}
    for k in range(r):
        out[f"intra.{k}.w"] = xavier(2 * f, e)
    out["inter.w"] = xavier(f + r * e, e)
    out["head.w"] = xavier(e, num_classes)
    return out


def draw(seed: int, spec: dict, device) -> dict:
    """Leaf name -> float32 tensor on ``device``, for ``spec``: leaf name
    -> (shape, bound), in the order of the one draw."""
    sizes = [math.prod(s) for s, _ in spec.values()]
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    out, at = {}, 0
    for (name, (shape, bound)), size in zip(spec.items(), sizes):
        out[name] = (flat[at: at + size] * bound).reshape(shape)
        at += size
    return out


def initial(seed: int, feat_dim: int, emb: int, num_relations: int,
            device) -> dict:
    """PC-GNN's leaves: name -> float32 tensor on ``device``."""
    return draw(seed, shapes(feat_dim, emb, num_relations), device)
