"""Carry model weights between the JAX package and the port.

The JAX parameter trees (numpy leaves, as ``train/checkpoint.py`` pickles
them).  PC-GNN:

    {"label_clf": {"w": [F, C], "b": [C]},
     "intra": [{"w": [2F, E]}, ...],       # one per relation
     "inter": {"w": [F + R*E, E]},
     "head": {"w": [E, C]},
     "embed": [N, F]}                       # learn_features only

maps one to one onto the port's ``PCGNN`` parameters ``label_clf.w``,
``label_clf.b``, ``intra.<r>.w``, ``inter.w``, ``head.w`` and ``embed``.
GCN and GraphSAGE:

    {"enc": {"w": [F (or 2F), E]}, "head": {"w": [E, C]}}

maps onto ``enc.w`` and ``head.w``.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict:
    """JAX parameter tree -> state dict for the port's model."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    if "enc" in tree:
        return {"enc.w": t(tree["enc"]["w"]), "head.w": t(tree["head"]["w"])}
    state = {"label_clf.w": t(tree["label_clf"]["w"]),
             "label_clf.b": t(tree["label_clf"]["b"]),
             "inter.w": t(tree["inter"]["w"]),
             "head.w": t(tree["head"]["w"])}
    for r, layer in enumerate(tree["intra"]):
        state[f"intra.{r}.w"] = t(layer["w"])
    if "embed" in tree:
        state["embed"] = t(tree["embed"])
    return state


def params_to_jax(model) -> dict:
    """The port's model -> JAX parameter tree with numpy leaves."""
    a = lambda p: p.detach().cpu().numpy().copy()
    if hasattr(model, "enc"):
        return {"enc": {"w": a(model.enc.w)}, "head": {"w": a(model.head.w)}}
    tree = {"label_clf": {"w": a(model.label_clf.w),
                          "b": a(model.label_clf.b)},
            "intra": [{"w": a(layer.w)} for layer in model.intra],
            "inter": {"w": a(model.inter.w)},
            "head": {"w": a(model.head.w)}}
    if model.learn_features:
        tree["embed"] = a(model.embed)
    return tree
