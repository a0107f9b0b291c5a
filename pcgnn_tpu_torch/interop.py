"""Carry PC-GNN weights between the JAX package and the port.

The JAX parameter tree (numpy leaves, as ``train/checkpoint.py`` pickles it):

    {"label_clf": {"w": [F, C], "b": [C]},
     "intra": [{"w": [2F, E]}, ...],       # one per relation
     "inter": {"w": [F + R*E, E]},
     "head": {"w": [E, C]}}

maps one to one onto the port's ``PCGNN`` parameters ``label_clf.w``,
``label_clf.b``, ``intra.<r>.w``, ``inter.w`` and ``head.w``.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict:
    """JAX parameter tree -> state dict for ``PCGNN.load_state_dict``."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    state = {"label_clf.w": t(tree["label_clf"]["w"]),
             "label_clf.b": t(tree["label_clf"]["b"]),
             "inter.w": t(tree["inter"]["w"]),
             "head.w": t(tree["head"]["w"])}
    for r, layer in enumerate(tree["intra"]):
        state[f"intra.{r}.w"] = t(layer["w"])
    return state


def params_to_jax(model) -> dict:
    """The port's ``PCGNN`` -> JAX parameter tree with numpy leaves."""
    a = lambda p: p.detach().cpu().numpy().copy()
    return {"label_clf": {"w": a(model.label_clf.w), "b": a(model.label_clf.b)},
            "intra": [{"w": a(layer.w)} for layer in model.intra],
            "inter": {"w": a(model.inter.w)},
            "head": {"w": a(model.head.w)}}
