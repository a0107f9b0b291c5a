"""Checkpoints: a pickle of a numpy tree (dicts, lists, arrays), written
atomically.  The format is the JAX package's (``pcgnn_tpu/train/checkpoint.py``),
so a parameter checkpoint written by either package loads in the other
(``interop`` converts between the tree and a ``PCGNN``)."""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree) if isinstance(tree, np.ndarray) else tree


def save_checkpoint(path: str, tree) -> None:
    host_tree = _to_numpy(tree)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(host_tree, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str):
    """Unpickle a checkpoint; only load files this program wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)
