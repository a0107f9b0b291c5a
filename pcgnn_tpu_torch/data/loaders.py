"""Dataset loading.

Counterpart of ``pcgnn_tpu/data/loaders.py``, with the same branches in the
same order:
  * ``synthetic:*`` — generated in-process;
  * a path ending in ``.npz`` — the native format (``save_native`` /
    ``load_native``; a file written by either package loads in the other);
  * ``yelp`` / ``amazon`` / ``amazon_new`` — PyG ``*.pt`` feature/label
    files plus pickled ``defaultdict(set)`` adjacency lists (homo + three
    relations);
  * ``tfinance`` / ``elliptic`` / ``weibo`` — one homo relation, which is
    also relation 0 (the same ``RelGraph`` object);
  * ``kdk`` — five CSC ``.npz`` relation networks + homo, CSC features.

The graph is built on the host and its tensors placed on ``device``.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np
import torch

from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.graph.csr import (MultiRelGraph, build_multirel,
                                       csr_from_adj_dict, csr_from_edges,
                                       csr_from_scipy, rel_threshold)

# dataset name -> (subdir, file prefix, relation suffixes, feature file)
_PICKLED = {
    "yelp": ("pyg/YelpChi/processed", "yelp", ("rur", "rtr", "rsr"),
             "YelpChi_data.pt"),
    "amazon": ("pyg/AmazonFraud/processed", "amazon", ("upu", "usu", "uvu"),
               "AmazonFraud_data.pt"),
    "amazon_new": ("pyg/AmazonFraud/processed", "amazon_new",
                   ("upu", "usu", "uvu"), "AmazonFraud_new_data.pt"),
    "tfinance": ("pyg/TFinance/processed", "tfinance", ("homo",),
                 "tfinance_data.pt"),
    "elliptic": ("pyg/Elliptic/processed", "elliptic", ("homo",),
                 "elliptic_data.pt"),
    "weibo": ("pyg/Weibo/processed", "weibo", ("homo",), "weibo.pt"),
}

# number of leading unlabeled node ids per dataset
NUM_UNLABELED = {"amazon": 3305, "amazon_new": 2013}

_KDK_NETWORKS = ("_c_acc_c_network", "_c_clcare_c_network",
                 "_c_fp_c_network", "_c_hsdrcare_c_network",
                 "_c_insr_c_network")


def load_data(name: str, prefix: str = "data/", *,
              threshold: float | list = 0.5, graph_id=None, seed: int = 0,
              device="cpu") -> MultiRelGraph:
    """``threshold`` may be one float or a per-relation list (the native
    format takes one float only: ``load_native``)."""
    if name.startswith("synthetic"):
        preset = name.split(":", 1)[1] if ":" in name else "small"
        return synthetic_fraud_graph(preset, seed=seed, threshold=threshold,
                                     device=device)
    if name.endswith(".npz"):
        return load_native(name, threshold=threshold, device=device)
    if name in _PICKLED:
        return _load_pickled(name, prefix, threshold, device)
    if name == "kdk":
        return _load_kdk(prefix, graph_id, threshold, device)
    raise ValueError(f"unknown dataset {name!r}")


def _load_feats_labels(path: str, key_hints: Sequence):
    """Features and labels from a PyG-style ``torch.save`` file: under the
    first key of ``key_hints`` that holds them (None: the object itself),
    as ``["x"]`` / ``["y"]`` or as attributes."""
    # a PyG Data object is no plain tensor tree: weights_only must be off
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, (list, tuple)):
        obj = obj[0]
    for key in key_hints:
        try:
            store = obj[key] if key else obj
        except (KeyError, TypeError, IndexError):
            continue
        try:
            x, y = store["x"], store["y"]
        except (KeyError, TypeError, IndexError):
            try:
                x, y = store.x, store.y
            except AttributeError:
                continue
        return np.asarray(x, dtype=np.float32), np.asarray(y).astype(np.int64)
    raise ValueError(f"could not locate x/y in {path}")


def _load_pickled(name: str, prefix: str, threshold,
                  device) -> MultiRelGraph:
    subdir, fpref, rel_sufs, pt_name = _PICKLED[name]
    base = os.path.join(prefix, subdir)
    feats, labels = _load_feats_labels(
        os.path.join(base, pt_name), ("review", "user", None))
    n = len(labels)

    def load_adj(suffix, thr):
        with open(os.path.join(base, f"{fpref}_{suffix}_adjlists.pickle"),
                  "rb") as f:
            return csr_from_adj_dict(pickle.load(f), n, threshold=thr,
                                     device=device)

    # a single-relation dataset's relation 0 is the homo graph itself: one
    # object, so the stores and ``MultiRelGraph.to`` share it
    homo = load_adj("homo", rel_threshold(threshold, None))
    rels = [homo if s == "homo" else load_adj(s, rel_threshold(threshold, r))
            for r, s in enumerate(rel_sufs)]
    return build_multirel(rels, homo, feats, labels, device=device)


def _load_kdk(prefix: str, graph_id, threshold, device) -> MultiRelGraph:
    """KDK: five CSC ``.npz`` relation networks + homo, features from a CSC
    matrix; each relation gets self-loops and symmetry."""
    import scipy.sparse

    gid = str(graph_id).zfill(3)
    feats = scipy.sparse.load_npz(
        os.path.join(prefix, "attributes", f"{gid}_node_feature(CSC).npz")
    ).astype(np.float32).toarray()
    labels = np.load(os.path.join(prefix, "labels",
                                  f"{gid}_label.npy")).flatten()
    rels = []
    for r, t in enumerate(_KDK_NETWORKS):
        mat = scipy.sparse.load_npz(
            os.path.join(prefix, "G0_Hetero", f"{gid}{t}(CSC).npz"))
        rels.append(csr_from_scipy(mat, threshold=rel_threshold(threshold, r),
                                   device=device))
    homo = csr_from_scipy(
        scipy.sparse.load_npz(os.path.join(
            prefix, "G0_Homo", f"{gid}_G0_Homo_network(CSC).npz")),
        threshold=rel_threshold(threshold, None), device=device)
    return build_multirel(rels, homo, feats, labels.astype(np.int64),
                          device=device)


# ---------------------------- native format ---------------------------- #

def save_native(path: str, graph: MultiRelGraph) -> None:
    """Write a MultiRelGraph to one ``.npz``: ``features``, ``labels``,
    ``num_relations`` and each relation's edge list (``rel{i}_row/col``,
    ``homo_row/col``)."""
    arrays = {
        "features": graph.features.cpu().numpy(),
        "labels": graph.labels.cpu().numpy(),
        "num_relations": np.asarray(graph.num_relations),
    }
    for i, rel in enumerate([*graph.relations, graph.homo]):
        tag = f"rel{i}" if i < graph.num_relations else "homo"
        if rel.is_stub:
            raise ValueError(
                f"save_native: relation {tag!r} is a degree-only stub "
                "(graph.csr.degree_stub); serializing it would write 0 "
                "edges and silently change pick weights on reload.")
        e = rel.num_edges
        indptr = rel.indptr.cpu().numpy()
        arrays[f"{tag}_row"] = np.repeat(
            np.arange(rel.num_nodes), np.diff(indptr)).astype(np.int32)[:e]
        arrays[f"{tag}_col"] = rel.col.cpu().numpy()[:e]
    np.savez_compressed(path, **arrays)


def load_native(path: str, *, threshold: float = 0.5,
                device="cpu") -> MultiRelGraph:
    """Read a ``save_native`` file.  ``threshold`` is one number for every
    relation, as in the JAX package, whose ``load_native`` fails inside
    numpy on a per-relation list; a list is refused here with a message
    that says so, rather than given a meaning the reference lacks."""
    if isinstance(threshold, (list, tuple)):
        raise ValueError(
            f"load_native takes one threshold for every relation, got the "
            f"per-relation list {list(threshold)!r}; the native .npz format "
            f"does not support per-relation thresholds (set 'threshold', "
            f"not 'thresholds')")
    z = np.load(path)
    feats, labels = z["features"], z["labels"]
    n = len(labels)
    nrel = int(z["num_relations"])

    def mk(tag):
        return csr_from_edges(z[f"{tag}_row"], z[f"{tag}_col"], n,
                              threshold=threshold, add_self_loops=False,
                              symmetrize=False, device=device)

    rels = [mk(f"rel{i}") for i in range(nrel)]
    return build_multirel(rels, mk("homo"), feats, labels, device=device)
