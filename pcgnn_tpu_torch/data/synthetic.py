"""Synthetic multi-relation fraud graphs.

Counterpart of ``pcgnn_tpu/data/synthetic.py``: the same presets and the
same ``np.random.default_rng`` calls in the same order, so a given seed gives
the same graph.  Features are class-conditional Gaussians; edges are
homophilous with probability ``homophily``, else uniform.
"""

from __future__ import annotations

import time

import numpy as np

from pcgnn_tpu_torch.graph.csr import (MultiRelGraph, build_multirel,
                                       csr_arrays, csr_from_edges,
                                       degree_stub, finalize_csr,
                                       rel_threshold)

# shape statistics of the reference datasets
PRESETS = {
    # name: (num_nodes, feat_dim, fraud_rate, edges_per_relation, num_relations)
    "yelp-like": (45954, 32, 0.145, (98630, 576724, 3402743), 3),
    "amazon-like": (11944, 25, 0.069, (351216, 7132958, 2073474), 3),
    "amazon_new-like": (9840, 25, 0.4, (301834, 600000, 400000), 3),
    "tiny": (512, 16, 0.15, (2048, 3072, 1024), 3),
    "small": (4096, 32, 0.1, (16384, 32768, 8192), 3),
    # heavy-tailed degree variants (hub rows far above the mean degree)
    "skew-tiny": (2048, 16, 0.15, (8192, 6144, 4096), 3),
    "yelp-skew": (45954, 32, 0.145, (98630, 576724, 3402743), 3),
    # directed stress presets: edge counts stay exact (no symmetrization),
    # and the homo graph is a degree-only stub (``graph.csr.degree_stub``)
    "stress-10m": (10_000_000, 64, 0.05, (120_000_000, 60_000_000, 20_000_000), 3),
    "stress-1m": (1_000_000, 64, 0.05, (12_000_000, 6_000_000, 2_000_000), 3),
}

# per-relation hub injection: relation index -> (num_hubs, max_hub_degree)
SKEW = {
    "skew-tiny": {0: (6, 512)},
    "yelp-skew": {2: (40, 20000)},
}

_DIRECTED_PRESETS = {"stress-10m", "stress-1m"}


def stub_degrees(srcs, dsts, n: int) -> np.ndarray:
    """[n] degrees of the directed union of the edge lists with a self-loop
    on every node, duplicates counted once: the degrees of the homo graph
    that ``csr_from_edges(symmetrize=False)`` would build, through the same
    CSR builder (the native core when it loads), without the graph."""
    indptr, _ = csr_arrays(np.concatenate(srcs), np.concatenate(dsts), n,
                           symmetrize=False, add_self_loops=True)
    return np.diff(indptr)


def synthetic_fraud_graph(preset: str | None = "tiny", *,
                          num_nodes: int | None = None,
                          feat_dim: int | None = None,
                          fraud_rate: float | None = None,
                          edges_per_relation: tuple | None = None,
                          homophily: float = 0.5,
                          feature_separation: float = 1.0, seed: int = 0,
                          threshold: float | list = 0.5,
                          device="cpu",
                          timings: dict | None = None) -> MultiRelGraph:
    """The preset's graph (or one of the given shape) from ``seed``.
    ``timings``, if given, receives the host seconds of each build step:
    ``draws`` (every random draw and index pass), ``relation r csr`` (the
    deduplicated CSR, native core or numpy), ``relation r finalize``
    (``finalize_csr``), ``homo`` and ``assemble``."""
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        if timings is not None:
            now = time.perf_counter()
            timings[name] = timings.get(name, 0.0) + now - last[0]
            last[0] = now

    if preset is not None:
        n, f, rate, epr, _ = PRESETS[preset]
        num_nodes = num_nodes or n
        feat_dim = feat_dim or f
        fraud_rate = fraud_rate if fraud_rate is not None else rate
        edges_per_relation = edges_per_relation or epr
    rng = np.random.default_rng(seed)
    n = num_nodes

    labels = (rng.random(n) < fraud_rate).astype(np.int64)
    direction = rng.normal(size=(feat_dim,))
    direction /= np.linalg.norm(direction)
    feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
    feats += (feature_separation * labels[:, None] * direction[None, :]).astype(
        np.float32)

    pos = np.flatnonzero(labels == 1)
    neg = np.flatnonzero(labels == 0)
    symmetrize = preset not in _DIRECTED_PRESETS

    skew = SKEW.get(preset, {})
    hub_ids = (rng.choice(n, size=max(s[0] for s in skew.values()),
                          replace=False)
               if skew else np.empty(0, np.int64))

    rels = []
    all_src, all_dst = [], []
    for r, e_count in enumerate(edges_per_relation):
        hub_src = hub_dst = np.empty(0, np.int64)
        if r in skew:
            n_hubs, max_deg = skew[r]
            degs = np.maximum(max_deg // (1 + np.arange(n_hubs)), 2)
            hub_src = np.repeat(hub_ids[:n_hubs], degs)
            hub_dst = rng.integers(0, n, size=len(hub_src))
            e_count = max(e_count - len(hub_src), 0)
        src = rng.integers(0, n, size=e_count)
        homo_edge = rng.random(e_count) < homophily
        dst_uniform = rng.integers(0, n, size=e_count)
        dst_same = np.where(
            labels[src] == 1,
            pos[rng.integers(0, len(pos), size=e_count)] if len(pos) else dst_uniform,
            neg[rng.integers(0, len(neg), size=e_count)] if len(neg) else dst_uniform,
        )
        dst = np.where(homo_edge, dst_same, dst_uniform)
        src = np.concatenate([src, hub_src])
        dst = np.concatenate([dst, hub_dst])
        lap("draws")
        indptr, col = csr_arrays(src, dst, n, symmetrize=symmetrize)
        lap(f"relation {r} csr")
        rels.append(finalize_csr(indptr, col, n,
                                 threshold=rel_threshold(threshold, r),
                                 device=device))
        lap(f"relation {r} finalize")
        all_src.append(src)
        all_dst.append(dst)

    homo_thr = rel_threshold(threshold, None)
    if preset in _DIRECTED_PRESETS:
        # the homo graph feeds only the pick weights: its degrees, with the
        # set semantics csr_from_edges would apply (the (src, dst) pairs of
        # all relations deduplicated, the self-loop folded into the set)
        homo = degree_stub(stub_degrees(all_src, all_dst, n),
                           threshold=homo_thr, device=device)
    else:
        homo = csr_from_edges(np.concatenate(all_src),
                              np.concatenate(all_dst), n, threshold=homo_thr,
                              symmetrize=symmetrize, device=device)
    lap("homo")
    g = build_multirel(rels, homo, feats, labels, device=device)
    lap("assemble")
    return g

