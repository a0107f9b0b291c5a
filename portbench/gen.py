"""The cell's graph, drawn from its seed on the host.

A frozen copy of the draws of ``pcgnn_tpu_torch/data/synthetic.py``: the
same ``np.random.default_rng`` calls in the same order, with the
statistics (nodes, features, fraud rate, edges per relation, hubs) taken
from the configuration and traffic files instead of a preset table.
Features are class-conditional Gaussians; an edge joins two nodes of the
same class with probability ``homophily``, else two uniform nodes.  The
arrays go to the program (which builds its own CSR) and to the reference
alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RawGraph:
    features: np.ndarray        # [N, F] float32
    labels: np.ndarray          # [N] int64
    srcs: tuple                 # per relation: [E_r] int64 edge sources
    dsts: tuple                 # per relation: [E_r] int64 edge targets

    @property
    def num_nodes(self) -> int:
        return int(self.labels.shape[0])


def draw_graph(seed: int, *, num_nodes: int, feat_dim: int,
               fraud_rate: float, edges_per_relation, homophily: float = 0.5,
               feature_separation: float = 1.0,
               hubs: dict | None = None) -> RawGraph:
    """The graph of ``seed``.  ``hubs`` maps a relation index (an int or
    its decimal string) to ``[num_hubs, max_hub_degree]``: hub i of that
    relation gets ``max(max_hub_degree // (1 + i), 2)`` extra out-edges to
    uniform targets, taken out of the relation's edge count."""
    hubs = {int(r): tuple(v) for r, v in (hubs or {}).items()}
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
    hub_ids = (rng.choice(n, size=max(h[0] for h in hubs.values()),
                          replace=False)
               if hubs else np.empty(0, np.int64))

    srcs, dsts = [], []
    for r, e_count in enumerate(edges_per_relation):
        hub_src = hub_dst = np.empty(0, np.int64)
        if r in hubs:
            n_hubs, max_deg = hubs[r]
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
        srcs.append(np.concatenate([src, hub_src]))
        dsts.append(np.concatenate([dst, hub_dst]))
    return RawGraph(features=feats, labels=labels, srcs=tuple(srcs),
                    dsts=tuple(dsts))
