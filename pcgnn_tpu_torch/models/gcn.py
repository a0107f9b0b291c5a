"""GCN baseline over the homogeneous relation, as an ``nn.Module``.

Counterpart of ``pcgnn_tpu/models/gcn.py``: each batch row aggregates all
its neighbors and itself (the self column joins only where the row's CSR
lacks the self-loop), normalized by 1/sqrt(max(count, 1)), the reference's
row-only normalization; then ``embeds = ReLU(agg W_enc)`` and a linear head.
``to_prob`` is a sigmoid.

Rows come from the homo graph's edge-window store when it has one (one
kernel fetch for the batch, ``self_union_feature_window``), else from the
[N+1, F] table by neighbor id; rows above the window cap go through the hub
lane (``ops.hub.hub_mean_sum``).  Parameters keep the JAX layout and names:
``enc.w`` [F, E] and ``head.w`` [E, C].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pcgnn_tpu_torch.models.initializers import xavier_uniform
from pcgnn_tpu_torch.models.lossfns import int_label_ce
from pcgnn_tpu_torch.models.pcgnn import Dense
from pcgnn_tpu_torch.ops.aggregate import (batch_neighbor_window,
                                           self_union_feature_window,
                                           union_self_window,
                                           window_sum_from_gathered)
from pcgnn_tpu_torch.ops.hub import hub_mean_sum


def padded_features(graph) -> torch.Tensor:
    """The [N+1, F] table with a zero sentinel row N: the graph's own when
    it was built (``graph.csr.materialize_edge_windows``), else made here."""
    if graph.features_pad is not None:
        return graph.features_pad
    x = graph.features
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                batch_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Cross-entropy as a weighted mean over the batch (padded slots weigh
    0; denominator max(sum w, 1))."""
    ce = int_label_ce(logits, labels)
    if batch_weight is None:
        batch_weight = torch.ones_like(ce)
    return (ce * batch_weight).sum() / batch_weight.sum().clamp(min=1.0)


class GCN(nn.Module):
    def __init__(self, feat_dim: int, emb_dim: int, num_classes: int = 2,
                 generator: torch.Generator | None = None, **_):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = False
        self.feat_dim = feat_dim
        self.emb_dim = emb_dim
        self.num_classes = num_classes
        g = generator if generator is not None else torch.Generator()
        self.enc = Dense(xavier_uniform((feat_dim, emb_dim), g))
        self.head = Dense(xavier_uniform((emb_dim, num_classes), g))

    @staticmethod
    def hub_relations(graph) -> tuple:
        """The relations whose hub lanes ``hub_plans`` plans: the homo
        graph."""
        return (graph.homo,)

    def aggregate(self, graph, batch: torch.Tensor,
                  hub_plans: Optional[tuple] = None) -> torch.Tensor:
        """[B, F] neighbor-and-self sums over sqrt(max(count, 1)).
        ``hub_plans`` = (the homo graph's hub plan,), or None to plan the
        hub chunks from this batch."""
        rel = graph.homo
        x_padded = padded_features(graph)
        if rel.ewin is not None:
            xw, keep = self_union_feature_window(rel, batch, graph.features)
        else:
            nbr, valid = batch_neighbor_window(rel, batch, allow_capped=True)
            nbr, keep = union_self_window(nbr, valid, batch)
            xw = x_padded[nbr]
        if rel.has_hubs:
            # rows above the window cap sum their whole tail in the hub
            # lane, self column included
            is_hub = rel.deg[batch] > rel.window_width
            keep = keep & ~is_hub[:, None]
        num, cnt = window_sum_from_gathered(xw, keep)
        if rel.has_hubs:
            h_num, h_cnt = hub_mean_sum(
                rel, batch, is_hub, x_padded, include_self=True,
                plan=hub_plans[0] if hub_plans else None)
            num = torch.where(is_hub[:, None], h_num, num)
            cnt = torch.where(is_hub, h_cnt, cnt)
        return num / cnt.clamp(min=1.0).sqrt()[:, None]

    def forward(self, graph, batch: torch.Tensor, batch_labels=None, *,
                train: bool = True, hub_plans: Optional[tuple] = None, **_):
        """Returns (logits [B, C], None)."""
        embeds = torch.relu(self.aggregate(graph, batch, hub_plans)
                            @ self.enc.w)
        return embeds @ self.head.w, None

    def to_prob(self, graph, batch, *, train: bool = False, **kw):
        logits, _ = self(graph, batch, train=train, **kw)
        return torch.sigmoid(logits), None

    def loss(self, graph, batch: torch.Tensor, batch_labels: torch.Tensor,
             batch_weight: Optional[torch.Tensor] = None,
             hub_plans: Optional[tuple] = None, **_):
        logits, _ = self(graph, batch, batch_labels, train=True,
                         hub_plans=hub_plans)
        return weighted_ce(logits, batch_labels, batch_weight)
