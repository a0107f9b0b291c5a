"""GraphSAGE baseline over the homogeneous relation, as an ``nn.Module``.

Counterpart of ``pcgnn_tpu/models/graphsage.py`` as the reference trainer
configures it (``gcn_style=True``): the mean over each row's neighbors and
itself (the self column joins only where the row's CSR lacks the
self-loop), no self-concat, then ``embeds = ReLU(mean W_enc)`` and a linear
head.  ``to_prob`` is a softmax over the classes.

``num_sample`` keeps a uniform random subset of ``num_sample`` neighbors on
rows with more: random per-slot priorities from a ``torch.Generator``, then
the smallest ranks by a stable double argsort.  A run draws from a fresh
generator each step; without one, a generator seeded 0 makes evaluation
deterministic.  The draw needs the full neighbor list, so a window-capped
relation is refused.

Rows come from the homo graph's edge-window store when it has one, else
from the [N+1, F] table by neighbor id; hub rows go through
``ops.hub.hub_mean_sum``.  Parameters: ``enc.w`` [F, E] ([2F, E] without
``gcn_style``) and ``head.w`` [E, C].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pcgnn_tpu_torch.models.gcn import padded_features, weighted_ce
from pcgnn_tpu_torch.models.initializers import xavier_uniform
from pcgnn_tpu_torch.models.pcgnn import Dense
from pcgnn_tpu_torch.ops.aggregate import (batch_feature_window,
                                           batch_neighbor_window,
                                           union_self_window,
                                           window_sum_from_gathered)
from pcgnn_tpu_torch.ops.hub import hub_mean_sum


def subsample_valid(valid: torch.Tensor, num_sample: int,
                    generator: torch.Generator) -> torch.Tensor:
    """``valid`` [B, D] with each row cut to ``num_sample`` of its valid
    slots, drawn uniformly: random priorities (+inf at invalid slots),
    ranked by a stable double argsort, the smallest ``num_sample`` kept."""
    pri = torch.rand(valid.shape, generator=generator, device=valid.device)
    pri = torch.where(valid, pri, torch.inf)
    order = torch.argsort(pri, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return valid & (rank < num_sample)


class GraphSage(nn.Module):
    def __init__(self, feat_dim: int, emb_dim: int, num_classes: int = 2,
                 gcn_style: bool = True, num_sample: Optional[int] = None,
                 generator: torch.Generator | None = None, **_):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = False
        self.feat_dim = feat_dim
        self.emb_dim = emb_dim
        self.num_classes = num_classes
        self.gcn_style = gcn_style
        self.num_sample = num_sample
        g = generator if generator is not None else torch.Generator()
        in_dim = feat_dim if gcn_style else 2 * feat_dim
        self.enc = Dense(xavier_uniform((in_dim, emb_dim), g))
        self.head = Dense(xavier_uniform((emb_dim, num_classes), g))

    def forward(self, graph, batch: torch.Tensor, batch_labels=None, *,
                train: bool = True,
                generator: Optional[torch.Generator] = None,
                hub_plans: Optional[tuple] = None, **_):
        """Returns (logits [B, C], None).  ``generator`` draws the
        ``num_sample`` subsets; ``hub_plans`` = (the homo graph's hub
        plan,), or None to plan the hub chunks from this batch."""
        rel = graph.homo
        if self.num_sample is not None and rel.has_hubs:
            raise ValueError(
                "GraphSage num_sample draws uniformly from the full neighbor "
                "list, which a window-capped relation does not expose; "
                "rebuild the graph with window_cap disabled or drop "
                "num_sample")
        x = graph.features
        use_ewin = rel.ewin is not None
        if use_ewin:
            # the store's window; ids from the dense table, for the
            # conditional self union
            d = max(rel.window_width, 1)
            valid = (torch.arange(d, device=batch.device)[None, :]
                     < rel.deg[batch].clamp(max=d)[:, None])
            nbr = rel.nbr2d[batch]
            xw = batch_feature_window(rel, batch, x.shape[1])
        else:
            nbr, valid = batch_neighbor_window(rel, batch, allow_capped=True)
        if self.num_sample is not None:
            if generator is None:
                generator = torch.Generator(device=batch.device)
                generator.manual_seed(0)
            valid = subsample_valid(valid, self.num_sample, generator)
        x_padded = padded_features(graph)
        if self.gcn_style:
            nbr, valid = union_self_window(nbr, valid, batch)
            if use_ewin:
                xw = torch.cat([xw, x[batch][:, None, :]], dim=1)
        if not use_ewin:
            xw = x_padded[nbr]
        if rel.has_hubs:
            is_hub = rel.deg[batch] > rel.window_width
            valid = valid & ~is_hub[:, None]
        num, cnt = window_sum_from_gathered(xw, valid)
        if rel.has_hubs:
            h_num, h_cnt = hub_mean_sum(
                rel, batch, is_hub, x_padded, include_self=self.gcn_style,
                plan=hub_plans[0] if hub_plans else None)
            num = torch.where(is_hub[:, None], h_num, num)
            cnt = torch.where(is_hub, h_cnt, cnt)
        neigh = num / cnt.clamp(min=1.0)[:, None]
        combined = neigh if self.gcn_style else torch.cat([x[batch], neigh],
                                                          dim=1)
        embeds = torch.relu(combined @ self.enc.w)
        return embeds @ self.head.w, None

    @staticmethod
    def hub_relations(graph) -> tuple:
        """The relations whose hub lanes ``hub_plans`` plans: the homo
        graph."""
        return (graph.homo,)

    def to_prob(self, graph, batch, *, train: bool = False, **kw):
        logits, _ = self(graph, batch, train=train, **kw)
        return torch.softmax(logits, dim=-1), None

    def loss(self, graph, batch: torch.Tensor, batch_labels: torch.Tensor,
             batch_weight: Optional[torch.Tensor] = None, *,
             generator: Optional[torch.Generator] = None,
             hub_plans: Optional[tuple] = None, **_):
        logits, _ = self(graph, batch, batch_labels, train=True,
                         generator=generator, hub_plans=hub_plans)
        return weighted_ce(logits, batch_labels, batch_weight)
