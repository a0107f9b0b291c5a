"""PC-GNN: one Pick-Choose-Aggregate layer, as an ``nn.Module``.

Counterpart of ``pcgnn_tpu/models/pcgnn.py`` for hub-free graphs whose
relations all carry edge-window stores (``graph.csr.attach_edge_windows``),
in both window lanes: the fused record store (one fetch per batch row for
all relations) and the per-relation stores (one fetch per relation).

  scores      = X W_clf + b                  (label-aware scores, [N, 2])
  d(u,v)      = |scores[u,0] - scores[v,0]|  (choose distance)
  keep        : per row, the keff nearest neighbors, plus int(ksample*rho)
                nearest train positives for fraud-labeled centers (train)
  h_r         = ReLU([x_v ; mean_{u kept} x_u] W_r)           (intra)
  combined    = ReLU([x_v ; h_1 ; ... ; h_R] W_inter)         (inter)
  gnn_logits  = combined W_head
  loss        = CE(gnn_logits, y) + alpha * CE(scores[batch], y)

Parameters keep the JAX layout and names: weights are [in, out];
``label_clf.w/b``, ``intra.<r>.w``, ``inter.w``, ``head.w``
(``interop`` converts to and from the JAX pytree).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pcgnn_tpu_torch.models.initializers import torch_linear, xavier_uniform
from pcgnn_tpu_torch.models.lossfns import int_label_ce
from pcgnn_tpu_torch.ops.aggregate import (
    _INF,
    batch_raw_window,
    batch_record_window,
    dedup_minor_keep,
    keep_nearest,
    minor_sum_compact_multi,
    oversample_candidates_values,
    oversample_keep,
    unpack_window,
    window_sum_from_gathered,
)


class Dense(nn.Module):
    """A weight ``w`` [in, out] and an optional bias ``b`` [out]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)


def selection_score(rows: torch.Tensor, w0: torch.Tensor,
                    b0: torch.Tensor) -> torch.Tensor:
    """Choose score of feature rows, [..., F] -> [...].

    Accumulated in float64 and rounded once to float32: the float32 result
    then does not depend on the summation order of the device or the
    operand shape, so a self-loop's distance is exactly 0 and the card and
    the CPU select the same neighbors.  (The JAX reference computes it in
    float32 at precision "highest"; the two agree to about an ulp.)
    """
    return (rows.double() @ w0.double() + b0.double()).float()


class PCGNN(nn.Module):
    def __init__(self, feat_dim: int, emb_dim: int, num_relations: int,
                 alpha: float, rho: float, num_classes: int = 2,
                 learn_features: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if learn_features:
            raise NotImplementedError(
                "learn_features is not ported yet (ROADMAP module 10: "
                "learned-feature lane and the mask kernel)")
        # float32 matmuls stay float32 on the card: TF32 keeps about three
        # decimal digits, which would perturb the choose ranking and break
        # parity with the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.feat_dim = feat_dim
        self.emb_dim = emb_dim
        self.num_relations = num_relations
        self.alpha = float(alpha)
        self.rho = float(rho)
        self.num_classes = num_classes
        g = generator if generator is not None else torch.Generator()
        self.label_clf = Dense(*torch_linear(feat_dim, num_classes, g))
        self.intra = nn.ModuleList(
            Dense(xavier_uniform((2 * feat_dim, emb_dim), g))
            for _ in range(num_relations))
        self.inter = Dense(xavier_uniform(
            (feat_dim + num_relations * emb_dim, emb_dim), g))
        self.head = Dense(xavier_uniform((emb_dim, num_classes), g))

    def minor_window(self, num_train_pos: int, relations) -> int:
        """Width of the compact oversample-candidate window: the largest
        ``int(ksample * rho)`` a window-lane row can request, bounded by the
        candidate pool."""
        cap = max((r.ksample_cap or r.ksample_max) for r in relations)
        return max(1, min(int(num_train_pos), int(cap * self.rho)))

    def forward(self, graph, batch: torch.Tensor,
                batch_labels: Optional[torch.Tensor], *, train: bool,
                train_pos: Optional[torch.Tensor] = None,
                train_pos_valid: Optional[torch.Tensor] = None,
                train_pos_feats: Optional[torch.Tensor] = None):
        """Returns (gnn_logits [B, C], center_scores [B, C]).

        ``train_pos_feats`` optionally supplies ``features[train_pos]``,
        which is constant for a run (frozen features, fixed split).
        """
        rels = graph.relations
        if any(rel.has_hubs for rel in rels):
            raise NotImplementedError(
                "relations with hub rows (deg > dcap) need the hub lane, "
                "which is not ported yet (ROADMAP module 7)")
        if not rels or any(rel.ewin is None for rel in rels):
            raise NotImplementedError(
                "PC-GNN in the port needs an edge-window store on every "
                "relation (graph.csr.materialize_edge_windows); the "
                "score-table lane and the CSR lane for graphs without "
                "stores are not ported yet (ROADMAP modules 4 and 8)")
        x = graph.features
        n, f = x.shape
        clf = self.label_clf
        use_fused = graph.fused is not None
        # with a bfloat16 store every selection score ranks the
        # bf16-rounded snapshot (centers and candidates here; the window
        # values are bf16 already); the loss path stays exact float32
        bf16 = any(rel.ewin.dtype == torch.bfloat16 for rel in rels)

        def sel_round(a):
            return a.to(torch.bfloat16).to(torch.float32) if bf16 else a

        # selection is non-differentiable: label_clf learns only through
        # the similarity loss on center_scores
        w0 = clf.w[:, 0].detach()
        b0 = clf.b[0].detach()
        self_feats = x[batch]
        center_scores = self_feats @ clf.w + clf.b
        center_s0 = selection_score(sel_round(self_feats), w0, b0)
        if use_fused:
            rec = batch_record_window(graph, batch)        # [B, W]

        if train:
            m_max = self.minor_window(int(train_pos.shape[0]), rels)
            tp_rows_f = (train_pos_feats if train_pos_feats is not None
                         else x[train_pos])
            tp_s0 = selection_score(sel_round(tp_rows_f), w0, b0)
            cand_ids, cand_valid, _, cand_slots = oversample_candidates_values(
                center_s0, tp_s0, train_pos, train_pos_valid, m_max)

        rel_sums = []       # per relation: (num, cnt, keep_minor)
        for r, rel in enumerate(rels):
            d_w = max(rel.window_width, 1)
            raw = (rec[:, graph.fused_off[r]: graph.fused_off[r + 1]]
                   if use_fused else batch_raw_window(rel, batch))
            xw = unpack_window(raw, d_w, f)                # [B, D, F]
            deg_b = rel.deg[batch].clamp(max=d_w)
            valid = (torch.arange(d_w, device=x.device)[None, :]
                     < deg_b[:, None])
            # slots past a row's degree hold the next node's run: valid
            # masks them before any use
            dist = (center_s0[:, None] - selection_score(xw, w0, b0)).abs()
            dist = torch.where(valid, dist, _INF)
            keep = keep_nearest(dist, rel.keff[batch], valid)
            num, cnt = window_sum_from_gathered(xw, keep)
            keep_minor = None
            if train:
                keep_minor = oversample_keep(rel, batch, batch_labels,
                                             cand_valid, self.rho)
                keep_minor = dedup_minor_keep(rel.nbr2d[batch], keep, n,
                                              cand_ids, keep_minor)
            rel_sums.append((num, cnt, keep_minor))

        if train:
            # minors come from the compact [P, F] exact float32 table
            minors = minor_sum_compact_multi(
                tp_rows_f, cand_slots, [km for _, _, km in rel_sums])
            rel_sums = [(num + mn, cnt + mc, None)
                        for (num, cnt, _), (mn, mc) in zip(rel_sums, minors)]

        rel_embs = []
        for layer, (num, cnt, _) in zip(self.intra, rel_sums):
            agg = num / cnt.clamp(min=1.0)[:, None]
            cat = torch.cat([self_feats, agg], dim=1)      # [B, 2F]
            rel_embs.append(torch.relu(cat @ layer.w))
        cat_all = torch.cat([self_feats] + rel_embs, dim=1)
        combined = torch.relu(cat_all @ self.inter.w)
        gnn_logits = combined @ self.head.w
        return gnn_logits, center_scores

    def to_prob(self, graph, batch, *, train: bool = False, **kw):
        """Sigmoid scores of both heads."""
        gnn_logits, label_logits = self(graph, batch, None, train=train, **kw)
        return torch.sigmoid(gnn_logits), torch.sigmoid(label_logits)

    def loss(self, graph, batch: torch.Tensor, batch_labels: torch.Tensor,
             batch_weight: Optional[torch.Tensor] = None, *,
             train_pos: torch.Tensor, train_pos_valid: torch.Tensor,
             train_pos_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Joint loss L_gnn + alpha * L_simi, as weighted means over the
        batch (padded slots weigh 0; denominator max(sum w, 1))."""
        gnn_logits, center_scores = self(
            graph, batch, batch_labels, train=True, train_pos=train_pos,
            train_pos_valid=train_pos_valid, train_pos_feats=train_pos_feats)
        ce_gnn = int_label_ce(gnn_logits, batch_labels)
        ce_label = int_label_ce(center_scores, batch_labels)
        if batch_weight is None:
            batch_weight = torch.ones_like(ce_gnn)
        denom = batch_weight.sum().clamp(min=1.0)
        gnn_loss = (ce_gnn * batch_weight).sum() / denom
        label_loss = (ce_label * batch_weight).sum() / denom
        return gnn_loss + self.alpha * label_loss
