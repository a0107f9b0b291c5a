"""PC-GNN: one Pick-Choose-Aggregate layer, as an ``nn.Module``.

Counterpart of ``pcgnn_tpu/models/pcgnn.py``, with its lanes:

  * store lanes: every relation carries an edge-window store
    (``graph.csr.attach_edge_windows``), read as fused records (one fetch
    per batch row for all relations) or per relation (one fetch each);
    each relation's selection scores, choose and kept-row sum come from
    the fetched rows in one kernel (``ops.aggregate.choose_window_sum``);
  * score-table lane: a graph without a store on every relation, under
    ``SCORE_FROM_WINDOW_MIN_NODES`` nodes, builds one [N] selection-score
    table per step, and each relation's choose reads the rows
    ``[x ; s0 (; train-positive indicator)]`` at its neighbor ids;
  * score-from-window without full coverage (stress scale): a relation
    with a store reads it, one without reads the feature rows at its
    neighbor ids (from the dense table or, without one, from the CSR
    through the ragged gather) and scores them.

Without a store, a relation's choose is one kernel too, which reads each
valid slot's row through its id (``ops.aggregate.choose_ids_sum``).

In each of these lanes a training step's oversampled minors of every
relation come from one more kernel (``ops.aggregate.oversample_minor_sums``).

Rows above a relation's window cap (hubs, on heavy-tailed graphs) go through
the hub lane (``ops.hub``), which reads their full CSR edge tails.  With
``learn_features`` the node table is a parameter ``embed`` and aggregation
runs the dense mask-GEMM lane (``_forward_learned``), which needs no store.

  scores      = X W_clf + b                  (label-aware scores, [N, 2])
  d(u,v)      = |scores[u,0] - scores[v,0]|  (choose distance)
  keep        : per row, the keff nearest neighbors, plus int(ksample*rho)
                nearest train positives for fraud-labeled centers (train)
  h_r         = ReLU([x_v ; mean_{u kept} x_u] W_r)           (intra)
  combined    = ReLU([x_v ; h_1 ; ... ; h_R] W_inter)         (inter)
  gnn_logits  = combined W_head
  loss        = CE(gnn_logits, y) + alpha * CE(scores[batch], y)

Parameters keep the JAX layout and names: weights are [in, out];
``label_clf.w/b``, ``intra.<r>.w``, ``inter.w``, ``head.w`` and, with
``learn_features``, ``embed`` [N, F] (``interop`` converts to and from the
JAX pytree).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pcgnn_tpu_torch.models.initializers import torch_linear, xavier_uniform
from pcgnn_tpu_torch.models.lossfns import int_label_ce
from pcgnn_tpu_torch.ops.aggregate import (
    _INF,
    batch_neighbor_window,
    batch_raw_window,
    batch_record_window,
    choose_ids_sum,
    choose_window_sum,
    keep_nearest,
    masked_mean_aggregate,
    oversample_candidates_values,
    oversample_keep,
    oversample_minor_sums,
    rank_train_positives,
    scatter_batch_mask_counts,
    selection_score,
)
from pcgnn_tpu_torch.ops.hub import hub_choose_sum, hub_table
from pcgnn_tpu_torch.utils.profiling import section

# node count from which a graph without a store on every relation scores
# the gathered rows instead of building an [N] score table each step (the
# per-step O(N) work would outweigh a batch's); tests patch it
SCORE_FROM_WINDOW_MIN_NODES = 200_000


class Dense(nn.Module):
    """A weight ``w`` [in, out] and an optional bias ``b`` [out]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)


class PCGNN(nn.Module):
    def __init__(self, feat_dim: int, emb_dim: int, num_relations: int,
                 alpha: float, rho: float, num_classes: int = 2,
                 learn_features: bool = False,
                 features: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if learn_features and features is None:
            raise ValueError(
                "learn_features=True needs the initial node table "
                "(PCGNN(..., features=...)): the reference initializes the "
                "embedding from the dataset features")
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
        # the trainable node table of the learned-feature lane (the
        # reference's nn.Embedding with requires_grad=True)
        self.learn_features = learn_features
        if learn_features:
            self.embed = nn.Parameter(features.detach().float().clone())

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
                train_pos_feats: Optional[torch.Tensor] = None,
                hub_plans: Optional[tuple] = None):
        """Returns (gnn_logits [B, C], center_scores [B, C]).

        ``train_pos_feats`` optionally supplies ``features[train_pos]``,
        which is constant for a run (frozen features, fixed split).
        ``hub_plans``, one per relation (``ops.hub.epoch_hub_plans`` over
        ``hub_relations``), fixes the hub lane's chunks; None plans each
        relation's chunks from this batch.
        """
        if self.learn_features:
            return self._forward_learned(
                graph, batch, batch_labels, train=train, train_pos=train_pos,
                train_pos_valid=train_pos_valid)
        rels = graph.relations
        x = graph.features
        n, f = x.shape
        clf = self.label_clf
        # every relation stored: the window lanes (fused records when the
        # graph has them).  Otherwise a relation with a store still reads it
        # when scores come from the windows (partial coverage, stress
        # scale), and one without reads table rows through its neighbor ids
        use_ewin = bool(rels) and all(rel.ewin is not None for rel in rels)
        use_fused = use_ewin and graph.fused is not None
        # two score strategies with the same values: one [N] score table
        # per step (graphs under SCORE_FROM_WINDOW_MIN_NODES without full
        # store coverage), or scores of the gathered rows themselves, whose
        # cost follows the batch, not N
        score_from_window = use_ewin or n >= SCORE_FROM_WINDOW_MIN_NODES
        # with bfloat16 stores on every relation, every selection score
        # ranks the bf16-rounded snapshot (centers, candidates and hub rows;
        # window values are bf16 already).  The JAX package takes this
        # rounding only under full coverage (pcgnn.py:185-186), and so does
        # the port.  The loss path stays exact float32
        bf16 = use_ewin and any(rel.ewin.dtype == torch.bfloat16
                                for rel in rels)

        def sel_round(a):
            return a.to(torch.bfloat16).to(torch.float32) if bf16 else a

        # selection is non-differentiable: label_clf learns only through
        # the similarity loss on center_scores
        w0 = clf.w[:, 0].detach()
        b0 = clf.b[0].detach()
        # the graph nodes of each part of a captured step
        # (``utils.profiling.section``; no-ops outside a capture)
        section("gather")
        self_feats = x[batch]
        section("dense")
        center_scores = self_feats @ clf.w + clf.b
        any_hub = any(rel.has_hubs for rel in rels)
        need_tp = train and any_hub
        tp_args = (train_pos, train_pos_valid) if need_tp else ()
        s0_col = None
        section("choose")
        if score_from_window:
            center_s0 = selection_score(sel_round(self_feats), w0, b0)
            tp_col = f
            section("hub")
            if need_tp:
                xs = hub_table(x, *tp_args)
            elif graph.features_pad is not None:
                xs = graph.features_pad
            elif not any_hub:
                # no sentinel row: the choose reads no padding id's row, so
                # no step copies the whole table
                xs = x
            else:
                xs = hub_table(x)
        else:
            # one score per node; window, hub and candidate rows read the
            # same values, so a self-loop's distance is exactly 0
            s0 = selection_score(x.detach(), w0, b0)
            center_s0 = s0[batch]
            section("hub")
            xs = hub_table(x, *tp_args, s0=s0)
            s0_col, tp_col = f, f + 1
        section("gather")
        if use_fused:
            rec = batch_record_window(graph, batch)        # [B, W] float32

        minor_ctx = ranked = None
        if train:
            m_max = self.minor_window(int(train_pos.shape[0]), rels)
            tp_rows_f = (train_pos_feats if train_pos_feats is not None
                         else x[train_pos])
            section("choose")
            tp_s0 = (selection_score(sel_round(tp_rows_f), w0, b0)
                     if score_from_window else s0[train_pos])
            section("oversample")
            # one sort of the train positives' scores a step: the minors'
            # windows and the hub lane's band read it
            ranked = rank_train_positives(tp_s0, train_pos_valid)
            if any_hub:
                # hub rows' minor requests can reach the whole candidate
                # pool, so the hub lane selects them over the score-sorted
                # candidate table instead of the compact window
                sp_sorted, order = ranked
                minor_ctx = (sp_sorted, order.to(torch.int32),
                             tp_rows_f.detach()[order])

        rel_sums = []       # per relation: (num, cnt)
        minor_rels = []     # per relation: (rel, neighbor ids, choose keep)
        for r, rel in enumerate(rels):
            section("gather")
            store_lane = rel.ewin is not None and score_from_window
            if store_lane:
                raw = (rec[:, graph.fused_off[r]: graph.fused_off[r + 1]]
                       if use_fused else batch_raw_window(rel, batch))
                deg_b = rel.deg[batch]
                # the minors' dedup reads nbr2d through the batch
                nbr = None
            else:
                nbr, _ = batch_neighbor_window(rel, batch, allow_capped=True)
                deg_b = rel.deg[batch]
            if rel.has_hubs:
                section("hub")
                is_hub = deg_b > rel.window_width
            hub_cap = rel.window_width if rel.has_hubs else None
            section("choose")
            # one kernel: scores, the keff nearest and their sum; slots
            # past a row's degree (the store's next node's run, the ids'
            # padding) and hub rows are invalid there
            if store_lane:
                num, cnt, keep = choose_window_sum(
                    raw, max(rel.window_width, 1), f, center_s0, w0, b0,
                    deg_b, rel.keff[batch], hub_cap=hub_cap,
                    round_bf16=bf16 and rel.ewin.dtype != torch.bfloat16,
                    want_keep=train)
            else:
                # each valid slot's row read through its id, its score
                # computed or, in the score-table lane, read from the table
                num, cnt, keep = choose_ids_sum(
                    xs, nbr, f, center_s0, w0, b0, deg_b, rel.keff[batch],
                    hub_cap=hub_cap, score_col=s0_col, round_bf16=bf16,
                    want_keep=train)
            if rel.has_hubs:
                h_num, h_cnt = hub_choose_sum(
                    rel, batch, is_hub, xs, f, center_s0, w0=w0, b0=b0,
                    s0_col=s0_col, tp_col=tp_col, round_sel=bf16,
                    minor_ctx=minor_ctx, batch_labels=batch_labels,
                    rho=self.rho, plan=hub_plans[r] if hub_plans else None)
                section("hub")
                num = torch.where(is_hub[:, None], h_num, num)
                cnt = torch.where(is_hub, h_cnt, cnt)
            if train:
                # the window's ids, padding N: a sentinel must not match
                minor_rels.append((rel, nbr, keep))
            rel_sums.append((num, cnt))

        if minor_rels:
            section("oversample")
            # one kernel for every relation: each fraud center's candidate
            # window, its keep, the dedup against the kept neighbors and
            # the sum of the minors' exact float32 rows, added into the
            # relations' sums (the hub lane took the hub rows' minors)
            oversample_minor_sums(
                center_s0, tp_s0, train_pos, train_pos_valid, tp_rows_f,
                m_max, batch, batch_labels, self.rho, minor_rels, rel_sums,
                ranked=ranked)

        section("dense")
        rel_embs = []
        for layer, (num, cnt) in zip(self.intra, rel_sums):
            agg = num / cnt.clamp(min=1.0)[:, None]
            cat = torch.cat([self_feats, agg], dim=1)      # [B, 2F]
            rel_embs.append(torch.relu(cat @ layer.w))
        cat_all = torch.cat([self_feats] + rel_embs, dim=1)
        combined = torch.relu(cat_all @ self.inter.w)
        gnn_logits = combined @ self.head.w
        return gnn_logits, center_scores

    def _forward_learned(self, graph, batch: torch.Tensor,
                         batch_labels: Optional[torch.Tensor], *, train: bool,
                         train_pos: Optional[torch.Tensor] = None,
                         train_pos_valid: Optional[torch.Tensor] = None):
        """Learned-feature forward: the dense mask-GEMM lane.

        Selection is the frozen lane's (choose and oversample, detached),
        scored from the current table: every node's selection score, so
        the train positives' scores move with ``embed`` too.  Aggregation
        builds the [B, N] 0/1 mask and its row counts in one kernel launch
        (``scatter_batch_mask_counts``) and contracts the mask with
        ``embed``, dividing the product by the counts
        (``masked_mean_aggregate``), whose gradient ``mask^T @ (g / cnt)``
        reaches the table.  Minors that are also kept
        neighbors collapse in the mask's set semantics, so no dedup runs.
        """
        rels = graph.relations
        if any(rel.has_hubs for rel in rels):
            raise ValueError(
                "learn_features=True needs uncapped relations: the hub lane "
                "is frozen-feature by design.  Rebuild the graph with "
                "csr_from_edges(window_cap=dmax) or train with frozen "
                "features.")
        x = self.embed
        n = graph.num_nodes
        clf = self.label_clf
        w0 = clf.w[:, 0].detach()
        b0 = clf.b[0].detach()
        s0 = selection_score(x.detach(), w0, b0)           # [N]
        s0_pad = torch.cat([s0, s0.new_full((1,), _INF)])  # sentinel N
        center_s0 = s0[batch]
        self_feats = x[batch]
        # the same rows as (embed @ w + b)[batch], at [B] cost
        center_scores = self_feats @ clf.w + clf.b
        if train:
            m_max = self.minor_window(int(train_pos.shape[0]), rels)
            cand_ids, cand_valid, _, _ = oversample_candidates_values(
                center_s0, s0[train_pos], train_pos, train_pos_valid, m_max)

        rel_embs = []
        for layer, rel in zip(self.intra, rels):
            nbr, valid = batch_neighbor_window(rel, batch)
            dist = (center_s0[:, None] - s0_pad[nbr]).abs()
            dist = torch.where(valid, dist, _INF)
            keep = keep_nearest(dist, rel.keff[batch], valid)
            if train:
                keep_minor = oversample_keep(rel, batch, batch_labels,
                                             cand_valid, self.rho)
                mask, cnt = scatter_batch_mask_counts(n, nbr, keep, cand_ids,
                                                      keep_minor)
            else:
                mask, cnt = scatter_batch_mask_counts(n, nbr, keep)
            agg = masked_mean_aggregate(mask, x, counts=cnt)
            cat = torch.cat([self_feats, agg], dim=1)      # [B, 2F]
            rel_embs.append(torch.relu(cat @ layer.w))
        cat_all = torch.cat([self_feats] + rel_embs, dim=1)
        combined = torch.relu(cat_all @ self.inter.w)
        return combined @ self.head.w, center_scores

    @staticmethod
    def hub_relations(graph) -> tuple:
        """The relations whose hub lanes ``hub_plans`` plans."""
        return tuple(graph.relations)

    def to_prob(self, graph, batch, *, train: bool = False, **kw):
        """Sigmoid scores of both heads."""
        gnn_logits, label_logits = self(graph, batch, None, train=train, **kw)
        return torch.sigmoid(gnn_logits), torch.sigmoid(label_logits)

    def loss(self, graph, batch: torch.Tensor, batch_labels: torch.Tensor,
             batch_weight: Optional[torch.Tensor] = None, *,
             train_pos: torch.Tensor, train_pos_valid: torch.Tensor,
             train_pos_feats: Optional[torch.Tensor] = None,
             hub_plans: Optional[tuple] = None) -> torch.Tensor:
        """Joint loss L_gnn + alpha * L_simi, as weighted means over the
        batch (padded slots weigh 0; denominator max(sum w, 1))."""
        gnn_logits, center_scores = self(
            graph, batch, batch_labels, train=True, train_pos=train_pos,
            train_pos_valid=train_pos_valid, train_pos_feats=train_pos_feats,
            hub_plans=hub_plans)
        ce_gnn = int_label_ce(gnn_logits, batch_labels)
        ce_label = int_label_ce(center_scores, batch_labels)
        if batch_weight is None:
            batch_weight = torch.ones_like(ce_gnn)
        denom = batch_weight.sum().clamp(min=1.0)
        gnn_loss = (ce_gnn * batch_weight).sum() / denom
        label_loss = (ce_label * batch_weight).sum() / denom
        return gnn_loss + self.alpha * label_loss
