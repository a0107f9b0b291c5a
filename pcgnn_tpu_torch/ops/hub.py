"""Blockwise hub-row aggregation lane.

Counterpart of ``pcgnn_tpu/ops/hub.py``: PC-GNN's choose lane
(``hub_choose_sum``) and the all-neighbor lane of the GraphSAGE and GCN
baselines (``hub_mean_sum``).  Rows whose degree exceeds the relation's
window cap ("hubs") leave the window lane: the batch's hub rows are ordered
by descending degree and processed in chunks of ``HUB_CHUNK``, each chunk
reading its rows' full CSR edge tails.  Per chunk of ``hub_choose_sum``:

  pass 1: neighbor ids -> table rows -> choose distances (from the table's
          score column in the score-table lane, else scored from the rows)
          -> each row's ``keff`` nearest (``keep_nearest``, lowest slot
          among ties);
  pass 2: the kept rows' feature sum, less the kept neighbors that duplicate
          selected oversampled minors (a kept neighbor duplicates iff it is
          a valid train positive and its distance is within the row's
          minor-selection threshold, ``chunk_minor_band``).

Semantics are those of the JAX lane; the execution differs where PyTorch
runs eagerly, and no difference changes a selection:

  * the chunk loop and each chunk's block count are host values.  The
    number of hub rows and every chunk's block count reach the host in ONE
    device-to-host copy per relation per step (``plan_hub_chunks``);
  * only the hub rows are processed (the JAX lane pads the last chunk with
    inactive rows and zeroes their results);
  * a chunk's whole edge tail, ``jb * block`` ids per row, is fetched once
    with the ragged-gather kernel and serves both passes; the JAX lane
    fetches it block by block in each pass.  The ids and values are the
    same; only the float order of the pass-2 sum differs;
  * the rank sort runs at the chunk's populated width ``jb * block``, known
    on the host (``keep_nearest_switch``; the JAX lane switches between a
    few static widths).

Everything here is selection plus frozen-feature aggregation, so every input
is detached: gradients reach the model only through the layers after it.
"""

from __future__ import annotations

from typing import Optional

import torch

from pcgnn_tpu_torch.ops.aggregate import (_INF, dedup_threshold,
                                          keep_nearest, selection_score)
from pcgnn_tpu_torch.ops.ragged_gather import ragged_gather

# chunk: hub rows processed together.  Each chunk reads
# ceil(max_deg_in_chunk / block) blocks for ALL its rows, so degree-descending
# order (plan_hub_chunks) keeps the read near the rows' own degrees.
# block: the granule of a chunk's tail width.
HUB_CHUNK = 32
HUB_BLOCK = 512

_INT32_MAX = torch.iinfo(torch.int32).max


def keep_nearest_switch(dist: torch.Tensor, kf_rows: torch.Tensor, jb: int,
                        block: int) -> torch.Tensor:
    """``keep_nearest`` over only the first ``jb * block`` columns of a
    chunk's distance buffer (+inf past each row's degree); later columns are
    never kept.  Exact: ``keff <= deg <= jb * block``, so every rank
    decision happens inside the truncation (at least one block is sorted,
    as in the JAX lane, so ``jb = 0`` needs no case of its own)."""
    w = min(max(jb, 1) * block, dist.shape[1])
    dw = dist[:, :w]
    keep = keep_nearest(dw, kf_rows, torch.isfinite(dw))
    if w == dist.shape[1]:
        return keep
    return torch.cat([keep, keep.new_zeros((keep.shape[0],
                                            dist.shape[1] - w))], dim=1)


def hub_table(x: torch.Tensor, train_pos: Optional[torch.Tensor] = None,
              train_pos_valid: Optional[torch.Tensor] = None,
              s0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N+1, FC] table the window and hub lanes gather rows from, in the
    JAX forward's column order: the exact features; the selection scores
    ``s0`` [N] as column F when given (the score-table lane); in training,
    the valid-train-positive indicator as the next column (the
    duplicate-minor subtraction reads it); and a zero sentinel row N, the
    id the CSR padding holds."""
    n = x.shape[0]
    cols = [x.detach()]
    if s0 is not None:
        cols.append(s0.detach()[:, None])
    if train_pos is not None:
        tp_rows = torch.where(train_pos_valid, train_pos, n)
        # invalid entries land in slot n, sliced away below (index_fill_
        # takes the value as a scalar: no host-to-device copy, no sync)
        tp_mask = x.new_zeros((n + 1,)).index_fill_(0, tp_rows, 1.0)
        cols.append(tp_mask[:n, None])
    xs = torch.cat(cols, dim=1)
    return torch.cat([xs, xs.new_zeros((1, xs.shape[1]))])


def plan_hub_chunks(deg_b: torch.Tensor, is_hub: torch.Tensor, chunk: int,
                    block: int):
    """(order [B] int64, n_hub, jbs): batch positions with the hub rows
    first, heaviest first (non-hubs after, in batch order); the number of
    hub rows; and each chunk's block count ``ceil(max deg / block)``.  A
    chunk's max degree is its first row's, so one [1 + B/chunk] device-to-
    host copy carries every count."""
    key = torch.where(is_hub, -deg_b.to(torch.int64), 1 << 60)
    order = torch.argsort(key, stable=True)
    heads = torch.where(is_hub, deg_b, 0)[order][::chunk].to(torch.int64)
    counts = torch.cat([is_hub.sum().view(1), heads]).tolist()
    n_hub = counts[0]
    jbs = [-(-d // block) for d in counts[1: 1 + -(-n_hub // chunk)]]
    return order, n_hub, jbs


def chunk_minor_band(c_s0, ks_rows, fraud, sp_sorted, slot_sorted,
                     feats_sorted, rho: float):
    """Exact oversampled-minor selection and feature sum for one hub chunk.

    For each fraud center, the ``int(ksample * rho)`` training positives
    nearest in selection score, ties resolved by candidate slot, selected
    over the score-sorted candidate axis (``sp_sorted`` +inf at invalid
    candidates, ``slot_sorted`` their slots, ``feats_sorted`` their exact
    feature rows):

      d   = |c_s0 - sp_sorted|                 [H, P]
      t   = m-th smallest distance             one value sort per row
      sel = (d < t) | first (m - #strict) ties in slot order
      num = sel @ feats_sorted

    Returns (mnum [H, F], mcnt [H], t [H]); ``t`` is the pass-2 duplicate
    threshold: +inf when every valid candidate is selected, -inf on rows
    that select none (not fraud, or m = 0).  Every row is a hub row: the
    JAX lane's ``active`` mask covers padded chunk rows, which the port
    does not make.
    """
    m = torch.floor(ks_rows.to(torch.float32) * rho).to(torch.int64)
    act = fraud & (m > 0)
    d = (c_s0[:, None] - sp_sorted[None, :]).abs()
    ds = torch.sort(d, dim=1).values
    n_valid = torch.isfinite(sp_sorted).sum()
    t = dedup_threshold(m, fraud, n_valid, ds)
    strict = d < t[:, None]
    tied = d == t[:, None]
    m_eff = torch.minimum(m.clamp(min=0), n_valid)
    n_needed = m_eff - strict.sum(dim=1)
    key = torch.where(tied, slot_sorted[None, :].to(torch.int64), _INT32_MAX)
    order = torch.argsort(key, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    sel = (strict | (tied & (rank < n_needed[:, None]))) & act[:, None]
    # float64, rounded once: the sum then does not depend on the device's
    # summation order (and TF32 cannot touch it)
    mnum = (sel.double() @ feats_sorted.double()).to(feats_sorted.dtype)
    mcnt = torch.where(act, m_eff, 0).to(feats_sorted.dtype)
    return mnum, mcnt, t


# a profiler range, so a trace attributes the lane's host and device time
@torch.profiler.record_function("hub_choose_sum")
def hub_choose_sum(rel, batch: torch.Tensor, is_hub: torch.Tensor,
                   xs: torch.Tensor, f: int, center_s0: torch.Tensor, *,
                   w0: torch.Tensor, b0: torch.Tensor,
                   s0_col: Optional[int] = None,
                   tp_col: Optional[int] = None,
                   round_sel: bool = False,
                   minor_ctx: Optional[tuple] = None,
                   batch_labels: Optional[torch.Tensor] = None,
                   rho: float = 0.5, chunk: int = HUB_CHUNK,
                   block: int = HUB_BLOCK):
    """Choose and sum over the hub rows' full neighbor lists.

    Args:
      rel: capped relation (``rel.has_hubs``).
      batch: [B] node ids.
      is_hub: [B] bool, ``deg[batch] > rel.window_width``.
      xs: [N+1, FC] table from ``hub_table``: exact features, the score
        and train-positive columns, zero sentinel row N.
      f: number of leading feature columns to aggregate.
      center_s0: [B] selection scores of the centers.
      w0, b0: the selection score's weights (``selection_score``).
      s0_col: column of ``xs`` holding every node's selection score (the
        score-table lane: the window rows of the relation read the same
        table, so hub rows take their neighbors' scores from it rather than
        recompute them); None scores the rows with ``w0``, ``b0``.
      tp_col: column of ``xs`` holding the train-positive indicator, read
        with ``minor_ctx``; None means column ``f``.
      round_sel: score the neighbor rows on their bf16-rounded values (a
        bfloat16 store ranks rounded values in the window lane, so hub rows
        of the same relation must too).  Sums stay exact.
      minor_ctx: (sp_sorted [P], slot_sorted [P], feats_sorted [P, F]), the
        score-sorted candidate table (train only).  Hub rows' minors are
        selected and summed here, and kept neighbors that duplicate them
        subtracted, so the caller excludes hub rows from the window lane's
        minor keep mask.
      batch_labels: [B] labels (train only; minors go to fraud centers).

    Returns (num [B, f], cnt [B]); zeros at non-hub rows.
    """
    xs = xs.detach()
    center_s0 = center_s0.detach()
    w0, b0 = w0.detach(), b0.detach()
    if minor_ctx is not None:
        minor_ctx = tuple(a.detach() for a in minor_ctx)
    if tp_col is None:
        tp_col = f
    num = xs.new_zeros((batch.shape[0], f))
    cnt = xs.new_zeros((batch.shape[0],))
    order, n_hub, jbs = plan_hub_chunks(rel.deg[batch], is_hub, chunk, block)
    for c, jb in enumerate(jbs):
        rows_slot = order[c * chunk: min((c + 1) * chunk, n_hub)]
        rows = batch[rows_slot]
        deg = rel.deg[rows]
        c_s0 = center_s0[rows_slot]
        thr = mnum = mcnt = None
        if minor_ctx is not None:
            mnum, mcnt, thr = chunk_minor_band(
                c_s0, rel.ksample[rows], batch_labels[rows_slot] == 1,
                *minor_ctx, rho)
        # the chunk's whole tail, jb blocks per row, in one fetch (the JAX
        # lane's _window_block, all blocks at once); past col reads N
        nbr = ragged_gather(rel.col, rel.indptr[rows], jb * block,
                            rel.num_nodes)
        xw = xs[nbr]                                   # [H, jb*block, FC]
        # pass 1: distances over every row's degree, +inf past it
        if s0_col is not None:
            s0n = xw[..., s0_col]
        else:
            rows_f = xw[..., :f]
            if round_sel:
                rows_f = rows_f.to(torch.bfloat16).to(torch.float32)
            s0n = selection_score(rows_f, w0, b0)
        slots = torch.arange(jb * block, device=xs.device)
        dist = (c_s0[:, None] - s0n).abs()
        dist = torch.where(slots[None, :] < deg[:, None], dist, _INF)
        keep = keep_nearest_switch(dist, rel.keff[rows], jb, block)
        # pass 2: kept sum, less kept neighbors that are selected minors; a
        # hub row sums hundreds to thousands of rows, so the sum runs in
        # float64 and is rounded once, whatever the device's order
        w = keep.to(torch.float64)
        if thr is not None:
            dup = keep & (xw[..., tp_col] > 0.5) & (dist <= thr[:, None])
            w = w - dup.to(torch.float64)
        num_c = torch.einsum("hw,hwf->hf", w, xw[..., :f].double())
        cnt_c = w.sum(dim=1)
        if mnum is not None:
            num_c, cnt_c = num_c + mnum, cnt_c + mcnt
        num[rows_slot] = num_c.to(xs.dtype)
        cnt[rows_slot] = cnt_c.to(xs.dtype)
    return num, cnt


# a profiler range, as for hub_choose_sum
@torch.profiler.record_function("hub_mean_sum")
def hub_mean_sum(rel, batch: torch.Tensor, is_hub: torch.Tensor,
                 x_padded: torch.Tensor, *, include_self: bool = True,
                 chunk: int = HUB_CHUNK, block: int = HUB_BLOCK):
    """All-neighbor sums over hub rows' full CSR tails: the GraphSAGE and
    GCN baselines' hub lane (no choose).

    ``x_padded`` is the [N+1, F] feature table with a zero sentinel row N.
    Chunks are planned as in ``hub_choose_sum``, and each chunk's whole tail
    is one ragged-gather fetch.  ``include_self`` is ``union_self_window``'s
    conditional self union: the row's own features join once, only when no
    block of its CSR holds the self-loop.  Sums run in float64 and are
    rounded once.  Returns (num [B, F], cnt [B]); zeros at non-hub rows.
    """
    x_padded = x_padded.detach()
    f = x_padded.shape[1]
    num = x_padded.new_zeros((batch.shape[0], f))
    cnt = x_padded.new_zeros((batch.shape[0],))
    order, n_hub, jbs = plan_hub_chunks(rel.deg[batch], is_hub, chunk, block)
    for c, jb in enumerate(jbs):
        rows_slot = order[c * chunk: min((c + 1) * chunk, n_hub)]
        rows = batch[rows_slot]
        nbr = ragged_gather(rel.col, rel.indptr[rows], jb * block,
                            rel.num_nodes)
        slots = torch.arange(jb * block, device=x_padded.device)
        valid = slots[None, :] < rel.deg[rows][:, None]
        w = valid.to(torch.float64)
        num_c = torch.einsum("hw,hwf->hf", w, x_padded[nbr].double())
        cnt_c = w.sum(dim=1)
        if include_self:
            has_self = (valid & (nbr == rows[:, None])).any(dim=1)
            miss = (~has_self).to(torch.float64)
            num_c = num_c + miss[:, None] * x_padded[rows].double()
            cnt_c = cnt_c + miss
        num[rows_slot] = num_c.to(x_padded.dtype)
        cnt[rows_slot] = cnt_c.to(x_padded.dtype)
    return num, cnt
