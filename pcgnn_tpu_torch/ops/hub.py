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

Semantics are those of the JAX lane (``_run_hub_chunks``); the execution
differs where PyTorch runs eagerly, and no difference changes a selection:

  * the chunks and each chunk's width come from a plan of host integers,
    ``plan_hub_chunks``, computed from a stack of batches in ONE
    device-to-host copy: the trainer plans once an epoch from the epoch's
    batches (``epoch_hub_plans``), so a step reads nothing back and its
    shapes stay fixed for the epoch (the captured step needs both); a call
    without a plan plans its own batch, with that one copy.  Inside the
    step, the heaviest-first order, the hub count and each chunk's
    ``active`` rows stay on the device, as in the JAX lane: every chunk of
    the plan runs at its planned width, and rows past the batch's hub
    count contribute and write zeros;
  * a chunk's whole edge tail, ``jb * block`` ids per row, is fetched once
    with the ragged-gather kernel and serves both passes; the JAX lane
    fetches it block by block in each pass.  The ids and values are the
    same; only the float order of the pass-2 sum differs;
  * the rank sort runs at the chunk's planned width ``jb * block``, a host
    integer (``keep_nearest_switch``; the JAX lane switches between a few
    static widths): exact for any width at or above the rows' degrees.

Everything here is selection plus frozen-feature aggregation, so every input
is detached: gradients reach the model only through the layers after it.
"""

from __future__ import annotations

from typing import Optional

import torch

from pcgnn_tpu_torch.ops.aggregate import (_INF, dedup_threshold,
                                          keep_nearest, selection_score)
from pcgnn_tpu_torch.ops.ragged_gather import ragged_gather
from pcgnn_tpu_torch.utils.profiling import in_section, span

# chunk: hub rows processed together.  Each chunk reads
# ceil(max_deg_in_chunk / block) blocks for ALL its rows, so degree-descending
# order (hub_order) keeps the read near the rows' own degrees.
# block: the granule of a chunk's tail width.
HUB_CHUNK = 32
HUB_BLOCK = 512

_INT32_MAX = torch.iinfo(torch.int32).max


def keep_nearest_switch(dist: torch.Tensor, kf_rows: torch.Tensor, jb: int,
                        block: int) -> torch.Tensor:
    """``keep_nearest`` over only the first ``jb * block`` columns of a
    chunk's distance buffer (+inf past each row's degree); later columns are
    never kept.  Exact for any ``jb`` with ``keff <= deg <= jb * block``,
    so a chunk takes its planned width, whatever its rows' own degrees (at
    least one block is sorted, as in the JAX lane, so ``jb = 0`` needs no
    case of its own)."""
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


def hub_order(deg_b: torch.Tensor, is_hub: torch.Tensor) -> torch.Tensor:
    """[..., B] int64 batch positions with the hub rows first, heaviest
    first (non-hubs after, in batch order), along the last axis."""
    key = torch.where(is_hub, -deg_b.to(torch.int64), 1 << 60)
    return torch.argsort(key, dim=-1, stable=True)


def hub_heads(deg_b: torch.Tensor, is_hub: torch.Tensor,
              chunk: int) -> torch.Tensor:
    """[1 + ceil(B / chunk)] int64 device counts of one or a stack of
    batches ([B] or [nb, B]): the most hub rows of any batch, then, for
    each chunk c, the largest degree that heads chunk c in any batch (a
    chunk's first row is its heaviest; 0 past a batch's hub rows)."""
    deg_b, is_hub = deg_b.reshape(-1, deg_b.shape[-1]), is_hub.reshape(
        -1, is_hub.shape[-1])
    heads = torch.where(is_hub, deg_b, 0).to(torch.int64).gather(
        1, hub_order(deg_b, is_hub))[:, ::chunk]
    counts = torch.cat([is_hub.sum(dim=1, keepdim=True), heads], dim=1)
    return counts.amax(dim=0)


def plan_from_heads(counts, chunk: int, block: int) -> tuple:
    """The plan of ``hub_heads``' counts, read back: each chunk's block
    count ``ceil(head degree / block)`` (at least 1), for the chunks that
    the most hub rows fill."""
    n_chunks = -(-counts[0] // chunk)
    return tuple(max(-(-d // block), 1) for d in counts[1: 1 + n_chunks])


def plan_hub_chunks(deg_b: torch.Tensor, is_hub: torch.Tensor, chunk: int,
                    block: int) -> tuple:
    """The hub plan of one batch ([B]) or of a stack ([nb, B]): a tuple of
    each chunk's block count, which bounds every batch of the stack (its
    hub rows fit the chunks, and each chunk's width covers its rows'
    degrees).  One device-to-host copy."""
    heads = hub_heads(deg_b, is_hub, chunk)
    with span("pcgnn.hub.readback"):
        counts = heads.tolist()
    return plan_from_heads(counts, chunk, block)


def epoch_hub_plans(relations, batches: torch.Tensor,
                    chunk: int = HUB_CHUNK, block: int = HUB_BLOCK) -> tuple:
    """One plan per relation (None where it has no hubs) bounding every
    batch of ``batches`` [nb, B]: all relations' counts come back in ONE
    device-to-host copy, and a graph without hubs reads nothing back."""
    return stack_hub_plans(
        relations, [rel.deg[batches] if rel.has_hubs else None
                    for rel in relations], chunk, block)


def stack_hub_plans(relations, degs, chunk: int = HUB_CHUNK,
                    block: int = HUB_BLOCK) -> tuple:
    """``epoch_hub_plans`` from a stack of each relation's batch degrees
    the caller supplies (``degs[r]`` [nb, B], None where relation r has no
    hubs; a row is a hub above ``window_width``): the sharded plan gathers
    them from the row blocks (``parallel.spmd.spmd_epoch_hub_plans``).
    One device-to-host copy; none when every entry is None."""
    heads = [None if deg is None else
             hub_heads(deg, deg > rel.window_width, chunk)
             for rel, deg in zip(relations, degs)]
    live = [h for h in heads if h is not None]
    if not live:
        return tuple(None for _ in relations)
    counts = torch.cat(live)
    with span("pcgnn.hub.readback"):
        flat = counts.tolist()
    plans, at = [], 0
    for h in heads:
        if h is None:
            plans.append(None)
            continue
        plans.append(plan_from_heads(flat[at: at + h.numel()], chunk, block))
        at += h.numel()
    return tuple(plans)


def plan_covers(big, small) -> bool:
    """Whether plan ``big`` bounds plan ``small`` (per relation: as many
    chunks or more, each at least as wide)."""
    return all(s is None or (b is not None and len(b) >= len(s)
                             and all(x >= y for x, y in zip(b, s)))
               for b, s in zip(big, small))


def plan_union(a, b) -> tuple:
    """The smallest plan that bounds plans ``a`` and ``b``."""
    def one(x, y):
        if x is None or y is None:
            return x if y is None else y
        n = max(len(x), len(y))
        x, y = x + (0,) * (n - len(x)), y + (0,) * (n - len(y))
        return tuple(max(p, q) for p, q in zip(x, y))
    return tuple(one(x, y) for x, y in zip(a, b))


def run_hub_chunks(deg_b: torch.Tensor, is_hub: torch.Tensor, plan,
                   chunk: int, block: int, like: torch.Tensor, f: int,
                   chunk_fn):
    """The JAX lane's ``_run_hub_chunks``: hub rows ordered heaviest first
    and cut into the plan's chunks (``plan_hub_chunks`` of this batch when
    ``plan`` is None), ``chunk_fn(rows_slot [chunk], active [chunk], jb)``
    run on each at its planned block count, and the per-row (num, cnt)
    scattered back to batch order.  ``rows_slot`` are batch positions;
    ``active`` marks the chunk's rows below the batch's hub count (the
    rest are padding: position 0 past the batch, and non-hub rows), whose
    results are zeroed.  Nothing is read back when a plan is given.
    Returns (num [B, f], cnt [B]) in ``like``'s dtype; zeros at non-hub
    rows."""
    b = is_hub.shape[0]
    if plan is None:
        plan = plan_hub_chunks(deg_b, is_hub, chunk, block)
    num = like.new_zeros((b, f))
    cnt = like.new_zeros((b,))
    if not plan:
        return num, cnt
    order = hub_order(deg_b, is_hub)
    n_hub = is_hub.sum()
    rows_total = len(plan) * chunk
    order_p = torch.nn.functional.pad(order, (0, max(rows_total - b, 0)))
    lane = torch.arange(chunk, device=is_hub.device)
    nums, cnts = [], []
    for c, jb in enumerate(plan):
        rows_slot = order_p[c * chunk: (c + 1) * chunk]
        active = c * chunk + lane < n_hub
        num_c, cnt_c = chunk_fn(rows_slot, active, jb)
        nums.append(torch.where(active[:, None], num_c, 0.0).to(like.dtype))
        cnts.append(torch.where(active, cnt_c, 0.0).to(like.dtype))
    k = min(rows_total, b)
    num.index_copy_(0, order[:k], torch.cat(nums)[:k])
    cnt.index_copy_(0, order[:k], torch.cat(cnts)[:k])
    return num, cnt


def chunk_minor_band(c_s0, ks_rows, fraud, active, sp_sorted, slot_sorted,
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
    that select none (not fraud, m = 0, or not ``active``: the chunk's
    padding rows past the batch's hub count, as in the JAX lane).
    """
    m = torch.floor(ks_rows.to(torch.float32) * rho).to(torch.int64)
    fraud = fraud & active
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


@in_section("hub")
def hub_choose_sum(rel, batch: torch.Tensor, is_hub: torch.Tensor,
                   xs: torch.Tensor, f: int, center_s0: torch.Tensor, *,
                   w0: torch.Tensor, b0: torch.Tensor,
                   s0_col: Optional[int] = None,
                   tp_col: Optional[int] = None,
                   round_sel: bool = False,
                   minor_ctx: Optional[tuple] = None,
                   batch_labels: Optional[torch.Tensor] = None,
                   rho: float = 0.5, chunk: int = HUB_CHUNK,
                   block: int = HUB_BLOCK, plan: Optional[tuple] = None):
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
      plan: the relation's chunk plan (``plan_hub_chunks`` of a stack of
        batches holding this one); None plans this batch alone.

    Returns (num [B, f], cnt [B]); zeros at non-hub rows.
    """
    xs = xs.detach()
    center_s0 = center_s0.detach()
    w0, b0 = w0.detach(), b0.detach()
    if minor_ctx is not None:
        minor_ctx = tuple(a.detach() for a in minor_ctx)
    if tp_col is None:
        tp_col = f

    def chunk_fn(rows_slot, active, jb):
        rows = batch[rows_slot]
        deg = torch.where(active, rel.deg[rows], 0)
        c_s0 = center_s0[rows_slot]
        thr = mnum = mcnt = None
        if minor_ctx is not None:
            mnum, mcnt, thr = chunk_minor_band(
                c_s0, rel.ksample[rows], batch_labels[rows_slot] == 1,
                active, *minor_ctx, rho)
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
        return num_c, cnt_c

    return run_hub_chunks(rel.deg[batch], is_hub, plan, chunk, block, xs, f,
                          chunk_fn)


@in_section("hub")
def hub_mean_sum(rel, batch: torch.Tensor, is_hub: torch.Tensor,
                 x_padded: torch.Tensor, *, include_self: bool = True,
                 chunk: int = HUB_CHUNK, block: int = HUB_BLOCK,
                 plan: Optional[tuple] = None):
    """All-neighbor sums over hub rows' full CSR tails: the GraphSAGE and
    GCN baselines' hub lane (no choose).

    ``x_padded`` is the [N+1, F] feature table with a zero sentinel row N.
    Chunks follow ``plan`` as in ``hub_choose_sum``, and each chunk's
    whole tail is one ragged-gather fetch.  ``include_self`` is
    ``union_self_window``'s conditional self union: the row's own features
    join once, only when no block of its CSR holds the self-loop.  Sums
    run in float64 and are rounded once.  Returns (num [B, F], cnt [B]);
    zeros at non-hub rows.
    """
    x_padded = x_padded.detach()

    def chunk_fn(rows_slot, active, jb):
        rows = batch[rows_slot]
        nbr = ragged_gather(rel.col, rel.indptr[rows], jb * block,
                            rel.num_nodes)
        slots = torch.arange(jb * block, device=x_padded.device)
        deg = torch.where(active, rel.deg[rows], 0)
        valid = slots[None, :] < deg[:, None]
        w = valid.to(torch.float64)
        num_c = torch.einsum("hw,hwf->hf", w, x_padded[nbr].double())
        cnt_c = w.sum(dim=1)
        if include_self:
            has_self = (valid & (nbr == rows[:, None])).any(dim=1)
            miss = (~has_self).to(torch.float64)
            num_c = num_c + miss[:, None] * x_padded[rows].double()
            cnt_c = cnt_c + miss
        return num_c, cnt_c

    return run_hub_chunks(rel.deg[batch], is_hub, plan, chunk, block,
                          x_padded, x_padded.shape[1], chunk_fn)
