"""Batch window fetches, the choose and oversample selection, and the
scatter-free window sums of the PC-GNN training step.

Counterpart of ``pcgnn_tpu/ops/aggregate.py`` for the frozen-feature window
lane.  Selection reproduces the JAX tie rules exactly:

  * ``keep_nearest`` keeps each row's k nearest, lowest column among ties;
  * candidate orderings are stable sorts, and the (distance, slot)
    lexicographic sort is two stable sorts, secondary key first;
  * ids stay in integer tensors throughout.

Selection is non-differentiable: everything that feeds it is detached.
"""

from __future__ import annotations

import torch

from pcgnn_tpu_torch.ops.window_gather import window_gather

_INF = float("inf")

# candidate windows wider than this run the minor dedup and the minor sums
# in blocks of this many columns, bounding the [B, chunk, *] temporaries
MINOR_CHUNK = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def batch_raw_window(rel, batch: torch.Tensor,
                     starts: torch.Tensor | None = None) -> torch.Tensor:
    """[B, ewin_dp] raw store values per batch row, one window each."""
    if rel.ewin is None:
        raise ValueError("batch_raw_window needs the edge-window store "
                         "(graph.csr.attach_edge_windows)")
    if starts is None:
        starts = rel.estart[batch]
    return window_gather(rel.ewin, starts, rel.ewin_dp)


def unpack_window(raw: torch.Tensor, d: int, f: int) -> torch.Tensor:
    """[B, >= d*f] fetched store rows -> [B, d, f] float32 windows (a
    bfloat16 store upcasts exactly)."""
    return raw[:, : d * f].reshape(raw.shape[0], d, f).to(torch.float32)


def batch_record_window(graph, batch: torch.Tensor) -> torch.Tensor:
    """[B, W] fused records: every relation's window in one fetch per batch
    row (``graph.csr._build_fused_store``).  Slice relation r's section at
    ``graph.fused_off[r]`` and unpack with :func:`unpack_window`."""
    if graph.fused is None:
        raise ValueError("batch_record_window needs the fused record store "
                         "(graph.csr.materialize_edge_windows(fused=True))")
    w = graph.fused.shape[1]
    return window_gather(graph.fused.view(-1), batch.to(torch.int64) * w, w)


def row_ranks(dist: torch.Tensor) -> torch.Tensor:
    """Exact per-row ascending rank of ``dist``, ties broken by column."""
    order = torch.argsort(dist, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True).to(torch.int32)


def keep_nearest(dist: torch.Tensor, k: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Mask of each row's ``k[b]`` nearest entries of ``dist`` (+inf at
    invalid slots): ``valid & (row_ranks(dist) < k[:, None])``, computed
    from one value sort.  All entries strictly nearer than the k-th
    smallest value t are kept, then the first ties at t in column order."""
    d = dist.shape[1]
    ds = torch.sort(dist, dim=1).values
    idx = (k.to(torch.int64) - 1).clamp(0, d - 1)
    t = ds.gather(1, idx[:, None])
    less = dist < t
    eq = dist == t
    tie_prefix = torch.cumsum(eq.to(torch.int32), dim=1)
    n_less = less.sum(dim=1, keepdim=True)
    keep_tie = eq & ((n_less + tie_prefix) <= k[:, None])
    return valid & (k[:, None] > 0) & (less | keep_tie)


def _pad_cols(a: torch.Tensor, width: int, value) -> torch.Tensor:
    if a.shape[1] >= width:
        return a
    pad = a.new_full((a.shape[0], width - a.shape[1]), value)
    return torch.cat([a, pad], dim=1)


def oversample_candidates_dense_values(center_s0: torch.Tensor,
                                       cand_s0: torch.Tensor,
                                       train_pos: torch.Tensor,
                                       train_pos_valid: torch.Tensor,
                                       m_max: int):
    """Each row's ``m_max`` nearest training positives over the full
    [B, P] distance matrix; ties go to the lowest candidate slot."""
    p = int(train_pos.shape[0])
    d = (center_s0[:, None] - cand_s0[None, :]).abs()
    d = torch.where(train_pos_valid[None, :], d, _INF)
    k = min(m_max, p)
    ds, order = torch.sort(d, dim=1, stable=True)
    cand_dist = ds[:, :k]
    order = order[:, :k]
    cand_ids = train_pos.to(torch.int32)[order]
    cand_valid = train_pos_valid[order] & torch.isfinite(cand_dist)
    cand_slots = order.to(torch.int32)
    return (_pad_cols(cand_ids, m_max, 0), _pad_cols(cand_valid, m_max, False),
            _pad_cols(cand_dist, m_max, _INF), _pad_cols(cand_slots, m_max, 0))


def oversample_candidates_values(center_s0: torch.Tensor,
                                 cand_s0: torch.Tensor,
                                 train_pos: torch.Tensor,
                                 train_pos_valid: torch.Tensor, m_max: int):
    """Per-row nearest training positives, compacted to ``m_max``.

    The distance is one-dimensional, so a center's m nearest candidates
    form a contiguous window of the score-sorted candidate list: sort the
    candidates once, find each center's position, and sort a [B, 2C]
    window of it by (distance, slot).  Small pools (2*m_max >= P) take the
    dense form.

    Returns (cand_ids [B, m] int32, cand_valid [B, m] bool, cand_dist
    [B, m] float32 ascending with +inf at invalid slots, cand_slots [B, m]
    int32 positions into ``train_pos``); invalid slots carry id and slot 0.
    """
    p = int(train_pos.shape[0])
    if 2 * m_max >= p:
        return oversample_candidates_dense_values(
            center_s0, cand_s0, train_pos, train_pos_valid, m_max)
    sp = torch.where(train_pos_valid, cand_s0, _INF)
    sp_sorted, order = torch.sort(sp, stable=True)
    slot_sorted = order.to(torch.int32)
    tp_sorted = train_pos.to(torch.int32)[order]
    # chunk stride C >= 2*m_max: rows of width 2C overlapping by C hold any
    # center's window [pos - m, pos + m) inside one row
    c = max(128, _round_up(2 * m_max, 128))
    nrows = -(-p // c)
    padw = nrows * c + c - p

    def overlap_rows(a, value):                 # [P] -> [R, 2C]
        a = torch.cat([a, a.new_full((padw,), value)])
        return torch.cat([a[: nrows * c].reshape(nrows, c),
                          a[c: nrows * c + c].reshape(nrows, c)], dim=1)

    rows_scores = overlap_rows(sp_sorted, _INF)
    rows_slots = overlap_rows(slot_sorted, 0)
    rows_tp = overlap_rows(tp_sorted, 0)
    pos = torch.searchsorted(sp_sorted, center_s0.contiguous())
    r0 = torch.div(pos - m_max, c, rounding_mode="floor").clamp(0, nrows - 1)
    win_scores = rows_scores[r0]
    win_slots = rows_slots[r0]
    win_tp = rows_tp[r0]
    d = (center_s0[:, None] - win_scores).abs()
    d = torch.where(torch.isfinite(win_scores), d, _INF)
    # lexicographic (distance, slot): stable sort on the secondary key,
    # then a stable sort on the primary one
    o1 = torch.sort(win_slots, dim=1, stable=True).indices
    o2 = torch.sort(d.gather(1, o1), dim=1, stable=True).indices
    order = o1.gather(1, o2)[:, :m_max]
    d_sorted = d.gather(1, order)
    cand_valid = torch.isfinite(d_sorted)
    cand_ids = torch.where(cand_valid, win_tp.gather(1, order), 0)
    cand_slots = torch.where(cand_valid, win_slots.gather(1, order), 0)
    return cand_ids, cand_valid, d_sorted, cand_slots


def oversample_keep(rel, batch: torch.Tensor, batch_labels: torch.Tensor,
                    cand_valid: torch.Tensor, rho: float,
                    ksample_b: torch.Tensor | None = None) -> torch.Tensor:
    """Keep mask over the compact candidate window: slot r is kept when
    ``r < int(ksample * rho)`` (in float32) and the center is fraud."""
    if ksample_b is None:
        ksample_b = rel.ksample[batch]
    m = torch.floor(ksample_b.to(torch.float32) * rho).to(torch.int32)
    slot = torch.arange(cand_valid.shape[1], device=cand_valid.device)
    is_fraud = batch_labels == 1
    return cand_valid & (slot[None, :] < m[:, None]) & is_fraud[:, None]


def dedup_minor_keep(nbr: torch.Tensor, keep: torch.Tensor, sentinel: int,
                     cand_ids: torch.Tensor,
                     keep_minor: torch.Tensor) -> torch.Tensor:
    """Drop oversampled candidates that are already kept neighbors (the
    reference collects both into one set), comparing in ``MINOR_CHUNK``
    column blocks."""
    kept_ids = torch.where(keep, nbr, sentinel).detach()
    ids = cand_ids.detach()
    dup = torch.cat([
        (ids[:, c0: c0 + MINOR_CHUNK, None] == kept_ids[:, None, :]).any(2)
        for c0 in range(0, ids.shape[1], MINOR_CHUNK)], dim=1)
    return keep_minor & ~dup


def window_sum_from_gathered(xw: torch.Tensor, keep: torch.Tensor):
    """(num [B, F], cnt [B]): the kept rows' sum and count of a gathered
    [B, D, F] window."""
    kf = keep.to(xw.dtype)
    return torch.einsum("bd,bdf->bf", kf, xw), kf.sum(dim=1)


def minor_sum_compact_multi(tp_feats: torch.Tensor, cand_slots: torch.Tensor,
                            keeps: list):
    """(num [B, F], cnt [B]) of selected minors for several keep masks
    sharing one candidate window, gathered by slot from the compact [P, F]
    train-positive table in ``MINOR_CHUNK`` blocks (one gather per block
    for all masks)."""
    b, m = cand_slots.shape
    p, f = tp_feats.shape
    tp = tp_feats.detach()
    slots = cand_slots.detach().clamp(0, p - 1).to(torch.int64)
    out = [(tp.new_zeros((b, f)), tp.new_zeros((b,))) for _ in keeps]
    for c0 in range(0, m, MINOR_CHUNK):
        xg = tp[slots[:, c0: c0 + MINOR_CHUNK]]
        for i, keep in enumerate(keeps):
            km = keep[:, c0: c0 + MINOR_CHUNK].detach().to(tp.dtype)
            num, cnt = out[i]
            out[i] = (num + torch.einsum("bm,bmf->bf", km, xg),
                      cnt + km.sum(dim=1))
    return out
