"""Batch window fetches, the choose and oversample selection, the
scatter-free window sums of the PC-GNN training step, the self-union windows
of the GraphSAGE and GCN baselines, and the dense mask-GEMM aggregation of
the learned-feature lane.

Counterpart of ``pcgnn_tpu/ops/aggregate.py``, with its full-graph mean
(``segment_mean_spmm``).  Selection reproduces the JAX tie rules exactly:

  * ``keep_nearest`` keeps each row's k nearest, lowest column among ties;
  * candidate orderings are stable sorts, and the (distance, slot)
    lexicographic sort is two stable sorts, secondary key first;
  * ids stay in integer tensors throughout.

The choose of a relation (scores, ``keep_nearest`` and the kept rows' sum)
is one hand-written kernel on the card (``ops.choose_window``), from the
fused records in the store lanes (``choose_window_sum``) and through the
neighbor ids in the lanes without stores (``choose_ids_sum``), and so are
a training step's oversampled minors of every relation (candidates, keep,
dedup and sums), ``oversample_minor_sums`` (``ops.oversample_minors``);
the plain version of each is the chain of ops it replaces.  On the card
``selection_score`` is a kernel of the same file too.

Selection is non-differentiable: everything that feeds it is detached.
"""

from __future__ import annotations

import torch

from pcgnn_tpu_torch.ops import choose_window, oversample_minors
from pcgnn_tpu_torch.ops.mask_build import build_batch_mask_counts
from pcgnn_tpu_torch.ops.ragged_gather import ragged_gather
from pcgnn_tpu_torch.ops.window_gather import window_gather

_INF = float("inf")

# candidate windows wider than this run the minor dedup and the minor sums
# in blocks of this many columns, bounding the [B, chunk, *] temporaries
MINOR_CHUNK = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def selection_score(rows: torch.Tensor, w0: torch.Tensor,
                    b0: torch.Tensor) -> torch.Tensor:
    """Choose score of feature rows, [..., F] -> [...].

    Accumulated in float64 and rounded once to float32: the float32 result
    then does not depend on the summation order of the device or the
    operand shape, so a self-loop's distance is exactly 0 and the card and
    the CPU select the same neighbors.  (The JAX reference computes it in
    float32 at precision "highest"; the two agree to about an ulp.)

    A CUDA tensor is scored by the kernel (``ops.choose_window.
    launch_scores``), a row a thread from its float32 values, with the
    float64 dot product of the choose kernel's ids source: a row's score
    depends on its values alone, whatever the rows' count, strides or
    launch, and no float64 copy of the rows is made.  bfloat16 and float16
    rows are widened to float32 first (exactly); a CUDA tensor of another
    dtype raises.  On the CPU it is the float64 expression.
    """
    if rows.device.type == "cpu":
        return (rows.double() @ w0.double() + b0.double()).float()
    if rows.device.type != "cuda":
        raise ValueError(f"selection_score: unsupported device "
                         f"{rows.device}")
    if rows.dtype in (torch.bfloat16, torch.float16):
        rows = rows.float()
    elif rows.dtype != torch.float32:
        raise ValueError(f"selection_score: the score kernel reads float32, "
                         f"bfloat16 or float16 rows, got {rows.dtype}")
    f = int(rows.shape[-1])
    if w0.shape != (f,) or b0.numel() != 1 or w0.dtype != torch.float32 \
            or b0.dtype != torch.float32 or w0.device != rows.device \
            or b0.device != rows.device:
        raise ValueError(f"selection_score: rows of {f} float32 values want "
                         f"w0 [{f}] and one b0, float32 on {rows.device}; "
                         f"got w0 {tuple(w0.shape)} {w0.dtype}, b0 "
                         f"{tuple(b0.shape)} {b0.dtype}")
    out = torch.empty(rows.shape[:-1], dtype=torch.float32,
                      device=rows.device)
    if out.numel() == 0:
        return out
    dims = _row_dims(rows)
    if (f > 1 and rows.stride(-1) != 1) or len(dims) > 2:
        rows = rows.contiguous()
        dims = _row_dims(rows)
    outer, inner = [(1, 0)] * (2 - len(dims)) + dims
    choose_window.launch_scores(rows.detach(), outer, inner, f,
                                w0.detach(), b0.detach(), out)
    return out


def _row_dims(rows: torch.Tensor) -> list:
    """(count, stride) of the leading dimensions of ``rows`` [..., F], size
    1 dropped and neighbors merged where one stride steps over the other:
    a row's offset is the sum of index * stride."""
    dims = []
    for size, stride in zip(rows.shape[:-1], rows.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == size * stride:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    return dims


def batch_raw_window(rel, batch: torch.Tensor,
                     starts: torch.Tensor | None = None) -> torch.Tensor:
    """[B, ewin_dp] float32 store values per batch row, one window each (a
    bfloat16 store is widened exactly by the fetch)."""
    if rel.ewin is None:
        raise ValueError("batch_raw_window needs the edge-window store "
                         "(graph.csr.attach_edge_windows)")
    if starts is None:
        starts = rel.estart[batch]
    return window_gather(rel.ewin, starts, rel.ewin_dp,
                         out_dtype=torch.float32)


def batch_feature_window(rel, batch: torch.Tensor, f: int,
                         starts: torch.Tensor | None = None) -> torch.Tensor:
    """[B, D, f] float32 neighbor feature windows from the relation's
    edge-window store, one kernel fetch for the batch; slots past a row's
    degree hold the next node's run and must be masked by the caller."""
    if rel.ewin is None:
        raise ValueError("batch_feature_window needs the edge-window store "
                         "(graph.csr.attach_edge_windows)")
    if f != rel.ewin_f:
        raise ValueError(f"batch_feature_window: feature width {f} != "
                         f"{rel.ewin_f}, the width the store was built with")
    raw = batch_raw_window(rel, batch, starts)
    return unpack_window(raw, max(rel.window_width, 1), f)


def unpack_window(raw: torch.Tensor, d: int, f: int) -> torch.Tensor:
    """[B, >= d*f] fetched store rows -> [B, d, f] float32 windows (a view
    of float32 rows; bfloat16 ones upcast exactly)."""
    return raw[:, : d * f].reshape(raw.shape[0], d, f).to(torch.float32)


def batch_record_window(graph, batch: torch.Tensor) -> torch.Tensor:
    """[B, W] float32 fused records: every relation's window in one fetch
    per batch row (``graph.csr._build_fused_store``), widened by the fetch.
    Slice relation r's section at ``graph.fused_off[r]`` and unpack with
    :func:`unpack_window` (a view)."""
    if graph.fused is None:
        raise ValueError("batch_record_window needs the fused record store "
                         "(graph.csr.materialize_edge_windows(fused=True))")
    w = graph.fused.shape[1]
    return window_gather(graph.fused.view(-1), batch.to(torch.int64) * w, w,
                         out_dtype=torch.float32)


def batch_neighbor_window(rel, batch: torch.Tensor, *,
                          allow_capped: bool = False):
    """(nbr [B, D] int32 neighbor ids, padding slots N; valid [B, D] bool)
    of a batch's CSR rows, D = ``rel.window_width``.

    Rows come from the dense table ``nbr2d`` when the graph has one, else
    as contiguous runs of ``col`` at ``indptr[batch]`` through the ragged
    gather, which reads N past the end of ``col``.  A capped relation
    (``rel.has_hubs``) exposes only a hub row's first D neighbors, so it
    is refused unless the caller handles hub rows (``allow_capped``).
    """
    if rel.is_stub:
        raise ValueError(
            "batch_neighbor_window called on a degree-only stub relation: "
            "its edge list is empty, so window aggregation would silently "
            "average zero phantom neighbors")
    if rel.has_hubs and not allow_capped:
        raise ValueError(
            f"batch_neighbor_window on a window-capped relation "
            f"(dcap={rel.window_width} < dmax={rel.dmax}) from a caller "
            f"that is not hub-aware: rows above the cap would silently "
            f"lose neighbors")
    d = max(rel.window_width, 1)
    degs = rel.deg[batch].clamp(max=d)
    valid = (torch.arange(d, device=batch.device)[None, :]
             < degs[:, None])
    if rel.nbr2d is not None:
        return rel.nbr2d[batch], valid
    raw = ragged_gather(rel.col, rel.indptr[batch], d, rel.num_nodes)
    return torch.where(valid, raw, rel.num_nodes), valid


def union_self_window(nbr: torch.Tensor, valid: torch.Tensor,
                      batch: torch.Tensor):
    """(nbr [B, D+1], keep [B, D+1]): the window with a self column that is
    active only where the row's CSR lacks the self-loop (the reference's set
    union of a node's neighbors and itself)."""
    batch = batch.to(nbr.dtype)
    present = ((nbr == batch[:, None]) & valid).any(dim=1)
    return (torch.cat([nbr, batch[:, None]], dim=1),
            torch.cat([valid, ~present[:, None]], dim=1))


def self_union_feature_window(rel, batch: torch.Tensor,
                              features: torch.Tensor):
    """The store form of ``batch_neighbor_window`` + ``union_self_window``
    + ``x_padded[nbr]``: (xw [B, D+1, F], keep [B, D+1]), the store's
    window with the exact feature row appended as the conditional self
    column.  Ids come from the dense table, one [B] row gather."""
    d = max(rel.window_width, 1)
    valid = (torch.arange(d, device=batch.device)[None, :]
             < rel.deg[batch].clamp(max=d)[:, None])
    xw = batch_feature_window(rel, batch, features.shape[1])
    _, keep = union_self_window(rel.nbr2d[batch], valid, batch)
    return torch.cat([xw, features[batch][:, None, :]], dim=1), keep


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


def choose_window_sum_plain(raw: torch.Tensor, d: int, f: int,
                            center_s0: torch.Tensor, w0: torch.Tensor,
                            b0: torch.Tensor, deg: torch.Tensor,
                            keff: torch.Tensor, *, hub_cap: int | None = None,
                            round_bf16: bool = False):
    """The plain version of :func:`choose_window_sum`, the chain of ops it
    replaces: the valid mask, ``selection_score`` of the (rounded) window
    rows, the distances, ``keep_nearest`` and
    ``window_sum_from_gathered``."""
    return _choose_gathered(unpack_window(raw, d, f), None, center_s0, w0,
                            b0, deg, keff, hub_cap, round_bf16)


def _choose_gathered(xw: torch.Tensor, scores: torch.Tensor | None,
                     center_s0: torch.Tensor, w0: torch.Tensor,
                     b0: torch.Tensor, deg: torch.Tensor, keff: torch.Tensor,
                     hub_cap: int | None, round_bf16: bool):
    """The chain of both plain versions on a gathered [B, D, F] window
    ``xw``: the valid mask (slots below min(deg, D), no row with deg >
    ``hub_cap``), the given [B, D] ``scores`` or ``selection_score`` of the
    (rounded) rows, the distances, ``keep_nearest`` and
    ``window_sum_from_gathered``."""
    d = xw.shape[1]
    valid = (torch.arange(d, device=xw.device)[None, :]
             < deg.clamp(max=d)[:, None])
    if hub_cap is not None:
        valid = valid & ~(deg > hub_cap)[:, None]
    if scores is None:
        rows = xw.to(torch.bfloat16).to(torch.float32) if round_bf16 else xw
        scores = selection_score(rows, w0, b0)
    dist = torch.where(valid, (center_s0[:, None] - scores).abs(), _INF)
    keep = keep_nearest(dist, keff, valid)
    num, cnt = window_sum_from_gathered(xw, keep)
    return num, cnt, keep


def choose_window_sum(raw: torch.Tensor, d: int, f: int,
                      center_s0: torch.Tensor, w0: torch.Tensor,
                      b0: torch.Tensor, deg: torch.Tensor, keff: torch.Tensor,
                      *, hub_cap: int | None = None, round_bf16: bool = False,
                      want_keep: bool = True):
    """The window lane's choose of one relation: (num [B, f] float32, cnt
    [B] float32, keep [B, d] bool, or None without ``want_keep``).

    ``raw`` [B, >= d*f] float32 holds each row's window of d slots of f
    values (a relation's section of the fused records, a view);
    ``center_s0`` [B] the centers' selection scores; ``w0`` [f] and
    ``b0`` (one value) the score's weight and bias; ``deg`` and ``keff``
    [B] the rows' degrees and keep counts.  Slots at or past min(deg, d)
    are invalid, and so is every slot of a row with deg > ``hub_cap`` (a
    hub, which the hub lane takes).  Each valid slot is scored as
    ``selection_score`` scores it, from its values rounded to bfloat16
    when ``round_bf16`` (a float32 store among bfloat16 ones), and each
    row keeps its keff nearest to the center by ``keep_nearest``'s rule;
    ``num`` sums the kept slots' values as stored, ``cnt`` counts them.

    On a CUDA tensor the wrapper launches the hand-written kernel
    (``ops.choose_window``, ``csrc/choose_window.cu``) or raises; on a CPU
    tensor it takes :func:`choose_window_sum_plain`.  It reads nothing
    back from the card.  The kernel's selection equals the plain
    version's and its sums add the same rows in another order.
    """
    if raw.dim() != 2 or raw.dtype != torch.float32:
        raise ValueError(f"choose_window_sum wants [B, W] float32 rows, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    b = int(raw.shape[0])
    if d < 1 or f < 1 or raw.shape[1] < d * f:
        raise ValueError(f"choose_window_sum: rows of {raw.shape[1]} values "
                         f"do not hold {d} slots of {f}")
    if (center_s0.shape != (b,) or deg.shape != (b,) or keff.shape != (b,)
            or w0.shape != (f,) or b0.numel() != 1):
        raise ValueError(
            f"choose_window_sum: B={b}, F={f} but center_s0 "
            f"{tuple(center_s0.shape)}, deg {tuple(deg.shape)}, keff "
            f"{tuple(keff.shape)}, w0 {tuple(w0.shape)}, b0 "
            f"{tuple(b0.shape)}")
    args = (center_s0, w0, b0, deg, keff)
    if any(a.device != raw.device for a in args):
        raise ValueError("choose_window_sum: arguments on different devices")
    if raw.device.type == "cpu":
        num, cnt, keep = choose_window_sum_plain(
            raw, d, f, center_s0, w0, b0, deg, keff, hub_cap=hub_cap,
            round_bf16=round_bf16)
        return num, cnt, keep if want_keep else None
    if raw.device.type != "cuda":
        raise ValueError(f"choose_window_sum: unsupported device "
                         f"{raw.device}")
    if raw.stride(1) != 1 or any(a.dtype != torch.float32
                                 for a in (center_s0, w0, b0)):
        raise ValueError("choose_window_sum: rows need unit column stride "
                         "and the scores float32")
    if d * f >= 2 ** 31 or d >= 2 ** 30:
        raise ValueError(f"choose_window_sum: {d} slots of {f} values "
                         f"exceed the kernel's 32-bit row indexing")
    dev = raw.device
    num = torch.empty((b, f), dtype=torch.float32, device=dev)
    cnt = torch.empty((b,), dtype=torch.float32, device=dev)
    keep = (torch.empty((b, d), dtype=torch.bool, device=dev) if want_keep
            else None)
    if b:
        choose_window.launch(
            raw.detach(), d, f, center_s0.detach().contiguous(), w0.detach(),
            b0.detach(), deg.to(torch.int32).contiguous(),
            keff.to(torch.int32).contiguous(), hub_cap, round_bf16, num, cnt,
            keep)
    return num, cnt, keep


def choose_ids_sum_plain(xs: torch.Tensor, nbr: torch.Tensor, f: int,
                         center_s0: torch.Tensor, w0: torch.Tensor,
                         b0: torch.Tensor, deg: torch.Tensor,
                         keff: torch.Tensor, *, hub_cap: int | None = None,
                         score_col: int | None = None,
                         round_bf16: bool = False):
    """The plain version of :func:`choose_ids_sum`, the chain of ops it
    replaces: the rows gathered at the ids (clamped into the table, so a
    padding id past it reads the last row, which no valid slot takes), the
    valid mask, the score column or ``selection_score`` of the (rounded)
    rows, the distances, ``keep_nearest`` and
    ``window_sum_from_gathered``."""
    rows = xs[nbr.clamp(max=xs.shape[0] - 1)]
    return _choose_gathered(
        rows[..., :f], None if score_col is None else rows[..., score_col],
        center_s0, w0, b0, deg, keff, hub_cap, round_bf16)


def choose_ids_sum(xs: torch.Tensor, nbr: torch.Tensor, f: int,
                   center_s0: torch.Tensor, w0: torch.Tensor,
                   b0: torch.Tensor, deg: torch.Tensor, keff: torch.Tensor,
                   *, hub_cap: int | None = None, score_col: int | None = None,
                   round_bf16: bool = False, want_keep: bool = True):
    """The choose of one relation in a lane without stores: (num [B, f]
    float32, cnt [B] float32, keep [B, D] bool, or None without
    ``want_keep``), as :func:`choose_window_sum`, with slot d of row b the
    row ``xs[nbr[b, d]]`` of a feature table.

    ``xs`` [R, >= f] float32 is the table (the features, their sentinel
    copy ``features_pad`` or ``ops.hub.hub_table``'s), whose first f
    columns are summed; ``nbr`` [B, D] the window's neighbor ids
    (``batch_neighbor_window``).  Slots at or past min(deg, D) are
    invalid, and so is every slot of a row with deg > ``hub_cap``, and an
    invalid slot's id is never read as a row: padding ids N need no
    sentinel row.  A valid slot's score is column ``score_col`` of its row
    (the score-table lane) or, without one, ``selection_score`` of its
    first f values, rounded to bfloat16 first where ``round_bf16``.

    On a CUDA tensor the wrapper launches the hand-written kernel
    (``ops.choose_window.launch_ids``) or raises; on a CPU tensor it takes
    :func:`choose_ids_sum_plain`.  It reads nothing back from the card.
    The kernel scores a row as ``selection_score`` does on the card, to
    the bit; its selection equals the plain version's and its sums add
    the same rows in another order.
    """
    if xs.dim() != 2 or xs.dtype != torch.float32 or nbr.dim() != 2:
        raise ValueError(f"choose_ids_sum wants a [R, C] float32 table and "
                         f"[B, D] ids, got {tuple(xs.shape)} {xs.dtype} and "
                         f"{tuple(nbr.shape)}")
    b, d = (int(s) for s in nbr.shape)
    cols = int(xs.shape[1])
    if d < 1 or f < 1 or cols < f or (score_col is not None
                                     and not 0 <= score_col < cols):
        raise ValueError(f"choose_ids_sum: a table of {cols} columns, "
                         f"{d} slots, f={f}, score column {score_col}")
    if (center_s0.shape != (b,) or deg.shape != (b,) or keff.shape != (b,)
            or w0.shape != (f,) or b0.numel() != 1):
        raise ValueError(
            f"choose_ids_sum: B={b}, F={f} but center_s0 "
            f"{tuple(center_s0.shape)}, deg {tuple(deg.shape)}, keff "
            f"{tuple(keff.shape)}, w0 {tuple(w0.shape)}, b0 "
            f"{tuple(b0.shape)}")
    if any(a.device != xs.device for a in (nbr, center_s0, w0, b0, deg,
                                           keff)):
        raise ValueError("choose_ids_sum: arguments on different devices")
    if xs.device.type == "cpu":
        num, cnt, keep = choose_ids_sum_plain(
            xs, nbr, f, center_s0, w0, b0, deg, keff, hub_cap=hub_cap,
            score_col=score_col, round_bf16=round_bf16)
        return num, cnt, keep if want_keep else None
    if xs.device.type != "cuda":
        raise ValueError(f"choose_ids_sum: unsupported device {xs.device}")
    if xs.stride(1) != 1 or any(a.dtype != torch.float32
                                for a in (center_s0, w0, b0)):
        raise ValueError("choose_ids_sum: the table needs unit column "
                         "stride and the scores float32")
    if d >= 2 ** 30 or f >= 2 ** 20:
        raise ValueError(f"choose_ids_sum: {d} slots of {f} values exceed "
                         f"the kernel's 32-bit row indexing")
    dev = xs.device
    num = torch.empty((b, f), dtype=torch.float32, device=dev)
    cnt = torch.empty((b,), dtype=torch.float32, device=dev)
    keep = (torch.empty((b, d), dtype=torch.bool, device=dev) if want_keep
            else None)
    if b:
        ids = nbr.to(torch.int32)
        if ids.stride(1) != 1:
            ids = ids.contiguous()
        choose_window.launch_ids(
            xs.detach(), ids, f, score_col, center_s0.detach().contiguous(),
            w0.detach(), b0.detach(), deg.to(torch.int32).contiguous(),
            keff.to(torch.int32).contiguous(), hub_cap, round_bf16, num, cnt,
            keep)
    return num, cnt, keep


def choose_keep_mask(rel, batch: torch.Tensor, nbr: torch.Tensor,
                     valid: torch.Tensor,
                     s0_padded: torch.Tensor) -> torch.Tensor:
    """The choose step: [B, D] mask of each row's ``keff`` nearest
    neighbors by |s0[center] - s0[neighbor]|, from the [N+1] score table
    ``s0_padded`` (row N for the padding id)."""
    d = (s0_padded[batch][:, None] - s0_padded[nbr]).abs()
    d = torch.where(valid, d, _INF)
    return keep_nearest(d, rel.keff[batch], valid)


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


def oversample_candidates_dense(batch: torch.Tensor, s0_padded: torch.Tensor,
                                train_pos: torch.Tensor,
                                train_pos_valid: torch.Tensor, m_max: int):
    """Id form of :func:`oversample_candidates_dense_values`: the scores
    of the centers and candidates come from the [N+1] table."""
    return oversample_candidates_dense_values(
        s0_padded[batch], s0_padded[train_pos], train_pos, train_pos_valid,
        m_max)


def oversample_candidates(batch: torch.Tensor, s0_padded: torch.Tensor,
                          train_pos: torch.Tensor,
                          train_pos_valid: torch.Tensor, m_max: int):
    """Id form of :func:`oversample_candidates_values`."""
    return oversample_candidates_values(
        s0_padded[batch], s0_padded[train_pos], train_pos, train_pos_valid,
        m_max)


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


def _normalized(num: torch.Tensor, cnt: torch.Tensor,
                norm: str) -> torch.Tensor:
    """[B, F] sums divided by their counts (``mean``) or the counts' square
    root (``sqrt``, GCN's row normalization), counts below 1 taken as 1."""
    if norm not in ("mean", "sqrt"):
        raise ValueError(f"unknown norm {norm!r}")
    denom = cnt.clamp(min=1.0)
    if norm == "sqrt":
        denom = denom.sqrt()
    return num / denom[:, None]


def window_mean_from_gathered(xw: torch.Tensor, keep: torch.Tensor,
                              minor_xw: torch.Tensor | None = None,
                              keep_minor: torch.Tensor | None = None, *,
                              norm: str = "mean") -> torch.Tensor:
    """[B, F] mean of the kept rows of a gathered [B, D, F] window and, if
    given, of the kept minors' gathered [B, M, F] rows."""
    num, cnt = window_sum_from_gathered(xw, keep)
    if minor_xw is not None:
        mnum, mcnt = window_sum_from_gathered(minor_xw, keep_minor)
        num, cnt = num + mnum, cnt + mcnt
    return _normalized(num, cnt, norm)


def window_mean_aggregate(nbr: torch.Tensor, keep: torch.Tensor,
                          features_padded: torch.Tensor,
                          minor_ids: torch.Tensor | None = None,
                          keep_minor: torch.Tensor | None = None, *,
                          norm: str = "mean") -> torch.Tensor:
    """[B, F] mean of the kept neighbors' rows of the [N+1, F] table (row
    N zero, the padding id) and the kept minors' rows: ``minor_ids`` [P]
    shared by every row or [B, M], with ``keep_minor`` [B, P] or [B, M]
    (deduplicated against the kept neighbors by ``dedup_minor_keep``)."""
    num, cnt = window_sum_from_gathered(features_padded[nbr], keep)
    if minor_ids is not None:
        km = keep_minor.to(features_padded.dtype)
        xm = features_padded[minor_ids]
        num = num + (km @ xm if minor_ids.dim() == 1
                     else torch.einsum("bm,bmf->bf", km, xm))
        cnt = cnt + km.sum(dim=1)
    return _normalized(num, cnt, norm)


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


def minor_sum_compact(tp_feats: torch.Tensor, cand_slots: torch.Tensor,
                      keep_minor: torch.Tensor):
    """:func:`minor_sum_compact_multi` for one keep mask."""
    return minor_sum_compact_multi(tp_feats, cand_slots, [keep_minor])[0]


def rank_train_positives(tp_s0: torch.Tensor, train_pos_valid: torch.Tensor):
    """(sp_sorted [P] float32, order [P] int64): the train positives'
    selection scores, +inf at invalid slots, in one stable ascending sort
    (equal scores in slot order).  The oversample kernel's windows and the
    hub lane's minor band read the same sort."""
    sp = torch.where(train_pos_valid, tp_s0, _INF)
    sp_sorted, order = torch.sort(sp, stable=True)
    return sp_sorted, order


def oversample_minor_keeps(center_s0: torch.Tensor, tp_s0: torch.Tensor,
                           train_pos: torch.Tensor,
                           train_pos_valid: torch.Tensor, m_max: int,
                           batch: torch.Tensor, batch_labels: torch.Tensor,
                           rho: float, rels: list):
    """(cand_slots [B, m_max] int32, keeps: [B, m_max] bool a relation):
    the selection of :func:`oversample_minor_sums` as the chain of ops
    computes it, ``oversample_candidates_values``, then per relation
    ``oversample_keep``, the hub rows' mask and ``dedup_minor_keep``."""
    cand_ids, cand_valid, _, cand_slots = oversample_candidates_values(
        center_s0, tp_s0, train_pos, train_pos_valid, m_max)
    keeps = []
    for rel, nbr, keep in rels:
        keep_minor = oversample_keep(rel, batch, batch_labels, cand_valid, rho)
        if rel.has_hubs:
            # the hub lane takes the hub rows' minors
            keep_minor = keep_minor & ~(rel.deg[batch]
                                        > rel.window_width)[:, None]
        if nbr is None:
            nbr = rel.nbr2d[batch]
        keeps.append(dedup_minor_keep(nbr, keep, rel.num_nodes, cand_ids,
                                      keep_minor))
    return cand_slots, keeps


def oversample_minor_sums_plain(center_s0: torch.Tensor, tp_s0: torch.Tensor,
                                train_pos: torch.Tensor,
                                train_pos_valid: torch.Tensor,
                                tp_rows: torch.Tensor, m_max: int,
                                batch: torch.Tensor,
                                batch_labels: torch.Tensor, rho: float,
                                rels: list, sums: list) -> None:
    """The plain version of :func:`oversample_minor_sums`, the chain of ops
    it replaces: :func:`oversample_minor_keeps`, then
    ``minor_sum_compact_multi``; each relation's sums are added into its
    pair of ``sums``."""
    cand_slots, keeps = oversample_minor_keeps(
        center_s0, tp_s0, train_pos, train_pos_valid, m_max, batch,
        batch_labels, rho, rels)
    minors = minor_sum_compact_multi(tp_rows, cand_slots, keeps)
    for (num, cnt), (m_num, m_cnt) in zip(sums, minors):
        num.add_(m_num)
        cnt.add_(m_cnt)


def oversample_minor_sums(center_s0: torch.Tensor, tp_s0: torch.Tensor,
                          train_pos: torch.Tensor,
                          train_pos_valid: torch.Tensor, tp_rows: torch.Tensor,
                          m_max: int, batch: torch.Tensor,
                          batch_labels: torch.Tensor, rho: float, rels: list,
                          sums: list, *, ranked: tuple,
                          view: tuple | None = None) -> None:
    """Add the oversampled minors of every relation into its choose sums,
    in place: each relation's (num [B, F] float32, cnt [B] float32) of
    ``sums``, which nothing differentiates.

    ``center_s0`` [B] holds the centers' selection scores; ``tp_s0``,
    ``train_pos`` and ``train_pos_valid`` [P] the train positives' scores,
    node ids and valid flags, ``tp_rows`` [P, F] their exact feature rows;
    ``m_max`` bounds the minors a row takes (``PCGNN.minor_window``).
    ``rels`` holds one (rel, nbr, keep) a relation: the relation's
    ``RelGraph`` (``ksample``, ``deg``, the hub cap and, where ``nbr`` is
    None, ``nbr2d``, all read at ``batch``; the sharded step passes its
    ``ShardedRel`` and the rows' local indices), the rows' neighbor ids
    [B, d] (None: ``nbr2d`` at ``batch``) and their choose keep mask
    [B, d].  A fraud-labeled row
    (``batch_labels`` 1) takes, in each relation, its first
    ``int(ksample * rho)`` candidates of the ``m_max`` nearest train
    positives by |score difference|, lowest slot first among ties
    (``oversample_candidates_values``), none on a hub row (the hub lane
    takes those), and drops those that are kept neighbors; ``num`` adds
    their rows, ``cnt`` their count.  ``ranked`` is the step's one sort of
    the train positives, :func:`rank_train_positives` (the hub lane reads
    it too; the plain version sorts in its own chain); ``view`` is a
    test's view of the kernel's selection (``oversample_minors.launch``).

    On a CUDA tensor the wrapper launches the hand-written kernel
    (``ops.oversample_minors``, ``csrc/oversample_minors.cu``) or raises;
    on a CPU tensor it takes :func:`oversample_minor_sums_plain`.  It
    reads nothing back from the card.  The kernel selects the same minors
    and counts them to the bit; its sums add the same rows in another
    order.
    """
    b = int(center_s0.shape[0])
    p = int(train_pos.shape[0])
    if len(rels) != len(sums) or tp_rows.dim() != 2 or m_max < 1:
        raise ValueError(f"oversample_minor_sums: {len(rels)} relations, "
                         f"{len(sums)} sums, rows {tuple(tp_rows.shape)}, "
                         f"m_max {m_max}")
    f = int(tp_rows.shape[1])
    shapes = [tp_s0.shape, train_pos_valid.shape, tp_rows.shape[:1]]
    if (any(s != (p,) for s in shapes) or batch.shape != (b,)
            or batch_labels.shape != (b,)):
        raise ValueError("oversample_minor_sums: the train positives' or "
                         "the batch's arguments differ in length")
    for (_, nbr, keep), (num, cnt) in zip(rels, sums):
        if (keep.dim() != 2 or keep.shape[0] != b or num.shape != (b, f)
                or cnt.shape != (b,)
                or (nbr is not None and nbr.shape != keep.shape)):
            raise ValueError(
                f"oversample_minor_sums: keep {tuple(keep.shape)}, nbr "
                f"{None if nbr is None else tuple(nbr.shape)}, num "
                f"{tuple(num.shape)} and cnt {tuple(cnt.shape)} for B={b}, "
                f"F={f}")
    if center_s0.device.type == "cpu":
        oversample_minor_sums_plain(center_s0, tp_s0, train_pos,
                                    train_pos_valid, tp_rows, m_max, batch,
                                    batch_labels, rho, rels, sums)
        return
    if center_s0.device.type != "cuda":
        raise ValueError(f"oversample_minor_sums: unsupported device "
                         f"{center_s0.device}")
    sp_sorted, order = ranked
    if (tp_rows.dtype != torch.float32 or tp_rows.stride(1) != 1
            or center_s0.dtype != torch.float32
            or sp_sorted.dtype != torch.float32 or p >= 2 ** 31):
        raise ValueError("oversample_minor_sums: scores and rows need "
                         "float32, rows unit column stride, P < 2^31")
    args = []
    for (rel, nbr, keep), (num, cnt) in zip(rels, sums):
        ids = rel.nbr2d if nbr is None else nbr
        if (ids is None or ids.dtype != torch.int32 or ids.stride(1) != 1
                or ids.shape[1] < keep.shape[1]
                or keep.dtype != torch.bool or keep.stride(1) != 1
                or rel.ksample.dtype != torch.int32
                or rel.deg.dtype != torch.int32
                or not (num.is_contiguous() and cnt.is_contiguous())
                or num.dtype != torch.float32 or cnt.dtype != torch.float32
                or num.requires_grad or cnt.requires_grad):
            raise ValueError(
                "oversample_minor_sums: a relation needs int32 ids and "
                "bool keep with unit column stride, int32 ksample and deg, "
                "and contiguous float32 sums that no gradient reads")
        args.append((ids, nbr is None, keep, rel.ksample.contiguous(),
                     rel.deg.contiguous(),
                     rel.window_width if rel.has_hubs else -1, num, cnt))
    if b and args:
        chunk = 0 if 2 * m_max >= p else max(128, _round_up(2 * m_max, 128))
        oversample_minors.launch(
            center_s0.detach().contiguous(), sp_sorted.contiguous(),
            order.to(torch.int64).contiguous(),
            train_pos.to(torch.int64).contiguous(), tp_rows.detach(), chunk,
            m_max, batch.to(torch.int64).contiguous(),
            batch_labels.to(torch.int64).contiguous(), float(rho), args,
            view)


def dedup_threshold(m: torch.Tensor, fraud: torch.Tensor, n_valid,
                    cand_dist: torch.Tensor) -> torch.Tensor:
    """[B] duplicate threshold from each row's minor count ``m`` and its
    ascending candidate distances ``cand_dist`` [B, W]: the m-th smallest
    distance, +inf where m reaches the ``n_valid`` valid candidates (all
    are selected), -inf where the row selects none (not ``fraud``, or
    m = 0).  A kept neighbor duplicates a selected minor iff it is a valid
    train positive within this distance (ties count)."""
    at_m = cand_dist.gather(1, (m - 1).clamp(0, cand_dist.shape[1] - 1)
                            [:, None])[:, 0]
    t = torch.where(m >= n_valid, _INF, at_m)
    return torch.where(fraud & (m > 0), t, -_INF)


def minor_dedup_threshold(rel, batch: torch.Tensor, batch_labels: torch.Tensor,
                          cand_valid: torch.Tensor, cand_dist: torch.Tensor,
                          rho: float) -> torch.Tensor:
    """:func:`dedup_threshold` of a batch's compact candidate window, with
    m = int(ksample * rho) (in float32) and fraud = label 1."""
    m = torch.floor(rel.ksample[batch].to(torch.float32) * rho).to(
        torch.int64)
    return dedup_threshold(m, batch_labels == 1, cand_valid.sum(dim=1),
                           cand_dist)


def scatter_batch_mask_counts(num_nodes: int, nbr: torch.Tensor,
                              keep: torch.Tensor,
                              minor_ids: torch.Tensor | None = None,
                              keep_minor: torch.Tensor | None = None):
    """(mask [B, N] float32 0/1, counts [B] float32): kept neighbors (and
    oversampled minors) as a dense mask with set semantics (duplicates give
    one 1.0), and each row's count of distinct kept ids, ``mask.sum(1)``.

    ``minor_ids`` is [M] (shared by every row) or [B, M], with
    ``keep_minor`` [B, M]; the build reads it in place as a second column
    group, so a minor that is also a kept neighbor collapses into one
    entry.  Both come from one launch of
    ``ops.mask_build.build_batch_mask_counts``.
    """
    if minor_ids is not None:
        minor_ids = minor_ids.to(torch.int32).contiguous()
        keep_minor = keep_minor.contiguous()
    return build_batch_mask_counts(nbr.to(torch.int32).contiguous(),
                                   keep.contiguous(), num_nodes, minor_ids,
                                   keep_minor)


def scatter_batch_mask(num_nodes: int, nbr: torch.Tensor, keep: torch.Tensor,
                       minor_ids: torch.Tensor | None = None,
                       keep_minor: torch.Tensor | None = None) -> torch.Tensor:
    """The mask of :func:`scatter_batch_mask_counts` alone, the JAX
    package's ``scatter_batch_mask``."""
    return scatter_batch_mask_counts(num_nodes, nbr, keep, minor_ids,
                                     keep_minor)[0]


def masked_mean_aggregate(mask: torch.Tensor, features: torch.Tensor, *,
                          norm: str = "mean",
                          counts: torch.Tensor | None = None) -> torch.Tensor:
    """[B, F] aggregate of ``features`` [N, F] through a [B, N] mask: one
    float32 GEMM, each row of the product then divided by its count
    (``mean``) or its square root (``sqrt``), counts below 1 taken as 1.

    ``counts`` [B] are the mask's row sums, as the mask build emits them;
    without them they are summed here.  The JAX package scales the mask
    before its GEMM; dividing the [B, F] product instead gives its values
    to float32 rounding and spares a pass over the [B, N] mask and a scaled
    copy of it held for the backward.  The gradient into ``features`` is
    ``mask^T @ (g / denom)``, another GEMM."""
    cnt = mask.sum(dim=1) if counts is None else counts
    return _normalized(torch.matmul(mask, features), cnt, norm)


# node-chunk width of the full-graph window mean: each chunk gathers one
# [C, D, F] float32 block (one window-gather launch in the edge-window form),
# 445 MB on yelp-like's widest relation.  Each chunk costs about nine
# launches of host time, so narrow chunks are host-bound: swept on an NVIDIA
# H100 80GB HBM3 at 700 W (chunk_sweep.py), the edge-window mean took
# 6.95 / 2.62 / 2.28 / 2.20 ms on yelp-like relation 2 and 243 / 49.3 / 15.5
# / 13.5 ms on stress-1m relation 0 at 1,024 / 4,096 / 16,384 / 65,536 nodes;
# 16,384 keeps the block a quarter of the widest one's
SPMM_NODE_CHUNK = 16384


def segment_mean_spmm(rel, features: torch.Tensor,
                      keep: torch.Tensor | None = None, *,
                      assume_ewin_features: bool = False) -> torch.Tensor:
    """[N, F] full-graph neighbor mean, h[v] = mean of x[u] over N(v).

    Three lowerings of the same math, chosen as the JAX package chooses:

      * edge-window form (``assume_ewin_features``, the relation has a
        store, no ``keep``, no hubs): each node chunk's windows come from
        the store in one window-gather fetch.  The store is a snapshot of
        the graph's features (bfloat16-rounded in a bf16 store): the
        caller asserts that ``features`` is that table;
      * window form (a dense neighbor table, no ``keep``, no hubs): each
        chunk gathers ``features[nbr2d]``;
      * segment form (everything else, including ``keep`` [E_pad] bool and
        hub relations): a sum over each row's run of the flat edge list,
        ``torch.segment_reduce`` with the CSR offsets, in place of the JAX
        package's sorted ``segment_sum``.  On the card it takes one thread
        per (row, feature) that adds the row's edges in edge order, with no
        atomics, so its result repeats bit for bit (``index_add_`` would
        add in the order its atomics land).
    """
    if rel.is_stub:
        raise ValueError("segment_mean_spmm called on a degree-only stub "
                         "relation (empty edge list); see degree_stub.")
    n = rel.num_nodes
    feats_pad = _pad_row(features)
    if keep is None and rel.nbr2d is not None and not rel.has_hubs:
        return _window_mean_all_nodes(
            rel, feats_pad,
            use_ewin=assume_ewin_features and rel.ewin is not None)
    e = rel.num_edges
    ids = rel.col[:e]
    if keep is not None:
        ids = torch.where(keep[:e], ids, n)     # dropped edges read row N
    vals = feats_pad[ids]
    offsets = rel.indptr.to(torch.int64)
    seg = torch.segment_reduce(vals, "sum", offsets=offsets, axis=0)
    cnt = (rel.deg.to(features.dtype) if keep is None else
           torch.segment_reduce(keep[:e].to(features.dtype), "sum",
                                offsets=offsets, axis=0))
    return seg / cnt.clamp(min=1.0)[:, None]


def _pad_row(features: torch.Tensor) -> torch.Tensor:
    """[N+1, F]: the features with the zero row N, the CSR padding id."""
    return torch.cat([features, features.new_zeros((1, features.shape[1]))])


def window_valid(rel, i0: int, i1: int, d: int) -> torch.Tensor:
    """[i1 - i0, d] window slots of rows i0..i1-1 below their degree
    (capped at d): the slots of a full-graph window that hold an edge."""
    cols = torch.arange(d, device=rel.deg.device)
    return cols < rel.deg[i0:i1].clamp(max=d)[:, None]


def _window_mean_all_nodes(rel, feats_pad: torch.Tensor, *,
                           use_ewin: bool = False) -> torch.Tensor:
    """[N, F] neighbor mean over every node, ``SPMM_NODE_CHUNK`` nodes at a
    time: each chunk's [C, D, F] window (from the store when ``use_ewin``,
    whose width must be F, else gathered from ``feats_pad`` [N+1, F]
    through ``nbr2d``), masked to
    each row's first min(deg, D) slots (an edge-window slot past the
    degree holds the next node's run) and averaged.  The last chunk holds
    only the remaining nodes (the JAX package clamps its ids and drops the
    extra rows); a row's value does not depend on its chunk."""
    n, d = rel.num_nodes, max(rel.window_width, 1)
    f = feats_pad.shape[1]
    out = feats_pad.new_empty((n, f))
    for i0 in range(0, n, SPMM_NODE_CHUNK):
        i1 = min(i0 + SPMM_NODE_CHUNK, n)
        valid = window_valid(rel, i0, i1, d)
        if use_ewin:
            xw = batch_feature_window(rel, None, f, starts=rel.estart[i0:i1])
        else:
            xw = feats_pad.index_select(0, rel.nbr2d[i0:i1].reshape(-1)).view(
                i1 - i0, d, f)
        num = torch.where(valid[..., None], xw, 0.0).sum(dim=1)
        torch.div(num, valid.sum(dim=1).clamp(min=1)[:, None], out=out[i0:i1])
    return out
