"""Edge scoring over whole relations: the choose step's distance
``|s0[v] - s0[u]|`` at every edge (v, u), a sampled dense-dense product of
a per-node score.

Counterpart of ``pcgnn_tpu/ops/sddmm.py``: the flat-edge form, the window
form over the dense neighbor table, its edge-window form that scores the
neighbors from the store's feature windows, and the exact per-row ranks of
the flat form.  Selection scores are the port's (``selection_score``:
float64, rounded once), so TF32 never touches them.
"""

from __future__ import annotations

import torch

from pcgnn_tpu_torch.ops.aggregate import (_INF, batch_feature_window,
                                           selection_score, window_valid)

# node-chunk width of the window forms: bounds each chunk's [C, D] gathers
# and the edge-window form's [C, D, F] feature block (one window-gather
# launch a chunk; its float64 scores take 890 MB on yelp-like's widest
# relation).  Distances are per slot, so no width changes a value.  Narrow
# chunks are host-bound: swept on an NVIDIA H100 80GB HBM3 at 700 W
# (chunk_sweep.py), the window / edge-window forms took 6.47 / 13.2,
# 1.21 / 4.01, 0.359 / 3.35 and 0.309 / 3.30 ms on yelp-like relation 2 at
# 1,024 / 4,096 / 16,384 / 65,536 nodes (stress-1m relation 0: 139 / 322,
# 26.3 / 61.5, 6.16 / 22.5, 2.04 / 20.1 ms); the mean's width keeps the
# blocks bounded alike
SDDMM_NODE_CHUNK = 16384


def edge_abs_diff(rel, s0: torch.Tensor) -> torch.Tensor:
    """[E_pad] float32 distance of each edge on the [N] score ``s0``;
    padding edges get +inf."""
    s0p = torch.cat([s0, s0.new_zeros(1)])
    row = rel.edge_rows()
    d = (s0p[row] - s0p[rel.col]).abs()
    return torch.where(row < rel.num_nodes, d, _INF)


def _chunks(n: int):
    for i0 in range(0, n, SDDMM_NODE_CHUNK):
        yield i0, min(i0 + SDDMM_NODE_CHUNK, n)


def edge_abs_diff_window(rel, s0: torch.Tensor):
    """Window form: dist[v, j] = |s0[v] - s0[nbr2d[v, j]]|.

    On a window-capped relation this scores each row's capped window only,
    the lane the batch aggregation sees.  Returns (dist [N, D] float32,
    +inf at invalid slots; valid [N, D] bool)."""
    if rel.is_stub:
        raise ValueError("edge_abs_diff_window called on a degree-only stub "
                         "relation (empty edge list); see degree_stub.")
    if rel.nbr2d is None:
        raise ValueError("edge_abs_diff_window needs the dense neighbor "
                         "table (rel.nbr2d); use edge_abs_diff for CSR-only "
                         "relations")
    n, d = rel.num_nodes, max(rel.window_width, 1)
    s0p = torch.cat([s0, s0.new_zeros(1)])
    dist = s0.new_empty((n, d))
    valid = torch.empty((n, d), dtype=torch.bool, device=s0.device)
    for i0, i1 in _chunks(n):
        valid[i0:i1] = v = window_valid(rel, i0, i1, d)
        dd = (s0[i0:i1, None] - s0p[rel.nbr2d[i0:i1]]).abs()
        dist[i0:i1] = torch.where(v, dd, _INF)
    return dist, valid


def edge_abs_diff_window_ewin(rel, s0: torch.Tensor, w0: torch.Tensor,
                              b0: torch.Tensor):
    """Edge-window form of :func:`edge_abs_diff_window`: each neighbor's
    score is computed from its row in the store's feature window,
    ``selection_score(xw, w0, b0)``, with no gather from ``s0``.  The caller
    asserts that ``s0`` scores the store's snapshot (bfloat16-rounded in a
    bf16 store) with the same ``w0``, ``b0``.  Returns (dist, valid) as the
    window form does."""
    if rel.ewin is None:
        raise ValueError("edge_abs_diff_window_ewin needs the edge-window "
                         "store (graph.csr.attach_edge_windows)")
    n, d = rel.num_nodes, max(rel.window_width, 1)
    dist = s0.new_empty((n, d))
    valid = torch.empty((n, d), dtype=torch.bool, device=s0.device)
    for i0, i1 in _chunks(n):
        valid[i0:i1] = v = window_valid(rel, i0, i1, d)
        xw = batch_feature_window(rel, None, rel.ewin_f,
                                  starts=rel.estart[i0:i1])
        dd = (s0[i0:i1, None] - selection_score(xw, w0, b0)).abs()
        dist[i0:i1] = torch.where(v, dd, _INF)
    return dist, valid


def edge_ranks_global(rel, dist: torch.Tensor) -> torch.Tensor:
    """[E_pad] int32 ascending rank of each edge's ``dist`` within its CSR
    row, ties broken by edge order; padding edges get large ranks.

    The JAX package's two-key sort (row, dist) is two stable sorts, the
    secondary key first; a sorted position less its row's first position
    is the rank, written back to each edge (the indices are a
    permutation)."""
    e = dist.shape[0]
    row = rel.edge_rows()
    by_dist = torch.sort(dist, stable=True).indices
    order = by_dist[torch.sort(row[by_dist], stable=True).indices]
    indptr_pad = torch.cat([rel.indptr, rel.indptr.new_tensor(
        [rel.num_edges])])
    pos = torch.arange(e, dtype=torch.int32, device=dist.device)
    rank_sorted = pos - indptr_pad[row[order].clamp(max=rel.num_nodes)]
    return torch.empty_like(pos).index_copy_(0, order, rank_sorted)
