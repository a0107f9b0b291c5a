"""Static padded CSR graph store, as dataclasses of tensors.

Counterpart of ``pcgnn_tpu/graph/csr.py``.  Each relation is an immutable
CSR built once on the host with numpy and then moved to ``device``:

  * ``indptr [N+1]``, ``col [E_pad]`` (padding = N), ``deg [N]``;
  * ``keff [N]``    — neighbors the choose step keeps:
        k = ceil(threshold * deg);  keff = deg if deg <= k + 1 else k;
  * ``ksample [N]`` — k itself, the oversample base count;
  * ``nbr2d [N, dcap]`` — dense neighbor table (padding = N).

The edge-window store (``attach_edge_windows``) lays the frozen feature rows
out in CSR edge order, so one batch row's neighbor-feature window is one
contiguous run that ``ops.window_gather`` copies with 16-byte vectors.  The
GPU layout differs from the TPU one in three ways: bf16 is stored natively
(no two-per-f32-word packing), each node's run starts on a 16-byte boundary
(not a 1024-element one), and there is no ``node_pack`` table (a GPU row
gather has no fixed per-dispatch cost to amortize).  Values are identical.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

# the window-gather kernel copies 16-byte vectors: runs, windows and starts
# are multiples of this many bytes
VEC_BYTES = 16

# dense neighbor-table budget (bytes); tables above it are not built, which
# the port does not support yet (the CSR lane, ROADMAP module 8)
NBR2D_BUDGET_BYTES = 512 * 1024 * 1024

# edge-window store budgets (bytes): per single store, and in total across a
# graph's relations (biggest relations first); the fused record store takes
# what the relations leave of the total
EWIN_BUDGET_BYTES = 4 * 1024 * 1024 * 1024
EWIN_TOTAL_BUDGET_BYTES = 6 * 1024 * 1024 * 1024

# kept edges per chunk of the on-device store build (bounds the [C, F]
# index temporary)
_EWIN_BUILD_CHUNK = 1 << 18
# nodes per chunk of the fused-store assembly
_FUSED_CHUNK = 2048


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to(x, device):
    return None if x is None else x.to(device)


@dataclasses.dataclass(frozen=True)
class RelGraph:
    """One relation's static CSR (tensors on one device)."""

    indptr: torch.Tensor   # [N+1] int32
    col: torch.Tensor      # [E_pad] int32, padding = N
    deg: torch.Tensor      # [N] int32
    keff: torch.Tensor     # [N] int32
    ksample: torch.Tensor  # [N] int32: ceil(threshold*deg)
    num_nodes: int
    num_edges: int
    dmax: int
    ksample_max: int = 0
    # bound on ksample over window-lane rows (deg <= dcap); 0 = ksample_max
    ksample_cap: int = 0
    # batch-window width; 0 = dmax.  dcap < dmax means hub rows exist
    dcap: int = 0
    nbr2d: torch.Tensor | None = None       # [N, max(dcap, 1)] int32
    # edge-window store: flat [L] float32 or bfloat16; node v's run starts
    # at element estart[v] and holds its first min(deg, dcap) neighbors'
    # feature rows; ewin_dp is the window length in elements
    ewin: torch.Tensor | None = None
    estart: torch.Tensor | None = None      # [N] int64 element offsets
    ewin_dp: int = 0
    ewin_f: int = 0

    @property
    def window_width(self) -> int:
        """Batch-window width: dcap, falling back to dmax."""
        return self.dcap if self.dcap else max(self.dmax, 0)

    @property
    def has_hubs(self) -> bool:
        return self.window_width < self.dmax

    def to(self, device) -> "RelGraph":
        return dataclasses.replace(
            self, indptr=self.indptr.to(device), col=self.col.to(device),
            deg=self.deg.to(device), keff=self.keff.to(device),
            ksample=self.ksample.to(device), nbr2d=_to(self.nbr2d, device),
            ewin=_to(self.ewin, device), estart=_to(self.estart, device))


@dataclasses.dataclass(frozen=True)
class MultiRelGraph:
    """Multi-relation graph plus node features and labels."""

    relations: tuple          # tuple[RelGraph, ...]
    homo: RelGraph
    features: torch.Tensor    # [N, F] float32
    labels: torch.Tensor      # [N] int64
    # fused record store: row v = every relation's edge window, relation r
    # in columns [fused_off[r], fused_off[r+1]); one row fetch per batch row
    # brings all relations' windows
    fused: torch.Tensor | None = None       # [N, W]
    fused_off: tuple = ()

    @property
    def num_nodes(self) -> int:
        return self.homo.num_nodes

    @property
    def num_relations(self) -> int:
        return len(self.relations)

    @property
    def feat_dim(self) -> int:
        return int(self.features.shape[1])

    def to(self, device) -> "MultiRelGraph":
        rels = tuple(r.to(device) for r in self.relations)
        homo = next((new for old, new in zip(self.relations, rels)
                     if old is self.homo), None) or self.homo.to(device)
        return dataclasses.replace(
            self, relations=rels, homo=homo,
            features=self.features.to(device), labels=self.labels.to(device),
            fused=_to(self.fused, device))


def csr_from_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int, *,
                   threshold: float = 0.5, add_self_loops: bool = True,
                   symmetrize: bool = True, edge_pad_multiple: int = 128,
                   window_cap: int | None = None,
                   device="cpu") -> RelGraph:
    """Build a RelGraph from a raw edge list: add self-loops, symmetrize,
    dedupe (set semantics), and lay the result out as padded CSR."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if add_self_loops:
        loops = np.arange(num_nodes, dtype=np.int64)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    key = np.unique(src * num_nodes + dst)      # sorted: CSR order
    src = key // num_nodes
    dst = key % num_nodes
    deg = np.bincount(src, minlength=num_nodes).astype(np.int64)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    return _finalize(indptr, dst, num_nodes, threshold, edge_pad_multiple,
                     window_cap, device)


def _dense_neighbor_table(indptr: np.ndarray, col: np.ndarray,
                          num_nodes: int, width: int) -> np.ndarray | None:
    """[N, width] neighbor table; rows longer than ``width`` keep their
    first ``width`` CSR entries.  None above ``NBR2D_BUDGET_BYTES``."""
    d = max(width, 1)
    if num_nodes * d * 4 > NBR2D_BUDGET_BYTES:
        return None
    nbr2d = np.full((num_nodes, d), num_nodes, dtype=np.int32)
    if len(col):
        rows = np.repeat(np.arange(num_nodes), np.diff(indptr))
        slots = np.arange(len(col)) - indptr[rows]
        fit = slots < d
        nbr2d[rows[fit], slots[fit]] = col[fit]
    return nbr2d


def _window_cap(deg: np.ndarray, dmax: int, window_cap: int | None) -> int:
    """Batch-window width policy: near-uniform degrees keep dcap == dmax;
    heavy tails cap at about the p99.5 degree."""
    if window_cap is not None:
        return min(int(window_cap), dmax)
    if dmax <= 128 or deg.size == 0:
        return dmax
    cap = _round_up(max(int(np.percentile(deg, 99.5)), 16), 16)
    return dmax if dmax <= 2 * cap else cap


def _finalize(indptr: np.ndarray, col: np.ndarray, num_nodes: int,
              threshold: float, edge_pad_multiple: int,
              window_cap: int | None = None, device="cpu") -> RelGraph:
    num_edges = int(indptr[-1])
    deg = np.diff(indptr).astype(np.int32)
    k = np.ceil(threshold * deg).astype(np.int32)
    keff = np.where(deg <= k + 1, deg, k).astype(np.int32)
    dmax = int(deg.max()) if num_nodes else 0
    dcap = _window_cap(deg, dmax, window_cap)
    # one full window of padding past the last edge keeps any row's window
    # read in bounds
    e_pad = _round_up(max(num_edges, 1) + max(dmax, 1),
                      math.lcm(max(edge_pad_multiple, 1), 128))
    col_p = np.full(e_pad, num_nodes, dtype=np.int32)
    col_p[:num_edges] = col
    nbr2d = _dense_neighbor_table(indptr, col[:num_edges], num_nodes, dcap)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return RelGraph(
        indptr=as_t(indptr), col=as_t(col_p), deg=as_t(deg), keff=as_t(keff),
        ksample=as_t(k), num_nodes=num_nodes, num_edges=num_edges, dmax=dmax,
        ksample_max=int(k.max()) if num_nodes else 0,
        ksample_cap=int(k[deg <= dcap].max(initial=0)) if num_nodes else 0,
        dcap=dcap, nbr2d=as_t(nbr2d) if nbr2d is not None else None)


def build_multirel(relations: Sequence[RelGraph], homo: RelGraph,
                   features: np.ndarray, labels: np.ndarray,
                   device="cpu") -> MultiRelGraph:
    return MultiRelGraph(
        relations=tuple(relations), homo=homo,
        features=torch.as_tensor(np.asarray(features, np.float32),
                                 device=device),
        labels=torch.as_tensor(np.asarray(labels, np.int64), device=device))


def attach_edge_windows(rel: RelGraph, features: torch.Tensor, *,
                        budget_bytes: int = EWIN_BUDGET_BYTES,
                        dtype: torch.dtype = torch.float32) -> RelGraph:
    """Materialize the relation's neighbor feature rows in CSR edge order,
    on the features' device.

    Valid only for frozen features: the store is a snapshot.  Node v's run
    holds ``min(deg, dcap)`` rows of F values, starting on a 16-byte
    boundary; the tail keeps one window of slack so the last window's
    read stays in bounds.  ``dtype`` bfloat16 rounds the stored values to
    nearest even; consumers upcast to float32 after the fetch.

    Returns the relation unchanged when it has no dense neighbor table or
    the store would exceed ``budget_bytes``.
    """
    if rel.nbr2d is None:
        return rel
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"edge-window store dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    dev = features.device
    esize = torch.empty((), dtype=dtype).element_size()
    a = VEC_BYTES // esize                     # elements per 16-byte vector
    n, f = features.shape
    d = max(rel.window_width, 1)
    dp = _round_up(d * f, a)
    degc = rel.deg.to(dev, torch.int64).clamp(max=d)
    runs = (degc * f + a - 1) // a * a
    estart = torch.cumsum(runs, 0) - runs
    length = int(runs.sum()) + dp
    if length * esize > budget_bytes:
        return rel
    flat = torch.zeros(length, dtype=dtype, device=dev)
    feats = features.to(dtype)
    # every kept edge slot (v, j < degc[v]) copies features[col[indptr[v]+j]]
    # to flat[estart[v] + j*f : ... + f]
    rows = torch.repeat_interleave(torch.arange(n, device=dev), degc)
    first = torch.cumsum(degc, 0) - degc
    slot = torch.arange(rows.numel(), device=dev) - first[rows]
    src = rel.col.to(dev, torch.int64)[rel.indptr.to(dev, torch.int64)[rows]
                                       + slot]
    dst = estart[rows] + slot * f
    cols = torch.arange(f, device=dev)
    for c0 in range(0, rows.numel(), _EWIN_BUILD_CHUNK):
        c1 = c0 + _EWIN_BUILD_CHUNK
        flat[dst[c0:c1, None] + cols] = feats[src[c0:c1]]
    return dataclasses.replace(rel, ewin=flat, estart=estart, ewin_dp=dp,
                               ewin_f=f)


def materialize_edge_windows(graph: MultiRelGraph, *,
                             budget_bytes: int = EWIN_BUDGET_BYTES,
                             total_budget_bytes: int = EWIN_TOTAL_BUDGET_BYTES,
                             dtype: torch.dtype = torch.float32,
                             fused: bool = True) -> MultiRelGraph:
    """Attach edge-window stores to the relations, biggest first, until the
    total budget is spent, then the fused record store from what is left.
    Must run after any feature transformation (the stores snapshot the
    features).  The homo graph gets no store: PC-GNN reads only its
    degrees."""
    remaining = total_budget_bytes
    rels = list(graph.relations)
    for i in sorted(range(len(rels)), key=lambda i: -rels[i].num_edges):
        r2 = attach_edge_windows(rels[i], graph.features,
                                 budget_bytes=min(budget_bytes, remaining),
                                 dtype=dtype)
        if r2.ewin is not None:
            remaining -= r2.ewin.numel() * r2.ewin.element_size()
        rels[i] = r2
    homo = next((new for old, new in zip(graph.relations, rels)
                 if old is graph.homo), graph.homo)
    fused_arr, fused_off = (_build_fused_store(rels, graph.num_nodes,
                                               remaining)
                            if fused else (None, ()))
    return dataclasses.replace(graph, relations=tuple(rels), homo=homo,
                               fused=fused_arr, fused_off=fused_off)


def _build_fused_store(rels, num_nodes: int, budget_bytes: int):
    """[N, W] record store: row v concatenates each relation's window
    ``ewin_r[estart_r[v] : estart_r[v] + dp_r]``.  W stays a multiple of
    16 bytes, so record v starts 16-byte aligned at element v * W."""
    from pcgnn_tpu_torch.ops.window_gather import window_gather

    if not rels or num_nodes == 0 or any(r.ewin is None for r in rels):
        return None, ()
    dtype, dev = rels[0].ewin.dtype, rels[0].ewin.device
    off = tuple(int(x) for x in np.cumsum([0] + [r.ewin_dp for r in rels]))
    w = off[-1]
    if num_nodes * w * rels[0].ewin.element_size() > budget_bytes:
        return None, ()
    out = torch.empty((num_nodes, w), dtype=dtype, device=dev)
    for i0 in range(0, num_nodes, _FUSED_CHUNK):
        i1 = min(i0 + _FUSED_CHUNK, num_nodes)
        for r, rel in enumerate(rels):
            out[i0:i1, off[r]:off[r + 1]] = window_gather(
                rel.ewin, rel.estart[i0:i1], rel.ewin_dp)
    return out, off


def rel_threshold(threshold, r) -> float:
    """Resolve a scalar-or-per-relation choose threshold; ``r=None`` (the
    homo graph) resolves a list to the 0.5 default."""
    if isinstance(threshold, (list, tuple)):
        return 0.5 if r is None else float(threshold[r])
    return float(threshold)
