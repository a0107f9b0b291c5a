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
Which relations get a store, and whether the fused record store is built,
is decided by the JAX package's byte accounting of its own layout
(``reference_store_bytes``), so both packages run the same lanes at every
budget.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from pcgnn_tpu_torch import native

# the window-gather kernel copies 16-byte vectors: runs, windows and starts
# are multiples of this many bytes
VEC_BYTES = 16

# dense neighbor-table budget (bytes); tables above it are not built, and
# the relation then reads its windows from the CSR through the ragged gather
# (``ops.aggregate.batch_neighbor_window``); it gets no edge-window store
NBR2D_BUDGET_BYTES = 512 * 1024 * 1024

# edge-window store budgets (bytes): per single store, and in total across a
# graph's relations (biggest relations first); the fused record store takes
# what the relations leave of the total
EWIN_BUDGET_BYTES = 4 * 1024 * 1024 * 1024
EWIN_TOTAL_BUDGET_BYTES = 6 * 1024 * 1024 * 1024

# sentinel-padded feature table budget (bytes): above it the table is not
# built, and a hub-free graph indexes the raw table with clamped ids instead
# (``models.pcgnn``), so that no step copies a multi-GB table
FPAD_BUDGET_BYTES = 1536 * 1024 * 1024

# kept edges per chunk of the on-device store build (bounds the [C, F]
# index temporary)
_EWIN_BUILD_CHUNK = 1 << 18
# nodes per chunk of the fused-store assembly
_FUSED_CHUNK = 2048

# the JAX package's store layout, in 4-byte words, for its byte accounting:
# runs aligned to 1024 words, the length rounded to whole 4 Mi-word build
# chunks, fused sections rounded to 128 words over whole 2048-node chunks
_REF_ALIGN = 1024
_REF_SLACK = 3072
_REF_BUILD_CHUNK = 4 * 1024 * 1024
_REF_SECTION = 128
_REF_FUSED_CHUNK = 2048
# offsets and ids are stored as int32, as in the JAX package
_INT32_MAX = 2**31 - 1


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
    # a degree-only stub: real degrees, no edge list (the JAX package's
    # ``degree_stub``); window consumers reject it
    is_stub: bool = False
    nbr2d: torch.Tensor | None = None       # [N, max(dcap, 1)] int32
    # edge-window store: flat [L] float32 or bfloat16; node v's run starts
    # at element estart[v] and holds its first min(deg, dcap) neighbors'
    # feature rows; ewin_dp is the window length in elements
    ewin: torch.Tensor | None = None
    estart: torch.Tensor | None = None      # [N] int64 element offsets
    ewin_dp: int = 0
    ewin_f: int = 0
    # whether the JAX package lays this store out with aligned runs
    # (``reference_store_bytes``): its fused record store needs them
    ewin_aligned: bool = False

    @property
    def window_width(self) -> int:
        """Batch-window width: dcap, falling back to dmax."""
        return self.dcap if self.dcap else max(self.dmax, 0)

    @property
    def has_hubs(self) -> bool:
        return self.window_width < self.dmax

    @property
    def e_pad(self) -> int:
        return int(self.col.shape[0])

    def edge_rows(self) -> torch.Tensor:
        """[E_pad] int32 CSR row of each edge, ``num_nodes`` on padding
        edges: row[e] = searchsorted(indptr, e, right) - 1."""
        e = torch.arange(self.e_pad, dtype=self.indptr.dtype,
                         device=self.indptr.device)
        row = torch.searchsorted(self.indptr, e, right=True,
                                 out_int32=True) - 1
        return torch.where(e < self.num_edges, row, self.num_nodes)

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
    # [N+1, F] features with a zero sentinel row N (the CSR padding id),
    # built once by ``materialize_edge_windows`` under ``FPAD_BUDGET_BYTES``
    features_pad: torch.Tensor | None = None

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
            fused=_to(self.fused, device),
            features_pad=_to(self.features_pad, device))

    def without_stores(self) -> "MultiRelGraph":
        """The graph with its edge-window and fused stores and its
        sentinel-padded table dropped: what the learned lane and
        ``edge_windows: false`` train on, and what a trainer builds the
        stores of its own model on."""
        drop = lambda r: dataclasses.replace(r, ewin=None, estart=None,
                                             ewin_dp=0, ewin_f=0)
        return dataclasses.replace(
            self, fused=None, fused_off=(), features_pad=None,
            homo=drop(self.homo),
            relations=tuple(drop(r) for r in self.relations))


def csr_arrays_plain(src: np.ndarray, dst: np.ndarray, num_nodes: int, *,
                     symmetrize: bool = True, add_self_loops: bool = True):
    """(indptr [N+1], col [E]) int64 of the deduplicated CSR of an edge
    list, rows sorted: the numpy version of ``native.csr_arrays``, which
    gives the same arrays (edges with an end outside [0, N) dropped,
    optional reversed copies and self-loops, set semantics)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    inside = (src >= 0) & (src < num_nodes) & (dst >= 0) & (dst < num_nodes)
    if not inside.all():
        src, dst = src[inside], dst[inside]
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if add_self_loops:
        loops = np.arange(num_nodes, dtype=np.int64)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    key = np.unique(src * num_nodes + dst)      # sorted: CSR order
    deg = np.bincount(key // num_nodes, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr, key % num_nodes


def csr_arrays(src: np.ndarray, dst: np.ndarray, num_nodes: int, *,
               symmetrize: bool = True, add_self_loops: bool = True):
    """(indptr, col) through the native graph core (``native``) when it
    loads, else through ``csr_arrays_plain``; the two are equal."""
    if native.available():
        return native.csr_arrays(src, dst, num_nodes, symmetrize=symmetrize,
                                 add_self_loops=add_self_loops)
    return csr_arrays_plain(src, dst, num_nodes, symmetrize=symmetrize,
                            add_self_loops=add_self_loops)


def csr_from_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int, *,
                   threshold: float = 0.5, add_self_loops: bool = True,
                   symmetrize: bool = True, edge_pad_multiple: int = 128,
                   window_cap: int | None = None,
                   device="cpu") -> RelGraph:
    """Build a RelGraph from a raw edge list: add self-loops, symmetrize,
    dedupe (set semantics), and lay the result out as padded CSR."""
    indptr, col = csr_arrays(src, dst, num_nodes, symmetrize=symmetrize,
                             add_self_loops=add_self_loops)
    return finalize_csr(indptr, col, num_nodes, threshold,
                        edge_pad_multiple, window_cap, device)


def csr_from_scipy(mat, *, threshold: float = 0.5, add_self_loops: bool = True,
                   symmetrize: bool = True, edge_pad_multiple: int = 128,
                   window_cap: int | None = None, device="cpu") -> RelGraph:
    """Build a RelGraph from a scipy sparse matrix (values ignored)."""
    coo = mat.tocoo()
    return csr_from_edges(
        coo.row, coo.col, mat.shape[0], threshold=threshold,
        add_self_loops=add_self_loops, symmetrize=symmetrize,
        edge_pad_multiple=edge_pad_multiple, window_cap=window_cap,
        device=device)


def csr_from_adj_dict(adj: dict, num_nodes: int, *, threshold: float = 0.5,
                      edge_pad_multiple: int = 128,
                      window_cap: int | None = None,
                      device="cpu") -> RelGraph:
    """Build a RelGraph from a reference-format adjacency dict of sets (the
    pickled ``defaultdict(set)`` files).  No self-loop or symmetry work is
    done: those files hold both.  Each row is sorted."""
    deg = np.zeros(num_nodes, dtype=np.int64)
    for n, neighs in adj.items():
        deg[int(n)] = len(neighs)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    col = np.empty(int(indptr[-1]), dtype=np.int64)
    for n, neighs in adj.items():
        s, e = indptr[int(n)], indptr[int(n) + 1]
        col[s:e] = sorted(int(x) for x in neighs)
    return finalize_csr(indptr, col, num_nodes, threshold,
                        edge_pad_multiple, window_cap, device)


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


def finalize_csr(indptr: np.ndarray, col: np.ndarray, num_nodes: int,
                 threshold: float = 0.5, edge_pad_multiple: int = 128,
                 window_cap: int | None = None, device="cpu") -> RelGraph:
    """The RelGraph of a deduplicated CSR (``csr_arrays``): degrees, the
    keep counts, the window cap, ``col`` padded with N, the dense table
    under ``NBR2D_BUDGET_BYTES``.  Offsets are stored as int32, as in the
    JAX package, so a relation holds fewer than 2^31 edges."""
    num_edges = int(indptr[-1])
    if num_edges > _INT32_MAX or num_nodes > _INT32_MAX:
        raise ValueError(
            f"a relation of {num_edges} edges over {num_nodes} nodes: its "
            f"int32 offsets and ids hold fewer than 2^31 of each")
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


def degree_stub(deg: np.ndarray, *, threshold: float = 0.5,
                device="cpu") -> RelGraph:
    """A degree-only relation: the real ``deg``/``keff``/``ksample`` and an
    edge list of sentinel ids alone (``num_edges = 0``, ``dmax = 0``, no
    dense table).  It serves where only degrees are read: the stress
    presets' homo graph feeds nothing but the pick weights.  Window
    consumers refuse it (``is_stub``).  The JAX package's stub holds 2,048
    sentinel slots, a TPU DMA-span rule; one is enough here, since the
    ragged gather returns the fill N past the end of ``col``."""
    deg = np.asarray(deg)
    n = int(deg.shape[0])
    k = np.ceil(threshold * deg).astype(np.int32)
    keff = np.where(deg <= k + 1, deg, k).astype(np.int32)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    kmax = int(k.max()) if n else 0
    return RelGraph(
        indptr=as_t(np.zeros(n + 1, np.int32)),
        col=as_t(np.full(1, n, np.int32)), deg=as_t(deg), keff=as_t(keff),
        ksample=as_t(k), num_nodes=n, num_edges=0, dmax=0, ksample_max=kmax,
        ksample_cap=kmax, is_stub=True)


def build_multirel(relations: Sequence[RelGraph], homo: RelGraph,
                   features: np.ndarray, labels: np.ndarray,
                   device="cpu") -> MultiRelGraph:
    return MultiRelGraph(
        relations=tuple(relations), homo=homo,
        features=torch.as_tensor(np.asarray(features, np.float32),
                                 device=device),
        labels=torch.as_tensor(np.asarray(labels, np.int64), device=device))


def _ref_words_per_slot(f: int, dtype: torch.dtype) -> int:
    """A neighbor slot's width in the JAX package's 4-byte words: bf16
    packs an even slot width two values to a word."""
    return (f + f % 2) // 2 if dtype == torch.bfloat16 else f


def reference_store_bytes(deg: np.ndarray, window_width: int, f: int,
                          dtype: torch.dtype, budget_bytes: int):
    """(bytes, aligned) that the JAX package's ``attach_edge_windows``
    charges for a relation's store, or None when it builds none.

    Its layout: each node's run of ``min(deg, D)`` slots starts on a
    1024-word boundary when that fits ``budget_bytes``, else exactly after
    the previous run; the length adds one window and 3,072 words of slack
    and rounds up to whole 4 Mi-word build chunks."""
    fw = _ref_words_per_slot(f, dtype)
    d = max(window_width, 1)
    dp = _round_up(d * fw, _REF_ALIGN)
    runs = np.minimum(np.asarray(deg, np.int64), d) * fw
    for aligned in (True, False):
        total = int((-(-runs // _REF_ALIGN) * _REF_ALIGN if aligned
                     else runs).sum())
        nbytes = _round_up(total + dp + _REF_SLACK, _REF_BUILD_CHUNK) * 4
        if nbytes <= budget_bytes:
            return nbytes, aligned
    return None


def _ref_charge(rel: RelGraph, f: int, dtype: torch.dtype,
                budget_bytes: int):
    """``reference_store_bytes`` of a relation that can carry a store; None
    for a stub or a relation without a dense neighbor table."""
    if rel.is_stub or rel.nbr2d is None:
        return None
    return reference_store_bytes(rel.deg.cpu().numpy(), rel.window_width, f,
                                 dtype, budget_bytes)


def attach_edge_windows(rel: RelGraph, features: torch.Tensor, *,
                        budget_bytes: int = EWIN_BUDGET_BYTES,
                        dtype: torch.dtype = torch.float32) -> RelGraph:
    """Materialize the relation's neighbor feature rows in CSR edge order,
    on the features' device.

    Valid only for frozen features: the store is a snapshot.  Node v's run
    holds ``min(deg, dcap)`` rows of F values, starting on a 16-byte
    boundary; the tail keeps one window of slack so the last window's
    read stays in bounds.  ``dtype`` bfloat16 rounds the stored values to
    nearest even; a consumer that wants float32 widens in the fetch.

    Returns the relation unchanged when it is a stub, has no dense neighbor
    table or the JAX package's store of it would exceed ``budget_bytes``
    (``reference_store_bytes``; this layout's own bytes decide nothing).
    """
    _check_store_dtype(dtype)
    charge = _ref_charge(rel, int(features.shape[1]), dtype, budget_bytes)
    if charge is None:
        return rel
    return _build_store(rel, features, dtype, aligned=charge[1])


def _check_store_dtype(dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"edge-window store dtype must be float32 or "
                         f"bfloat16, got {dtype}")


def _build_store(rel: RelGraph, features: torch.Tensor, dtype: torch.dtype,
                 *, aligned: bool) -> RelGraph:
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
                               ewin_f=f, ewin_aligned=aligned)


def materialize_edge_windows(graph: MultiRelGraph, *,
                             budget_bytes: int = EWIN_BUDGET_BYTES,
                             total_budget_bytes: int = EWIN_TOTAL_BUDGET_BYTES,
                             dtype: torch.dtype = torch.float32,
                             fused: bool = True, relations: bool = True,
                             homo: bool = False) -> MultiRelGraph:
    """Attach edge-window stores to the relations, biggest first, until the
    total budget is spent, then the fused record store from what is left;
    and the sentinel-padded table ``features_pad`` under
    ``FPAD_BUDGET_BYTES``.  Must run after any feature transformation (the
    stores snapshot the features).

    The JAX package builds every store for every model.  The port builds
    what the model reads, since parity is on values, not layouts: PC-GNN
    reads the relations' stores (``relations``) and only the homo graph's
    degrees; GraphSAGE and GCN read only the homo graph's store (``homo``).
    Coverage follows the JAX package's accounting of its own stores
    (``reference_store_bytes``): each relation it would store is charged
    to the total, built or not, so the homo store gets what the relations'
    stores leave, and is the relation's own when homo is one of them.
    """
    _check_store_dtype(dtype)
    f = graph.feat_dim
    remaining = total_budget_bytes
    rels = list(graph.relations)
    charges = {}
    for i in sorted(range(len(rels)), key=lambda i: -rels[i].num_edges):
        charge = _ref_charge(rels[i], f, dtype, min(budget_bytes, remaining))
        if charge is None:
            continue
        remaining -= charge[0]
        charges[i] = charge
        if relations:
            rels[i] = _build_store(rels[i], graph.features, dtype,
                                   aligned=charge[1])
    shared = next((i for i, old in enumerate(graph.relations)
                   if old is graph.homo), None)
    if shared is not None:
        homo_rel = rels[shared]
        if homo and homo_rel.ewin is None and shared in charges:
            homo_rel = _build_store(homo_rel, graph.features, dtype,
                                    aligned=charges[shared][1])
    elif homo:
        homo_rel = attach_edge_windows(
            graph.homo, graph.features,
            budget_bytes=min(budget_bytes, remaining), dtype=dtype)
    else:
        homo_rel = graph.homo
    fused_arr, fused_off = (_build_fused_store(rels, graph.num_nodes,
                                               remaining)
                            if fused and relations else (None, ()))
    fpad = None
    if graph.features.numel() * 4 <= FPAD_BUDGET_BYTES:
        x = graph.features
        fpad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return dataclasses.replace(graph, relations=tuple(rels), homo=homo_rel,
                               fused=fused_arr, fused_off=fused_off,
                               features_pad=fpad)


def _build_fused_store(rels, num_nodes: int, budget_bytes: int):
    """[N, W] record store: row v concatenates each relation's window
    ``ewin_r[estart_r[v] : estart_r[v] + dp_r]``.  W stays a multiple of
    16 bytes, so record v starts 16-byte aligned at element v * W.

    Built when the JAX package builds its own: every relation's store is
    aligned in its accounting and its record table (sections of whole 128
    words, over whole 2048-node chunks) fits ``budget_bytes``."""
    from pcgnn_tpu_torch.ops.window_gather import window_gather

    if (not rels or num_nodes == 0
            or any(r.ewin is None or not r.ewin_aligned for r in rels)):
        return None, ()
    dtype, dev = rels[0].ewin.dtype, rels[0].ewin.device
    ref_w = sum(_round_up(max(r.window_width, 1)
                          * _ref_words_per_slot(r.ewin_f, dtype), _REF_SECTION)
                for r in rels)
    if _round_up(num_nodes, _REF_FUSED_CHUNK) * ref_w * 4 > budget_bytes:
        return None, ()
    off = tuple(int(x) for x in np.cumsum([0] + [r.ewin_dp for r in rels]))
    w = off[-1]
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
