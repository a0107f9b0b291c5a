"""Sharded PC-GNN and GraphSAGE/GCN steps over a mesh of ranks.

Counterpart of ``pcgnn_tpu/parallel/spmd.py``.  Each rank is one process on
one device (``parallel.mesh``); the JAX package's ``shard_map`` body runs
here eagerly on every rank, with its collectives as explicit calls.

Layout over the (dcn, data, graph) mesh:
  * batch / labels / weights : every rank is given the full [B] arrays and
    takes its contiguous block over the data axes, [B/dd];
  * node features            : row block ``g`` of [N_pad, F] on graph rank g;
  * graph structure          : each relation is a :class:`ShardedRel` that
    holds only this rank's row block of ``nbr2d``/``deg``/``keff``/
    ``ksample`` and of the edge-window store; the hub sub-CSR of a
    window-capped relation is replicated;
  * parameters               : replicated, an ``nn.Module`` on every rank.

Per relation one of three lanes, as in the JAX package:
  fast lane (a sharded store): the owner of a batch row fetches its window
    from the local store (the fused record table, kernel 1a, or the
    relation's store, kernel 1c with ``active`` = owned rows when dg > 1),
    chooses and sums locally, and publishes (sum, count) in the packed
    output sum;
  plain lane (no store): the owner chooses from its ``nbr2d`` block and the
    all-gathered score table and publishes the kept ids; every rank sums
    the kept rows of its own block;
  hub lane (rows above the window cap): every graph rank runs the same
    choose sweep over the replicated hub sub-CSR (kernel 2 fetches each
    chunk's edge tails) and sums the neighbors in its own block; the graph
    leader alone adds the replicated minor band.  Its chunks come from the
    caller's ``hub_plans`` (one plan a stack of batches,
    :func:`spmd_epoch_hub_plans`), or from the batch's own, read back.

In training a row's owner adds the row's oversampled minors of every
relation, as the single device does (``ops.aggregate.
oversample_minor_sums``, one kernel on the card), from the replicated
train-positive rows.

Collectives are batched as in the JAX package: one packed [Bd, 3R]
metadata sum, one packed [Bd, R(F+1)] output sum, plus the self-feature
and train-positive owner picks and, where a plain or hub lane needs it,
the [N_pad] score all-gather.  Those whose inputs exist at the start of
the step are issued there and waited at first use, with the
halo-independent work between (``RankMesh.overlap``,
``parallel.distributed``: the JAX package's collective overlap).

Gradients: no collective carries one.  Selection is detached and the
features are frozen, so everything the parameters touch comes after the
graph collectives and is the same on every rank of a graph group.  Each
rank takes the backward of ``Σ_local ce·w / den`` (``den`` summed over the
data axes without gradient); one flattened sum over the data axes then
completes the gradients (:func:`data_sum_grads`), and every rank runs the
same Adam step on them, so the replicas stay bit-equal.

Selection precision follows the JAX SPMD rule: a bfloat16 store on ANY
relation makes every selection score rank the bf16-rounded snapshot
(``spmd.py:675-677``); the single-device path does so only when every
relation has a store.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pcgnn_tpu_torch.graph.csr import _build_store, _ref_words_per_slot
from pcgnn_tpu_torch.ops.aggregate import (
    _INF,
    choose_window_sum,
    keep_nearest,
    oversample_minor_keeps,
    oversample_minor_sums,
    rank_train_positives,
    selection_score,
    unpack_window,
    window_sum_from_gathered,
)
from pcgnn_tpu_torch.ops.hub import (HUB_BLOCK, HUB_CHUNK, chunk_minor_band,
                                     keep_nearest_switch, run_hub_chunks,
                                     stack_hub_plans)
from pcgnn_tpu_torch.ops.ragged_gather import ragged_gather
from pcgnn_tpu_torch.ops.window_gather import window_gather
from pcgnn_tpu_torch.parallel.mesh import RankMesh

# sharded edge-window store budget (bytes ACROSS the mesh, in the JAX
# package's accounting of its own layout); relations whose store would
# exceed it run the plain lane
SPMD_EWIN_BUDGET_BYTES = 8 * 1024 * 1024 * 1024

# the JAX package's sharded store layout, in 4-byte words: runs aligned to
# 1024 words, one window and 3,072 words of slack per block; fused record
# sections of whole 128 words
_REF_ALIGN = 1024
_REF_SLACK = 3072
_REF_SECTION = 128
# nodes per chunk of the fused record assembly
_FUSED_CHUNK = 2048


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShardedRel:
    """One relation's structure on one graph rank: its row block of the
    dense neighbor table (global ids, padding N) and of the per-node
    vectors, padded to ``block`` rows (zero degree).

    A window-capped relation also carries the compact hub sub-CSR
    (``hub_*``), replicated: the full neighbor lists of the rows above the
    cap, and this block's node -> hub-slot map ``hub_idx`` (-1 for other
    rows).  With a store, ``ewin`` is this block's edge-window store in the
    port's layout (runs on 16-byte boundaries, bf16 stored natively) and
    ``estart`` its LOCAL element offsets."""

    nbr2d: torch.Tensor     # [block, D] int32
    deg: torch.Tensor       # [block] int32
    keff: torch.Tensor      # [block] int32
    ksample: torch.Tensor   # [block] int32
    num_nodes: int
    width: int
    ksample_max: int = 0
    ksample_cap: int = 0
    dmax: int = 0
    hub_idx: Optional[torch.Tensor] = None      # [block] int32
    hub_start: Optional[torch.Tensor] = None    # [H] int64, into hub_col
    hub_col: Optional[torch.Tensor] = None      # [Eh] int32
    hub_deg: Optional[torch.Tensor] = None      # [H] int32
    hub_keff: Optional[torch.Tensor] = None     # [H] int32
    hub_ksample: Optional[torch.Tensor] = None  # [H] int32
    ewin: Optional[torch.Tensor] = None         # [Lb] float32 / bfloat16
    estart: Optional[torch.Tensor] = None       # [block] int64, local
    ewin_dp: int = 0
    ewin_f: int = 0

    @property
    def has_hubs(self) -> bool:
        return self.hub_col is not None

    @property
    def window_width(self) -> int:
        return self.width

    @property
    def packed(self) -> bool:
        """A bfloat16 store (the JAX package packs it two to a word)."""
        return self.ewin is not None and self.ewin.dtype == torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Everything one rank holds of a sharded graph: its feature block
    ``x_local`` [block, F], the relations' shards (PC-GNN) or the homo
    graph's (GCN, GraphSAGE), the fused record block [block, W] when
    built, and the full labels (replicated)."""

    mesh: RankMesh
    n_pad: int
    x_local: torch.Tensor
    labels: torch.Tensor
    shards: tuple = ()
    homo: Optional[ShardedRel] = None
    fused: Optional[torch.Tensor] = None
    fused_off: tuple = ()

    @property
    def block(self) -> int:
        return self.n_pad // self.mesh.dg

    @property
    def col_lo(self) -> int:
        return self.mesh.graph_index * self.block


def pad_graph_for_mesh(graph, mesh: RankMesh, device=None):
    """(x_local [block, F] on ``device``, N_pad): the feature rows padded
    to a multiple of the graph axis, this rank's block of them."""
    dg = mesh.dg
    n = graph.num_nodes
    n_pad = _round_up(n, dg)
    block = n_pad // dg
    lo = mesh.graph_index * block
    feats = graph.features
    x = feats[lo: min(lo + block, n)]
    if x.shape[0] < block:
        x = torch.cat([x, x.new_zeros((block - x.shape[0], x.shape[1]))])
    dev = feats.device if device is None else device
    return x.to(dev).contiguous(), n_pad


def shard_relation(rel, mesh: RankMesh, n_pad: int,
                   features: Optional[torch.Tensor] = None, *,
                   edge_windows: bool = True,
                   ewin_dtype: torch.dtype = torch.float32,
                   ewin_budget_bytes: int = SPMD_EWIN_BUDGET_BYTES,
                   device=None) -> ShardedRel:
    """This rank's row block of one relation (``graph.csr.RelGraph``).

    The dense [N, D] neighbor table (D = dcap; hub rows keep their first D
    slots here and their full lists in the hub sub-CSR) and deg/keff/
    ksample become block arrays on ``device``.  With ``features`` and
    ``edge_windows`` the block's edge-window store is built too, when the
    JAX package's sharded store of the relation fits
    ``ewin_budget_bytes`` (:func:`reference_sharded_store_bytes`)."""
    if rel.is_stub:
        raise ValueError("cannot shard a degree-only stub relation "
                         "(graph.csr.degree_stub): it has no edges")
    dev = rel.deg.device if device is None else torch.device(device)
    dg = mesh.dg
    block = n_pad // dg
    n, d = rel.num_nodes, max(rel.window_width, 1)
    lo = mesh.graph_index * block
    hi = min(lo + block, n)
    indptr = rel.indptr.cpu().numpy().astype(np.int64)
    col = rel.col[: rel.num_edges].cpu().numpy()
    deg_np = rel.deg.cpu().numpy()
    if rel.nbr2d is not None:
        nbr = rel.nbr2d[lo:hi].cpu().numpy()
    else:
        # beyond the single-device table budget: this block's rows only
        nbr = np.full((max(hi - lo, 0), d), n, np.int32)
        cnt = np.minimum(deg_np[lo:hi], d)
        rows = np.repeat(np.arange(hi - lo), cnt)
        slots = np.arange(len(rows)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        nbr[rows, slots] = col[indptr[lo + rows] + slots]

    def blockvec(v, fill=0):
        v = np.asarray(v)[lo:hi]
        out = np.full(block, fill, v.dtype)
        out[: len(v)] = v
        return out

    nbr2d = np.full((block, d), n, np.int32)
    nbr2d[: len(nbr)] = nbr
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    hub_kw = (_build_hub_shard(rel, indptr, col, deg_np, blockvec, put)
              if rel.has_hubs else {})
    ewin_kw = {}
    if edge_windows and features is not None:
        ewin_kw = _build_sharded_ewin(rel, deg_np, features, mesh, n_pad,
                                      ewin_dtype, ewin_budget_bytes, dev)
    return ShardedRel(
        nbr2d=put(nbr2d), deg=put(blockvec(deg_np)),
        keff=put(blockvec(rel.keff.cpu().numpy())),
        ksample=put(blockvec(rel.ksample.cpu().numpy())),
        num_nodes=n, width=d, ksample_max=rel.ksample_max,
        ksample_cap=rel.ksample_cap, dmax=rel.dmax, **hub_kw, **ewin_kw)


def _build_hub_shard(rel, indptr, col, deg_np, blockvec, put) -> dict:
    """The compact hub sub-CSR (full neighbor lists of the rows above the
    cap, replicated) and this block's node -> hub-slot map.  The ragged
    gather reads N past the end of ``hub_col``, so it carries no tail
    padding."""
    d = max(rel.window_width, 1)
    hub_rows = np.flatnonzero(deg_np > d)
    h = len(hub_rows)
    hub_deg = deg_np[hub_rows].astype(np.int32)
    hub_start = np.cumsum(hub_deg, dtype=np.int64) - hub_deg
    hub_col = np.full(max(int(hub_deg.sum()), 1), rel.num_nodes, np.int32)
    for i, v in enumerate(hub_rows):
        s = int(hub_start[i])
        hub_col[s: s + hub_deg[i]] = col[indptr[v]: indptr[v] + hub_deg[i]]
    hub_idx = np.full(len(deg_np), -1, np.int32)
    hub_idx[hub_rows] = np.arange(h, dtype=np.int32)
    # one zero-degree slot keeps the clipped slot of a non-hub row valid
    pad1 = lambda a: np.concatenate([a, np.zeros(1, a.dtype)])
    return dict(
        hub_idx=put(blockvec(hub_idx, fill=-1)),
        hub_start=put(pad1(hub_start)),
        hub_col=put(hub_col),
        hub_deg=put(pad1(hub_deg)),
        hub_keff=put(pad1(rel.keff.cpu().numpy()[hub_rows])),
        hub_ksample=put(pad1(rel.ksample.cpu().numpy()[hub_rows])))


def reference_sharded_store_bytes(deg: np.ndarray, window_width: int,
                                  f: int, dtype: torch.dtype, dg: int,
                                  n_pad: int) -> int:
    """Bytes the JAX package's ``_build_sharded_ewin`` charges for a
    relation's store across a graph axis of ``dg``: dg blocks of the
    longest block's length, each node's run of ``min(deg, D)`` slots
    aligned to 1024 words, plus one window and 3,072 words, rounded to
    1024 words (``spmd.py:316-329``)."""
    fw = _ref_words_per_slot(f, dtype)
    d = max(window_width, 1)
    dp = _round_up(d * fw, _REF_ALIGN)
    degc = np.zeros(n_pad, np.int64)
    degc[: len(deg)] = np.minimum(np.asarray(deg, np.int64), d)
    runs = -(-degc * fw // _REF_ALIGN) * _REF_ALIGN
    block_lens = runs.reshape(dg, n_pad // dg).sum(axis=1)
    lb = _round_up(int(block_lens.max()) + dp + _REF_SLACK, _REF_ALIGN)
    return lb * dg * 4


def _build_sharded_ewin(rel, deg_np, features, mesh, n_pad, dtype,
                        budget_bytes, dev) -> dict:
    """This block's edge-window store, when the JAX package's sharded store
    of the relation fits the budget.  Built as the single-device store of
    the relation with every row outside the block at degree 0, so the
    block's runs start at offset 0 and ``estart`` is local."""
    f = int(features.shape[1])
    nbytes = reference_sharded_store_bytes(deg_np, rel.window_width, f,
                                           dtype, mesh.dg, n_pad)
    if nbytes > budget_bytes:
        return {}
    block = n_pad // mesh.dg
    lo = mesh.graph_index * block
    hi = min(lo + block, rel.num_nodes)
    masked = torch.zeros(rel.num_nodes, dtype=torch.int32)
    masked[lo:hi] = rel.deg[lo:hi].cpu()
    part = dataclasses.replace(
        rel, indptr=rel.indptr.to(dev), col=rel.col.to(dev),
        deg=masked.to(dev), nbr2d=None, ewin=None, estart=None)
    built = _build_store(part, features.to(dev), dtype, aligned=True)
    estart = torch.zeros(block, dtype=torch.int64, device=dev)
    estart[: hi - lo] = built.estart[lo:hi]
    return dict(ewin=built.ewin, estart=estart, ewin_dp=built.ewin_dp,
                ewin_f=f)


def build_sharded_fused(shards: tuple, n_pad: int, *,
                        budget_bytes: int = SPMD_EWIN_BUDGET_BYTES):
    """(fused [block, W], off) — this block's fused record table: row i
    concatenates every relation's window of local node i, relation r in
    columns [off[r], off[r+1]), so one fetch per batch row brings all
    relations' windows.  Built from the block stores with the window
    gather.  (None, ()) when a relation has no store or the JAX package's
    table (sections of whole 128 words, ``spmd.py:382-389``) exceeds
    ``budget_bytes``."""
    if not shards or any(sh.ewin is None for sh in shards):
        return None, ()
    ref_w = sum(_round_up(max(sh.width, 1)
                          * _ref_words_per_slot(sh.ewin_f, sh.ewin.dtype),
                          _REF_SECTION) for sh in shards)
    if n_pad * ref_w * 4 > budget_bytes:
        return None, ()
    off = tuple(int(x) for x in np.cumsum([0] + [sh.ewin_dp
                                                 for sh in shards]))
    block = int(shards[0].deg.shape[0])
    out = torch.empty((block, off[-1]), dtype=shards[0].ewin.dtype,
                      device=shards[0].ewin.device)
    for i0 in range(0, block, _FUSED_CHUNK):
        i1 = min(i0 + _FUSED_CHUNK, block)
        for r, sh in enumerate(shards):
            out[i0:i1, off[r]:off[r + 1]] = window_gather(
                sh.ewin, sh.estart[i0:i1], sh.ewin_dp)
    return out, off


def shard_relations(graph, mesh: RankMesh, n_pad: int, *,
                    edge_windows: bool = True,
                    ewin_dtype: torch.dtype = torch.float32,
                    ewin_budget_bytes: int = SPMD_EWIN_BUDGET_BYTES,
                    device=None) -> tuple:
    feats = graph.features if edge_windows and graph.num_relations else None
    return tuple(
        shard_relation(r, mesh, n_pad, feats, edge_windows=edge_windows,
                       ewin_dtype=ewin_dtype,
                       ewin_budget_bytes=ewin_budget_bytes, device=device)
        for r in graph.relations)


def shard_graph(graph, mesh: RankMesh, *, pcgnn: bool = True,
                edge_windows: bool = True,
                ewin_dtype: torch.dtype = torch.float32,
                ewin_budget_bytes: int = SPMD_EWIN_BUDGET_BYTES,
                fused: bool = True, device=None) -> ShardedGraph:
    """This rank's :class:`ShardedGraph` of ``graph`` (a
    ``graph.csr.MultiRelGraph`` on any device): PC-GNN's relations (and
    the fused record table, with ``fused``) or, for GCN and GraphSAGE, the
    homo graph."""
    x_local, n_pad = pad_graph_for_mesh(graph, mesh, device)
    dev = x_local.device
    kw = dict(edge_windows=edge_windows, ewin_dtype=ewin_dtype,
              ewin_budget_bytes=ewin_budget_bytes, device=dev)
    labels = graph.labels.to(dev)
    if not pcgnn:
        homo = shard_relation(graph.homo, mesh, n_pad,
                              graph.features if edge_windows else None, **kw)
        return ShardedGraph(mesh=mesh, n_pad=n_pad, x_local=x_local,
                            labels=labels, homo=homo)
    shards = shard_relations(graph, mesh, n_pad, **kw)
    table, off = (build_sharded_fused(shards, n_pad,
                                      budget_bytes=ewin_budget_bytes)
                  if fused else (None, ()))
    return ShardedGraph(mesh=mesh, n_pad=n_pad, x_local=x_local,
                        labels=labels, shards=shards, fused=table,
                        fused_off=off)


def shard_batch(mesh: RankMesh, *arrays):
    """This rank's blocks of batch-axis arrays (every rank passes the same
    full arrays)."""
    out = [mesh.batch_block(a) for a in arrays]
    return out if len(out) > 1 else out[0]


# ----------------------------------------------------------------- partials

def block_partials(ids: torch.Tensor, keep: torch.Tensor, col_lo: int,
                   block: int, x_local: torch.Tensor):
    """(num [B, F], cnt [B]): the sum and count of the kept ids' feature
    rows that lie in this rank's block (global ids ``ids`` [B, M])."""
    local = ids.to(torch.int64) - col_lo
    w = (keep & (local >= 0) & (local < block)).to(x_local.dtype)
    xg = x_local[local.clamp(0, block - 1)]
    return torch.einsum("bd,bdf->bf", w, xg), w.sum(dim=-1)


def sharded_raw_window(sh: ShardedRel, starts: torch.Tensor,
                       mine: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, ewin_dp] float32 store rows from this rank's LOCAL store block,
    one window-gather fetch.  With ``mine`` (dg > 1) rows this rank does
    not own are not copied (the kernel's ``active``) and are then set to
    0, so a zero-weight contraction cannot pick up what the card's memory
    held."""
    raw = window_gather(sh.ewin, starts, sh.ewin_dp, active=mine,
                        out_dtype=torch.float32)
    if mine is not None:
        raw.masked_fill_(~mine[:, None], 0.0)
    return raw


def sharded_feature_window(sh: ShardedRel, starts: torch.Tensor,
                           mine: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """:func:`sharded_raw_window` as [B, D, F] float32 windows."""
    return unpack_window(sharded_raw_window(sh, starts, mine),
                         max(sh.width, 1), sh.ewin_f)


# ----------------------------------------------------------------- hub lane

def spmd_hub_sum(sh: ShardedRel, mesh: RankMesh, is_hub: torch.Tensor,
                 deg_b: torch.Tensor, hslot: torch.Tensor,
                 s0_full: torch.Tensor, center_s0: torch.Tensor,
                 x_local: torch.Tensor, col_lo: int, *,
                 tp_block: Optional[torch.Tensor] = None,
                 minor_ctx: Optional[tuple] = None,
                 labels: Optional[torch.Tensor] = None, rho: float = 0.5,
                 plan=None, chunk: int = HUB_CHUNK,
                 block_w: int = HUB_BLOCK):
    """Choose and partial sum over the hub rows (the sharded form of
    ``ops.hub.hub_choose_sum``).

    The hub sub-CSR is replicated and the scores ``s0_full`` are global, so
    every graph rank plans and sweeps the same chunks (``ops.hub``'s
    ``run_hub_chunks`` at ``plan``, the same on every rank of the graph
    group, :func:`spmd_epoch_hub_plans`; None plans this batch: one
    read-back per call) and keeps the same neighbors; only the feature sum
    is local (neighbors in this block), so the packed output sum completes
    it.  ``tp_block`` [block] marks this block's valid train positives for
    the duplicate-minor subtraction, done by the rank that added the
    neighbor.  ``minor_ctx`` (replicated) gives the in-chunk minor band,
    which only the graph leader adds.  Sums run in float64, rounded once
    per rank.  Returns (num [B, F], cnt [B]); zeros at non-hub rows."""
    x = x_local.detach()
    center_s0 = center_s0.detach()
    block, f = x.shape
    n_pad = s0_full.shape[0]
    lead = mesh.graph_index == 0

    def chunk_fn(rows_slot, active, jb):
        hs = hslot[rows_slot].to(torch.int64)
        deg = torch.where(active, sh.hub_deg[hs], 0)
        c_s0 = center_s0[rows_slot]
        thr = mnum = mcnt = None
        if minor_ctx is not None:
            mnum, mcnt, thr = chunk_minor_band(
                c_s0, sh.hub_ksample[hs], labels[rows_slot] == 1, active,
                *minor_ctx, rho)
        nbr = ragged_gather(sh.hub_col, sh.hub_start[hs], jb * block_w,
                            sh.num_nodes)
        slots = torch.arange(jb * block_w, device=x.device)
        dist = (c_s0[:, None] - s0_full[nbr.clamp(0, n_pad - 1)]).abs()
        dist = torch.where(slots[None, :] < deg[:, None], dist, _INF)
        keep = keep_nearest_switch(dist, sh.hub_keff[hs], jb, block_w)
        local = nbr.to(torch.int64) - col_lo
        inb = (local >= 0) & (local < block)
        lcl = local.clamp(0, block - 1)
        w = (keep & inb).to(torch.float64)
        if tp_block is not None and thr is not None:
            dup = (keep & inb & (tp_block[lcl] > 0.5)
                   & (dist <= thr[:, None]))
            w = w - dup.to(torch.float64)
        num_c = torch.einsum("hw,hwf->hf", w, x[lcl].double())
        cnt_c = w.sum(dim=1)
        if mnum is not None and lead:
            num_c, cnt_c = num_c + mnum, cnt_c + mcnt
        return num_c, cnt_c

    return run_hub_chunks(deg_b, is_hub, plan, chunk, block_w, x, f,
                          chunk_fn)


def spmd_hub_mean(sh: ShardedRel, is_hub: torch.Tensor, deg_b: torch.Tensor,
                  hslot: torch.Tensor, x_local: torch.Tensor, col_lo: int,
                  batch: torch.Tensor, *, include_self: bool, plan=None,
                  chunk: int = HUB_CHUNK, block_w: int = HUB_BLOCK):
    """All-neighbor partial sums over hub rows (the sharded form of
    ``ops.hub.hub_mean_sum``, for GraphSAGE and GCN; no choose).  Every
    graph rank sweeps the same full lists, at ``plan`` (None: this
    batch's own, one read-back), and sums the neighbors in its block; the
    conditional self row is added by the row's block owner.  Sums in
    float64, rounded once per rank."""
    x = x_local.detach()
    block, f = x.shape

    def chunk_fn(rows_slot, active, jb):
        rows = batch[rows_slot]
        hs = hslot[rows_slot].to(torch.int64)
        nbr = ragged_gather(sh.hub_col, sh.hub_start[hs], jb * block_w,
                            sh.num_nodes)
        slots = torch.arange(jb * block_w, device=x.device)
        deg = torch.where(active, sh.hub_deg[hs], 0)
        valid = slots[None, :] < deg[:, None]
        local = nbr.to(torch.int64) - col_lo
        inb = (local >= 0) & (local < block)
        w = (valid & inb).to(torch.float64)
        num_c = torch.einsum("hw,hwf->hf", w,
                             x[local.clamp(0, block - 1)].double())
        cnt_c = w.sum(dim=1)
        if include_self:
            has_self = (valid & (nbr == rows[:, None])).any(dim=1)
            self_local = rows - col_lo
            self_in = (self_local >= 0) & (self_local < block)
            miss = (~has_self & self_in).to(torch.float64)
            num_c = num_c + miss[:, None] * x[
                self_local.clamp(0, block - 1)].double()
            cnt_c = cnt_c + miss
        return num_c, cnt_c

    return run_hub_chunks(deg_b, is_hub, plan, chunk, block_w, x, f,
                          chunk_fn)


def plan_relations(sg: ShardedGraph) -> tuple:
    """The relations a sharded model's hub lanes plan: PC-GNN's shards, or
    the homo graph's of GCN and GraphSAGE (``model.hub_relations`` on one
    device)."""
    return sg.shards if sg.homo is None else (sg.homo,)


def spmd_epoch_hub_plans(sg: ShardedGraph, batches: torch.Tensor,
                         chunk: int = HUB_CHUNK,
                         block: int = HUB_BLOCK) -> tuple:
    """The hub plans of a stack of full batches [n, B] for this rank's
    blocks [n, Bd] (the sharded ``ops.hub.epoch_hub_plans``; the JAX body
    plans each batch inside its ``while_loop``): each graph rank reads the
    degrees of the rows it owns, for every relation with hubs, and ONE
    owner pick over the graph axis publishes them all; then ONE read-back
    of the heads (``ops.hub.stack_hub_plans``).  Every rank of a graph
    group holds the same blocks and so gets the same plans; a graph
    without hubs issues nothing and reads nothing back.  One plan per
    :func:`plan_relations` entry, None where it has no hubs."""
    rels = plan_relations(sg)
    hubs = [r for r, sh in enumerate(rels) if sh.has_hubs]
    if not hubs:
        return tuple(None for _ in rels)
    mesh = sg.mesh
    blocks = mesh.batch_block(batches.t()).t()                 # [n, Bd]
    local = (blocks - sg.col_lo).reshape(-1)
    mine = (local >= 0) & (local < sg.block)
    lclip = local.clamp(0, sg.block - 1)
    degs = mesh.owner_pick(mine, torch.stack(
        [rels[r].deg[lclip] for r in hubs], dim=1))       # [n * Bd, H]
    degs = degs.view(*blocks.shape, len(hubs))
    return stack_hub_plans(
        rels, [degs[..., hubs.index(r)] if r in hubs else None
               for r in range(len(rels))], chunk, block)


# ------------------------------------------------------------------ PC-GNN

def spmd_forward(model, sg: ShardedGraph, batch: torch.Tensor,
                 batch_labels: Optional[torch.Tensor], *, train: bool,
                 train_pos: Optional[torch.Tensor] = None,
                 train_pos_valid: Optional[torch.Tensor] = None,
                 train_pos_feats: Optional[torch.Tensor] = None,
                 fused: bool = True, record: Optional[dict] = None,
                 hub_plans: Optional[tuple] = None):
    """This rank's (gnn_logits [Bd, C], center_scores [Bd, C]) for its
    block of the full [B] ``batch`` (and ``batch_labels``, read in
    training: fraud centers get oversampled minors).

    The math of ``models.pcgnn.PCGNN.forward`` (the JAX SPMD body,
    ``spmd.py:694-896``).  ``fused`` reads the fused record table when it
    was built; False reads each relation's store (kernel 1c at dg > 1).
    ``train_pos_feats`` optionally gives the train positives' feature rows
    (constant for a run); else they are owner-picked from the blocks.
    ``record`` (a dict, for tests) receives each relation's published
    selection: ``kept<r>`` [Bd, D] kept window ids + 1 (0 = none; a fast
    lane publishes them for this with one more graph sum),
    ``keep_minor<r>`` [Bd, M] over ``cand_ids`` (the plain selection,
    ``oversample_minor_keeps``, published with one more), and ``cnt<r>``.
    ``hub_plans`` (one per relation, :func:`spmd_epoch_hub_plans`) fixes
    the hub lanes' chunks, so nothing is read back; None plans this
    batch, one read-back per hub relation.

    Schedule: the self-row, train-positive and metadata owner picks and the
    score gather are issued first and waited just before their first use;
    the window fetches (kernel 1a or 1c), their selection scores and the
    neighbor-id reads run under them.  The arithmetic and its order are the
    same with ``mesh.overlap`` on and off, so the results are bit-equal."""
    mesh = sg.mesh
    batch = mesh.batch_block(batch)
    y = mesh.batch_block(batch_labels) if train else None
    x_local = sg.x_local
    block, n_pad, dg, col_lo = sg.block, sg.n_pad, mesh.dg, sg.col_lo
    shards = sg.shards
    f = x_local.shape[1]
    clf = model.label_clf
    w0 = clf.w[:, 0].detach()
    b0 = clf.b[0].detach()
    local = batch - col_lo
    mine = (local >= 0) & (local < block)
    lclip = local.clamp(0, block - 1)
    use_fused = fused and sg.fused is not None
    # SPMD selection-precision rule: any bf16 store rounds every score
    packed_sel = any(sh.packed for sh in shards)

    def s0_of(rows):
        if packed_sel:
            rows = rows.to(torch.bfloat16).to(torch.float32)
        return selection_score(rows.detach(), w0, b0)

    # every collective is issued as soon as its inputs exist, in the order
    # of first use, and waited just before it (parallel.mesh: async under
    # RankMesh.overlap); the halo-independent work below runs under them
    self_h = mesh.owner_pick_async(mine, x_local[lclip], "self_rows")
    tp_h = tp_mine = None
    if train:
        tp_local = train_pos - col_lo
        tp_mine = (tp_local >= 0) & (tp_local < block) & train_pos_valid
        if train_pos_feats is None:
            tp_h = mesh.owner_pick_async(
                tp_mine, x_local[tp_local.clamp(0, block - 1)],
                "train_pos_rows")
    # owner metadata: ONE packed sum for all relations
    cols = []
    for sh in shards:
        cols += [sh.deg[lclip], sh.keff[lclip],
                 sh.hub_idx[lclip] if sh.has_hubs
                 else sh.deg.new_zeros(lclip.shape)]
    meta_h = mesh.owner_pick_async(mine, torch.stack(cols, dim=1),
                                   "owner_meta")              # [Bd, 3R]
    s0_h = None
    if any(sh.ewin is None or sh.has_hubs for sh in shards):
        s0_h = mesh.graph_gather_async(s0_of(x_local), "scores")  # [N_pad]

    # halo-independent: this rank's own rows of every relation.  The valid
    # masks of owned rows read the local metadata, which the owner pick
    # publishes unchanged (no other row is ever valid)
    if use_fused:
        # one fetch of every relation's window per owned row (kernel 1a:
        # record v of the block at v * W)
        width = sg.fused.shape[1]
        rec = window_gather(sg.fused.view(-1), lclip * width, width,
                            out_dtype=torch.float32)
        mesh.note()
    # per relation (nbr, then a fast lane's owned degrees (0 where not
    # mine) and store rows, or a plain lane's valid mask)
    lanes = []
    for r, sh in enumerate(shards):
        d = sh.width
        deg_l = sh.deg[lclip]
        nbr = sh.nbr2d[lclip]
        if sh.ewin is not None:
            raw = (rec[:, sg.fused_off[r]: sg.fused_off[r + 1]] if use_fused
                   else sharded_raw_window(sh, sh.estart[lclip],
                                           mine if dg > 1 else None))
            lanes.append((nbr, torch.where(mine, deg_l, 0), raw))
        else:
            offs = torch.arange(d, device=batch.device)[None, :]
            valid_o = mine[:, None] & (offs < deg_l.clamp(max=d)[:, None])
            if sh.has_hubs:
                # hubs leave the window
                valid_o = valid_o & (deg_l <= d)[:, None]
            lanes.append((nbr, valid_o))
        mesh.note()

    self_feats = self_h.wait()                                   # [Bd, F]
    center_scores = self_feats @ clf.w + clf.b
    center_s0 = s0_of(self_feats)

    minor_ctx = tp_block = ranked = None
    if train:
        tp_feats = train_pos_feats if tp_h is None else tp_h.wait()
        tp_s0 = s0_of(tp_feats)
        m_max = model.minor_window(int(train_pos.shape[0]), shards)
        # one sort of the train positives' scores a step: the minors'
        # windows and the hub lane's band read it
        ranked = rank_train_positives(tp_s0, train_pos_valid)
        if any(sh.has_hubs for sh in shards):
            tp_rows = torch.where(tp_mine, tp_local.clamp(0, block - 1),
                                  block)
            tp_block = x_local.new_zeros((block + 1,)).index_fill_(
                0, tp_rows, 1.0)[:block]
            sp_sorted, order = ranked
            minor_ctx = (sp_sorted, order.to(torch.int32),
                         tp_feats.detach()[order])

    meta_all = meta_h.wait()

    rel_sums = []       # per relation (num, cnt)
    minor_rels = []     # per relation (shard, neighbor ids, choose keep)
    for r, sh in enumerate(shards):
        d = sh.width
        deg_b, keff_b, hslot = meta_all[:, 3 * r: 3 * r + 3].unbind(1)
        is_hub = deg_b > d if sh.has_hubs else None
        nbr = lanes[r][0]
        if sh.ewin is not None:
            # fast lane: the owner chooses and sums its rows' windows, in
            # one kernel (hub rows leave the window)
            _, deg_o, raw = lanes[r]
            num, cnt, keep = choose_window_sum(
                raw, d, f, center_s0, w0, b0, deg_o, keff_b,
                hub_cap=d if sh.has_hubs else None,
                round_bf16=packed_sel and not sh.packed,
                want_keep=train or record is not None)
            if record is not None:
                record[f"kept{r}"] = mesh.graph_sum(
                    torch.where(keep, nbr + 1, 0))
        else:
            # plain lane: publish the kept ids, sum this block's rows
            valid_o = lanes[r][1]
            s0_full = s0_h.wait()
            dist = (center_s0[:, None]
                    - s0_full[nbr.to(torch.int64).clamp(0, n_pad - 1)]).abs()
            dist = torch.where(valid_o, dist, _INF)
            keep = keep_nearest(dist, keff_b, valid_o)
            enc = mesh.graph_sum(torch.where(keep, nbr + 1, 0))
            kept_ids, kept = enc - 1, enc > 0
            if record is not None:
                record[f"kept{r}"] = enc
            num, cnt = block_partials(kept_ids, kept, col_lo, block, x_local)
            nbr, keep = kept_ids, kept
        if sh.has_hubs:
            h_num, h_cnt = spmd_hub_sum(
                sh, mesh, is_hub, deg_b, hslot, s0_h.wait(), center_s0,
                x_local, col_lo, tp_block=tp_block, minor_ctx=minor_ctx,
                labels=y, rho=model.rho,
                plan=None if hub_plans is None else hub_plans[r])
            num, cnt = num + h_num, cnt + h_cnt     # disjoint row sets
        rel_sums.append((num, cnt))
        minor_rels.append((sh, nbr, keep))

    if train:
        # the single device's minors at the owned rows (local indices):
        # only a row's owner adds them, so the packed sum counts them once
        y_owned = torch.where(mine, y, 0)
        if record is not None:
            slots, keeps = oversample_minor_keeps(
                center_s0, tp_s0, train_pos, train_pos_valid, m_max, lclip,
                y_owned, model.rho, minor_rels)
            record["cand_ids"] = train_pos.to(torch.int32)[slots]
            m_w = slots.shape[1]
            pub = mesh.graph_sum(torch.cat(
                [k.to(torch.int32) for k in keeps], dim=1)) > 0
            for r in range(len(keeps)):
                record[f"keep_minor{r}"] = pub[:, r * m_w: (r + 1) * m_w]
        oversample_minor_sums(
            center_s0, tp_s0, train_pos, train_pos_valid, tp_feats, m_max,
            lclip, y_owned, model.rho, minor_rels, rel_sums, ranked=ranked)

    # ONE packed sum completes every relation's sums
    packed = mesh.graph_sum(torch.cat(
        [torch.cat([num, cnt[:, None]], dim=1) for num, cnt in rel_sums],
        dim=1))                                                  # [Bd, R(F+1)]
    rel_embs = []
    for r, layer in enumerate(model.intra):
        num = packed[:, r * (f + 1): r * (f + 1) + f]
        cnt = packed[:, r * (f + 1) + f]
        if record is not None:
            record[f"cnt{r}"] = cnt
        agg = num / cnt.clamp(min=1.0)[:, None]
        rel_embs.append(torch.relu(torch.cat([self_feats, agg], dim=1)
                                   @ layer.w))
    combined = torch.relu(torch.cat([self_feats] + rel_embs, dim=1)
                          @ model.inter.w)
    return combined @ model.head.w, center_scores


def _data_mean(mesh: RankMesh, ces: list, w: torch.Tensor,
               alpha: float = 1.0):
    """(loss, local) of the weighted means over the data axes of one or
    two CE terms, ``Σ ce0·w / D (+ alpha · Σ ce1·w / D)``, D = max(Σ w, 1):
    the loss (detached, the same on every rank) and this rank's share,
    the same sums over its block only, whose backward summed over the data
    axes is the gradient of the loss.  One data-axis sum (elided at extent
    1) carries every total.  The arithmetic is the single-device loss's
    (``PCGNN.loss``, ``models.gcn.weighted_ce``), so at a data extent of 1
    the two give the same bits."""
    nums = [(ce * w).sum() for ce in ces]
    tot = mesh.data_sum(torch.stack([n.detach() for n in nums] + [w.sum()]))
    den = tot[-1].clamp(min=1.0)

    def combine(parts):
        out = parts[0] / den
        return out if len(parts) == 1 else out + alpha * (parts[1] / den)

    return combine(tot[:-1]), combine(nums)


def spmd_loss(model, sg: ShardedGraph, batch, batch_labels, batch_weight,
              train_pos, train_pos_valid, *,
              train_pos_feats: Optional[torch.Tensor] = None,
              fused: bool = True, hub_plans: Optional[tuple] = None):
    """(loss, local) of the joint weighted-mean CE
    ``CE(gnn) + alpha * CE(scores)`` over the full batch (see
    :func:`_data_mean`; the JAX package sums ``(ce_gnn + alpha * ce_lab)
    · w`` first, ``spmd.py:1163-1181``, the same value to an ulp)."""
    from pcgnn_tpu_torch.models.lossfns import int_label_ce

    gnn_logits, center_scores = spmd_forward(
        model, sg, batch, batch_labels, train=True, train_pos=train_pos,
        train_pos_valid=train_pos_valid, train_pos_feats=train_pos_feats,
        fused=fused, hub_plans=hub_plans)
    y = sg.mesh.batch_block(batch_labels)
    return _data_mean(sg.mesh, [int_label_ce(gnn_logits, y),
                                int_label_ce(center_scores, y)],
                      sg.mesh.batch_block(batch_weight), model.alpha)


def spmd_predict(model, sg: ShardedGraph, batch, train_pos=None,
                 train_pos_valid=None, *, fused: bool = True,
                 hub_plans: Optional[tuple] = None):
    """[B, 2] sigmoid of the GNN head for the full ``batch``, on every
    rank (gathered over the data axes)."""
    with torch.no_grad():
        gnn_logits, _ = spmd_forward(model, sg, batch, None, train=False,
                                     train_pos=train_pos,
                                     train_pos_valid=train_pos_valid,
                                     fused=fused, hub_plans=hub_plans)
        return sg.mesh.data_gather(torch.sigmoid(gnn_logits))


# --------------------------------------------------------------- baselines

def spmd_homo_forward(model, sg: ShardedGraph, batch: torch.Tensor, *,
                      generator: Optional[torch.Generator] = None,
                      hub_plans: Optional[tuple] = None):
    """This rank's logits [Bd, C] of GraphSAGE or GCN for its block of the
    full [B] ``batch`` (the JAX SPMD homo body, ``spmd.py:1000-1085``):
    one owner-computes window lane (store, kernel 1c at dg > 1, or plain)
    plus the hub lane; the conditional self row; mean (GraphSAGE) or
    sqrt-count (GCN) normalization.  GraphSAGE's ``num_sample`` draws the
    full [B, D] priorities from ``generator`` on every rank (seeded alike,
    so the draw is replicated) and takes this block's rows, the draw the
    single-device model makes for the same batch.  ``hub_plans`` (one
    entry, :func:`spmd_epoch_hub_plans`) fixes the hub lane's chunks; None
    plans this batch, one read-back."""
    from pcgnn_tpu_torch.models.gcn import GCN

    mesh = sg.mesh
    sh = sg.homo
    is_gcn = isinstance(model, GCN)
    gcn_style = True if is_gcn else model.gcn_style
    num_sample = None if is_gcn else model.num_sample
    if num_sample is not None and sh.has_hubs:
        raise ValueError(
            "GraphSage num_sample draws uniformly from the full neighbor "
            "list, which a window-capped relation does not expose; rebuild "
            "the graph with window_cap disabled or drop num_sample")
    full_b = batch.shape[0]
    batch = mesh.batch_block(batch)
    x_local = sg.x_local
    block, dg, col_lo = sg.block, mesh.dg, sg.col_lo
    d = sh.width
    local = batch - col_lo
    mine = (local >= 0) & (local < block)
    lclip = local.clamp(0, block - 1)
    # issued first, waited at first use (spmd_forward's schedule)
    self_h = mesh.owner_pick_async(mine, x_local[lclip], "self_rows")
    meta_h = mesh.owner_pick_async(mine, torch.stack(
        [sh.deg[lclip], sh.hub_idx[lclip] if sh.has_hubs
         else sh.deg.new_zeros(lclip.shape)], dim=1), "owner_meta")
    # halo-independent: the owned rows' window (the local metadata is what
    # the owner pick publishes for them)
    deg_l = sh.deg[lclip]
    valid_w = (torch.arange(d, device=batch.device)[None, :]
               < deg_l.clamp(max=d)[:, None])
    if sh.has_hubs:
        valid_w = valid_w & (deg_l <= d)[:, None]
    nbr = sh.nbr2d[lclip]                                       # [Bd, D]
    valid_o = mine[:, None] & valid_w
    if num_sample is not None:
        if generator is None:
            generator = torch.Generator(device=batch.device)
            generator.manual_seed(0)
        pri = mesh.batch_block(torch.rand((full_b, d), generator=generator,
                                          device=batch.device))
        pri = torch.where(valid_w, pri, torch.inf)
        order = torch.argsort(pri, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        valid_o = valid_o & (rank < num_sample)
    if sh.ewin is not None:
        xw = sharded_feature_window(sh, sh.estart[lclip],
                                    mine if dg > 1 else None)
        num, cnt = window_sum_from_gathered(xw, valid_o)
    mesh.note()

    self_feats = self_h.wait()                                  # [Bd, F]
    deg_b, hslot = meta_h.wait().unbind(1)
    is_hub = deg_b > d if sh.has_hubs else None
    if sh.ewin is not None:
        if gcn_style:
            present = ((nbr == batch[:, None]) & valid_o).any(dim=1)
            addself = mine & ~present
            if sh.has_hubs:
                addself = addself & ~is_hub
            w_self = addself.to(xw.dtype)
            num = num + w_self[:, None] * self_feats
            cnt = cnt + w_self
    else:
        enc = mesh.graph_sum(torch.where(valid_o, nbr + 1, 0))
        kept_ids, kept = enc - 1, enc > 0
        num, cnt = block_partials(kept_ids, kept, col_lo, block, x_local)
        if gcn_style:
            present = (kept & (kept_ids == batch[:, None])).any(dim=1)
            addself = ~present
            if sh.has_hubs:
                addself = addself & ~is_hub
            pn, pc = block_partials(batch[:, None], addself[:, None], col_lo,
                                    block, x_local)
            num, cnt = num + pn, cnt + pc
    if sh.has_hubs:
        h_num, h_cnt = spmd_hub_mean(
            sh, is_hub, deg_b, hslot, x_local, col_lo, batch,
            include_self=gcn_style,
            plan=None if hub_plans is None else hub_plans[0])
        num, cnt = num + h_num, cnt + h_cnt
    f = x_local.shape[1]
    out = mesh.graph_sum(torch.cat([num, cnt[:, None]], dim=1))
    num, cnt = out[:, :f], out[:, f]
    denom = cnt.clamp(min=1.0)
    if is_gcn:
        denom = denom.sqrt()
    neigh = num / denom[:, None]
    combined = neigh if gcn_style else torch.cat([self_feats, neigh], dim=1)
    return torch.relu(combined @ model.enc.w) @ model.head.w


def spmd_homo_loss(model, sg: ShardedGraph, batch, batch_labels,
                   batch_weight, *,
                   generator: Optional[torch.Generator] = None,
                   hub_plans: Optional[tuple] = None):
    """(loss, local) of the weighted-mean CE of GraphSAGE or GCN over the
    full batch (:func:`_data_mean`)."""
    from pcgnn_tpu_torch.models.lossfns import int_label_ce

    logits = spmd_homo_forward(model, sg, batch, generator=generator,
                               hub_plans=hub_plans)
    ce = int_label_ce(logits, sg.mesh.batch_block(batch_labels))
    return _data_mean(sg.mesh, [ce], sg.mesh.batch_block(batch_weight))


def spmd_homo_predict(model, sg: ShardedGraph, batch, *,
                      generator: Optional[torch.Generator] = None,
                      hub_plans: Optional[tuple] = None) -> torch.Tensor:
    """[B, 2] probabilities for the full ``batch`` on every rank: a
    sigmoid for GCN, a softmax for GraphSAGE (its draws from
    ``generator``, by default a fresh one seeded 0)."""
    from pcgnn_tpu_torch.models.gcn import GCN

    with torch.no_grad():
        logits = spmd_homo_forward(model, sg, batch, generator=generator,
                                   hub_plans=hub_plans)
        probs = (torch.sigmoid(logits) if isinstance(model, GCN)
                 else torch.softmax(logits, dim=-1))
        return sg.mesh.data_gather(probs)


# -------------------------------------------------------------------- step

def data_sum_grads(model, mesh: RankMesh) -> None:
    """Sum every parameter's gradient over the data axes with ONE
    flattened all-reduce (elided at extent 1), blocking: it follows the
    backward, and the parameters are a few KB, so nothing is left to run
    under it."""
    if mesh.dd == 1:
        return
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = mesh.data_sum(torch.cat([g.reshape(-1) for g in grads]))
    i = 0
    for p in params:
        n = p.numel()
        p.grad = flat[i: i + n].view_as(p).clone()
        i += n


def spmd_train_step(model, optimizer, sg: ShardedGraph, batch, y, w,
                    consts: Optional[dict] = None,
                    generator: Optional[torch.Generator] = None,
                    hub_plans: Optional[tuple] = None) -> torch.Tensor:
    """One sharded optimizer step on the full batch (each rank computes
    its block): loss -> local backward -> data-axis gradient sum -> Adam.
    Returns the loss (detached, the same on every rank).  PC-GNN reads the
    train positives in ``consts`` (``tp``, ``tpv``, optional ``tpf``);
    ``hub_plans`` fixes the hub lanes' chunks (None: planned from this
    batch).  This is the step that ``train.capture.StepRunner`` captures
    for a sharded trainer, cut at its collectives."""
    optimizer.zero_grad(set_to_none=True)
    if sg.homo is None:
        loss, local = spmd_loss(model, sg, batch, y, w, consts["tp"],
                                consts["tpv"],
                                train_pos_feats=consts.get("tpf"),
                                hub_plans=hub_plans)
    else:
        loss, local = spmd_homo_loss(model, sg, batch, y, w,
                                     generator=generator,
                                     hub_plans=hub_plans)
    local.backward()
    data_sum_grads(model, sg.mesh)
    optimizer.step()
    return loss
