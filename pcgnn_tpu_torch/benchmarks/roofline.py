"""Roofline benchmarks for the PC-GNN hot ops on the card (counterpart of
``benchmarks/roofline.py``).

    python -m pcgnn_tpu_torch.benchmarks.roofline [--preset yelp-like] \\
        [--batch_size 1024] [--emb_size 64] [--out FILE] [--device cuda]

Times each hot op with ``utils.roofline.measure`` against the least bytes
it must move (``sol_frac``: those bytes' time at the card's peak rate over
the measured time) and prints one JSON line per op, with the JAX script's
kernel names, plus the card's name and power limit; writes ``--out`` only
if given.

  matmul_anchor         8192^3 bf16 ``torch.matmul``: the timing path
                        against the card's known peak (``mfu``).
  window_gather         the [B, D] neighbor-window row gather ``xs[nbr]``.
  window_gather_ewin    ``batch_feature_window``: kernel 1 on the largest
                        relation's edge-window store.
  fused_record_fetch    ``batch_record_window``: kernel 1 on the fused
                        record store, widened to float32.
  choose_keep_nearest   ``keep_nearest`` on [B, D].
  spmm_*_form           ``segment_mean_spmm``'s window, edge-window and
                        segment forms over the largest relation.
  sddmm_*_form          ``ops/sddmm.py``'s window, edge-window and flat
                        forms over the largest relation.
  loss_fwd / loss_grad / train_step / train_step_scan16
                        one optimizer step ablated: the loss alone, loss and
                        gradients, the whole step (``Trainer.single_step``)
                        and 16 steps a call (``nscan=16``), against
                        ``pcgnn_step_streaming_bytes``.

Byte counts that differ from the JAX script's:

  * ``window_gather`` counts the [N+1, F+1] table at most once,
    ``min(B * D, N + 1)`` rows, where the JAX script counts one table row
    read per gathered row and accepts ``sol_frac`` above 1 when the table
    stays in fast memory.  yelp-like's table (6.07 MB) stays in the card's
    50 MB L2, and ``measure`` refuses a share above ``SOL_LIMIT``: counted
    the JAX way the call would read 58.2 MB, counted so 35.5 MB.
  * The store reads (``window_gather_ewin``, ``fused_record_fetch``,
    ``spmm_ewin_form``, ``sddmm_ewin_form``) count the store's element size
    (2 bytes in a bfloat16 store) where the JAX script counts 4; the two
    fetches count their float32 output and int64 starts, and the fetch's
    whole row (``ewin_dp`` or the record width) where the JAX script counts
    D * F.
  * ``choose_keep_nearest`` counts what the port's call reads and writes:
    the distances, the ``valid`` mask, the [B] counts and the kept mask
    (the JAX script counts distances and mask).
  * ``spmm_*`` and the window and flat ``sddmm`` forms count as the JAX
    script does, over the port's padded edge count ``e_pad``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pcgnn_tpu_torch.benchmarks import card_line
from pcgnn_tpu_torch.utils import roofline

# the anchor's matrix side
ANCHOR_M = 8192


def bench_relation_kernels(graph, batch_size: int) -> list:
    """Rows of the relation ops on ``graph`` (its device): the anchor, the
    window fetches, the choose, and the full-graph SpMM and SDDMM forms of
    the largest relation."""
    from pcgnn_tpu_torch.ops.aggregate import (batch_feature_window,
                                               batch_neighbor_window,
                                               batch_record_window,
                                               keep_nearest,
                                               segment_mean_spmm)
    from pcgnn_tpu_torch.ops.sddmm import (edge_abs_diff,
                                           edge_abs_diff_window,
                                           edge_abs_diff_window_ewin)
    dev = graph.features.device
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n, f = graph.num_nodes, graph.feat_dim
    batch = torch.as_tensor(rng.integers(0, n, batch_size), device=dev)
    # production gathers features + the score column in ONE row gather
    xs = torch.as_tensor(rng.standard_normal((n + 1, f + 1)),
                         dtype=torch.float32, device=dev)
    rows = []

    def add(kernel, shape, fn, *args, **counts):
        res = roofline.measure(fn, *args, device=dev, **counts)
        rows.append({"kernel": kernel, "shape": shape, **res})

    m = ANCHOR_M
    a = torch.randn((m, m), generator=gen, device=dev).to(torch.bfloat16)
    add("matmul_anchor", f"[{m},{m}] bf16", lambda a: a @ a, a,
        analytic_bytes=3 * m * m * 2, analytic_flops=2 * m ** 3)
    del a

    rel = max(graph.relations, key=lambda r: r.num_edges)
    nbr, valid = batch_neighbor_window(rel, batch, allow_capped=True)
    b, d = nbr.shape
    # the table read once (at most every row), each gathered row written,
    # each id read
    table_rows = min(b * d, n + 1)
    add("window_gather", f"[{b},{d},{f + 1}]", lambda xs, nbr: xs[nbr],
        xs, nbr,
        analytic_bytes=table_rows * (f + 1) * 4 + b * d * ((f + 1) * 4 + 4))

    if rel.ewin is not None:
        es, dp = rel.ewin.element_size(), rel.ewin_dp
        add("window_gather_ewin", f"[{b},{d},{f}]",
            lambda r, b_: batch_feature_window(r, b_, f), rel, batch,
            analytic_bytes=b * (dp * (es + 4) + 8))

    if graph.fused is not None:
        w, es = graph.fused.shape[1], graph.fused.element_size()
        add("fused_record_fetch", f"[{batch_size},{w}]", batch_record_window,
            graph, batch, analytic_bytes=batch_size * (w * (es + 4) + 8))

    dist = torch.where(valid, torch.as_tensor(
        np.abs(rng.standard_normal((b, d))), dtype=torch.float32,
        device=dev), torch.inf)
    keff = rel.keff[batch]
    add("choose_keep_nearest", f"[{b},{d}]", keep_nearest, dist, keff, valid,
        analytic_bytes=b * d * (4 + 1 + 1) + b * keff.element_size())

    feats = torch.as_tensor(rng.standard_normal((n, f)), dtype=torch.float32,
                            device=dev)
    e_pad = rel.e_pad
    shape = f"E={rel.num_edges} N={n} F={f}"
    # gather E rows (no reuse credit) + col/row indices + write [N, F]
    spmm_bytes = e_pad * (f * 4 + 8) + n * (f * 4 + 4)
    if rel.nbr2d is not None and not rel.has_hubs:
        add("spmm_window_form", shape, segment_mean_spmm, rel, feats,
            analytic_bytes=spmm_bytes)
    if rel.ewin is not None:
        # the edge-window form reads the store's snapshot of the graph's
        # own features
        es = rel.ewin.element_size()
        add("spmm_ewin_form", shape,
            lambda r, x: segment_mean_spmm(r, x, assume_ewin_features=True),
            rel, graph.features,
            analytic_bytes=e_pad * (f * es + 8) + n * (f * 4 + 4))
    keep_all = torch.ones(e_pad, dtype=torch.bool, device=dev)
    add("spmm_segment_form", shape, segment_mean_spmm, rel, feats, keep_all,
        analytic_bytes=spmm_bytes)

    s0 = torch.as_tensor(rng.standard_normal((n,)), dtype=torch.float32,
                         device=dev)
    nd = n * max(int(rel.window_width), 1)
    if rel.nbr2d is not None:
        # read nbr2d + scores, write dist + valid ([N, D] each)
        add("sddmm_window_form", f"E={rel.num_edges}", edge_abs_diff_window,
            rel, s0, analytic_bytes=nd * (4 + 4 + 4 + 1))
    if rel.ewin is not None:
        es = rel.ewin.element_size()
        w0 = torch.as_tensor(rng.standard_normal((f,)), dtype=torch.float32,
                             device=dev)
        b0 = torch.tensor(0.1, device=dev)
        s0g = graph.features @ w0 + b0
        add("sddmm_ewin_form", f"E={rel.num_edges}",
            edge_abs_diff_window_ewin, rel, s0g, w0, b0,
            analytic_bytes=nd * (f * es + 4 + 1))
    add("sddmm_flat_form", f"E={rel.num_edges}", edge_abs_diff, rel, s0,
        analytic_bytes=e_pad * (4 + 4 + 4))
    return rows


def bench_train_step(preset: str, batch_size: int, emb_size: int,
                     device="cuda", graph=None) -> list:
    """Stage-ablated timings of one optimizer step: the loss alone, loss
    and gradients, and the full step (loss -> grads -> Adam), one and 16
    steps a call.  ``graph``: the preset's graph already built (its stores
    are kept)."""
    from pcgnn_tpu_torch.train.trainer import Trainer
    cfg = dict(seed=2, data_name=f"synthetic:{preset}", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=emb_size,
               lr=0.01, weight_decay=0.001, alpha=2.0, rho=0.5,
               epochs=1, valid_epochs=10 ** 9, batch_size=batch_size,
               patience=10 ** 9, exp_num=0)
    t = Trainer(cfg, graph=graph, device=device)
    dev = t.device
    rng = np.random.default_rng(0)
    batch = rng.choice(np.asarray(t.idx_train), batch_size)
    y = t.graph.labels.cpu().numpy()[batch]
    w = np.ones((batch_size,), np.float32)
    model = t.new_model()
    fn, args = t.single_step(model, t.new_optimizer(model), batch, y, w)
    _, _, batch_t, y_t, w_t = args
    m_max = model.minor_window(int(t.train_pos_dev.shape[0]),
                               t.graph.relations)
    step_bytes = roofline.pcgnn_step_streaming_bytes(
        t.graph, batch_size, m_max, emb_size)
    consts = t.consts

    def loss(model, batch, y, w):
        return model.loss(t.graph, batch, y, w, train_pos=consts["tp"],
                          train_pos_valid=consts["tpv"],
                          train_pos_feats=consts.get("tpf"))

    def fwd(model, batch, y, w):
        with torch.no_grad():
            return loss(model, batch, y, w)

    def fwd_grad(model, batch, y, w):
        model.zero_grad(set_to_none=True)
        out = loss(model, batch, y, w)
        out.backward()
        return out.detach()

    rows = []
    for kernel, f_, a_ in (("loss_fwd", fwd, (model, batch_t, y_t, w_t)),
                           ("loss_grad", fwd_grad,
                            (model, batch_t, y_t, w_t)),
                           ("train_step", fn, args)):
        res = roofline.measure(f_, *a_, analytic_bytes=step_bytes,
                               device=dev)
        rows.append({"kernel": kernel, "shape": f"B={batch_size}", **res})
    # 16 steps a call, as the JAX script scans them
    nscan = 16
    model16 = t.new_model()
    fn16, args16 = t.single_step(model16, t.new_optimizer(model16), batch,
                                 y, w, nscan=nscan)
    res = roofline.measure(fn16, *args16, analytic_bytes=step_bytes * nscan,
                           device=dev)
    res["wall_ms"] /= nscan
    rows.append({"kernel": "train_step_scan16", "shape": f"B={batch_size}",
                 **res})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="yelp-like")
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--emb_size", type=int, default=64)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.graph.csr import materialize_edge_windows
    dev = torch.device(args.device)
    card = card_line(dev)
    graph = materialize_edge_windows(synthetic_fraud_graph(
        args.preset, seed=2, device=dev))
    rows = bench_relation_kernels(graph, args.batch_size)
    rows.extend(bench_train_step(args.preset, args.batch_size,
                                 args.emb_size, dev, graph=graph))
    out = {"preset": args.preset, "device": str(dev),
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "card": card, "kernels": rows}
    for r in rows:
        print(json.dumps({**r, "card": card}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
