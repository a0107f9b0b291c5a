#!/usr/bin/env python3
"""Time the full-graph ops of ``pcgnn_tpu_torch`` at several node-chunk
widths on one CUDA card.

    python3 chunk_sweep.py [--widths 1024 4096 16384 65536]

On the largest relation of ``chip_smoke.py``'s yelp-like graph (bf16
stores) and of the 1M-node stress graph, each chunked call (the window and
edge-window means, the window and edge-window distances) is timed with
``utils.roofline.measure`` at each width of ``SPMM_NODE_CHUNK`` and
``SDDMM_NODE_CHUNK``.  This is the measurement that chose the widths the
ops keep; no width changes a value, so nothing is checked here
(``chip_smoke.py`` phase 22 checks the chosen widths).  Prints the card's
name and power limit, then one JSON object: {graph: {"relation": r,
"ms": {width: {call: ms}}}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import chip_smoke as smoke

CHUNKED = ("spmm_window", "spmm_ewin", "sddmm_window", "sddmm_ewin")


def sweep(g, widths) -> dict:
    """Each chunked call on ``g``'s largest relation, timed at each width."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import sddmm
    from pcgnn_tpu_torch.utils.roofline import measure
    big = max(range(g.num_relations), key=lambda r: g.relations[r].num_edges)
    rel = g.relations[big]
    x, s0, w0, b0 = smoke.full_graph_inputs(g, rel)
    kept = agg.SPMM_NODE_CHUNK, sddmm.SDDMM_NODE_CHUNK
    out = {}
    try:
        for c in widths:
            agg.SPMM_NODE_CHUNK = sddmm.SDDMM_NODE_CHUNK = c
            out[c] = {name: measure(fn, *args,
                                    target_s=smoke.FULL_TARGET_S)["wall_ms"]
                      for name, fn, args, _ in smoke.full_graph_calls(
                          rel, x, s0, w0, b0) if name in CHUNKED}
    finally:
        agg.SPMM_NODE_CHUNK, sddmm.SDDMM_NODE_CHUNK = kept
    return {"relation": big, "ms": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", type=int, nargs="+",
                    default=[1024, 4096, 16384, 65536])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chunk_sweep: torch.cuda.is_available() is false; this sweep "
              "times a CUDA card", file=sys.stderr)
        return 1
    from pcgnn_tpu_torch.data.loaders import load_data
    from pcgnn_tpu_torch.ops import kernels
    from pcgnn_tpu_torch.train.trainer import Trainer
    kernels.build()
    card = smoke.card_line()
    res = {}
    t0 = time.time()
    like = Trainer(smoke.BENCH_CFG, device="cuda").graph
    res["yelp-like"] = sweep(like, args.widths)
    del like
    print(f"yelp-like swept at {time.time() - t0:.1f} s", file=sys.stderr)
    g = load_data(smoke.STRESS_CFG["data_name"],
                  seed=smoke.STRESS_CFG["seed"])
    stress = Trainer(smoke.STRESS_CFG, graph=g, device="cuda").graph
    del g
    res["stress-1m"] = sweep(stress, args.widths)
    print(f"stress-1m swept at {time.time() - t0:.1f} s", file=sys.stderr)
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
