"""Probe: window-gather strategies for the PC-GNN hot path (counterpart of
``benchmarks/gather_probe.py``).

    python -m pcgnn_tpu_torch.benchmarks.gather_probe \\
        [--n 45954] [--f 33] [--b 1024] [--d 212] [--e 6837250] \\
        [--device cuda]

The training step gathers [B, D, F] neighbor-feature windows.  A row
gather by neighbor id moves one F-wide row a slot; because the feature
table is frozen, each relation's neighbor features can be stored
contiguously in edge order, so a batch row's window is one contiguous
[D, F] block.  This measures the JAX script's five strategies as the port
computes them:

  row_gather              ``table[nbr]``                  (XLA row gather)
  block_gather            ``edge_feats[starts[:, None] + arange(d)]``
                                                          (``lax.gather``)
  kernel1_dynamic_slice   kernel 1 on the flattened rows, starts s * F,
                          dp = d * F           (vmapped ``dynamic_slice``)
  kernel2_flat_block      kernel 2 on the float32 rows' int32 bits, dp
                          rounded up to 128, cut to d * F and viewed back
                          as float32                  (Pallas flat block)
  row_gather_bf16         ``table_bf16[nbr]``             (bf16 row gather)

Each is held exactly against the first that computes the same values
(``block_gather`` for the contiguous windows, ``row_gather`` rounded to
bfloat16 for the last) on each of ``INDEX_SETS`` sets of ids and
starts, then timed with ``utils.roofline.measure`` over the output bytes,
as the JAX script counts them, taking those sets in turn (``kernel_ms``:
calls queued ahead of the card, the output's write-back included; the
edge rows read from memory, the 6 MB table from the L2).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pcgnn_tpu_torch.benchmarks import card_line
from pcgnn_tpu_torch.ops.ragged_gather import ragged_gather
from pcgnn_tpu_torch.ops.window_gather import window_gather
from pcgnn_tpu_torch.utils import roofline

# sets of ids and starts the timed calls take in turn: eight 28.6 MB
# windows' reads from the edge rows, past the 50 MB L2 between two uses
INDEX_SETS = 8


def row_gather(table: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    return table[nbr]


def block_gather(edge_feats: torch.Tensor, starts: torch.Tensor,
                 d: int) -> torch.Tensor:
    """[B, d, F]: rows starts[b] .. starts[b] + d of ``edge_feats``."""
    pos = starts.to(torch.int64)[:, None] + torch.arange(
        d, device=edge_feats.device)
    return edge_feats[pos]


def kernel1_dynamic_slice(edge_feats: torch.Tensor, starts: torch.Tensor,
                          d: int) -> torch.Tensor:
    """``block_gather`` through kernel 1: one window of d * F values a row
    of the flattened [E, F] rows."""
    f = edge_feats.shape[1]
    out = window_gather(edge_feats.view(-1), starts.to(torch.int64) * f,
                        d * f)
    return out.view(starts.shape[0], d, f)


def kernel2_flat_block(flat_i: torch.Tensor, starts: torch.Tensor, d: int,
                       f: int) -> torch.Tensor:
    """``block_gather`` through kernel 2, as ``gather_probe.py:80-89``
    bitcasts: [B, dp] int32 runs of the float32 rows' bits (dp = d * F
    rounded up to 128), cut to d * F and viewed back as float32."""
    df = d * f
    dp = -(-df // 128) * 128
    raw = ragged_gather(flat_i, starts.to(torch.int64) * f, dp, 0)
    return raw[:, :df].view(torch.float32).reshape(starts.shape[0], d, f)


def probe_data(n: int, f: int, b: int, d: int, e: int, device,
               seed: int = 0, sets: int = INDEX_SETS) -> dict:
    """The JAX script's inputs: the [N+1, F] table, [B, D] neighbor ids and
    sorted [B] starts from numpy's seeded generator (its one set first,
    then the others, for timing: lists ``nbr`` and ``starts``), and the
    [E + D + 4096, F] edge-feature rows (902 MB at the defaults) from a
    seeded generator on the device."""
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.normal(size=(n + 1, f)).astype(np.float32),
                            device=device)
    nbr, starts = [], []
    for _ in range(sets):
        nbr.append(torch.as_tensor(
            rng.integers(0, n, size=(b, d)).astype(np.int32), device=device))
        starts.append(torch.as_tensor(
            np.sort(rng.integers(0, e - d, size=(b,))).astype(np.int32),
            device=device))
    gen = torch.Generator(device=device).manual_seed(seed)
    edge_feats = torch.randn((e + d + 4096, f), generator=gen,
                             device=device)
    return {"table": table, "nbr": nbr, "starts": starts,
            "edge_feats": edge_feats}


def strategies(data: dict, d: int) -> list:
    """[(name, fn, arg sets, extra bytes, name of the output it must equal,
    transform of that output)]."""
    table, nbr, starts = data["table"], data["nbr"], data["starts"]
    ef = data["edge_feats"]
    f = ef.shape[1]
    flat_i = ef.view(-1).view(torch.int32)
    out_bytes = nbr[0].numel() * f * 4
    same = lambda x: x
    on = lambda src, ids: [(src, i) for i in ids]
    return [
        ("row_gather", row_gather, on(table, nbr), 0, None, None),
        ("block_gather", lambda e_, s: block_gather(e_, s, d),
         on(ef, starts), 0, None, None),
        ("kernel1_dynamic_slice",
         lambda e_, s: kernel1_dynamic_slice(e_, s, d), on(ef, starts), 0,
         "block_gather", same),
        ("kernel2_flat_block",
         lambda fl, s: kernel2_flat_block(fl, s, d, f), on(flat_i, starts),
         0, "block_gather", same),
        ("row_gather_bf16", row_gather, on(table.to(torch.bfloat16), nbr),
         -out_bytes // 2, "row_gather", lambda x: x.to(torch.bfloat16))]


def run(n: int = 45954, f: int = 33, b: int = 1024, d: int = 212,
        e: int = 6_837_250, device="cuda") -> dict:
    """Each strategy checked on every set and timed; prints the JAX
    script's lines and returns {"rows": [...], "out_bytes", "card"}."""
    dev = torch.device(device)
    card = card_line(dev)
    data = probe_data(n, f, b, d, e, dev)
    out_bytes = b * d * f * 4
    print(f"gather [B={b}, D={d}, F={f}]  out={out_bytes / 1e6:.1f} MB; "
          f"on {card}")
    outs, rows = {}, []
    for name, fn, arg_sets, extra, ref, as_ref in strategies(data, d):
        got = [fn(*a) for a in arg_sets]
        if ref is not None:
            if not all(torch.equal(g, as_ref(w))
                       for g, w in zip(got, outs[ref])):
                raise AssertionError(f"{name} differs from {ref}")
            print(f"{name} correct: True")
        outs.setdefault(name, got)
        r = roofline.measure(fn, arg_sets=arg_sets,
                             analytic_bytes=out_bytes + extra, device=dev)
        rows.append({"name": name, "wall_ms": r["wall_ms"],
                     "readings_ms": r.get("readings_ms"),
                     "achieved_gbps": r["achieved_gbps"],
                     "sol_frac": r.get("sol_frac"),
                     "analytic_bytes": out_bytes + extra,
                     "checked_against": ref})
        sol = r.get("sol_frac")
        spread = (f" ({min(r['readings_ms']) * 1e3:.2f}-"
                  f"{max(r['readings_ms']) * 1e3:.2f})"
                  if r.get("readings_ms") else "")
        print(f"{name:28s} wall {r['wall_ms']:8.4f} ms{spread}   "
              f"{r['achieved_gbps']:7.1f} GB/s  sol "
              + (f"{sol:.3f}" if sol is not None else "-"))
    return {"rows": rows, "out_bytes": out_bytes, "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=45954)
    ap.add_argument("--f", type=int, default=33)
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--d", type=int, default=212)
    ap.add_argument("--e", type=int, default=6_837_250)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.n, args.f, args.b, args.d, args.e, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
