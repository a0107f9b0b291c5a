"""Probe: window-gather kernel variants on the card (counterpart of
``benchmarks/gather_kernel_probe.py``).

    python -m pcgnn_tpu_torch.benchmarks.gather_kernel_probe \\
        [--b 1024] [--d 212] [--f 33] [--e 6837250] [--device cuda]

Moves [B, dp] int32 windows (dp = d * f rounded up to 128: 7,040 at the
defaults) out of a flat int32 array of about e * f elements (902 MB), at
sorted random starts, every way the port has:

  A. the port's current kernels: kernel 2 (``ops/ragged_gather``) and
     kernel 1's copy (``ops/window_gather``, the int32 bits as float32),
     at the starts and, beside P-a, at the starts rounded down to 1024;
  B. P-s, the shift gather (``ops/gather_probe.shift_gather``), at the JAX
     probe's (rows, slots) pairs, slots capped at what 227 KB of shared
     memory holds (printed);
  C. P-a, the aligned gather (``ops/gather_probe.aligned_gather``), rows
     8 / 16 / 32 / 64, at the starts rounded down to 1024;

with the library yardstick ``flat.unfold(0, dp, 1)[starts]`` and each
variant's plain version.  Every variant is held exactly against its plain
version on each of ``START_SETS`` sets of starts (a copy: one differing
element fails), then timed with ``utils.roofline.measure`` over those sets
in turn (``kernel_ms``: calls queued ahead of the card, reads from memory,
the output's write-back included; a call of about 20 us is shorter than
its host overhead, and repeated calls on one set would find its 28.8 MB in
the L2).  Each line gives the median time (with the spread of its
readings), GB/s and ``sol`` over the output bytes, as the JAX script
counts them, and beside it the read+write bound (each window read once
and written once: 57.7 MB, 17.2 us at 3.35 TB/s at the defaults), the
bound every kernel of the port is held to; a time under it by more than
``SOL_LIMIT`` fails.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pcgnn_tpu_torch.benchmarks import card_line
from pcgnn_tpu_torch.ops import gather_probe as gp
from pcgnn_tpu_torch.ops import ragged_gather as rg
from pcgnn_tpu_torch.ops import window_gather as wg
from pcgnn_tpu_torch.utils import roofline

_CH = 1024
_L = 128
# sets of starts the timed calls take in turn: eight 28.8 MB read sets at
# the defaults, past the 50 MB L2 between two uses of one set
START_SETS = 8
# the JAX probe's sweeps: P-s (rows, slots) pairs and P-a rows
SHIFT_SWEEP = ((8, 4), (16, 8), (32, 8), (32, 16), (64, 16))
ALIGNED_ROWS = (8, 16, 32, 64)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def probe_data(b: int, d: int, f: int, e: int, device, seed: int = 0,
               sets: int = START_SETS):
    """(flat [L] int32, [starts [B] int32] * sets, dp): the JAX probe's
    shapes.  L keeps its padding past e * f (the TPU kernels read a
    1024-aligned span past every start); flat's values come from a seeded
    generator on the device, the starts from numpy's, sorted, as the JAX
    probe draws them (its one set first, then the others, for timing)."""
    dp = _round_up(d * f, _L)
    span = _round_up(dp, _CH) + _CH
    flat_len = e * f
    need = _round_up(flat_len + span, _CH) + span
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randint(-2 ** 30, 2 ** 30, (need,), generator=gen,
                         dtype=torch.int32, device=device)
    rng = np.random.default_rng(seed)
    starts = [torch.as_tensor(np.sort(rng.integers(
        0, flat_len - span, size=(b,))).astype(np.int32), device=device)
        for _ in range(sets)]
    return flat, starts, dp


def variants(flat, starts: list, dp: int) -> list:
    """[(name, kind, fn, arg sets, params)]: each variant's call and its
    arguments, one tuple per set of starts; the ``want`` of its kind is
    its plain output on each set (``plain_outputs``)."""
    al = [s // _CH * _CH for s in starts]
    as_f32 = flat.view(torch.float32)
    s64 = [s.to(torch.int64) for s in starts]
    al64 = [s.to(torch.int64) for s in al]
    on = lambda src, ss: [(src, s) for s in ss]
    copy1 = lambda fl, s: wg.window_gather(fl, s, dp).view(torch.int32)
    out = [
        ("A: kernel 2 (ragged_gather)", "kernel 2",
         lambda fl, s: rg.ragged_gather(fl, s, dp, 0), on(flat, starts), {}),
        ("A: kernel 1 copy (window_gather)", "kernel 1 copy", copy1,
         on(as_f32, s64), {}),
        ("A: kernel 1 copy, aligned starts", "kernel 1 copy aligned", copy1,
         on(as_f32, al64), {})]
    for rows, slots in SHIFT_SWEEP:
        k = gp.shift_slots(dp, rows, slots)
        name = f"B: shift rows={rows} slots={slots}"
        if k != slots:
            name += f" (capped {k})"
        out.append((name, "P-s",
                    lambda fl, s, r=rows, k=slots: gp.shift_gather(
                        fl, s, dp, r, k), on(flat, starts),
                    {"rows": rows, "slots": slots, "slots_applied": k}))
    for rows in ALIGNED_ROWS:
        out.append((f"C: aligned rows={rows}", "P-a",
                    lambda fl, s, r=rows: gp.aligned_gather(fl, s, dp, r),
                    on(flat, al),
                    {"rows": rows,
                     "slots_applied": gp.aligned_slots(dp, rows)}))
    out += [
        ("library: unfold(0, dp, 1)[starts]", "library",
         lambda fl, s: fl.unfold(0, dp, 1)[s], on(flat, s64), {}),
        ("plain P-s", "plain P-s",
         lambda fl, s: gp.shift_gather_plain(fl, s, dp), on(flat, starts),
         {}),
        ("plain P-a", "plain P-a",
         lambda fl, s: gp.aligned_gather_plain(fl, s, dp), on(flat, al), {})]
    return out


# the plain output each kind is held to: the window at the start, or at the
# start rounded down to 1024
_ALIGNED_KINDS = ("P-a", "plain P-a", "kernel 1 copy aligned")


def check_exact(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| over the int32 windows; raises unless equal."""
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((diff != 0).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{name} differs from its plain version in "
                             f"{bad} elements")
    return float(diff.max()) if diff.numel() else 0.0


def run(b: int = 1024, d: int = 212, f: int = 33, e: int = 6_837_250,
        device="cuda") -> dict:
    """Every variant checked on every set of starts and timed; prints the
    JAX probe's lines and returns {"rows": [...], "dp", "out_bytes",
    "rw_bytes", "card", ...}.  Raises when a variant differs from its plain
    version, or when a time reads under the read+write bound by more than
    ``SOL_LIMIT`` (the timing or the count would be wrong)."""
    dev = torch.device(device)
    card = card_line(dev)
    flat, starts, dp = probe_data(b, d, f, e, dev)
    out_bytes = b * dp * 4
    # each window read once and written once, and the starts read
    rw_bytes = 2 * out_bytes + b * 4
    rate, _ = roofline.chip_peaks()
    rw_ms = rw_bytes / rate * 1e3 if rate else None
    print(f"window [B={b}, dp={dp}]  out={out_bytes / 1e6:.1f} MB")
    print(f"read+write bound {rw_bytes / 1e6:.1f} MB"
          + (f", {rw_ms * 1e3:.1f} us at {rate / 1e12:.2f} TB/s"
             if rw_ms else "") + f"; on {card}")
    cap = gp.slot_cap((dp + 4) * 4)
    print(f"P-s slots capped at {cap} (slots of {(dp + 4) * 4} bytes in "
          f"{gp.SMEM_LIMIT} bytes of shared memory); P-a ring "
          f"{gp.slot_cap(dp * 4)} slots of {dp * 4} bytes")
    al = [s // _CH * _CH for s in starts]
    want = {"shift": [gp.shift_gather_plain(flat, s, dp) for s in starts],
            "aligned": [gp.aligned_gather_plain(flat, s, dp) for s in al]}
    rows = []
    for name, kind, fn, arg_sets, params in variants(flat, starts, dp):
        wants = want["aligned" if kind in _ALIGNED_KINDS else "shift"]
        err = max(check_exact(name, fn(*a), w)
                  for a, w in zip(arg_sets, wants))
        r = roofline.measure(fn, arg_sets=arg_sets, analytic_bytes=out_bytes,
                             device=dev)
        ms = r["wall_ms"]
        row = {"name": name, "kernel": kind, **params,
               "wall_ms": ms, "readings_ms": r.get("readings_ms"),
               "achieved_gbps": r["achieved_gbps"],
               "sol_frac": r.get("sol_frac"), "rw_bound_ms": rw_ms,
               "rw_frac": rw_ms / ms if rw_ms else None,
               "exact": True, "max_abs_err": err}
        if rw_ms and ms * roofline.SOL_LIMIT < rw_ms:
            raise AssertionError(f"{name}: {ms * 1e3:.2f} us reads under its "
                                 f"read+write bound {rw_ms * 1e3:.2f} us; the "
                                 f"timing or the byte count is wrong")
        rows.append(row)
        sol = f"{row['sol_frac']:.3f}" if row["sol_frac"] is not None else "-"
        spread = (f" ({min(row['readings_ms']) * 1e3:.2f}-"
                  f"{max(row['readings_ms']) * 1e3:.2f})"
                  if row["readings_ms"] else "")
        bound = (f"; read+write bound {rw_ms * 1e3:.1f} us: "
                 f"{row['rw_frac']:.3f}" if rw_ms else "")
        print(f"{name:34s} wall {ms:8.4f} ms{spread}   "
              f"{row['achieved_gbps']:7.1f} GB/s  sol {sol}{bound}")
    print("aligned correct:", all(r["exact"] for r in rows
                                  if r["kernel"] == "P-a"))
    print("shift correct:", all(r["exact"] for r in rows
                                if r["kernel"] == "P-s"))
    return {"rows": rows, "b": b, "dp": dp, "out_bytes": out_bytes,
            "rw_bytes": rw_bytes, "rw_bound_ms": rw_ms,
            "shift_slot_cap": cap, "start_sets": len(starts), "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--d", type=int, default=212)
    ap.add_argument("--f", type=int, default=33)
    ap.add_argument("--e", type=int, default=6_837_250)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.b, args.d, args.f, args.e, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
