"""The readings the limits are set from, for one cell over many seeds in
one process (the benchmark's own runs do not run this):

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ...
        [--seconds 2] [--control-seeds 3]

For each seed: the program set up as a run sets it up (once, for the
first seed: the dataset is the configuration's, so each later seed only
draws its initial weights and records epoch 0 again, ``Run.reseed``), a
short window at the cell's load, then the compared numbers of the program
against the reference (the lower readings), and, on the first
``--control-seeds`` seeds, of the control (the reference in TF32 in the
program's place) and of the faults put in the reference's place: half of
every batch left out with the mean over the rest, every step fed the next
step's batch row (a replay that reads the wrong row of the static
buffers), and one validation answer altered by 0.5 (a state left
unchanged reads 1 by the measure and needs no run); and the reference
against itself from initial weights one float32 step nearer zero
(``round_off``: what round-off alone moves).  One JSON line a reading."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, harness


def faults(ref, g, rec: dict, hyper: dict, sound: dict) -> dict:
    """The compared numbers of each fault, put in the place of reference
    module ``ref``, against the sound reference ``sound``."""
    half = dict(rec)
    half["weights"] = []
    for w in rec["weights"]:
        w = w.clone()
        w[w.shape[0] // 2:] = 0.0
        half["weights"].append(w)
    out = {"half_batch": check.gaps(
        check.reference_readings(ref, g, half, hyper), sound)}
    shifted = dict(rec)
    shifted["batches"] = rec["batches"][1:] + rec["batches"][:1]
    shifted["weights"] = rec["weights"][1:] + rec["weights"][:1]
    out["wrong_row"] = check.gaps(
        check.reference_readings(ref, g, shifted, hyper), sound)
    altered = dict(sound)
    altered["probs"] = sound["probs"].clone()
    altered["probs"][0] = (altered["probs"][0] + 0.5) % 1.0
    out["answer_altered"] = check.gaps(altered, sound)
    return out


def round_off(ref, g, rec: dict, hyper: dict, sound: dict) -> dict:
    """The compared numbers of the reference against itself from initial
    weights one float32 step nearer zero: how far round-off alone moves
    them."""
    nudged = dict(rec)
    nudged["params0"] = {k: torch.nextafter(v, torch.zeros_like(v))
                         for k, v in rec["params0"].items()}
    return check.gaps(check.reference_readings(ref, g, nudged, hyper), sound)


def steps(got: dict, sound: dict) -> dict:
    """What the compared numbers are made of: each step's relative loss
    gap, each leaf's change gap, and the first gradient's elements whose
    sign differs (Adam moves each of them by about twice the rate)."""
    rn = {k: float(v.double().norm()) for k, v in sound["change"].items()}
    return {
        "loss": [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                     sound["losses"])],
        "change": {k: abs(float(got["change"][k].double().norm()) - rn[k])
                   / rn[k] for k in rn},
        "grad_sign_flips": sum(int((torch.sign(got["grad"][k])
                                    != torch.sign(sound["grad"][k])).sum())
                               for k in sound["grad"])}


def readings(cfg: dict, traffic: dict, seeds, seconds: float,
             control_seeds: int, device):
    """One dict a seed (module docstring), as it is read."""
    hyper = cfg["model"]
    run = g = None
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        with harness.no_tf32():
            if run is None:
                run = harness.Run(cfg, traffic, seed, device)
                run.setup()
                run.reference()
                g = run.ref
            else:
                run.reseed(seed)
            setup_s = time.perf_counter() - t0
            run.window(seconds)
            ref = run.refmod
            prog = check.program_readings(run.rec, device)
            sound = check.reference_readings(ref, g, run.rec, hyper)
            line = {"seed": seed, "setup_s": setup_s, "laps": run.laps,
                    "steps": steps(prog, sound),
                    "pick_bad": check.pick_bad(g, run.rec["plan_batches"],
                                               run.rec["plan_weights"],
                                               run.rec["plan_labels"]),
                    "program": check.gaps(prog, sound)}
            if i < control_seeds:
                t1 = time.perf_counter()
                low = check.reference_readings(ref, g, run.rec, hyper,
                                               low=True)
                line["control"] = check.gaps(low, sound)
                line["control_steps"] = steps(low, sound)
                line["faults"] = faults(ref, g, run.rec, hyper, sound)
                line["round_off"] = round_off(ref, g, run.rec, hyper, sound)
                line["reference_s"] = time.perf_counter() - t1
        yield line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.Path("BENCHMARK.json"))
    _, cfg, traffic = harness.cell_files(bench, args.workload)
    for line in readings(cfg, traffic, args.seeds, args.seconds,
                         args.control_seeds, torch.device("cuda:0")):
        print(json.dumps({"workload": args.workload, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
