#!/usr/bin/env python3
"""Where the host build of a synthetic graph spends its time.

    python3 build_profile.py [--preset stress-10m] [--seed 2] [--numpy]
                             [--out FILE]

Builds the preset on the host (CPU tensors, as ``chip_smoke.py`` builds
its stress graphs before moving them to the card) under cProfile, with the
graph core that ``graph.csr.csr_arrays`` loads, and prints one JSON line:
the seconds of each build step (``synthetic_fraud_graph(timings=...)``:
the random draws, each relation's CSR and ``finalize_csr``, the homo
degrees, the assembly), the functions with the most own time, the peak
resident memory, and the host (cores, CPU model, numpy and torch
versions, the first touch of 2 GiB of fresh memory against a second pass
over it).  ``--numpy`` builds the graph again with the native core off
(the numpy version of every CSR), checks that the two graphs are equal,
and prints that build's line too.  ``--out`` also writes the lines to
FILE.  Needs no card.
"""

from __future__ import annotations

import argparse
import cProfile
import contextlib
import json
import os
import platform
import pstats
import resource
import sys
import time
from unittest import mock

import numpy as np
import torch

from pcgnn_tpu_torch import native
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph

TOP_FUNCTIONS = 12
TOUCH_BYTES = 2 << 30


def host_facts() -> dict:
    model = ""
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        model = next((line.split(":", 1)[1].strip() for line in f
                      if line.startswith("model name")), "")
    a = np.empty(TOUCH_BYTES // 8)
    t0 = time.perf_counter()
    a.fill(1.0)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    a.fill(2.0)
    second = time.perf_counter() - t0
    del a
    return {"cores": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "cpu": model, "python": platform.python_version(),
            "numpy": np.__version__, "torch": torch.__version__,
            "touch_2gib_first_s": first, "touch_2gib_second_s": second}


def top_functions(prof: cProfile.Profile) -> list:
    """[(function, own seconds, calls)] with the most own time."""
    stats = pstats.Stats(prof).stats
    rows = sorted(((pstats.func_std_string(fn), tt, nc)
                   for fn, (_, nc, tt, _, _) in stats.items()),
                  key=lambda r: -r[1])
    return [(name, round(tt, 3), nc) for name, tt, nc in rows[:TOP_FUNCTIONS]]


def profiled_build(preset: str, seed: int) -> tuple:
    timings = {}
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    g = synthetic_fraud_graph(preset, seed=seed, timings=timings)
    prof.disable()
    total = time.perf_counter() - t0
    rels = [{"edges": r.num_edges, "dmax": r.dmax, "dense_table":
             r.nbr2d is not None} for r in g.relations]
    return g, {"preset": preset, "seed": seed, "total_s": total,
               "steps_s": timings, "relations": rels,
               "top_own_s": top_functions(prof),
               "peak_rss_bytes": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss * 1024}


def graphs_equal(a, b) -> bool:
    def rel_equal(x, y):
        return all(torch.equal(getattr(x, k), getattr(y, k)) for k in (
            "indptr", "col", "deg", "keff", "ksample"))
    return (torch.equal(a.features, b.features)
            and torch.equal(a.labels, b.labels)
            and rel_equal(a.homo, b.homo)
            and all(rel_equal(x, y) for x, y in zip(a.relations,
                                                     b.relations)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="stress-10m")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--numpy", action="store_true",
                    help="build again with the numpy CSR and compare")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    lines = [{"host": host_facts()}]
    print(json.dumps(lines[-1]), flush=True)
    g, rec = profiled_build(args.preset, args.seed)
    rec["csr_path"] = ("native " + native.loaded_path()
                       if native.available() else "numpy")
    lines.append(rec)
    print(json.dumps(rec), flush=True)
    if args.numpy:
        with mock.patch.object(native, "available", lambda: False):
            g2, rec2 = profiled_build(args.preset, args.seed)
        rec2["csr_path"] = "numpy"
        rec2["equal_to_native_build"] = graphs_equal(g, g2)
        lines.append(rec2)
        print(json.dumps(rec2), flush=True)
        if not rec2["equal_to_native_build"]:
            print("build_profile: the numpy and native builds differ",
                  file=sys.stderr)
            return 1
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
