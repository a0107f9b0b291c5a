"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  ``--trace 0`` times the window and prints
the cell's end-to-end metrics; ``--trace 1`` profiles the cell's traced
slice (``traced_epochs`` epochs with their validations) and prints its
per-layer metrics, with ``busy_s``, ``window_s`` and the breakdown.  Both
check the timed path against the plain reference and print each compared
number beside its limit, as the last lines of standard error and under
``compared``, the last key of the result line, which is the last line of
standard output.  No card, fewer cards than the cell asks for, or a JAX
module loaded once the window closes: a reason on standard error, no
result, a nonzero exit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
# one process with few threads: the host's share of an epoch stays steady
os.environ.setdefault("OMP_NUM_THREADS", "1")
# build and kernel caches at fixed places inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "portbench-cache" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness
    torch.set_num_threads(1)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = harness.cell_files(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark times the card and never runs "
              "on the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    metrics = harness.cell_metrics(bench, args.workload, bool(args.trace))
    with harness.no_tf32():
        line, rows = harness.run_cell(cfg, traffic, metrics, args.seed,
                                      args.seconds, bool(args.trace),
                                      "cuda:0", T0)
    for k, v, lim in rows:
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
