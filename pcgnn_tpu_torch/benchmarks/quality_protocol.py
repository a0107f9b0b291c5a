"""The reference's full verification protocol, end to end through the
port's pipeline (counterpart of ``benchmarks/quality_protocol.py``):

  utils.expgen   -> the 10-prime-seed config grid (epochs 1000, patience
                    100, per-dataset hyperparameters), in seed-major order
  the CLI        -> one ``python -m pcgnn_tpu_torch.cli`` run at a time
                    (one card, one job), under a wall budget
  train.analysis -> mean±std over the result tree's test tables

and writes the quality table.  Datasets are the synthetic reference-scale
presets (the real YelpChi/Amazon files are not in the repository).

    python -m pcgnn_tpu_torch.benchmarks.quality_protocol \\
        [--workdir build/quality_protocol] [--datasets ...] \\
        [--seeds all|N] [--train_ratios 0.4] [--max_hours 4] \\
        [--epochs N] [--out PATH] [--device cuda]

The runs work in ``--workdir`` (configs, each run's log under ``logs/``,
the result tree ``experimental_results/``); the table goes to ``--out``,
by default ``<workdir>/RESULTS_QUALITY.md``, never the repository's
``RESULTS_QUALITY.md``.  ``--epochs`` cuts every config to that many
epochs (validating at least once); the default keeps expgen's 1000.  The
JAX script points ``JAX_COMPILATION_CACHE_DIR`` into the workdir so
that later runs skip their compiles; PyTorch compiles nothing ahead of a
run and the kernels build once per process, so there is no counterpart.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

from pcgnn_tpu_torch.utils import expgen

DATASETS = ("synthetic:yelp-like", "synthetic:yelp-skew",
            "synthetic:amazon-like", "synthetic:amazon_new-like")
DEFAULT_WORKDIR = os.path.join("build", "quality_protocol")


def configs(workdir: str, datasets, seeds, train_ratios,
            epochs: int | None = None) -> list:
    """expgen's config files under ``<workdir>/configs``, seed-major (if the
    wall budget cuts the sweep short, every dataset has the same seeds
    done); ``epochs`` cuts each, with ``valid_epochs`` at most that."""
    paths = expgen.generate(os.path.join(workdir, "configs"),
                            datasets=datasets, seeds=seeds,
                            train_ratios=train_ratios)
    paths = [p for seed in seeds for p in paths
             if os.path.basename(p).endswith(f"seed{seed}.json")]
    if epochs is not None:
        for p in paths:
            with open(p) as f:
                cfg = json.load(f)
            cfg.update(epochs=epochs,
                       valid_epochs=min(cfg["valid_epochs"], epochs))
            with open(p, "w") as f:
                json.dump(cfg, f, indent=2)
    return paths


def table(summary: dict, seeds, device_line: str) -> str:
    """The JAX script's table of ``train.analysis.summarize``'s groups."""
    lines = [
        "# RESULTS_QUALITY — the reference verification protocol, "
        "pcgnn_tpu_torch",
        "",
        f"Prime-seed grid (seeds {list(seeds)}), per-dataset reference HP "
        "(`utils.expgen`), run through serial `pcgnn_tpu_torch.cli` runs "
        f"-> `train.analysis` on {device_line}.  Synthetic reference-scale "
        "presets (the real YelpChi/Amazon files are not redistributable).",
        "",
        "| data | model | train_ratio | seeds | AUC | F1-macro | Recall |",
        "|---|---|---|---|---|---|---|",
    ]
    for (model, data_name, train_ratio), stats in summary.items():
        def ms(metric):
            s = stats[metric]
            std = 0.0 if math.isnan(s["std"]) else s["std"]
            return f"{s['mean']:.4f}±{std:.4f}"

        lines.append(
            f"| {data_name} | {model} | {train_ratio} "
            f"| {stats['auc']['count']} | {ms('auc')} "
            f"| {ms('f1_macro')} | {ms('recall')} |")
    return "\n".join(lines) + "\n"


def run(workdir: str = DEFAULT_WORKDIR, datasets=DATASETS, seeds="all",
        train_ratios=(0.4,), max_hours: float = 4.0,
        epochs: int | None = None, out: str | None = None,
        device: str = "cuda", run_timeout: float | None = None) -> dict:
    """Generate, run and aggregate; returns {"runs": [(config, rc,
    seconds)], "done", "failed", "skipped", "summary", "out"}.
    ``run_timeout``: seconds one CLI run may take before it is killed and
    counted as failed (default: no limit)."""
    from pcgnn_tpu_torch.benchmarks import card_line
    from pcgnn_tpu_torch.train.analysis import (format_summary,
                                                load_all_test_dfs, summarize)
    from pcgnn_tpu_torch.utils.multiproc import worker_env
    seeds = expgen.SEEDS if seeds == "all" else expgen.SEEDS[: int(seeds)]
    workdir = os.path.abspath(workdir)
    os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
    paths = configs(workdir, datasets, seeds, train_ratios, epochs)
    print(f"{len(paths)} configs ({len(seeds)} seeds x {len(datasets)} "
          f"datasets x {len(train_ratios)} ratios)", flush=True)

    # the CLI runs with cwd=workdir (its result tree lands there); the
    # package is imported from this checkout
    env = worker_env()
    deadline = time.time() + max_hours * 3600
    runs, skipped = [], 0
    for path in paths:
        if time.time() > deadline:
            skipped += 1
            continue
        name = os.path.basename(path)
        print("launch:", name, flush=True)
        t0 = time.time()
        with open(os.path.join(workdir, "logs", name + ".log"), "w") as log:
            try:
                rc = subprocess.run(
                    [sys.executable, "-m", "pcgnn_tpu_torch.cli",
                     f"--exp_config_path={path}", "--device", device],
                    cwd=workdir, env=env, stdout=log,
                    stderr=subprocess.STDOUT, timeout=run_timeout).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
        runs.append((name, rc, time.time() - t0))
        print(f"  rc={rc} ({runs[-1][2]:.0f}s)", flush=True)
    done = sum(rc == 0 for _, rc, _ in runs)
    failed = len(runs) - done
    print(f"runs: {done} ok, {failed} failed, {skipped} skipped (budget)",
          flush=True)

    summary = summarize(load_all_test_dfs(
        os.path.join(workdir, "experimental_results")))
    result = {"runs": runs, "done": done, "failed": failed,
              "skipped": skipped, "summary": summary, "out": None}
    if not summary:
        print("no results to aggregate")
        return result
    print(format_summary(summary))
    out = out or os.path.join(workdir, "RESULTS_QUALITY.md")
    with open(out, "w") as f:
        f.write(table(summary, seeds, card_line(device) or device))
    print(f"wrote {out}")
    result["out"] = out
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--datasets", nargs="+", default=list(DATASETS))
    ap.add_argument("--seeds", default="all",
                    help="'all' = the 10 prime seeds, or a count prefix")
    ap.add_argument("--train_ratios", nargs="+", type=float, default=[0.4])
    ap.add_argument("--max_hours", type=float, default=4.0,
                    help="stop launching new runs past this wall budget; "
                    "completed runs still aggregate")
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut every config to this many epochs")
    ap.add_argument("--out", default=None,
                    help="the table (default <workdir>/RESULTS_QUALITY.md)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.workdir, args.datasets, args.seeds, args.train_ratios,
        args.max_hours, args.epochs, args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
