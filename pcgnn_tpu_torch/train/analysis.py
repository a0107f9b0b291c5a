"""Result aggregation over repeated seeds: mean, std and count of AUC /
F1-macro / recall / G-mean, grouped by (model, data_name, train_ratio).

Counterpart of ``pcgnn_tpu/train/analysis.py``, without pandas: it reads
the port's CSV test tables (``test_df/*.csv``, ``train.results``) with
``csv``, and computes as pandas' ``groupby(...).agg(["mean", "std",
"count"])`` does: empty or NaN cells are skipped, std has ddof = 1 (NaN for
one value, 0 for equal values), groups come sorted.  Values stay the
strings the tables hold, so ``train_ratio`` groups as written.

Usage:
  python -m pcgnn_tpu_torch.train.analysis [--results ./experimental_results]
"""

from __future__ import annotations

import argparse
import glob
import math
import os

import numpy as np

from pcgnn_tpu_torch.train.results import read_table

METRICS = ("auc", "f1_macro", "recall", "gmean")
GROUP_KEYS = ("model", "data_name", "train_ratio")
STATS = ("mean", "std", "count")


def load_all_test_dfs(results_dir: str = "./experimental_results") -> list:
    """Every row of every test table under ``results_dir``, as dicts."""
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "test_df",
                                              "*.csv"))):
        rows.extend(read_table(path))
    return rows


def _stats(cells: list) -> dict:
    vals = np.array([float(c) for c in cells if c not in (None, "")],
                    dtype=np.float64)
    vals = vals[~np.isnan(vals)]
    n = len(vals)
    # the spread about the first value: equal values give exactly 0, as
    # pandas' running variance does
    return {"mean": float(vals.mean()) if n else math.nan,
            "std": float((vals - vals[0]).std(ddof=1)) if n > 1 else math.nan,
            "count": n}


def summarize(rows: list) -> dict:
    """{group tuple: {metric: {"mean", "std", "count"}}} over the present
    ``GROUP_KEYS`` and ``METRICS``, groups in sorted order."""
    if not rows:
        return {}
    cols = set().union(*rows)
    keys = [k for k in GROUP_KEYS if k in cols]
    metrics = [m for m in METRICS if m in cols]
    groups: dict = {}
    for row in rows:
        groups.setdefault(tuple(row.get(k) for k in keys), []).append(row)
    return {g: {m: _stats([r.get(m) for r in groups[g]]) for m in metrics}
            for g in sorted(groups)}


def format_summary(summary: dict) -> str:
    """One line per group: the group's keys, then mean ± std (n) of each
    metric."""
    lines = []
    for group, metrics in summary.items():
        cells = [f"{m} {s['mean']:.4f} ± {s['std']:.4f} ({s['count']})"
                 for m, s in metrics.items()]
        lines.append("  ".join([" ".join(map(str, group))] + cells))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="./experimental_results")
    args = ap.parse_args(argv)
    rows = load_all_test_dfs(args.results)
    if not rows:
        print("no test results found")
        return
    print(format_summary(summarize(rows)))


if __name__ == "__main__":
    main()
