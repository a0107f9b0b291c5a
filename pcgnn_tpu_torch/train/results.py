"""Experiment result management.

Counterpart of ``pcgnn_tpu/train/results.py``: the same tree under
``./experimental_results`` — ``validation_df/ test_df/ validation_log/
test_log/ saved_models/ predictions/`` — with the same config-headed
``.log`` files and ``.npy`` predictions.  The cumulative result tables are
CSV files (``<exp_id>.csv`` per validation run, ``<model>-<data>.csv`` for
tests) instead of pickled DataFrames.
"""

from __future__ import annotations

import csv
import math
import os
from datetime import datetime

import numpy as np

_METRICS = ("accuracy", "f1", "f1_macro", "precision", "precision_macro",
            "recall", "recall_macro", "auc", "gmean")

# metric-line key -> table column
_LOG_METRIC_COLS = (
    ("accuracy", "accuracy"), ("f1", "f1"), ("f1-macro", "f1_macro"),
    ("precision", "precision"), ("ap", "precision_macro"),
    ("recall", "recall"), ("recall-macro", "recall_macro"),
    ("auc-roc", "auc"), ("gmean", "gmean"),
)


def write_table(path: str, rows: list) -> None:
    """Write a list of dicts as CSV (columns in first-seen order)."""
    cols = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)


def read_table(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class ResultManager:
    def __init__(self, args: dict, root: str = "./experimental_results"):
        self.root = root
        self.dirs = {
            "df_val": os.path.join(root, "validation_df"),
            "df_test": os.path.join(root, "test_df"),
            "log_val": os.path.join(root, "validation_log"),
            "log_test": os.path.join(root, "test_log"),
            "models": os.path.join(root, "saved_models"),
            "preds": os.path.join(root, "predictions"),
        }
        for d in self.dirs.values():
            os.makedirs(d, exist_ok=True)
        self.args = args
        model, data_name = args["model"], args["data_name"]
        stamp = datetime.now().strftime("%y%m%d-%H%M%S-%f")
        self.exp_id = f"{model}-{data_name}-{stamp}"
        self.df_val_path = os.path.join(self.dirs["df_val"],
                                        f"{self.exp_id}.csv")
        self.df_test_path = os.path.join(self.dirs["df_test"],
                                         f"{model}-{data_name}.csv")
        self.log_val_path = os.path.join(self.dirs["log_val"],
                                         f"{self.exp_id}.log")
        self.log_test_path = os.path.join(self.dirs["log_test"],
                                          f"{self.exp_id}.log")
        self.model_path = os.path.join(self.dirs["models"],
                                       f"{self.exp_id}.ckpt")
        self.df_val: list = []
        self.df_test: list = (read_table(self.df_test_path)
                              if os.path.exists(self.df_test_path) else [])
        header = "\n".join(f"{k}: {args[k]}" for k in sorted(args))
        for path in (self.log_val_path, self.log_test_path):
            with open(path, "a") as f:
                f.write(header + "\n")

    @staticmethod
    def _row(res) -> dict:
        return {k: getattr(res, k) for k in _METRICS}

    def write_val_log(self, epoch: int, epoch_best: int, res, print_line=True):
        line = (f"[Epoch-{str(epoch).zfill(3)}] Validation performance\n"
                f"{res.line}")
        with open(self.log_val_path, "a") as f:
            f.write(line + "\n")
        if print_line:
            print(line)
        self.df_val.append(dict(epoch=epoch, epoch_best=epoch_best,
                                **self._row(res)))
        write_table(self.df_val_path, self.df_val)

    def load_df_test(self) -> list:
        """Rebuild the cumulative test table by re-parsing every test
        ``.log`` of this (model, data) pair; logs whose run never reached
        the final test are skipped."""
        rows = []
        pair = f"{self.args['model']}-{self.args['data_name']}"
        log_dir = self.dirs["log_test"]
        for name in sorted(os.listdir(log_dir)):
            if pair not in name:
                continue
            with open(os.path.join(log_dir, name)) as f:
                # the test line ends "\t\n" plus the writer's "\n": drop the
                # empty trailer
                lines = [ln.strip() for ln in f.readlines()][:-1]
            if not lines or "Test performance" not in lines[-1]:
                continue
            result = lines.pop()
            metrics = dict(m.strip().split(": ", 1)
                           for m in result.split("- ")[1:] if ": " in m)
            metrics = {k.lower(): float(v) for k, v in metrics.items()}
            row = dict(exp_id=name[:-4], epoch_best=metrics["epoch_best"])
            for key, col in _LOG_METRIC_COLS:
                row[col] = metrics.get(key, math.nan)
            cfg = dict(ln.split(": ", 1) for ln in lines if ": " in ln)
            row.update({k: cfg[k] for k in sorted(cfg)})
            rows.append(row)
        write_table(self.df_test_path, rows)
        self.df_test = rows
        return rows

    def write_test_log(self, epoch_best: int, res, print_line=True):
        self.load_df_test()
        line = f"Test performance: - Epoch_Best: {epoch_best}\t" + res.line
        with open(self.log_test_path, "a") as f:
            f.write(line + "\n")
        if print_line:
            print(line)
        row = dict(exp_id=self.exp_id, epoch_best=epoch_best,
                   **self._row(res))
        row.update({k: str(self.args[k]) for k in sorted(self.args)})
        self.df_test.append(row)
        write_table(self.df_test_path, self.df_test)

    def get_best_model_exp_id(self, metric: str = "auc") -> str:
        vals = [float(r[metric]) for r in self.df_test]
        return self.df_test[int(np.argmax(vals))]["exp_id"]

    def get_best_model_path(self, metric: str = "auc") -> str:
        return os.path.join(self.dirs["models"],
                            f"{self.get_best_model_exp_id(metric)}.ckpt")

    def save_predictions(self, arr: np.ndarray, name: str) -> None:
        np.save(os.path.join(self.dirs["preds"], f"{self.exp_id}-{name}"), arr)
