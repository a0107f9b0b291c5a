"""Quality benchmark: train PC-GNN, GCN and GraphSAGE on reference-scale
synthetic graphs over repeated seeds (the reference's verification
protocol), and write a table of mean±std AUC / F1-macro / GMean / recall
(counterpart of ``benchmarks/quality_run.py``).

    python -m pcgnn_tpu_torch.benchmarks.quality_run [--seeds 2 3 5] \\
        [--epochs 300] [--valid_epochs 10] [--patience 100] \\
        [--out build/quality_run/RESULTS.md] [--device cuda]

The JAX script's five settings, flags and defaults.  Each run trains
through ``Trainer.train`` (validation every ``valid_epochs``, patience,
restore-best), whose test AUC, recall and F1-macro it reports; GMean is
the restored model's, from ``Trainer.evaluate`` on the test split.
It prints the JAX script's line per run and its JSON rows, and writes its
table to ``--out`` (under the git-ignored ``build/`` by default; never
``RESULTS.md``), with the card's name and power limit in place of "single
TPU".  The runs' result trees go to ``experimental_results/`` beside
``--out``.  It trains on ``cuda`` unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

SETTINGS = [
    # (data, model, train_ratio, lr, wd, batch)
    ("synthetic:yelp-like", "PCGNN", 0.4, 0.01, 0.001, 1024),
    ("synthetic:yelp-like", "GCN", 0.4, 0.01, 0.001, 1024),
    ("synthetic:yelp-like", "SAGE", 0.4, 0.01, 0.001, 1024),
    # BASELINE.json config 3 (configs/pcgnn_amazon.json's settings)
    ("synthetic:amazon-like", "PCGNN", 0.4, 0.005, 0.0005, 256),
    # heavy-tailed preset: relation 2's hub rows go through the hub lane
    ("synthetic:yelp-skew", "PCGNN", 0.4, 0.01, 0.001, 1024),
]
DEFAULT_OUT = os.path.join("build", "quality_run", "RESULTS.md")
TABLE_HEADER = ("| data | model | AUC | F1-macro | GMean | Recall | s/run |",
                "|---|---|---|---|---|---|---|")


def mean_std(xs) -> tuple:
    """(mean, sample std), std 0 for one value."""
    return (float(np.mean(xs)),
            float(np.std(xs, ddof=1)) if len(xs) > 1 else 0.0)


def table(rows: list, seeds, epochs: int, patience: int, valid_epochs: int,
          device_line: str) -> str:
    """The JAX script's table of ``rows``."""
    lines = [
        "# RESULTS — pcgnn_tpu_torch quality runs (synthetic "
        "reference-scale graphs)",
        "",
        f"Device: {device_line}; epochs<={epochs}, patience {patience}, "
        f"valid every {valid_epochs}; seeds {list(seeds)}.  Datasets are "
        "synthetic (the reference's YelpChi/Amazon files are not "
        "redistributable); absolute numbers are not comparable to "
        "BASELINE.md, the purpose is end-to-end capability + relative "
        "model behavior.  The port's parity with the JAX package is held "
        "by tests/test_torch_*.py.",
        "",
        *TABLE_HEADER,
    ]
    for r in rows:
        lines.append(
            f"| {r['data']} | {r['model']} | "
            f"{r['auc'][0]:.4f}±{r['auc'][1]:.4f} | "
            f"{r['f1_macro'][0]:.4f}±{r['f1_macro'][1]:.4f} | "
            f"{r['gmean'][0]:.4f}±{r['gmean'][1]:.4f} | "
            f"{r['recall'][0]:.4f}±{r['recall'][1]:.4f} | "
            f"{r['sec_per_run']:.0f} |")
    return "\n".join(lines) + "\n"


def run(seeds=(2, 3, 5), epochs: int = 300, valid_epochs: int = 10,
        patience: int = 100, out: str = DEFAULT_OUT, device="cuda",
        settings=SETTINGS, graphs=None) -> tuple:
    """(rows, runs): the JAX script's rows, and per run its setting, seed,
    metrics, seconds and (on a card) peak device memory.  ``graphs``:
    {(data_name, seed): graph} already built, without stores (a trainer
    builds its model's)."""
    from pcgnn_tpu_torch.benchmarks import card_line
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer, resolve_device
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    results_root = os.path.join(os.path.dirname(out) or ".",
                                "experimental_results")
    graphs = graphs or {}
    rows, runs = [], []
    for data, model, tr, lr, wd, bs in settings:
        aucs, f1s, gmeans, recalls, times = [], [], [], [], []
        for seed in seeds:
            cfg = dict(seed=seed, data_name=data, model=model, train_ratio=tr,
                       test_ratio=0.67, emb_size=64, lr=lr, weight_decay=wd,
                       alpha=2.0, rho=0.5, epochs=epochs,
                       valid_epochs=valid_epochs, batch_size=bs,
                       patience=patience, exp_num=0)
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            t = Trainer(cfg, graph=graphs.get((data, seed)),
                        result=ResultManager(cfg, root=results_root),
                        device=dev)
            auc, recall, f1 = t.train()
            res = t.evaluate(t.model, t.idx_test, t.y_test,
                             print_line=False)
            aucs.append(auc)
            f1s.append(f1)
            recalls.append(recall)
            gmeans.append(res.gmean)
            times.append(time.time() - t0)
            runs.append(dict(
                data=data, model=model, seed=seed, auc=auc, f1_macro=f1,
                recall=recall, gmean=res.gmean, seconds=times[-1],
                epochs_run=len(t.epoch_times),
                peak_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                                if on_card else None)))
            print(f"[{model} {data} seed={seed}] auc={auc:.4f} "
                  f"f1_mac={f1:.4f} gmean={res.gmean:.4f} "
                  f"({times[-1]:.0f}s)", flush=True)
            del t
        rows.append(dict(data=data, model=model, train_ratio=tr,
                         seeds=len(seeds), auc=mean_std(aucs),
                         f1_macro=mean_std(f1s), gmean=mean_std(gmeans),
                         recall=mean_std(recalls),
                         sec_per_run=float(np.mean(times))))
    device_line = card_line(dev) or str(dev)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(table(rows, seeds, epochs, patience, valid_epochs,
                      device_line))
    return rows, runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[2, 3, 5])
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--valid_epochs", type=int, default=10)
    ap.add_argument("--patience", type=int, default=100)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows, _ = run(args.seeds, args.epochs, args.valid_epochs, args.patience,
                  args.out, args.device)
    print(json.dumps(rows, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
