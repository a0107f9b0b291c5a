"""Experiment config generation: the 10-prime-seed x dataset x train_ratio
grid with per-dataset lr / weight_decay / batch_size, written as JSON files
for ``pcgnn_tpu_torch.cli``.

Counterpart of ``pcgnn_tpu/utils/expgen.py``: the same files, schema and
hyperparameters.

Usage:
  python -m pcgnn_tpu_torch.utils.expgen --out_dir experiment_configs
"""

from __future__ import annotations

import argparse
import json
import os

SEEDS = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29]
TRAIN_RATIOS = [0.01, 0.05, 0.1, 0.4]

# per-dataset hyperparameters
DATASET_HP = {
    "yelp": dict(lr=0.01, weight_decay=0.001, batch_size=1024),
    "amazon_new": dict(lr=0.005, weight_decay=0.0005, batch_size=256),
    "amazon": dict(lr=0.005, weight_decay=0.0005, batch_size=256),
    "synthetic:yelp-like": dict(lr=0.01, weight_decay=0.001, batch_size=1024),
    "synthetic:amazon-like": dict(lr=0.005, weight_decay=0.0005,
                                  batch_size=256),
    "synthetic:yelp-skew": dict(lr=0.01, weight_decay=0.001, batch_size=1024),
    "synthetic:amazon_new-like": dict(lr=0.005, weight_decay=0.0005,
                                      batch_size=256),
}

FIXED = dict(model="PCGNN", test_ratio=0.67, emb_size=64, epochs=1000,
             valid_epochs=10, patience=100, alpha=2, rho=0.5)


def generate(out_dir: str, datasets=("yelp", "amazon_new"),
             seeds=SEEDS, train_ratios=TRAIN_RATIOS) -> list:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    exp_num = 0
    for data_name in datasets:
        hp = DATASET_HP.get(data_name, DATASET_HP["yelp"])
        for train_ratio in train_ratios:
            for seed in seeds:
                cfg = dict(FIXED)
                cfg.update(hp)
                cfg.update(seed=seed, data_name=data_name,
                           train_ratio=train_ratio, exp_num=exp_num)
                safe = data_name.replace(":", "_")
                path = os.path.join(
                    out_dir, f"{safe}-tr{train_ratio}-seed{seed}.json")
                with open(path, "w") as f:
                    json.dump(cfg, f, indent=2)
                paths.append(path)
                exp_num += 1
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", default="experiment_configs")
    ap.add_argument("--datasets", nargs="+", default=["yelp", "amazon_new"])
    ap.add_argument("--train_ratios", nargs="+", type=float,
                    default=TRAIN_RATIOS)
    args = ap.parse_args(argv)
    paths = generate(args.out_dir, datasets=args.datasets,
                     train_ratios=args.train_ratios)
    print(f"wrote {len(paths)} configs to {args.out_dir}")


if __name__ == "__main__":
    main()
