"""Command-line entry point.

``python -m pcgnn_tpu_torch.cli --exp_config_path=<cfg.json> [--device cpu]``
runs one training job on the GPU (``cuda``, the default) or the CPU;
list-valued config entries run a sweep with mean ± std aggregation.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from pcgnn_tpu_torch.train.trainer import Trainer
from pcgnn_tpu_torch.utils.config import grid, load_config, print_config


def run_single(config: dict, device=None):
    print_config(config)
    return Trainer(config, device=device).train()


def run(config: dict, device=None):
    configs = grid(config)
    if len(configs) == 1:
        return run_single(configs[0], device)

    f1s, aucs, recalls = [], [], []
    for i, cnf in enumerate(configs):
        print(f"Running {i}:\n")
        t0 = time.time()
        auc, recall, f1 = run_single(cnf, device)
        aucs.append(auc)
        recalls.append(recall)
        f1s.append(f1)
        print(f"Running {i} done, elapsed time {time.time() - t0:.1f}s")

    def agg(xs):
        return (float(np.mean(xs)),
                float(np.std(xs, ddof=1)) if len(xs) > 1 else 0.0)

    print(f"AUC    {agg(aucs)[0]:.4f} ± {agg(aucs)[1]:.4f}")
    print(f"F1-mac {agg(f1s)[0]:.4f} ± {agg(f1s)[1]:.4f}")
    print(f"Recall {agg(recalls)[0]:.4f} ± {agg(recalls)[1]:.4f}")
    return aucs, recalls, f1s


def main(argv=None):
    parser = argparse.ArgumentParser(prog="pcgnn_tpu_torch")
    parser.add_argument("--exp_config_path", type=str,
                        default="./configs/pcgnn_synthetic.json")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain CPU path")
    args = parser.parse_args(argv)
    return run(load_config(args.exp_config_path), device=args.device)


if __name__ == "__main__":
    main()
