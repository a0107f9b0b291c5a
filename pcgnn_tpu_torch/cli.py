"""Command-line entry point.

``python -m pcgnn_tpu_torch.cli --exp_config_path=<cfg.json> [--device cpu]``
runs one training job on the GPU (``cuda``, the default) or the CPU;
list-valued config entries run a sweep with mean ± std aggregation.

Multi-device:
  * ``num_devices: N > 1`` (without ``distributed``) starts N local ranks
    (``utils.multiproc``), rank r on ``cuda:r`` (or all on the CPU with
    ``--device cpu``), joined over localhost; it raises when fewer cards
    are visible.  Rank 0's metrics are returned, its log printed.
  * ``distributed: true``: this process is one rank of a group
    (``train.trainer.Trainer``); every rank runs the same command.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from pcgnn_tpu_torch.train.trainer import Trainer, resolve_device
from pcgnn_tpu_torch.utils.config import grid, load_config, print_config

# a gang of local ranks that does not finish in this time is killed
RANKS_TIMEOUT_S = 24 * 3600.0


def rank_device(device, rank: int) -> str:
    """Rank r's device: ``cuda:r`` for the default ``cuda``, else
    ``device`` itself (the CPU, or one card named by the caller)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{rank}"
    return str(dev)


def run_local_ranks(config: dict, device=None):
    """Train ``config`` on ``num_devices`` local ranks, one process each;
    returns their (auc, recall, f1), which must be the same on every
    rank."""
    from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                                 run_workers, worker_env)
    n = int(config["num_devices"])
    dev = resolve_device(device)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"num_devices={n} but only "
                         f"{torch.cuda.device_count()} devices are visible")
    with tempfile.TemporaryDirectory(prefix="pcgnn_ranks-") as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        outs = [os.path.join(tmp, f"metrics-{r}.json") for r in range(n)]
        logs = gang_with_fresh_port(lambda port: run_workers(
            ["-m", "pcgnn_tpu_torch.cli"],
            [("--exp_config_path", cfg_path, "--rank", r, "--port", port,
              "--device", rank_device(device, r), "--metrics_out", outs[r])
             for r in range(n)],
            env=worker_env(), timeout=RANKS_TIMEOUT_S, cwd=os.getcwd()))
        print(logs[0], end="")
        metrics = []
        for out in outs:
            with open(out) as f:
                metrics.append(tuple(json.load(f)))
    # the replicas decide alike: every rank ends with the same metrics
    if any(m != metrics[0] for m in metrics):
        raise RuntimeError(f"the ranks' metrics differ: {metrics}")
    return metrics[0]


def run_rank(config: dict, rank: int, port: int, device, metrics_out: str):
    """One of ``run_local_ranks``' ranks: join the group, train, write the
    metrics."""
    from pcgnn_tpu_torch.parallel.distributed import (default_backend,
                                                      init_distributed)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(f"localhost:{port}", int(config["num_devices"]), rank,
                     backend=config.get("dist_backend")
                     or default_backend(dev))
    try:
        metrics = Trainer(config, device=dev).train()
    finally:
        torch.distributed.destroy_process_group()
    with open(metrics_out, "w") as f:
        json.dump([float(m) for m in metrics], f)
    return metrics


def run_single(config: dict, device=None):
    if int(config.get("num_devices") or 1) > 1 and not config.get(
            "distributed"):
        return run_local_ranks(config, device)
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
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; a distributed "
                        "rank's default is cuda:<local rank>); 'cpu' runs "
                        "the plain CPU path")
    # a rank of run_local_ranks (set by the launcher, not by hand)
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--metrics_out", type=str, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    config = load_config(args.exp_config_path)
    if args.rank is not None:
        print_config(config)
        return run_rank(config, args.rank, args.port, args.device,
                        args.metrics_out)
    return run(config, device=args.device)


if __name__ == "__main__":
    main()
