"""Multi-host scaling harness: the product surface (``python -m
pcgnn_tpu_torch.cli`` with ``distributed: true``) over 1 to N "hosts"
(counterpart of ``benchmarks/multihost_scaling.py``).

    python -m pcgnn_tpu_torch.benchmarks.multihost_scaling [--procs 2] \\
        [--devices_per_proc 4] [--mesh_graph 2] [--preset small] \\
        [--batch_per_data 256] [--epochs 6] [--warm_epochs 1] \\
        [--device cuda]

A process of the JAX script is one host with ``devices_per_proc`` devices;
here each device is a rank of its own, so a host is ``devices_per_proc``
CLI processes (``ranks_per_host``) and ``procs`` hosts are procs x
devices_per_proc ranks on the ('dcn', 'data', 'graph') mesh of (procs,
devices_per_proc / mesh_graph, mesh_graph).  Each rank is the unmodified
CLI (the trainer joins the group and trains), given its ``process_id``
and a fresh coordinator port; it works in a directory of its own, since
every rank opens its result logs.  The process ladder is 1, 2, 4, ... and
``procs``.  Per count the gang runs twice, ``warm_epochs`` and
``warm_epochs + epochs`` epochs, and the wall times are differenced, so
start-up and the graph build cancel.  Prints one record per count (procs,
epoch_s, epochs_per_s, warm_s, scaling_eff, ranks, backend) and the
summary.

``--device cuda`` puts rank r on ``cuda:r`` (NCCL); ``cuda:K`` puts every
rank on that card (gloo for more than one rank: NCCL takes one rank per
card); ``cpu`` runs gloo ranks on the CPU, the JAX script's setting.  On a
one-card machine the numbers are relative, bounded by the host and the
shared card: no scaling claim.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch


def rank_main(pid: int, cfg_path: str, workdir: str, device: str) -> None:
    """One rank: its process id and directory, then the CLI."""
    from pcgnn_tpu_torch import cli
    os.environ["PCGNN_PROCESS_ID"] = str(pid)
    rank_dir = os.path.join(workdir, str(pid))
    os.makedirs(rank_dir, exist_ok=True)
    os.chdir(rank_dir)
    cli.main(["--exp_config_path", cfg_path, "--device", device])


def ladder(procs: int) -> list:
    out, n = [], 1
    while n <= procs:
        out.append(n)
        n *= 2
    if out[-1] != procs:
        out.append(procs)
    return out


def run_cli_gang(nproc: int, args, epochs: int) -> float:
    """Train on ``nproc`` hosts of ``devices_per_proc`` ranks; returns the
    gang's wall seconds."""
    from pcgnn_tpu_torch.cli import rank_device
    from pcgnn_tpu_torch.parallel.distributed import gang_backend
    from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                                 run_workers, worker_env)
    world = nproc * args.devices_per_proc
    cfg = dict(seed=2, data_name=f"synthetic:{args.preset}", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=64, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=epochs,
               valid_epochs=10 ** 9, patience=10 ** 9, exp_num=0,
               batch_size=args.batch_per_data * nproc * (
                   args.devices_per_proc // args.mesh_graph),
               distributed=True, num_processes=world,
               ranks_per_host=args.devices_per_proc,
               mesh_graph=args.mesh_graph,
               dist_backend=gang_backend(args.device, world))
    with tempfile.TemporaryDirectory(prefix="multihost_scaling-") as tmp:
        cfg_path = os.path.join(tmp, "cfg.json")

        def launch(port):
            cfg["coordinator_address"] = f"localhost:{port}"
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            t0 = time.perf_counter()
            run_workers(["-m", "pcgnn_tpu_torch.benchmarks.multihost_scaling"],
                        [("--rank", pid, cfg_path, tmp,
                          rank_device(args.device, pid))
                         for pid in range(world)],
                        env=worker_env(OMP_NUM_THREADS=1),
                        timeout=args.timeout)
            return time.perf_counter() - t0

        return gang_with_fresh_port(launch)


def run(args) -> list:
    """Every count's record (the summary's)."""
    from pcgnn_tpu_torch.parallel.distributed import gang_backend
    dev = torch.device(args.device)
    if args.devices_per_proc % args.mesh_graph:
        raise ValueError(f"mesh_graph={args.mesh_graph} does not divide "
                         f"devices_per_proc={args.devices_per_proc}")
    if dev.type == "cuda" and dev.index is None:
        world = args.procs * args.devices_per_proc
        if world > torch.cuda.device_count():
            raise ValueError(f"{world} ranks need {world} cards, one a rank; "
                             f"{torch.cuda.device_count()} are visible (put "
                             f"the ranks on one card with --device cuda:0)")
    results, base = [], None
    for n in ladder(args.procs):
        t_warm = run_cli_gang(n, args, args.warm_epochs)
        t_full = run_cli_gang(n, args, args.warm_epochs + args.epochs)
        dt = max(t_full - t_warm, 1e-9) / args.epochs
        rec = dict(procs=n, epoch_s=round(dt, 3),
                   epochs_per_s=round(1.0 / dt, 4), warm_s=round(t_warm, 1),
                   ranks=n * args.devices_per_proc,
                   backend=gang_backend(args.device,
                                        n * args.devices_per_proc))
        if base is None:
            base = rec
        rec["scaling_eff"] = round(
            rec["epochs_per_s"] / base["epochs_per_s"], 3)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"summary": results}))
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices_per_proc", type=int, default=4)
    ap.add_argument("--mesh_graph", type=int, default=2)
    ap.add_argument("--preset", default="small")
    ap.add_argument("--batch_per_data", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--warm_epochs", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a gang may take before it is killed")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        rank_main(int(argv[1]), argv[2], argv[3], argv[4])
        return 0
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
