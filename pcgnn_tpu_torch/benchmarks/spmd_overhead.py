"""Sharded-step overhead on one card (counterpart of
``benchmarks/spmd_overhead.py``).

    python -m pcgnn_tpu_torch.benchmarks.spmd_overhead [--preset yelp-like] \\
        [--batch_size 1024] [--nscan 16] [--device cuda]

Runs the sharded training step (``parallel.spmd.spmd_train_step``) as the
only rank of a 1-rank ``torch.distributed`` group (NCCL on the card, gloo
on the CPU) at the (1, 1) mesh, next to the plain single-device step, on
the same graph, batch and yelp-like configuration, both through
``Trainer.single_step`` (on the card replays of the captured step; the
1-rank group's has no collective, so it is one piece too), ``nscan``
steps a call.  The sharded trainer is
configured as a ``distributed: true`` rank is: bf16 sharded edge-window
stores and the sharded fused record table.  The first call of each, from
the same initial weights, must return the same loss bit for bit (the
1-rank group elides every collective, and both add their oversampled minors
with the oversample kernel), so the two differ only in structure.  Each is
then timed twice, in turns, and the difference of their mean step times is
the cost of the sharded program's structure.

The process joins a process group and leaves it before it exits: run it
as a process of its own.  Prints one JSON line with the JAX script's keys,
the two losses and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pcgnn_tpu_torch.benchmarks import card_line
from pcgnn_tpu_torch.utils import roofline


def run(preset: str = "yelp-like", batch_size: int = 1024, nscan: int = 16,
        device="cuda") -> dict:
    """The JAX script's reading (and the losses); joins a 1-rank group and
    leaves it."""
    import torch.distributed as dist

    from pcgnn_tpu_torch.train.trainer import Trainer
    from pcgnn_tpu_torch.utils.multiproc import free_port
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    card = card_line(dev)
    cfg = dict(seed=2, data_name=f"synthetic:{preset}", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=64, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=1,
               valid_epochs=10 ** 9, batch_size=batch_size,
               patience=10 ** 9, exp_num=0)
    t = Trainer(cfg, device=dev)
    rng = np.random.default_rng(0)
    batch = rng.choice(np.asarray(t.idx_train), batch_size)
    y = t.graph.labels.cpu().numpy()[batch]
    w = np.ones((batch_size,), np.float32)
    model = t.new_model()
    fn, fargs = t.single_step(model, t.new_optimizer(model), batch, y, w,
                              nscan=nscan)
    loss_single = fn(*fargs)

    backend = "nccl" if dev.type == "cuda" else "gloo"
    sharded = dict(cfg, distributed=True, dist_backend=backend,
                   coordinator_address=f"localhost:{free_port()}",
                   num_processes=1, process_id=0)
    try:
        ts = Trainer(sharded, device=dev)
        if ts.mesh.size != 1 or ts.mesh.backend != backend:
            raise AssertionError(f"the sharded trainer's mesh is {ts.mesh}")
        smodel = ts.new_model()
        sfn, sargs = ts.single_step(smodel, ts.new_optimizer(smodel), batch,
                                    y, w, nscan=nscan)
        loss_spmd = sfn(*sargs)
        if not torch.equal(loss_single, loss_spmd):
            raise AssertionError(f"the (1, 1) sharded step's loss "
                                 f"{float(loss_spmd)!r} differs from the "
                                 f"single step's {float(loss_single)!r}")
        # in turns (single, sharded, sharded, single): the host's speed
        # moves between moments of one run
        calls = {"single": lambda: fn(*fargs), "spmd": lambda: sfn(*sargs)}
        readings = {"single": [], "spmd": []}
        for name in ("single", "spmd", "spmd", "single"):
            readings[name].append(roofline.timed_ms(calls[name]) / nscan)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    single_ms = sum(readings["single"]) / 2
    spmd_ms = sum(readings["spmd"]) / 2
    return {
        "metric": "spmd_1x1_step_overhead",
        "preset": preset,
        "batch_size": batch_size,
        "nscan": nscan,
        "single_chip_step_ms": single_ms,
        "spmd_1x1_step_ms": spmd_ms,
        "overhead_pct": (spmd_ms / single_ms - 1) * 100,
        "step_ms_readings": readings,
        "loss_single": float(loss_single),
        "loss_spmd": float(loss_spmd),
        "backend": backend,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="yelp-like")
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--nscan", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.preset, args.batch_size, args.nscan,
                         args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
