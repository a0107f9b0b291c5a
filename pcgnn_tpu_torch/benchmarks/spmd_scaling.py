"""SPMD scaling harness: the sharded PC-GNN train step over ('data',
'graph') meshes (counterpart of ``benchmarks/spmd_scaling.py``).

    python -m pcgnn_tpu_torch.benchmarks.spmd_scaling [--devices 8] \\
        [--preset small] [--batch_per_data 256] [--steps 10] \\
        [--device cuda] [--params FILE.npz]

Runs ``parallel.spmd.spmd_train_step`` over the meshes (1, 1), then
(d, 1) (data-parallel) and (1, d) (graph partition) for d = 2, 4, ... up
to ``--devices``, and reports per-step wall time and weak-scaling
throughput.  Each mesh is one gang of dd x dg ranks, one process each
(``utils.multiproc``).  ``--device cuda`` puts rank r on ``cuda:r`` over
NCCL and refuses a mesh larger than the visible cards; ``--device
cuda:K`` puts every rank on that card (one rank over NCCL, more over
gloo: NCCL takes one rank per card); ``--device cpu`` runs gloo ranks on
the CPU, the setting of the JAX script (its virtual CPU devices), whose
numbers are relative and bounded by the host's cores.

Every rank builds the preset's graph (seed 2), shards it
(``shard_graph``: float32 edge-window stores, no fused table, as the JAX
script's ``shard_relations``), takes the batch ``rng(0).integers(0, N,
b)`` with b = batch_per_data x dd, the first 256 fraud nodes as the train
positives, and the parameters of ``--params`` (an ``.npz`` of the model's
``state_dict``, e.g. the JAX package's through ``interop.params_from_jax``)
or of ``torch.Generator().manual_seed(0)``; one warm step, then
``--steps`` timed steps.  Prints one JSON record per mesh (the JAX
script's keys, plus the warm step's loss ``warm_loss``, the (1, 1) mesh's
loss on the same batch ``ref_loss``, the backend and rank 0's kernel
launches), then the summary with ``weak_scaling_eff``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 2
EMB = 64
NUM_TRAIN_POS = 256


def mesh_shapes(devices: int) -> list:
    """(1, 1), then (d, 1) and (1, d) for d = 2, 4, ... up to ``devices``."""
    shapes, d = [], 1
    while d <= devices:
        shapes.append((d, 1))
        if d > 1:
            shapes.append((1, d))
        d *= 2
    return shapes


def _batch(n: int, b: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, n, b)


def rank_main(rank: int, world: int, port: int, dd: int, dg: int,
              spec_path: str, out: str) -> None:
    """One rank of a mesh's gang: shard, step, and (rank 0) write the
    record to ``out``."""
    from pcgnn_tpu_torch.cli import rank_device
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.models import build_model
    from pcgnn_tpu_torch.ops import ragged_gather as rg
    from pcgnn_tpu_torch.ops import window_gather as wg
    from pcgnn_tpu_torch.parallel import spmd
    from pcgnn_tpu_torch.parallel.distributed import init_distributed
    from pcgnn_tpu_torch.parallel.mesh import make_mesh
    from pcgnn_tpu_torch.train.trainer import make_optimizer
    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device(rank_device(spec["device"], rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(f"localhost:{port}", world, rank,
                     backend=spec["backend"])
    try:
        mesh = make_mesh(data=dd, graph=dg)
        g = synthetic_fraud_graph(spec["preset"], seed=SEED)
        model = build_model("PCGNN", feat_dim=g.feat_dim, emb_dim=EMB,
                            num_relations=g.num_relations, alpha=2.0,
                            rho=0.5,
                            generator=torch.Generator().manual_seed(0))
        if spec["params"]:
            arr = np.load(spec["params"])
            model.load_state_dict({k: torch.from_numpy(arr[k])
                                   for k in arr.files})
        model.to(dev)
        labels = g.labels.numpy()
        tp = torch.as_tensor(np.flatnonzero(labels == 1)[:NUM_TRAIN_POS],
                             device=dev)
        consts = {"tp": tp, "tpv": torch.ones(len(tp), dtype=torch.bool,
                                              device=dev)}
        sg = spmd.shard_graph(g, mesh, pcgnn=True, edge_windows=True,
                              ewin_dtype=torch.float32, fused=False,
                              device=dev)
        # this rank's structure bytes; every graph block is as large, so
        # the whole structure is dg of them
        struct_rank = sum(a.numel() * a.element_size() for sh in sg.shards
                          for a in (sh.nbr2d, sh.deg, sh.keff, sh.ksample))

        def inputs(b):
            batch = _batch(g.num_nodes, b)
            return (torch.as_tensor(batch, device=dev),
                    torch.as_tensor(labels[batch], device=dev),
                    torch.ones(b, dtype=torch.float32, device=dev))

        ref = {}
        if (dd, dg) == (1, 1):
            # the single-rank loss at every mesh's batch, for the check
            with torch.no_grad():
                for b in spec["batches"]:
                    loss, _ = spmd.spmd_loss(model, sg, *inputs(b),
                                             consts["tp"], consts["tpv"])
                    ref[str(b)] = float(loss)
        b = spec["batch_per_data"] * dd
        batch, y, w = inputs(b)
        opt = make_optimizer(model, 0.01, 0.001)

        def step():
            return spmd.spmd_train_step(model, opt, sg, batch, y, w, consts)

        def barrier(loss) -> float:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return float(loss)

        warm_loss = barrier(step())
        t0 = time.perf_counter()
        for _ in range(spec["steps"]):
            loss = step()
        loss = barrier(loss)
        dt = (time.perf_counter() - t0) / spec["steps"]
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        rec = {"mesh": f"data={dd} graph={dg}", "batch": b,
               "step_ms": round(dt * 1e3, 2),
               "rows_per_s": round(b / dt, 1), "loss": round(loss, 4),
               "struct_bytes_per_device": struct_rank,
               "struct_bytes_total": struct_rank * dg,
               "warm_loss": warm_loss, "ref_losses": ref,
               "backend": spec["backend"], "device": str(dev),
               "launches": {"window_gather": wg.launches,
                            "window_gather_masked": wg.masked_launches,
                            "ragged_gather": rg.launches}}
        with open(out, "w") as f:
            json.dump(rec, f)


def run(devices: int = 8, preset: str = "small", batch_per_data: int = 256,
        steps: int = 10, device="cuda", params: str | None = None,
        meshes=None,
        timeout: float = 1800.0) -> dict:
    """Every mesh's record and the summary: {"records", "summary"}.
    ``meshes``: the (dd, dg) shapes to run (default ``mesh_shapes``);
    the first must be (1, 1), the reference of every loss."""
    from pcgnn_tpu_torch.parallel.distributed import gang_backend
    from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                                 run_workers, worker_env)
    meshes = [tuple(m) for m in (meshes or mesh_shapes(devices))]
    if meshes[0] != (1, 1):
        raise ValueError(f"the first mesh must be (1, 1), not {meshes[0]}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        big = max(dd * dg for dd, dg in meshes)
        if big > torch.cuda.device_count():
            raise ValueError(f"a mesh of {big} ranks needs {big} cards, one "
                             f"a rank; {torch.cuda.device_count()} are "
                             f"visible (put the ranks on one card with "
                             f"--device cuda:0)")
    records = []
    with tempfile.TemporaryDirectory(prefix="spmd_scaling-") as tmp:
        for dd, dg in meshes:
            world = dd * dg
            spec = {"preset": preset, "batch_per_data": batch_per_data,
                    "steps": steps, "device": device, "params": params,
                    "backend": gang_backend(device, world),
                    "batches": sorted({batch_per_data * m[0]
                                       for m in meshes})}
            spec_path = os.path.join(tmp, f"spec-{dd}x{dg}.json")
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            out = os.path.join(tmp, f"rec-{dd}x{dg}.json")
            gang_with_fresh_port(lambda port: run_workers(
                ["-m", "pcgnn_tpu_torch.benchmarks.spmd_scaling"],
                [("--rank", r, world, port, dd, dg, spec_path, out)
                 for r in range(world)],
                env=worker_env(OMP_NUM_THREADS=1), timeout=timeout))
            with open(out) as f:
                rec = json.load(f)
            refs = records[0]["ref_losses"] if records else rec["ref_losses"]
            rec["ref_loss"] = refs[str(rec["batch"])]
            records.append(rec)
            print(json.dumps(rec), flush=True)
    base = records[0]
    for r in records:
        r["weak_scaling_eff"] = round(
            (r["rows_per_s"] / base["rows_per_s"])
            / (r["batch"] / base["batch"]), 3)
    summary = [{k: r[k] for k in ("mesh", "step_ms", "rows_per_s",
                                  "weak_scaling_eff")} for r in records]
    print(json.dumps({"summary": summary}))
    return {"records": records, "summary": summary}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        r, world, port, dd, dg = (int(a) for a in argv[1:6])
        rank_main(r, world, port, dd, dg, argv[6], argv[7])
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--preset", default="small")
    ap.add_argument("--batch_per_data", type=int, default=256,
                    help="batch rows per 'data'-axis rank (weak scaling)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", default=None,
                    help=".npz of the PC-GNN state_dict (default: the "
                    "initialization of seed 0)")
    args = ap.parse_args(argv)
    run(args.devices, args.preset, args.batch_per_data, args.steps,
        args.device, args.params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
