"""The entry points of ``__graft_entry__.py``, ported.

``entry(device=None)``
    The single-card forward of the flagship PC-GNN on the tiny graph with
    bfloat16 edge-window stores and the fused record table: returns
    ``(fn, (params, batch, y))``, and ``fn(params, batch, y)`` gives
    ``(logits [64, 2], center_scores [64, 2])`` in training mode.  The fused
    record fetch is kernel 1.

``dryrun_multichip(n_devices, device="cuda")``
    Starts ``n_devices`` rank processes on a ``factor_mesh(n)`` (data,
    graph) mesh; every rank runs ONE full sharded training step (loss,
    gradients, Adam) in each of three passes, in the JAX file's order:

    1. ``tiny`` at batch 8·dd, the plain lane (the score all-gather);
    2. ``skew-tiny`` at seed 1, batch 16·dd with hub rows in it: the hub
       lane (kernel 2), bfloat16 sharded stores and the sharded fused
       record table (kernel 1);
    3. ``stress-1m``: 1M nodes, the plain lane without stores, batch
       128·dd, 4,096 train positives; the rank's structure (``nbr2d``,
       ``deg``, ``keff``, ``ksample``) must be 1/dg of the graph's, within
       4,096 bytes a rank.  ``GRAFT_DRYRUN_STRESS=0`` skips it.

    The layout is ``parallel.distributed.gang_backend``'s: ``cuda`` puts
    rank r on ``cuda:r`` over NCCL (refused with fewer cards than ranks),
    ``cuda:0`` every rank on that card over gloo, ``cpu`` gloo on the CPU.
    Each rank builds the graphs itself from their seeds.  Rank 0's lines
    are printed; the ranks' results (loss, seconds, kernel launches of the
    step, structure bytes, and the step's summed gradients and updated
    parameters by name, as numpy) are returned.

    python -m pcgnn_tpu_torch.graft_entry --devices N [--device D]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from pcgnn_tpu_torch.train.trainer import resolve_device

EMB, ALPHA, RHO = 64, 2.0, 0.5
LR, WD = 0.01, 0.001            # the JAX file's torch_adam(0.01, 0.001)
RANK_TIMEOUT_S = 900.0


def _model(graph, seed: int, device):
    from pcgnn_tpu_torch.models import build_model
    return build_model("PCGNN", feat_dim=graph.feat_dim, emb_dim=EMB,
                       num_relations=graph.num_relations, alpha=ALPHA,
                       rho=RHO,
                       generator=torch.Generator().manual_seed(seed)
                       ).to(device)


def _train_pos(labels: np.ndarray, count: int, device):
    tp = torch.as_tensor(np.flatnonzero(labels == 1)[:count], device=device)
    return tp, torch.ones(len(tp), dtype=torch.bool, device=device)


def entry(device=None):
    """``(fn, (params, batch, y))`` of the tiny graph's bf16-store forward
    (``__graft_entry__.entry``): ``params`` is the model's state dict, and
    ``fn`` runs the module with the given one (``torch.func.
    functional_call``), so weights from elsewhere drop in."""
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.graph.csr import materialize_edge_windows
    dev = resolve_device(device)
    graph = materialize_edge_windows(
        synthetic_fraud_graph("tiny", seed=0, device=dev),
        dtype=torch.bfloat16)
    model = _model(graph, 0, dev)
    labels = graph.labels.cpu().numpy()
    tp, tpv = _train_pos(labels, 32, dev)
    batch = torch.arange(64, device=dev)
    y = torch.as_tensor(labels[:64], device=dev)

    def fn(params, batch, y):
        return torch.func.functional_call(
            model, params, (graph, batch, y),
            dict(train=True, train_pos=tp, train_pos_valid=tpv))

    params = {k: v.detach() for k, v in model.state_dict().items()}
    return fn, (params, batch, y)


# ------------------------------------------------------------- the ranks

def _launches() -> dict:
    from pcgnn_tpu_torch.train.capture import launch_counts
    return launch_counts()


def _zero_launches() -> None:
    from pcgnn_tpu_torch.ops import (choose_window, mask_build,
                                     oversample_minors, ragged_gather,
                                     window_gather)
    window_gather.launches = window_gather.masked_launches = 0
    ragged_gather.launches = mask_build.launches = choose_window.launches = 0
    choose_window.ids_launches = choose_window.score_launches = 0
    oversample_minors.launches = 0


def _step(model, sg, labels, batch: np.ndarray, tp, tpv, what: str,
          t0: float) -> dict:
    """One sharded training step on the full ``batch`` (every rank takes
    its data block); its loss must be finite.  Kernel launch counts are
    set to 0 just before the step and read just after."""
    from pcgnn_tpu_torch.parallel.spmd import spmd_train_step
    from pcgnn_tpu_torch.train.trainer import make_optimizer
    dev = sg.x_local.device
    opt = make_optimizer(model, LR, WD)
    bt = torch.as_tensor(batch, device=dev)
    y = torch.as_tensor(labels[batch], device=dev)
    w = torch.ones(len(batch), device=dev)
    _zero_launches()
    t1 = time.time()
    loss = float(spmd_train_step(model, opt, sg, bt, y, w,
                                 {"tp": tp, "tpv": tpv}))
    step_s = time.time() - t1
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite {what} SPMD loss: {loss}")
    # the step leaves the summed gradients in .grad
    arrays = {f"{kind}/{n}": t.detach().cpu().numpy()
              for n, p in model.named_parameters()
              for kind, t in (("grads", p.grad), ("params", p))}
    return {"loss": loss, "launches": _launches(), "step_s": step_s,
            "seconds": time.time() - t0, "arrays": arrays}


def tiny_pass(mesh, dev) -> dict:
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.parallel.spmd import shard_graph
    t0 = time.time()
    g = synthetic_fraud_graph("tiny", seed=0)
    labels = g.labels.numpy()
    model = _model(g, 0, dev)
    tp, tpv = _train_pos(labels, 32, dev)
    sg = shard_graph(g, mesh, edge_windows=False, device=dev)
    out = _step(model, sg, labels, np.arange(8 * mesh.dd), tp, tpv,
                "tiny", t0)
    out["line"] = (f"dryrun_multichip ok: mesh=({mesh.dd}x{mesh.dg}) "
                   f"loss={out['loss']:.4f}")
    return out


def skew_pass(mesh, dev) -> dict:
    """The hub lane, the bf16 sharded stores and the sharded fused record
    table through the full step."""
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.parallel.spmd import shard_graph
    t0 = time.time()
    g = synthetic_fraud_graph("skew-tiny", seed=1)
    if not any(r.has_hubs for r in g.relations):
        raise AssertionError("skew-tiny has no window-capped relation")
    labels = g.labels.numpy()
    model = _model(g, 1, dev)
    tp, tpv = _train_pos(labels, 64, dev)
    sg = shard_graph(g, mesh, edge_windows=True, ewin_dtype=torch.bfloat16,
                     fused=True, device=dev)
    if not any(sh.has_hubs for sh in sg.shards):
        raise AssertionError("no shard of skew-tiny has hub rows")
    if not all(sh.ewin is not None for sh in sg.shards):
        raise AssertionError("a shard of skew-tiny has no bf16 store")
    if sg.fused is None:
        raise AssertionError("skew-tiny's sharded fused table was not built")
    rng = np.random.default_rng(1)
    batch = rng.integers(0, g.num_nodes, 16 * mesh.dd)
    rel0 = g.relations[0]
    hub_nodes = np.flatnonzero(rel0.deg.numpy() > rel0.window_width)
    batch[: min(4, len(hub_nodes))] = hub_nodes[:4]   # touch the hub lane
    out = _step(model, sg, labels, batch, tp, tpv, "skew", t0)
    out["line"] = (f"dryrun_multichip skew ok: mesh=({mesh.dd}x{mesh.dg}) "
                   f"loss={out['loss']:.4f} (hub lane + bf16 sharded store)")
    return out


def structure_bytes(graph, shards) -> tuple:
    """(this rank's bytes, the graph's bytes) of the relations' structure:
    ``nbr2d`` [N, D] int32 and ``deg``, ``keff``, ``ksample``, as one
    device holds them whole, against the rank's shard tensors."""
    total = sum(r.num_nodes * max(r.window_width, 1) * 4
                + sum(a.numel() * a.element_size()
                      for a in (r.deg, r.keff, r.ksample))
                for r in graph.relations)
    mine = sum(a.numel() * a.element_size() for sh in shards
               for a in (sh.nbr2d, sh.deg, sh.keff, sh.ksample))
    return mine, total


def stress_pass(mesh, dev) -> dict:
    """1M nodes through the same sharded step in the plain lane, the
    structure row-block partitioned over the graph axis."""
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.parallel.spmd import shard_graph
    t0 = time.time()
    g = synthetic_fraud_graph("stress-1m", seed=0)
    build_s = time.time() - t0
    labels = g.labels.numpy()
    model = _model(g, 0, dev)
    tp, tpv = _train_pos(labels, 4096, dev)
    # no stores: the plain lane is what a relation over the store budget
    # runs; the fast lane is the skew pass's
    sg = shard_graph(g, mesh, edge_windows=False, device=dev)
    dg = mesh.dg
    mine, total = structure_bytes(g, sg.shards)
    if mine * dg > total + 4096 * dg:
        raise AssertionError(f"structure not 1/{dg}-sharded: {mine} * {dg} "
                             f"> {total}")
    batch = np.random.default_rng(0).integers(0, g.num_nodes, 128 * mesh.dd)
    out = _step(model, sg, labels, batch, tp, tpv, "stress", t0)
    out.update(build_s=build_s, struct_rank_bytes=mine,
               struct_total_bytes=total, num_nodes=g.num_nodes,
               directed_edges=[r.num_edges for r in g.relations])
    out["line"] = (f"dryrun_multichip stress-1m ok: mesh=({mesh.dd}x"
                   f"{dg}) loss={out['loss']:.4f} struct "
                   f"{mine / 1e6:.0f}MB/dev of {total / 1e6:.0f}MB total "
                   f"({out['seconds']:.0f}s)")
    return out


def rank_main(rank: int, world: int, port: int, device: str,
              out: str) -> None:
    """One rank of :func:`dryrun_multichip`: join the gang, run the
    passes, write the results to ``out``."""
    import torch.distributed as dist

    from pcgnn_tpu_torch.cli import rank_device
    from pcgnn_tpu_torch.parallel.distributed import (gang_backend,
                                                      init_distributed)
    from pcgnn_tpu_torch.parallel.mesh import factor_mesh, make_mesh
    dev = torch.device(rank_device(device, rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(f"localhost:{port}", world, rank,
                     backend=gang_backend(device, world))
    try:
        dd, dg = factor_mesh(world)
        mesh = make_mesh(data=dd, graph=dg)
        res = {"rank": rank, "mesh": [dd, dg], "device": str(dev),
               "backend": mesh.backend, "overlap": mesh.overlap,
               "passes": {}}
        passes = [("tiny", tiny_pass), ("skew-tiny", skew_pass)]
        if os.environ.get("GRAFT_DRYRUN_STRESS", "1") != "0":
            passes.append(("stress-1m", stress_pass))
        arrays = {}
        for name, run in passes:
            rec = res["passes"][name] = run(mesh, dev)
            arrays.update({f"{name}/{k}": v
                           for k, v in rec.pop("arrays").items()})
            print(rec["line"], flush=True)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    np.savez(out + ".npz", **arrays)


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run the three passes on ``n_devices`` ranks (module docstring);
    returns every rank's results, rank 0 first."""
    from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                                 run_workers, worker_env)
    dev = resolve_device(device)
    n = int(n_devices)
    if dev.type == "cuda" and dev.index is None and (
            n > torch.cuda.device_count()):
        raise ValueError(f"{n} ranks on device 'cuda' need a card each; "
                         f"{torch.cuda.device_count()} are visible (name one "
                         f"card, e.g. 'cuda:0', to share it over gloo)")
    env = worker_env(OMP_NUM_THREADS=max(1, (os.cpu_count() or 1) // n))
    with tempfile.TemporaryDirectory(prefix="graft_dryrun-") as work:
        outs = [os.path.join(work, f"rank{r}.json") for r in range(n)]
        gang_with_fresh_port(lambda port: run_workers(
            ["-m", "pcgnn_tpu_torch.graft_entry", "--rank"],
            [(r, n, port, str(device), outs[r]) for r in range(n)],
            env=env, timeout=RANK_TIMEOUT_S))
        results = []
        for path in outs:
            with open(path) as f:
                res = json.load(f)
            with np.load(path + ".npz") as npz:
                for key in npz.files:
                    name, kind, param = key.split("/", 2)
                    res["passes"][name].setdefault(kind, {})[param] = npz[key]
            results.append(res)
    for rec in results[0]["passes"].values():
        print(rec["line"])
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        r, world, port, device, out = argv[1:6]
        rank_main(int(r), int(world), int(port), device, out)
        return 0
    p = argparse.ArgumentParser(
        prog="python -m pcgnn_tpu_torch.graft_entry",
        description="One sharded training step on N ranks in each of the "
                    "tiny, skew-tiny and stress-1m passes "
                    "(__graft_entry__.dryrun_multichip)")
    p.add_argument("--devices", type=int, required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (rank r on cuda:r, NCCL), cuda:K (every rank "
                        "on one card, gloo) or cpu (gloo)")
    args = p.parse_args(argv)
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
