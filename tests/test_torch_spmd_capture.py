"""The sharded epoch and evaluate through the runners
(``train.capture``), on gloo CPU ranks: the sharded hub plan of a stack
(``parallel.spmd.spmd_epoch_hub_plans``), the steps and forwards that take
it, and the cut points a capture of the sharded step would make
(``parallel.mesh.CutRecorder`` in its dry mode, which captures nothing).

Gangs of two ranks at (data, graph) = (1, 2) and (2, 1) run one worker
script each, side by side, started with ``utils.multiproc``; every worker
writes its values to an ``.npz`` and a ``.json``.  This process computes
the unsharded plans, the JAX package's ``spmd_loss_fn`` on its CPU mesh
and holds the ranks to them.  On the CPU the runners run eagerly; the
captured pieces are held to these eager steps bit for bit on the card
(``tests/test_torch_cuda.py``).

Tolerances against the JAX package, as ``tests/test_torch_spmd.py``: loss
rtol 1e-5, gradients rtol 1e-4 / atol 1e-6.  Between the port's own
sharded paths (epoch plan against per-call plans, runners against the
per-batch loop) the bits must be equal: the hub lanes sum in float64 and
round once, so a wider chunk plan cannot move a value.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.models import build_model as jax_model
from pcgnn_tpu.parallel import mesh as jmesh
from pcgnn_tpu.parallel import spmd as jspmd
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.interop import params_from_jax
from pcgnn_tpu_torch.ops import hub
from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                             run_workers, worker_env)

LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
MESHES = [(1, 2), (2, 1)]
SEED, EMB, B, NTP, STEPS = 4, 16, 32, 48, 3
# name: (model, edge_windows, bf16 stores) on skew-tiny, whose relation 0
# and homo graph have hub rows
CASES = {
    "pcgnn_stores": ("PCGNN", True),
    "pcgnn_plain": ("PCGNN", False),
    "gcn_hub": ("GCN", False),
    "sage_hub": ("SAGE", True),
}
# the trainers of the runner checks: (config changes, preset)
TRAINERS = {
    "pcgnn": ({}, "skew-tiny"),
    "sage_draws": ({"model": "SAGE", "num_sample": 5, "lr": 0.005,
                    "weight_decay": 0.0005}, "tiny"),
}
CFG = dict(seed=7, model="PCGNN", train_ratio=0.4, test_ratio=0.67,
           emb_size=16, lr=0.01, weight_decay=0.001, alpha=2.0, rho=0.5,
           epochs=2, valid_epochs=10 ** 9, batch_size=32, patience=10 ** 9,
           exp_num=0)

_WORKER = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
rank, world, port, dd, dg, spec_path, out = sys.argv[1:8]
rank, world, dd, dg = int(rank), int(world), int(dd), int(dg)
spec = json.load(open(spec_path))
os.chdir(os.path.dirname(out))
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.parallel import spmd
from pcgnn_tpu_torch.parallel.mesh import CutRecorder, recording
from pcgnn_tpu_torch.train.metrics import evaluate
from pcgnn_tpu_torch.train.results import ResultManager
from pcgnn_tpu_torch.train.trainer import Trainer, make_optimizer

# the first Trainer joins the group and builds its mesh; the cases reuse it
trainers = {}
for name, (changes, preset) in spec["trainers"].items():
    cfg = dict(spec["cfg"], data_name="synthetic:" + preset, distributed=True,
               coordinator_address=f"localhost:{port}", num_processes=world,
               process_id=rank, mesh_graph=dg, **changes)
    trainers[name] = Trainer(cfg, device="cpu", result=ResultManager(
        cfg, root=os.path.join(os.path.dirname(out), f"r{rank}-{name}")))
mesh = trainers["pcgnn"].mesh
res = {"data_rank": mesh.data_rank, "graph_index": mesh.graph_index}
arr = np.load(spec["npz"])
g = synthetic_fraud_graph("skew-tiny", seed=spec["seed"])
tp = torch.from_numpy(arr["tp"])
tpv = torch.ones(len(tp), dtype=torch.bool)
consts = {"tp": tp, "tpv": tpv}
stack = torch.from_numpy(arr["stack"])
ys = g.labels[stack]
ws = torch.ones(stack.shape, dtype=torch.float32)


def counted_tolist():
    """torch.Tensor.tolist, counting its calls (the plan's read-backs)."""
    real = torch.Tensor.tolist
    calls = []

    def tolist(t):
        calls.append(1)
        return real(t)

    torch.Tensor.tolist = tolist
    return calls, lambda: setattr(torch.Tensor, "tolist", real)


for name, (model_name, ew) in spec["cases"].items():
    pcgnn = model_name == "PCGNN"
    sg = spmd.shard_graph(g, mesh, pcgnn=pcgnn, edge_windows=ew,
                          ewin_dtype=torch.bfloat16)
    # the plan of the stack: one graph collective, one read-back
    mesh.stats.reset()
    calls, restore = counted_tolist()
    try:
        plans = spmd.spmd_epoch_hub_plans(sg, stack)
    finally:
        restore()
    res[name + ".plans"] = plans
    res[name + ".plan_calls"] = dict(mesh.stats.calls)
    res[name + ".plan_readbacks"] = len(calls)
    kw = (dict(num_relations=3, alpha=2.0, rho=0.5) if pcgnn else {})

    def fresh():
        model = build_model(model_name, feat_dim=g.feat_dim,
                            emb_dim=spec["emb"],
                            generator=torch.Generator().manual_seed(0),
                            **kw)
        return model, make_optimizer(model, 0.01, 0.001)

    if pcgnn:
        # the epoch-planned loss and gradients of the first batch, for
        # the JAX comparison
        model, _ = fresh()
        loss, local = spmd.spmd_loss(model, sg, stack[0], ys[0], ws[0], tp,
                                     tpv, hub_plans=plans)
        local.backward()
        spmd.data_sum_grads(model, mesh)
        res[name + ".loss0"] = float(loss)
        for n, p in model.named_parameters():
            res[f"{name}.grad0.{n}"] = p.grad.numpy()
    # the steps with the stack's plan, with each batch's own plan, and
    # with the plan under the dry recorder (overlap on, then off)
    schedules = {"on": sg, "off": dataclasses.replace(
        sg, mesh=dataclasses.replace(mesh, overlap=False))}
    for way in ("epoch", "own", "dry_on", "dry_off"):
        model, opt = fresh()
        sgw = schedules["off" if way == "dry_off" else "on"]
        losses, cuts = [], []
        for i in range(stack.shape[0]):
            step = lambda: spmd.spmd_train_step(
                model, opt, sgw, stack[i], ys[i], ws[i], consts,
                hub_plans=None if way == "own" else plans)
            if way.startswith("dry"):
                with recording(CutRecorder()) as rec:
                    losses.append(step())
                cuts.append(rec.cuts)
            else:
                losses.append(step())
        res[f"{name}.{way}.losses"] = torch.stack(losses).numpy()
        for n, p in model.named_parameters():
            res[f"{name}.{way}.{n}"] = p.detach().numpy()
        if cuts:
            res[f"{name}.{way}.cuts"] = cuts
    # the sharded predict with the plan and with its own
    model, _ = fresh()
    for way in ("epoch", "own"):
        hp = None if way == "own" else plans
        if pcgnn:
            pred = spmd.spmd_predict(model, sg, stack[0], tp, tpv,
                                     hub_plans=hp)
        else:
            pred = spmd.spmd_homo_predict(model, sg, stack[0], hub_plans=hp)
        res[f"{name}.pred_{way}"] = pred.numpy()

# the trainers: run_epoch and evaluate through the runners against the
# per-batch loop (Trainer.step with its own plan, Trainer.predict)
for name, t in trainers.items():
    got = {}
    for way in ("runner", "loop"):
        model = t.new_model()
        opt = t.new_optimizer(model)
        losses = []
        for epoch in range(2):
            if way == "runner":
                losses.append(t.run_epoch(model, opt, epoch))
                continue
            batches, weights = t.epoch_plan(epoch)
            losses.append(torch.stack([
                t.step(model, opt, b, t.labels[b], w,
                       t.step_generator(epoch, i))
                for i, (b, w) in enumerate(zip(batches, weights))]).mean())
        if way == "runner":
            ev = t.evaluate(model, t.idx_valid, t.y_valid, print_line=False)
        else:
            ev = evaluate(lambda b: t.predict(model, b), t.idx_valid,
                          t.y_valid, t.batch_size, print_line=False)
        res[f"{name}.{way}.losses"] = torch.stack(losses).numpy()
        res[f"{name}.{way}.probs"] = ev.anomaly_confidence
        res[f"{name}.{way}.auc"] = ev.auc
        for n, p in model.named_parameters():
            res[f"{name}.{way}.{n}"] = p.detach().numpy()
    res[name + ".num_batches"] = t.num_batches

arrays = {k: v for k, v in res.items() if isinstance(v, np.ndarray)}
np.savez(out + ".npz", **arrays)
json.dump({k: v for k, v in res.items() if k not in arrays},
          open(out + ".json", "w"))
torch.distributed.destroy_process_group()
'''


def _stack(g):
    """[3, B] batches of skew-tiny: relation 0's hub rows in every batch,
    more in the second, some fraud centers."""
    rng = np.random.default_rng(3)
    labels = g.labels.numpy()
    hubs = np.flatnonzero(g.relations[0].deg.numpy()
                          > g.relations[0].window_width)
    homo = np.flatnonzero(g.homo.deg.numpy() > g.homo.window_width)
    stack = rng.integers(0, g.num_nodes, (3, B))
    stack[:, :2] = hubs[:2]
    stack[1, 2:6] = hubs[2:6]
    stack[:, 6:8] = homo[:2]
    stack[1, B // 2: B // 2 + 3] = homo[2:5]
    stack[:, 10:16] = np.flatnonzero(labels == 1)[50:56]
    return stack.astype(np.int64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_capture")
    g = synthetic_fraud_graph("skew-tiny", seed=SEED)
    labels = g.labels.numpy()
    arrs = {"stack": _stack(g),
            "tp": np.flatnonzero(labels == 1)[:NTP].astype(np.int64)}
    npz = str(tmp / "inputs.npz")
    np.savez(npz, **arrs)
    spec = {"seed": SEED, "emb": EMB, "npz": npz, "cfg": CFG,
            "cases": CASES, "trainers": TRAINERS}
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    env = worker_env(OMP_NUM_THREADS=1)

    def gang(dd, dg):
        prefix = str(tmp / f"out-{dd}x{dg}-")
        gang_with_fresh_port(lambda port: run_workers(
            str(worker), [(r, 2, port, dd, dg, spec_path, prefix + str(r))
                          for r in range(2)], env=env, timeout=300))
        ranks = []
        for r in range(2):
            res = json.loads(open(prefix + f"{r}.json").read())
            npzr = np.load(prefix + f"{r}.npz")
            res.update({k: npzr[k] for k in npzr.files})
            ranks.append(res)
        return ranks

    with ThreadPoolExecutor(len(MESHES)) as pool:
        gangs = {m: pool.submit(gang, *m) for m in MESHES}
        jax_ref = _jax_loss(arrs)
        out = {"ranks": {m: f.result() for m, f in gangs.items()},
               "jax": jax_ref, "graph": g, "arrs": arrs}
    return out


def _jax_loss(arrs):
    """The JAX package's ``spmd_loss_fn`` at (1, 2) on its CPU mesh, for
    the first batch of the stack, skew-tiny with bf16 stores, from the
    port's initial weights (seeded 0) carried to JAX; and without
    stores."""
    import jax.numpy as jnp

    from pcgnn_tpu_torch.interop import params_to_jax
    from pcgnn_tpu_torch.models import build_model
    jg = jax_graph("skew-tiny", seed=SEED)
    mesh = jmesh.make_mesh(data=1, graph=2, devices=jax.devices()[:2])
    n_pad = -(-jg.num_nodes // 2) * 2
    x, _ = jspmd.pad_graph_for_mesh(jg, mesh)
    model = jax_model("PCGNN", feat_dim=jg.feat_dim, emb_dim=EMB,
                      num_relations=3, alpha=2.0, rho=0.5)
    tmodel = build_model("PCGNN", feat_dim=jg.feat_dim, emb_dim=EMB,
                         num_relations=3, alpha=2.0, rho=0.5,
                         generator=torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, params_to_jax(tmodel))
    batch = arrs["stack"][0]
    y = np.asarray(jg.labels)[batch]
    bs, ys, ws = jspmd.shard_batch(
        mesh, jnp.asarray(batch, jnp.int32), jnp.asarray(y, jnp.int32),
        jnp.ones(B, jnp.float32))
    tp = jnp.asarray(arrs["tp"], jnp.int32)
    tpv = jnp.ones(len(arrs["tp"]), bool)
    out = {}
    for name, ew in (("pcgnn_stores", True), ("pcgnn_plain", False)):
        shards = jspmd.shard_relations(jg, mesh, n_pad, edge_windows=ew,
                                       ewin_dtype=jnp.bfloat16)
        table, off = (jspmd.build_sharded_fused(jg, shards, mesh, n_pad)
                      if ew else (None, ()))
        lf = jspmd.spmd_loss_fn(model, mesh, n_pad, shards, fused_off=off)
        loss, grads = jax.jit(jax.value_and_grad(lambda p: lf(
            p, x, shards, bs, ys, ws, tp, tpv, table)))(params)
        grads = params_from_jax(jax.tree.map(np.asarray, grads))
        out[name] = (float(loss), {k: v.numpy() for k, v in grads.items()})
    return out


def _block_stack(stack, dd, data_rank):
    bd = stack.shape[1] // dd
    return stack[:, data_rank * bd: (data_rank + 1) * bd]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dd,dg", MESHES)
def test_epoch_plan_equals_the_unsharded_plan(runs, name, dd, dg):
    """``spmd_epoch_hub_plans`` gives every rank the unsharded
    ``ops.hub.epoch_hub_plans`` of its data block of the stack (the whole
    stack at (1, 2)), with one graph collective (none at dg = 1) and one
    read-back."""
    g = runs["graph"]
    rels = g.relations if CASES[name][0] == "PCGNN" else (g.homo,)
    for res in runs["ranks"][(dd, dg)]:
        blocks = _block_stack(runs["arrs"]["stack"], dd, res["data_rank"])
        want = hub.epoch_hub_plans(rels, torch.from_numpy(blocks))
        assert any(p for p in want)
        got = tuple(None if p is None else tuple(p)
                    for p in res[name + ".plans"])
        assert got == want
        assert res[name + ".plan_calls"] == {"graph": int(dg > 1),
                                             "data": 0}
        assert res[name + ".plan_readbacks"] == 1


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dd,dg", MESHES)
def test_epoch_planned_steps_equal_per_call_plans(runs, name, dd, dg):
    """Three sharded Adam steps with the stack's plan give the same losses
    and parameters, bit for bit, as the same steps each planning its own
    batch, on every rank; so does the forward; the replicas agree."""
    ranks = runs["ranks"][(dd, dg)]
    for res in ranks:
        keys = [k for k in res if k.startswith(name + ".epoch.")]
        assert len(keys) > 2
        for k in keys:
            np.testing.assert_array_equal(
                res[k], res[k.replace(".epoch.", ".own.")], err_msg=k)
            np.testing.assert_array_equal(res[k], ranks[0][k], err_msg=k)
        np.testing.assert_array_equal(res[name + ".pred_epoch"],
                                      res[name + ".pred_own"])


@pytest.mark.parametrize("name", ["pcgnn_stores", "pcgnn_plain"])
def test_epoch_planned_loss_matches_jax_spmd(runs, name):
    """At (1, 2) the epoch-planned sharded loss and gradients of the
    stack's first batch equal the JAX package's ``spmd_loss_fn`` on its
    CPU mesh for the same weights and batch."""
    loss, grads = runs["jax"][name]
    for res in runs["ranks"][(1, 2)]:
        np.testing.assert_allclose(res[name + ".loss0"], loss, **LOSS)
        for n, want in grads.items():
            np.testing.assert_allclose(res[f"{name}.grad0.{n}"], want,
                                       err_msg=n, **GRAD)


@pytest.mark.parametrize("name", sorted(TRAINERS))
@pytest.mark.parametrize("dd,dg", MESHES)
def test_runner_epochs_and_evaluate_equal_the_per_batch_loop(runs, name,
                                                            dd, dg):
    """Two sharded epochs through ``Trainer.run_epoch`` (the runner: one
    plan an epoch) and the stacked ``Trainer.evaluate`` equal the
    per-batch loop (``Trainer.step`` planning each batch, ``evaluate``
    over ``Trainer.predict``) bit for bit: losses, parameters and
    probabilities, on every rank (GraphSAGE's draws included)."""
    ranks = runs["ranks"][(dd, dg)]
    for res in ranks:
        assert res[name + ".num_batches"] > 1
        keys = [k for k in res if k.startswith(name + ".runner.")]
        assert any(k.endswith(".probs") for k in keys) and len(keys) > 4
        for k in keys:
            np.testing.assert_array_equal(
                res[k], res[k.replace(".runner.", ".loop.")], err_msg=k)
            np.testing.assert_array_equal(res[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("dd,dg", MESHES)
def test_dry_cut_points_are_the_same_on_every_rank_and_step(runs, dd, dg):
    """The dry recorder logs the same cut list on every rank and at every
    step, with overlap on and off, and runs the same steps (the bits of
    the unrecorded ones).  An extent-1 axis makes no cut: at (1, 2) no
    data-axis collective, at (2, 1) no graph-axis one.  Overlap on issues
    and waits every collective; off, each is one blocking call."""
    absent = "data" if dd == 1 else "graph"
    for name in CASES:
        lists = {}
        for way in ("dry_on", "dry_off"):
            per_rank = [res[f"{name}.{way}.cuts"]
                        for res in runs["ranks"][(dd, dg)]]
            first = per_rank[0][0]
            assert first, (name, way)
            for steps in per_rank:
                assert len(steps) == STEPS
                assert all(s == first for s in steps), (name, way)
            assert not any(axis == absent for _, _, axis in first)
            lists[way] = first
            for res in runs["ranks"][(dd, dg)]:
                np.testing.assert_array_equal(res[f"{name}.{way}.losses"],
                                              res[f"{name}.epoch.losses"])
        kinds_on = {k for k, _, _ in lists["dry_on"]}
        assert kinds_on == {"issue", "wait"}
        assert {k for k, _, _ in lists["dry_off"]} == {"call"}
        issued = [(n, a) for k, n, a in lists["dry_on"] if k == "issue"]
        assert issued == [(n, a) for _, n, a in lists["dry_off"]]
        assert sorted(issued) == sorted(
            (n, a) for k, n, a in lists["dry_on"] if k == "wait")
