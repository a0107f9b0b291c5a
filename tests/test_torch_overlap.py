"""Collective overlap in the sharded step (``parallel.mesh`` async forms,
``parallel.spmd`` schedule, ``parallel.distributed`` switches).

Gangs of gloo ranks on the CPU at meshes (data, graph) of (1, 2) and
(2, 1) run each case twice in one process, on the mesh the process
setting builds (overlap on, the default) and on its blocking copy
(``dataclasses.replace(mesh, overlap=False)``), from the same weights and
batch.  With it on, the
step issues its collectives with ``async_op=True`` and waits at first use;
the arithmetic and its order are the same, so losses, gradients and the
published selections must be bit-equal across the two schedules, and
equal to the single-process step at the sharded step's tolerances (loss
rtol 1e-5, gradients rtol 1e-4 / atol 1e-6).  The schedule itself is read
from ``CollectiveStats.waits``: how many operations were noted between
each collective's issue and its completion.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.graph.csr import materialize_edge_windows
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.parallel import distributed as tdist
from pcgnn_tpu_torch.parallel.mesh import make_mesh
from pcgnn_tpu_torch.utils.multiproc import (free_port, gang_with_fresh_port,
                                             run_workers, worker_env)

LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
MESHES = [(1, 2), (2, 1)]
SEED, EMB, B, NTP = 4, 16, 32, 48

# name: (model, preset, edge_windows, store dtype, fused)
CASES = {
    "plain": ("PCGNN", "tiny", False, "float32", False),
    "fused": ("PCGNN", "tiny", True, "float32", True),
    "store": ("PCGNN", "tiny", True, "bfloat16", False),
    "hub_fused": ("PCGNN", "skew-tiny", True, "bfloat16", True),
    "hub_plain": ("PCGNN", "skew-tiny", False, "float32", False),
    "gcn_store": ("GCN", "tiny", True, "float32", False),
}

_WORKER = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, port, dd, dg, spec_path, out = sys.argv[1:8]
rank, world, dd, dg = int(rank), int(world), int(dd), int(dg)
from pcgnn_tpu_torch.parallel.distributed import init_distributed
from pcgnn_tpu_torch.parallel.mesh import make_mesh
init_distributed(f"localhost:{port}", world, rank, backend="gloo")
mesh = make_mesh(data=dd, graph=dg)
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.parallel import spmd

spec = json.load(open(spec_path))
res = {"default_overlap": mesh.overlap, "graph_index": mesh.graph_index,
       "data_rank": mesh.data_rank}
graphs = {}
for name, case in spec["cases"].items():
    arr = np.load(case["npz"])
    if case["preset"] not in graphs:
        graphs[case["preset"]] = synthetic_fraud_graph(case["preset"],
                                                       seed=spec["seed"])
    g = graphs[case["preset"]]
    pcgnn = case["model"] == "PCGNN"
    kw = (dict(num_relations=3, alpha=2.0, rho=0.5) if pcgnn else {})
    model = build_model(case["model"], feat_dim=g.feat_dim,
                        emb_dim=spec["emb"], **kw)
    sg = spmd.shard_graph(g, mesh, pcgnn=pcgnn, edge_windows=case["ew"],
                          ewin_dtype=getattr(torch, case["dtype"]),
                          fused=case["fused"])
    batch, y, w, tp = (torch.from_numpy(arr[k])
                       for k in ("batch", "y", "w", "tp"))
    tpv = torch.ones(len(tp), dtype=torch.bool)
    schedules = {"on": sg, "off": dataclasses.replace(
        sg, mesh=dataclasses.replace(mesh, overlap=False))}
    for mode, sgm in schedules.items():
        model.load_state_dict({k[2:]: torch.from_numpy(arr[k])
                               for k in arr.files if k.startswith("p.")})
        model.zero_grad(set_to_none=True)
        key = f"{name}.{mode}"
        mesh.stats.reset()
        if pcgnn:
            rec = {}
            spmd.spmd_forward(model, sgm, batch, y, train=True, train_pos=tp,
                              train_pos_valid=tpv, fused=case["fused"],
                              record=rec)
            for k, v in rec.items():
                res[f"{key}.rec.{k}"] = v.numpy()
            mesh.stats.reset()
            loss, local = spmd.spmd_loss(model, sgm, batch, y, w, tp, tpv,
                                         fused=case["fused"])
        else:
            mesh.stats.reset()
            loss, local = spmd.spmd_homo_loss(model, sgm, batch, y, w)
        res[key + ".stats"] = mesh.stats.snapshot()
        local.backward()
        spmd.data_sum_grads(model, mesh)
        res[key + ".loss"] = np.array(loss.item(), np.float32)
        for n, p in model.named_parameters():
            res[f"{key}.grad.{n}"] = p.grad.numpy()
    if pcgnn and dg > 1 and name == "plain":
        # the score gather against the zero-padded all-reduce it replaces
        s0 = (sg.x_local.double() @ model.label_clf.w[:, 0].detach().double()
              + float(model.label_clf.b[0])).float()
        got = mesh.graph_gather(s0)
        old = torch.zeros(dg * s0.shape[0])
        old[mesh.graph_index * s0.shape[0]:
            (mesh.graph_index + 1) * s0.shape[0]] = s0
        dist.all_reduce(old, group=mesh.graph_group)
        res["gather.new"] = got.numpy()
        res["gather.old"] = old.numpy()
arrays = {k: v for k, v in res.items() if isinstance(v, np.ndarray)}
np.savez(out + ".npz", **arrays)
json.dump({k: v for k, v in res.items() if k not in arrays},
          open(out + ".json", "w"))
dist.destroy_process_group()
'''


def _single_device(case, g, params, arrs):
    """The port's single-process loss and gradients on the same inputs."""
    model_name, _, ew, dtype, fused = case
    kw = (dict(num_relations=3, alpha=2.0, rho=0.5)
          if model_name == "PCGNN" else {})
    model = build_model(model_name, feat_dim=g.feat_dim, emb_dim=EMB, **kw)
    model.load_state_dict(params)
    if ew:
        g = materialize_edge_windows(
            g, dtype=getattr(torch, dtype), relations=model_name == "PCGNN",
            homo=model_name != "PCGNN", fused=fused)
    batch, y, w, tp = (torch.from_numpy(arrs[k])
                       for k in ("batch", "y", "w", "tp"))
    tpv = torch.ones(len(tp), dtype=torch.bool)
    kw = (dict(train_pos=tp, train_pos_valid=tpv)
          if model_name == "PCGNN" else {})
    loss = model.loss(g, batch, y, w, **kw)
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy().copy()
                                  for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap")
    graphs = {}
    spec = {"seed": SEED, "emb": EMB, "cases": {}}
    todo = []
    for i, (name, case) in enumerate(CASES.items()):
        model_name, preset, ew, dtype, fused = case
        if preset not in graphs:
            graphs[preset] = synthetic_fraud_graph(preset, seed=SEED)
        g = graphs[preset]
        labels = g.labels.numpy()
        rng = np.random.default_rng(i)
        batch = rng.integers(0, g.num_nodes, B)
        rel0 = g.relations[0]
        if rel0.has_hubs:
            batch[:4] = np.flatnonzero(
                rel0.deg.numpy() > rel0.window_width)[:4]
        batch[4:10] = np.flatnonzero(labels == 1)[50:56]
        arrs = dict(batch=batch.astype(np.int64),
                    y=labels[batch].astype(np.int64),
                    w=np.ones(B, np.float32),
                    tp=np.flatnonzero(labels == 1)[:NTP].astype(np.int64))
        arrs["w"][-1] = 0.0
        kw = (dict(num_relations=3, alpha=2.0, rho=0.5)
              if model_name == "PCGNN" else {})
        params = build_model(
            model_name, feat_dim=g.feat_dim, emb_dim=EMB,
            generator=torch.Generator().manual_seed(i), **kw).state_dict()
        path = str(tmp / f"{name}.npz")
        np.savez(path, **arrs, **{"p." + k: v.numpy()
                                  for k, v in params.items()})
        spec["cases"][name] = dict(model=model_name, preset=preset, ew=ew,
                                   dtype=dtype, fused=fused, npz=path)
        todo.append((name, case, g, params, arrs))
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    env = worker_env(OMP_NUM_THREADS=1)

    def gang(dd, dg):
        world = dd * dg
        prefix = str(tmp / f"out-{dd}x{dg}-")
        return gang_with_fresh_port(lambda port: run_workers(
            str(worker), [(r, world, port, dd, dg, spec_path, prefix + str(r))
                          for r in range(world)], env=env, timeout=300))

    out = {"single": {}, "ranks": {}}
    with ThreadPoolExecutor(len(MESHES)) as pool:
        gangs = [pool.submit(gang, dd, dg) for dd, dg in MESHES]
        for name, case, g, params, arrs in todo:
            out["single"][name] = _single_device(case, g, params, arrs)
        for fut in gangs:
            fut.result()
    for dd, dg in MESHES:
        ranks = []
        for r in range(dd * dg):
            prefix = str(tmp / f"out-{dd}x{dg}-{r}")
            res = json.loads(open(prefix + ".json").read())
            npz = np.load(prefix + ".npz")
            res.update({k: npz[k] for k in npz.files})
            ranks.append(res)
        out["ranks"][(dd, dg)] = ranks
    return out


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dd,dg", MESHES)
def test_overlap_on_and_off_are_bit_equal(runs, name, dd, dg):
    """Loss, gradients and published selections (kept ids, keep-minor
    masks, counts) are the same bits with overlap on and off."""
    for res in runs["ranks"][(dd, dg)]:
        assert res["default_overlap"] is True
        on = {k[len(name) + 4:]: v for k, v in res.items()
              if k.startswith(name + ".on.") and not k.endswith(".stats")}
        off = {k[len(name) + 5:]: v for k, v in res.items()
               if k.startswith(name + ".off.") and not k.endswith(".stats")}
        assert set(on) == set(off) and "loss" in on
        if CASES[name][0] == "PCGNN":
            assert any(k.startswith("rec.kept") for k in on)
        for k in on:
            np.testing.assert_array_equal(on[k], off[k], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dd,dg", MESHES)
def test_overlap_step_equals_single_process(runs, name, dd, dg):
    loss, grads = runs["single"][name]
    for res in runs["ranks"][(dd, dg)]:
        np.testing.assert_allclose(res[f"{name}.on.loss"], loss, **LOSS)
        for n, want in grads.items():
            np.testing.assert_allclose(res[f"{name}.on.grad.{n}"], want,
                                       err_msg=n, **GRAD)


# the operations each case notes (parallel.spmd) before its first wait:
# one a relation (its ids, masks and store fetch) and the fused fetch
_NOTED = {"plain": 3, "fused": 4, "store": 3, "hub_fused": 4,
          "hub_plain": 3, "gcn_store": 1}


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_are_issued_before_the_fetch_and_waited_after(runs,
                                                                  name):
    """At (1, 2) with overlap on, the owner-meta sum, the self-row pick and
    (plain and hub lanes) the score gather are async, issued before the
    halo-independent work (the fetches, ids and masks) and completed
    after it; with overlap off every collective completes where it is
    issued."""
    needs_scores = name in ("plain", "hub_fused", "hub_plain")
    for res in runs["ranks"][(1, 2)]:
        on, off = res[f"{name}.on.stats"], res[f"{name}.off.stats"]
        waits = {w["name"]: w for w in on["waits"]}
        expect = {"self_rows", "owner_meta"} | (
            {"scores"} if needs_scores else set())
        assert expect <= set(waits), on["waits"]
        assert ("scores" in waits) == needs_scores
        for key in expect:
            assert waits[key]["ops_between"] >= _NOTED[name], waits[key]
        # the later picks are issued under the earlier ones
        assert waits["self_rows"]["collectives_between"] >= 1
        assert on["async_calls"]["graph"] == on["calls"]["graph"] > 0
        assert off["async_calls"]["graph"] == 0
        assert off["calls"] == on["calls"] and off["bytes"] == on["bytes"]
        for w in off["waits"]:
            assert w["collectives_between"] == w["ops_between"] == 0


def test_dg1_issues_no_async_graph_collective(runs):
    for res in runs["ranks"][(2, 1)]:
        for name in CASES:
            st = res[f"{name}.on.stats"]
            assert st["calls"]["graph"] == st["async_calls"]["graph"] == 0
            # the loss terms' data sum
            assert st["async_calls"]["data"] == 1


def test_score_gather_equals_the_padded_all_reduce(runs):
    """The tiled ``all_gather_into_tensor`` gives the bits the zero-padded
    all-reduce gave, on every rank."""
    for res in runs["ranks"][(1, 2)]:
        np.testing.assert_array_equal(res["gather.new"], res["gather.old"])
        assert res["gather.new"].shape == (512,)
        assert np.isfinite(res["gather.new"]).all()


def test_enable_collective_overlap_raises_once_a_group_exists():
    tdist.init_distributed(f"localhost:{free_port()}", 1, 0, backend="gloo",
                           overlap=False)
    try:
        assert make_mesh().overlap is False
        with pytest.raises(RuntimeError, match="before the process group"):
            tdist.enable_collective_overlap()
        with pytest.raises(ValueError, match="collective overlap"):
            tdist.ensure_initialized(backend="gloo")
        tdist.ensure_initialized(backend="gloo", overlap=False)
    finally:
        torch.distributed.destroy_process_group()
    tdist.enable_collective_overlap()
    tdist.init_distributed(f"localhost:{free_port()}", 1, 0, backend="gloo")
    try:
        assert make_mesh().overlap is True
    finally:
        torch.distributed.destroy_process_group()


def test_a_mesh_keeps_the_schedule_it_was_built_with():
    """The schedule cannot be flipped on a mesh in use: the blocking
    reference is another mesh, sharing the groups and the counts."""
    import dataclasses
    tdist.init_distributed(f"localhost:{free_port()}", 1, 0, backend="gloo")
    try:
        mesh = make_mesh()
        with pytest.raises(dataclasses.FrozenInstanceError):
            mesh.overlap = False
        blocking = dataclasses.replace(mesh, overlap=False)
        assert mesh.overlap is True and blocking.overlap is False
        assert blocking.stats is mesh.stats
    finally:
        torch.distributed.destroy_process_group()
