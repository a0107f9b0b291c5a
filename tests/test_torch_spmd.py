"""The sharded step (``pcgnn_tpu_torch.parallel.spmd``) against the JAX
package's SPMD functions and the port's single-device path.

Sharded runs are gangs of gloo ranks on the CPU, started with the port's
``utils.multiproc`` at meshes (data, graph) of (1, 2), (2, 2) and (4, 1).
A worker imports only ``torch`` and the port: it builds the graphs from
their preset and seed, loads each case's weights (the JAX parameters,
converted by ``interop.params_from_jax``) and its batch from an ``.npz``,
and writes its loss, gradients, predictions, published selections and
collective counts to another.  This process computes the JAX SPMD values on
the 8-device virtual mesh of ``tests/conftest.py`` (a (2, 2) mesh of its
first four devices) and the port's single-device values.

Tolerances, as the port's single-device parity tests: loss rtol 1e-5,
gradients rtol 1e-4 / atol 1e-6, predictions rtol 1e-4 / atol 1e-5.  Kept
ids, keep-minor masks and counts are exact: against an independent numpy
oracle of the reference's choose (``tests/oracle.py``) on the hub-free
graph, and across meshes.

On the CPU the window gather takes its plain version, which copies every
row: that non-owned rows of the masked fetch are zeroed before any use is
checked on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.models import build_model as jax_model
from pcgnn_tpu.parallel import mesh as jmesh
from pcgnn_tpu.parallel import spmd as jspmd
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.graph.csr import materialize_edge_windows
from pcgnn_tpu_torch.interop import params_from_jax
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.parallel import spmd
from pcgnn_tpu_torch.parallel.mesh import RankMesh
from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                             run_workers, worker_env)
from tests.oracle import adjacency_sets, choose_oracle

LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
PRED = dict(rtol=1e-4, atol=1e-5)
MESHES = [(1, 2), (2, 2), (4, 1)]
SEED, EMB, ALPHA, RHO, B, NTP = 4, 16, 2.0, 0.5, 32, 48
LR, WD, STEPS = 0.01, 0.001, 3
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name: (model, preset, edge_windows, store dtype, fused, extra)
CASES = {
    "fused": ("PCGNN", "tiny", True, "float32", True, {}),
    "store": ("PCGNN", "tiny", True, "float32", False, {}),
    "plain": ("PCGNN", "tiny", False, "float32", False, {}),
    "hub_store": ("PCGNN", "skew-tiny", True, "bfloat16", False, {}),
    "hub_fused": ("PCGNN", "skew-tiny", True, "bfloat16", True, {}),
    "hub_plain": ("PCGNN", "skew-tiny", False, "float32", False, {}),
    # some relations over the store budget: the SPMD selection rule
    # (any bf16 store rounds every score) differs from the single-device
    # one, so this case is held to the JAX SPMD values only
    # (128 features: the relations' windows then differ in bytes)
    "partial": ("PCGNN", "tiny", True, "bfloat16", False,
                {"partial": 1, "feat_dim": 128}),
    "gcn_store": ("GCN", "tiny", True, "float32", False, {}),
    "gcn_hub": ("GCN", "skew-tiny", False, "float32", False, {}),
    "sage_store": ("SAGE", "tiny", True, "bfloat16", False, {}),
    "sage_hub": ("SAGE", "skew-tiny", True, "float32", False, {}),
    # num_sample: a torch.Generator draw, so no JAX counterpart
    "sage_sample": ("SAGE", "tiny", False, "float32", False,
                    {"num_sample": 5, "no_jax": 1}),
}

_WORKER = r'''
import json, sys
import numpy as np
import torch
rank, world, port, dd, dg, spec_path, out = sys.argv[1:8]
rank, world, dd, dg = int(rank), int(world), int(dd), int(dg)
from pcgnn_tpu_torch.parallel.distributed import init_distributed
from pcgnn_tpu_torch.parallel.mesh import make_mesh
init_distributed(f"localhost:{port}", world, rank, backend="gloo")
mesh = make_mesh(data=dd, graph=dg)
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.parallel import spmd
from pcgnn_tpu_torch.train.trainer import make_optimizer

spec = json.load(open(spec_path))
graphs = {}
res = {"data_rank": mesh.data_rank, "graph_index": mesh.graph_index}
for name, case in spec["cases"].items():
    if [dd, dg] not in case["meshes"]:
        continue
    arr = np.load(case["npz"])
    key = (case["preset"], case["feat_dim"])
    if key not in graphs:
        graphs[key] = synthetic_fraud_graph(case["preset"], seed=spec["seed"],
                                            feat_dim=case["feat_dim"])
    g = graphs[key]
    pcgnn = case["model"] == "PCGNN"
    kw = (dict(num_relations=3, alpha=spec["alpha"], rho=spec["rho"])
          if case["model"] == "PCGNN"
          else dict(num_sample=case.get("num_sample")))
    model = build_model(case["model"], feat_dim=g.feat_dim,
                        emb_dim=spec["emb"], **kw)
    model.load_state_dict({k[2:]: torch.from_numpy(arr[k])
                           for k in arr.files if k.startswith("p.")})
    sg = spmd.shard_graph(g, mesh, pcgnn=pcgnn,
                          edge_windows=case["ew"],
                          ewin_dtype=getattr(torch, case["dtype"]),
                          ewin_budget_bytes=case["budget"],
                          fused=case["fused"])
    batch = torch.from_numpy(arr["batch"])
    y = torch.from_numpy(arr["y"])
    w = torch.from_numpy(arr["w"])
    tp = torch.from_numpy(arr["tp"])
    tpv = torch.ones(len(tp), dtype=torch.bool)
    res[name + ".stores"] = [sh.ewin is not None for sh in
                             (sg.shards if pcgnn else (sg.homo,))]
    res[name + ".fused"] = sg.fused is not None

    def gen():
        g_ = torch.Generator()
        g_.manual_seed(spec["sample_seed"])
        return g_

    mesh.stats.reset()
    rec = {}
    if pcgnn:
        logits, _ = spmd.spmd_forward(model, sg, batch, y, train=True,
                                      train_pos=tp, train_pos_valid=tpv,
                                      fused=case["fused"], record=rec)
        for k, v in rec.items():
            res[f"{name}.rec.{k}"] = v.numpy()
        mesh.stats.reset()
        loss, local = spmd.spmd_loss(model, sg, batch, y, w, tp, tpv,
                                     fused=case["fused"])
    else:
        loss, local = spmd.spmd_homo_loss(model, sg, batch, y, w,
                                          generator=gen())
    local.backward()
    spmd.data_sum_grads(model, mesh)
    res[name + ".stats"] = mesh.stats.snapshot()
    res[name + ".loss"] = float(loss)
    for n, p in model.named_parameters():
        res[f"{name}.grad.{n}"] = p.grad.numpy()
    if pcgnn:
        res[name + ".pred"] = spmd.spmd_predict(model, sg, batch, tp, tpv,
                                                fused=case["fused"]).numpy()
    else:
        res[name + ".pred"] = spmd.spmd_homo_predict(model, sg,
                                                     batch).numpy()
    if case.get("steps"):
        opt = make_optimizer(model, spec["lr"], spec["wd"])
        consts = {"tp": tp, "tpv": tpv}
        for _ in range(spec["steps"]):
            spmd.spmd_train_step(model, opt, sg, batch, y, w, consts,
                                 gen())
        for n, p in model.named_parameters():
            res[f"{name}.stepped.{n}"] = p.detach().numpy()
    if name == "store" and dg > 1:
        # the masked fetch: non-owned rows zero, owned rows the store's
        sh = sg.shards[2]
        local_ = batch - sg.col_lo
        mine = (local_ >= 0) & (local_ < sg.block)
        lclip = local_.clamp(0, sg.block - 1)
        got = spmd.sharded_feature_window(sh, sh.estart[lclip], mine)
        want = spmd.sharded_feature_window(sh, sh.estart[lclip])
        res["masked.zero"] = bool((got[~mine] == 0).all())
        res["masked.owned"] = bool(torch.equal(got[mine], want[mine]))
        res["masked.rows"] = int(mine.sum())
arrays = {k: v for k, v in res.items() if isinstance(v, np.ndarray)}
np.savez(out + ".npz", **arrays)
json.dump({k: v for k, v in res.items() if k not in arrays},
          open(out + ".json", "w"))
torch.distributed.destroy_process_group()
'''


def _batch(preset, labels, rel0=None):
    rng = np.random.default_rng(3)
    batch = rng.integers(0, len(labels), B)
    if rel0 is not None and rel0.has_hubs:
        deg = np.asarray(rel0.deg)
        batch[:4] = np.flatnonzero(deg > rel0.window_width)[:4]
    # fraud centers exercise the minors
    batch[4:10] = np.flatnonzero(labels == 1)[50:56]
    return batch.astype(np.int64)


def _partial_budget(g, dtype, dg):
    """A budget between the relations' sharded store bytes (the JAX
    package's accounting): the smaller relations get a store, the
    largest does not."""
    n_pad = -(-g.num_nodes // dg) * dg
    nbytes = sorted(spmd.reference_sharded_store_bytes(
        np.asarray(r.deg), r.window_width, g.feat_dim, dtype, dg, n_pad)
        for r in g.relations)
    assert nbytes[0] < nbytes[2]
    return nbytes[0]


def _jax_values(name, case, jg, jparams, arrs, jm):
    """JAX SPMD (loss, grads by port name, preds) at the (2, 2) mesh."""
    model_name, _, ew, dtype, fused, extra = case
    mesh, n_pad = jm
    x, _ = jspmd.pad_graph_for_mesh(jg, mesh)
    batch = jnp.asarray(arrs["batch"], jnp.int32)
    y = jnp.asarray(arrs["y"], jnp.int32)
    w = jnp.asarray(arrs["w"], jnp.float32)
    bs, ys, ws = jspmd.shard_batch(mesh, batch, y, w)
    kw = dict(edge_windows=ew, ewin_dtype=_JDT[dtype])
    if extra.get("partial"):
        kw["ewin_budget_bytes"] = arrs["budget"]
    model = jax_model(model_name, feat_dim=jg.feat_dim, emb_dim=EMB,
                      num_relations=3, alpha=ALPHA, rho=RHO)
    if model_name == "PCGNN":
        tp = jnp.asarray(arrs["tp"], jnp.int32)
        tpv = jnp.ones(len(arrs["tp"]), bool)
        shards = jspmd.shard_relations(jg, mesh, n_pad, **kw)
        table, off = ((jspmd.build_sharded_fused(jg, shards, mesh, n_pad))
                      if fused else (None, ()))
        lf = jspmd.spmd_loss_fn(model, mesh, n_pad, shards, fused_off=off)
        loss, grads = jax.jit(jax.value_and_grad(lambda p: lf(
            p, x, shards, bs, ys, ws, tp, tpv, table)))(jparams)
        pf = jspmd.spmd_predict_fn(model, mesh, n_pad, shards,
                                   fused_off=off)
        pred = pf(jparams, x, shards, bs, tp, tpv, table)
        stores = [sh.ewin is not None for sh in shards]
    else:
        feats = np.asarray(jg.features) if ew else None
        sh = jspmd.shard_relation(jg.homo, mesh, n_pad, feats, **kw)
        lf = jspmd.spmd_homo_loss_fn(model, mesh, n_pad, sh)
        loss, grads = jax.jit(jax.value_and_grad(lambda p: lf(
            p, x, sh, bs, ys, ws, jax.random.key(0))))(jparams)
        pred = jspmd.spmd_homo_predict_fn(model, mesh, n_pad, sh)(
            jparams, x, sh, bs)
        stores = [sh.ewin is not None]
    grads = params_from_jax(jax.tree.map(np.asarray, grads))
    return (float(loss), {k: v.numpy() for k, v in grads.items()},
            np.asarray(pred), stores)


def _single_device(case, g, params, arrs):
    """The port's single-device loss, gradients, predictions and, with
    ``steps``, the parameters after that many Adam steps."""
    from pcgnn_tpu_torch.train.trainer import make_optimizer, train_step

    model_name, _, ew, dtype, _, extra = case
    kw = (dict(num_relations=3, alpha=ALPHA, rho=RHO)
          if model_name == "PCGNN"
          else dict(num_sample=extra.get("num_sample")))
    model = build_model(model_name, feat_dim=g.feat_dim, emb_dim=EMB, **kw)
    model.load_state_dict(params)
    if ew:
        g = materialize_edge_windows(
            g, dtype=_TDT[dtype], relations=model_name == "PCGNN",
            homo=model_name != "PCGNN", fused=case[4])
    batch, y, w = (torch.from_numpy(arrs[k]) for k in ("batch", "y", "w"))
    tp = torch.from_numpy(arrs["tp"])
    tpv = torch.ones(len(tp), dtype=torch.bool)
    gen = lambda: torch.Generator().manual_seed(11)
    pcgnn = model_name == "PCGNN"
    kw = (dict(train_pos=tp, train_pos_valid=tpv) if pcgnn
          else dict(generator=gen()))
    loss = model.loss(g, batch, y, w, **kw)
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    with torch.no_grad():
        pred, _ = model.to_prob(g, batch, **(
            dict(train_pos=tp, train_pos_valid=tpv) if pcgnn else {}))
    stepped = None
    if extra.get("steps"):
        model.load_state_dict(params)
        opt = make_optimizer(model, LR, WD)
        for _ in range(STEPS):
            train_step(model, opt, g, batch, y, w, {"tp": tp, "tpv": tpv},
                       gen())
        stepped = {n: p.detach().numpy() for n, p in model.named_parameters()}
    return float(loss.detach()), grads, pred.numpy(), stepped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd")
    jgraphs, tgraphs = {}, {}
    mesh = jmesh.make_mesh(data=2, graph=2, devices=jax.devices()[:4])
    spec = {"seed": SEED, "emb": EMB, "alpha": ALPHA, "rho": RHO,
            "lr": LR, "wd": WD, "steps": STEPS, "sample_seed": 11,
            "cases": {}}
    out = {"jax": {}, "single": {}}
    todo = []
    for i, (name, case) in enumerate(CASES.items()):
        model_name, preset, ew, dtype, fused, extra = case
        key = (preset, extra.get("feat_dim"))
        if key not in jgraphs:
            jgraphs[key] = jax_graph(preset, seed=SEED, feat_dim=key[1])
            tgraphs[key] = torch_graph(preset, seed=SEED, feat_dim=key[1])
        jg, tg = jgraphs[key], tgraphs[key]
        labels = np.asarray(jg.labels)
        jparams = jax_model(model_name, feat_dim=jg.feat_dim, emb_dim=EMB,
                            num_relations=3, alpha=ALPHA,
                            rho=RHO).init(jax.random.key(i))
        arrs = dict(batch=_batch(preset, labels, tg.relations[0]),
                    tp=np.flatnonzero(labels == 1)[:NTP].astype(np.int64),
                    w=np.ones(B, np.float32))
        arrs["y"] = labels[arrs["batch"]].astype(np.int64)
        arrs["w"][-1] = 0.0            # a padded slot weighs 0
        budget = spmd.SPMD_EWIN_BUDGET_BYTES
        if extra.get("partial"):
            budget = _partial_budget(tg, _TDT[dtype], 2)
            arrs["budget"] = budget
        params = params_from_jax(jax.tree.map(np.asarray, jparams))
        path = str(tmp / f"{name}.npz")
        np.savez(path, **arrs, **{"p." + k: v.numpy()
                                  for k, v in params.items()})
        steps = name in ("fused", "sage_sample")
        if steps:
            extra = dict(extra, steps=1)
        spec["cases"][name] = dict(
            model=model_name, preset=preset, ew=ew, dtype=dtype,
            fused=fused, budget=budget, npz=path, steps=steps,
            feat_dim=extra.get("feat_dim"),
            num_sample=extra.get("num_sample"),
            meshes=[[2, 2]] if extra.get("partial") else MESHES)
        todo.append((name, case, extra, jg, tg, jparams, params, arrs))
        out.setdefault("arrs", {})[name] = arrs
        out.setdefault("params", {})[name] = {k: v.numpy()
                                              for k, v in params.items()}
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    # the three gangs run at once, beside the reference computations here
    env = worker_env(OMP_NUM_THREADS=1)

    def gang(dd, dg):
        world = dd * dg
        prefix = str(tmp / f"out-{dd}x{dg}-")
        return gang_with_fresh_port(lambda port: run_workers(
            str(worker), [(r, world, port, dd, dg, spec_path, prefix + str(r))
                          for r in range(world)], env=env, timeout=300))

    with ThreadPoolExecutor(len(MESHES)) as pool:
        gangs = [pool.submit(gang, dd, dg) for dd, dg in MESHES]
        for name, case, extra, jg, tg, jparams, params, arrs in todo:
            if not extra.get("no_jax"):
                out["jax"][name] = _jax_values(
                    name, case, jg, jparams, arrs,
                    (mesh, -(-jg.num_nodes // 2) * 2))
            if not extra.get("partial"):
                out["single"][name] = _single_device(
                    case[:5] + (extra,), tg, params, arrs)
        for fut in gangs:
            fut.result()
    out["ranks"] = {}
    for dd, dg in MESHES:
        world = dd * dg
        prefix = str(tmp / f"out-{dd}x{dg}-")
        ranks = []
        for r in range(world):
            res = json.loads(open(prefix + f"{r}.json").read())
            npz = np.load(prefix + f"{r}.npz")
            res.update({k: npz[k] for k in npz.files})
            ranks.append(res)
        out["ranks"][(dd, dg)] = ranks
    out["tgraphs"] = tgraphs
    return out


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not CASES[n][5].get("partial")])
@pytest.mark.parametrize("dd,dg", MESHES)
def test_sharded_step_matches_single_device(runs, name, dd, dg):
    """Loss, gradients and predictions of every rank equal the port's
    single-device values; gradients are bit-equal across ranks."""
    loss, grads, pred, _ = runs["single"][name]
    ranks = runs["ranks"][(dd, dg)]
    for res in ranks:
        np.testing.assert_allclose(res[name + ".loss"], loss, **LOSS)
        for n, want in grads.items():
            np.testing.assert_allclose(res[f"{name}.grad.{n}"], want,
                                       err_msg=n, **GRAD)
            np.testing.assert_array_equal(res[f"{name}.grad.{n}"],
                                          ranks[0][f"{name}.grad.{n}"])
        np.testing.assert_allclose(res[name + ".pred"], pred, **PRED)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not CASES[n][5].get("no_jax")])
def test_sharded_step_matches_jax_spmd(runs, name):
    """At (2, 2) the port's sharded loss, gradients and predictions equal
    the JAX package's ``spmd_loss_fn`` / ``spmd_predict_fn`` (or their
    homo forms), and both take the same lanes."""
    loss, grads, pred, stores = runs["jax"][name]
    for res in runs["ranks"][(2, 2)]:
        assert res[name + ".stores"] == stores
        np.testing.assert_allclose(res[name + ".loss"], loss, **LOSS)
        for n, want in grads.items():
            np.testing.assert_allclose(res[f"{name}.grad.{n}"], want,
                                       err_msg=n, **GRAD)
        np.testing.assert_allclose(res[name + ".pred"], pred, **PRED)
    if CASES[name][5].get("partial"):
        assert 0 < sum(stores) < len(stores)


def _published(runs, name, dd, dg):
    """Each relation's selections over the full batch, in data order, from
    graph rank 0 of each data block (the published values are the same on
    every graph rank)."""
    ranks = [r for r in runs["ranks"][(dd, dg)] if r["graph_index"] == 0]
    ranks.sort(key=lambda r: r["data_rank"])
    keys = [k for k in ranks[0] if k.startswith(name + ".rec.")]
    return {k.split(".rec.")[1]: np.concatenate([r[k] for r in ranks])
            for k in keys}


@pytest.mark.parametrize("name", ["fused", "store", "plain"])
def test_selections_match_the_oracle_exactly(runs, name):
    """Kept window ids, kept minors and counts, published by the sharded
    step at every mesh, equal the reference's choose (numpy oracle: stable
    argsort of float64 score distances, set union with the minors)
    exactly, and one another."""
    g = runs["tgraphs"][("tiny", None)]
    arrs = runs["arrs"][name]
    x = g.features.numpy().astype(np.float64)
    jp = runs["params"][name]
    s0 = x @ jp["label_clf.w"][:, 0].astype(np.float64) + float(
        jp["label_clf.b"][0])
    batch = arrs["batch"]
    recs = [_published(runs, name, dd, dg) for dd, dg in MESHES]
    for rec in recs[1:]:
        for k in recs[0]:
            np.testing.assert_array_equal(rec[k], recs[0][k], err_msg=k)
    rec = recs[0]
    for r, rel in enumerate(g.relations):
        want = choose_oracle(batch, arrs["y"], adjacency_sets(rel), s0,
                             arrs["tp"], RHO, threshold=0.5)
        for i in range(len(batch)):
            kept = {int(v) - 1 for v in rec[f"kept{r}"][i] if v}
            minors = {int(c) for c, k in zip(rec["cand_ids"][i],
                                             rec[f"keep_minor{r}"][i]) if k}
            assert kept | minors == want[i], (r, i)
            assert not kept & minors
            assert rec[f"cnt{r}"][i] == len(want[i])


def test_replicas_stay_bit_equal_and_follow_single_device(runs):
    """Three Adam steps: every rank's parameters are bit-equal, and equal
    the single-device steps' within 1e-3 (a first Adam step moves a weight
    by ~lr wherever its gradient nearly cancels, so parameters are
    compared loosely, gradients tightly above)."""
    for name in ("fused", "sage_sample"):
        want = runs["single"][name][3]
        for dd, dg in MESHES:
            ranks = runs["ranks"][(dd, dg)]
            for n, w in want.items():
                for res in ranks:
                    np.testing.assert_array_equal(
                        res[f"{name}.stepped.{n}"],
                        ranks[0][f"{name}.stepped.{n}"])
                np.testing.assert_allclose(ranks[0][f"{name}.stepped.{n}"],
                                           w, atol=1e-3, rtol=0)


def test_dg1_issues_no_graph_collective(runs):
    """At (4, 1) no graph-axis collective is called; one data-axis sum of
    the loss terms and one of the flattened gradients remain.  At dg > 1
    the graph sums are batched: a fixed handful per step."""
    for res in runs["ranks"][(4, 1)]:
        for name in ("fused", "store", "plain", "hub_store", "gcn_store"):
            st = res[name + ".stats"]
            assert st["calls"]["graph"] == 0, (name, st)
            assert st["calls"]["data"] == 2, (name, st)
    for res in runs["ranks"][(1, 2)]:
        st = res["fused.stats"]
        assert st["calls"]["data"] == 0
        # owner picks of self rows, train positives and metadata, and the
        # packed output sum (a row's owner adds its minors into it)
        assert st["calls"]["graph"] == 4, st
        # the plain lane adds the score all-gather and one kept-id publish
        # per relation
        assert res["plain.stats"]["calls"]["graph"] == 4 + 1 + 3


def test_masked_fetch_zeroes_the_rows_it_skips(runs):
    for dd, dg in ((1, 2), (2, 2)):
        for res in runs["ranks"][(dd, dg)]:
            assert res["masked.zero"] and res["masked.owned"]
            assert 0 < res["masked.rows"] < B


# ------------------------------------------------- structure (no gang)

def _mesh(dd, dg, g):
    return RankMesh(shape={"dcn": 1, "data": dd, "graph": dg}, rank=g,
                    host=0, data_index=0, graph_index=g)


def test_structure_is_sharded():
    """Each rank's nbr2d/deg/keff/ksample and store hold 1/dg of the rows;
    the block's windows are exactly its nodes' neighbor feature rows at
    local offsets; the blocks tile the dense table."""
    g = torch_graph("tiny", seed=SEED)
    dg = 4
    shards = [spmd.shard_relations(g, _mesh(2, dg, i), g.num_nodes,
                                   edge_windows=True) for i in range(dg)]
    feats = g.features.numpy()
    for r, rel in enumerate(g.relations):
        blocks = [s[r] for s in shards]
        for arr in ("nbr2d", "deg", "keff", "ksample", "estart"):
            total = getattr(rel, arr if arr != "estart" else "deg")
            for sh in blocks:
                a = getattr(sh, arr)
                assert a.shape[0] * dg == total.shape[0]
        np.testing.assert_array_equal(
            torch.cat([sh.nbr2d for sh in blocks]).numpy(),
            rel.nbr2d.numpy())
        indptr, col = rel.indptr.numpy(), rel.col.numpy()
        block = g.num_nodes // dg
        for v in np.random.default_rng(r).integers(0, g.num_nodes, 16):
            sh = blocks[v // block]
            dc = min(int(rel.deg[v]), rel.window_width)
            s = int(sh.estart[v % block])
            got = sh.ewin[s: s + dc * g.feat_dim].numpy()
            np.testing.assert_array_equal(
                got.reshape(dc, -1), feats[col[indptr[v]: indptr[v] + dc]])


@pytest.mark.parametrize("dg", [2, 4])
def test_store_and_fused_coverage_match_jax_at_the_budget(dg):
    """The sharded store and the fused table are built exactly when the
    JAX package builds its own: one byte below and at each budget."""
    jg = jax_graph("tiny", seed=SEED)
    tg = torch_graph("tiny", seed=SEED)
    mesh = jmesh.make_mesh(data=8 // dg, graph=dg)
    n_pad = -(-tg.num_nodes // dg) * dg
    for dtype in ("float32", "bfloat16"):
        for r, rel in enumerate(tg.relations):
            nbytes = spmd.reference_sharded_store_bytes(
                rel.deg.numpy(), rel.window_width, tg.feat_dim,
                _TDT[dtype], dg, n_pad)
            for budget in (nbytes - 1, nbytes):
                jsh = jspmd.shard_relation(
                    jg.relations[r], mesh, n_pad, np.asarray(jg.features),
                    ewin_dtype=_JDT[dtype], ewin_budget_bytes=budget)
                tsh = spmd.shard_relation(
                    rel, _mesh(8 // dg, dg, 0), n_pad, tg.features,
                    ewin_dtype=_TDT[dtype], ewin_budget_bytes=budget)
                assert (jsh.ewin is None) == (tsh.ewin is None)
                assert (tsh.ewin is None) == (budget < nbytes)
        jsh = jspmd.shard_relations(jg, mesh, n_pad, ewin_dtype=_JDT[dtype])
        tsh = spmd.shard_relations(tg, _mesh(8 // dg, dg, 0), n_pad,
                                   ewin_dtype=_TDT[dtype])
        fw = (tg.feat_dim + tg.feat_dim % 2) // 2 if dtype == "bfloat16" \
            else tg.feat_dim
        ref_w = sum(-(-max(s.width, 1) * fw // 128) * 128 for s in tsh)
        edge = n_pad * ref_w * 4
        for budget in (edge - 1, edge):
            jf, _ = jspmd.build_sharded_fused(jg, jsh, mesh, n_pad,
                                              budget_bytes=budget)
            tf, _ = spmd.build_sharded_fused(tsh, n_pad,
                                             budget_bytes=budget)
            assert (jf is None) == (tf is None) == (budget < edge)


def test_shard_relation_rejects_stub_builds_hub():
    from pcgnn_tpu_torch.graph.csr import csr_from_edges, degree_stub

    with pytest.raises(ValueError, match="stub"):
        spmd.shard_relation(degree_stub(np.ones(16, np.int64)),
                            _mesh(2, 4, 0), 16)
    rng = np.random.default_rng(0)
    src = np.concatenate([rng.integers(0, 64, 256), np.zeros(300, np.int64)])
    dst = np.concatenate([rng.integers(0, 64, 256), rng.integers(0, 64, 300)])
    rel = csr_from_edges(src, dst, 64, window_cap=8)
    assert rel.has_hubs
    deg, ip, col = rel.deg.numpy(), rel.indptr.numpy(), rel.col.numpy()
    hub_rows = np.flatnonzero(deg > rel.window_width)
    for g in range(4):
        sh = spmd.shard_relation(rel, _mesh(2, 4, g), 64)
        assert sh.has_hubs
        hub_idx = sh.hub_idx.numpy()
        rows = np.arange(16) + 16 * g
        assert set(rows[hub_idx >= 0]) == set(hub_rows[(hub_rows >= 16 * g)
                                                       & (hub_rows < 16 * g
                                                          + 16)])
        for v in hub_rows:
            hs = int(np.flatnonzero(hub_rows == v)[0])
            s = int(sh.hub_start[hs])
            np.testing.assert_array_equal(
                sh.hub_col[s: s + deg[v]].numpy(), col[ip[v]: ip[v] + deg[v]])


def test_shard_batch_takes_the_data_blocks():
    """Contiguous blocks over the data axes in (dcn, data) order, as
    ``P(daxes)`` splits the batch."""
    from pcgnn_tpu_torch.parallel.mesh import RankMesh
    b = torch.arange(12)
    got = [spmd.shard_batch(RankMesh(shape={"dcn": 2, "data": 2, "graph": 2},
                                     rank=0, host=h, data_index=d,
                                     graph_index=0), b, b * 10)
           for h in range(2) for d in range(2)]
    for i, (bb, yy) in enumerate(got):
        assert bb.tolist() == list(range(3 * i, 3 * i + 3))
        assert torch.equal(yy, bb * 10)
    with pytest.raises(ValueError, match="divide"):
        spmd.shard_batch(RankMesh(shape={"dcn": 1, "data": 5, "graph": 1},
                                  rank=0, host=0, data_index=0,
                                  graph_index=0), b)


def test_block_partials_matches_jax():
    rng = np.random.default_rng(0)
    b, m, n, f, block = 16, 300, 64, 8, 16
    ids = rng.integers(0, n, (b, m)).astype(np.int32)
    keep = rng.random((b, m)) < 0.3
    x_local = rng.normal(size=(block, f)).astype(np.float32)
    for col_lo in (0, 16, 48):
        num0, cnt0 = spmd.block_partials(torch.from_numpy(ids),
                                         torch.from_numpy(keep), col_lo,
                                         block, torch.from_numpy(x_local))
        jn, jc = jspmd._block_partials(jnp.asarray(ids), jnp.asarray(keep),
                                       col_lo, block, jnp.asarray(x_local))
        np.testing.assert_allclose(num0.numpy(), np.asarray(jn), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(cnt0.numpy(), np.asarray(jc))
