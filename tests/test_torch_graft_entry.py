"""The port's driver entry points (``pcgnn_tpu_torch.graft_entry``) against
``__graft_entry__.py``.

``entry()`` runs on the CPU with the JAX entry's parameters carried across
by ``interop``: logits and center scores within rtol 1e-5 / atol 1e-6 of
``jax.jit`` of the JAX ``fn``.  ``dryrun_multichip(2, device="cpu")``
starts two gloo ranks at the (1, 2) mesh; each rank's tiny and skew-tiny
loss equals the JAX package's SPMD loss on the same graph, batch, train
positives and the port's initial weights carried to JAX, within rtol 1e-5
(as ``tests/test_torch_spmd.py`` holds the sharded step).  The stress
pass runs here with ``stress-1m`` cut to ``small``'s shape (4,096 nodes,
directed as the stress presets are) in both packages; the real
``stress-1m`` runs on the card (``chip_smoke.py`` phase 27).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgnn_tpu.data import synthetic as jsyn
from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.models import build_model as jax_model
from pcgnn_tpu.parallel import mesh as jmesh
from pcgnn_tpu.parallel import spmd as jspmd
from pcgnn_tpu_torch import graft_entry
from pcgnn_tpu_torch.data import synthetic as tsyn
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.interop import params_from_jax, params_to_jax
from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                             run_workers, worker_env)

ROOT = Path(__file__).resolve().parents[1]
FWD = dict(rtol=1e-5, atol=1e-6)
LOSS = dict(rtol=1e-5)


def _jax_entry_module():
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_the_jax_entry():
    jfn, (jparams, jbatch, jy) = _jax_entry_module().entry()
    jlogits, jcenter = jax.jit(jfn)(jparams, jbatch, jy)
    fn, (params, batch, y) = graft_entry.entry(device="cpu")
    assert set(params) == set(params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    np.testing.assert_array_equal(batch.numpy(), np.asarray(jbatch))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    logits, center = fn(params_from_jax(jax.tree.map(np.asarray, jparams)),
                        batch, y)
    assert logits.shape == (64, 2) and center.shape == (64, 2)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **FWD)
    np.testing.assert_allclose(center.detach().numpy(), np.asarray(jcenter),
                               **FWD)
    # the port's own weights give finite values of the same shapes
    own, _ = fn(params, batch, y)
    assert torch.isfinite(own).all()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no GPU"):
        graft_entry.dryrun_multichip(2)


def _jax_spmd_loss(jg, params, batch, tp, fused_store: bool, mesh):
    """The JAX package's sharded loss (``spmd_loss_fn``) at ``mesh``: the
    plain lane, or bf16 stores with the sharded fused table."""
    labels = np.asarray(jg.labels)
    n_pad = -(-jg.num_nodes // 2) * 2
    x, _ = jspmd.pad_graph_for_mesh(jg, mesh)
    model = jax_model("PCGNN", feat_dim=jg.feat_dim, emb_dim=64,
                      num_relations=jg.num_relations, alpha=2.0, rho=0.5)
    bs, ys, ws = jspmd.shard_batch(
        mesh, jnp.asarray(batch, jnp.int32),
        jnp.asarray(labels[batch], jnp.int32),
        jnp.ones(len(batch), jnp.float32))
    tpj = jnp.asarray(tp, jnp.int32)
    tpv = jnp.ones(len(tp), bool)
    if fused_store:
        shards = jspmd.shard_relations(jg, mesh, n_pad, edge_windows=True,
                                       ewin_dtype=jnp.bfloat16)
        table, off = jspmd.build_sharded_fused(jg, shards, mesh, n_pad)
    else:
        shards = jspmd.shard_relations(jg, mesh, n_pad, edge_windows=False)
        table, off = None, ()
    lf = jspmd.spmd_loss_fn(model, mesh, n_pad, shards, fused_off=off)
    return float(jax.jit(lambda p: lf(p, x, shards, bs, ys, ws, tpj, tpv,
                                      table))(params))


def test_dryrun_multichip_matches_the_jax_spmd_step(monkeypatch, capsys):
    monkeypatch.setenv("GRAFT_DRYRUN_STRESS", "0")
    ranks = graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh=(1x2) loss=" in out
    assert "dryrun_multichip skew ok: mesh=(1x2)" in out
    assert [r["rank"] for r in ranks] == [0, 1]
    mesh = jmesh.make_mesh(data=1, graph=2, devices=jax.devices()[:2])
    # the tiny pass: seed 0, batch 8, 32 train positives, plain lane
    g = synthetic_fraud_graph("tiny", seed=0)
    labels = g.labels.numpy()
    want = _jax_spmd_loss(
        jax_graph("tiny", seed=0),
        params_to_jax(graft_entry._model(g, 0, "cpu")), np.arange(8),
        np.flatnonzero(labels == 1)[:32], False, mesh)
    # the skew pass: seed 1, batch 16 with the hub rows first
    gs = synthetic_fraud_graph("skew-tiny", seed=1)
    batch = np.random.default_rng(1).integers(0, gs.num_nodes, 16)
    rel0 = gs.relations[0]
    hubs = np.flatnonzero(rel0.deg.numpy() > rel0.window_width)
    batch[: min(4, len(hubs))] = hubs[:4]
    want_skew = _jax_spmd_loss(
        jax_graph("skew-tiny", seed=1),
        params_to_jax(graft_entry._model(gs, 1, "cpu")), batch,
        np.flatnonzero(gs.labels.numpy() == 1)[:64], True, mesh)
    for r in ranks:
        assert r["mesh"] == [1, 2] and r["backend"] == "gloo"
        assert r["overlap"] is True
        assert set(r["passes"]) == {"tiny", "skew-tiny"}
        np.testing.assert_allclose(r["passes"]["tiny"]["loss"], want, **LOSS)
        np.testing.assert_allclose(r["passes"]["skew-tiny"]["loss"],
                                   want_skew, **LOSS)
        # the CPU takes the kernels' plain versions: no launch is counted
        assert not any(r["passes"]["skew-tiny"]["launches"].values())
    # every rank publishes the same sums: the same gradients and the same
    # parameters after the Adam step
    for name in ("tiny", "skew-tiny"):
        first = ranks[0]["passes"][name]
        assert set(first["grads"]) == set(first["params"]) and first["grads"]
        for r in ranks[1:]:
            for kind in ("grads", "params"):
                for k, v in first[kind].items():
                    assert np.isfinite(v).all(), (name, kind, k)
                    np.testing.assert_array_equal(
                        r["passes"][name][kind][k], v, err_msg=k)


_STRESS_WORKER = r'''
import sys
from pcgnn_tpu_torch import graft_entry
from pcgnn_tpu_torch.data import synthetic
synthetic.PRESETS["stress-1m"] = synthetic.PRESETS["small"]
r, world, port, out = sys.argv[1:5]
graft_entry.rank_main(int(r), int(world), int(port), "cpu", out)
'''


def test_stress_pass_shards_the_structure(tmp_path, monkeypatch):
    """The stress pass with ``stress-1m`` cut to ``small``'s shape, at
    (1, 2): finite loss, and each rank holds half of the structure's bytes
    (within 4,096 a rank), as many as the JAX package's shard of the same
    graph puts on a device; the loss equals the JAX package's SPMD loss."""
    monkeypatch.setitem(jsyn.PRESETS, "stress-1m", jsyn.PRESETS["small"])
    worker = tmp_path / "worker.py"
    worker.write_text(_STRESS_WORKER)
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    env = worker_env(OMP_NUM_THREADS=1)
    env.pop("GRAFT_DRYRUN_STRESS", None)
    gang_with_fresh_port(lambda port: run_workers(
        str(worker), [(r, 2, port, outs[r]) for r in range(2)], env=env,
        timeout=300))
    ranks = [json.load(open(o)) for o in outs]
    jg = jax_graph("stress-1m", seed=0)
    mesh = jmesh.make_mesh(data=1, graph=2, devices=jax.devices()[:2])
    n_pad = -(-jg.num_nodes // 2) * 2
    shards = jspmd.shard_relations(jg, mesh, n_pad, edge_windows=False)
    jax_dev = sum(max(s.data.size * s.data.dtype.itemsize
                      for s in arr.addressable_shards)
                  for sh in shards
                  for arr in (sh.nbr2d, sh.deg, sh.keff, sh.ksample))
    # the loss: seed 0, batch 128, the first 4,096 train positives
    monkeypatch.setitem(tsyn.PRESETS, "stress-1m", tsyn.PRESETS["small"])
    g = synthetic_fraud_graph("stress-1m", seed=0)
    want = _jax_spmd_loss(
        jg, params_to_jax(graft_entry._model(g, 0, "cpu")),
        np.random.default_rng(0).integers(0, g.num_nodes, 128),
        np.flatnonzero(g.labels.numpy() == 1)[:4096], False, mesh)
    for r in ranks:
        rec = r["passes"]["stress-1m"]
        np.testing.assert_allclose(rec["loss"], want, **LOSS)
        mine, total = rec["struct_rank_bytes"], rec["struct_total_bytes"]
        assert total <= 2 * mine <= total + 4096 * 2
        assert mine == jax_dev
        assert rec["line"].startswith(
            "dryrun_multichip stress-1m ok: mesh=(1x2)")
        assert rec["num_nodes"] == jg.num_nodes
