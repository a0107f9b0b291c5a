"""The port's scaling harnesses (``benchmarks/spmd_scaling.py`` and
``multihost_scaling.py`` of ``pcgnn_tpu_torch``) over gloo ranks on the
CPU, against the JAX package's SPMD step.

``spmd_scaling`` is fed the JAX package's initial parameters (converted by
``interop.params_from_jax``): its (1, 1) warm-step loss equals the JAX
package's (1, 1) ``make_spmd_train_step`` loss on the same batch, and
every mesh's warm loss equals the (1, 1) loss on its own batch, both to
rtol 1e-5 (the sharded sums run in another float order).  Each gang has
its own timeout, so no test can hang.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.models import build_model as jax_model
from pcgnn_tpu.parallel.mesh import make_mesh as jax_mesh
from pcgnn_tpu.parallel.spmd import (make_spmd_train_step, pad_graph_for_mesh,
                                     shard_batch, shard_relations)
from pcgnn_tpu.train.trainer import torch_adam
from pcgnn_tpu_torch.benchmarks import multihost_scaling, spmd_scaling
from pcgnn_tpu_torch.interop import params_from_jax
from pcgnn_tpu_torch.parallel.distributed import gang_backend

LOSS_RTOL = 1e-5
GANG_TIMEOUT_S = 120
PRESET, BATCH = "tiny", 32


def _jax_one_by_one(params0):
    """The JAX package's (1, 1) SPMD step's loss at ``params0`` on the
    harness's batch."""
    g = jax_graph(PRESET, seed=spmd_scaling.SEED)
    model = jax_model("PCGNN", feat_dim=g.feat_dim, emb_dim=spmd_scaling.EMB,
                      num_relations=3, alpha=2.0, rho=0.5)
    mesh = jax_mesh(data=1, graph=1, devices=jax.devices()[:1])
    x_sharded, n_pad = pad_graph_for_mesh(g, mesh)
    shards = shard_relations(g, mesh, n_pad)
    tx = torch_adam(0.01, 0.001)
    step = make_spmd_train_step(model, mesh, tx, x_sharded, shards, n_pad)
    labels = np.asarray(g.labels)
    train_pos = np.flatnonzero(labels == 1)[:spmd_scaling.NUM_TRAIN_POS]
    batch = np.random.default_rng(0).integers(0, g.num_nodes, BATCH)
    bs, ys, ws = shard_batch(mesh, jnp.asarray(batch, jnp.int32),
                             jnp.asarray(labels[batch], jnp.int32),
                             jnp.ones((BATCH,), jnp.float32))
    params = jax.tree.map(jnp.array, params0)
    _, _, loss = step(params, tx.init(params), bs, ys, ws,
                      jnp.asarray(train_pos, jnp.int32),
                      jnp.ones(len(train_pos), bool))
    return float(loss)


def test_spmd_scaling_matches_jax(tmp_path, capsys):
    """--devices 2 over gloo: (1, 1), (2, 1), (1, 2), the JAX params fed
    in; the records carry the JAX script's keys and the summary its weak
    scaling efficiency."""
    g = jax_graph(PRESET, seed=spmd_scaling.SEED)
    params0 = jax_model("PCGNN", feat_dim=g.feat_dim,
                        emb_dim=spmd_scaling.EMB, num_relations=3, alpha=2.0,
                        rho=0.5).init(jax.random.key(0))
    npz = tmp_path / "params.npz"
    np.savez(npz, **{k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, params0)).items()})
    # the gangs run while the JAX step compiles here
    with ThreadPoolExecutor(1) as pool:
        gangs = pool.submit(spmd_scaling.run, devices=2, preset=PRESET,
                            batch_per_data=BATCH, steps=1, device="cpu",
                            params=str(npz), timeout=GANG_TIMEOUT_S)
        want = _jax_one_by_one(params0)
        out = gangs.result()
    recs = out["records"]
    assert [r["mesh"] for r in recs] == [
        "data=1 graph=1", "data=2 graph=1", "data=1 graph=2"]
    assert [r["batch"] for r in recs] == [BATCH, 2 * BATCH, BATCH]
    assert all(r["backend"] == "gloo" for r in recs)
    np.testing.assert_allclose(recs[0]["warm_loss"], want, rtol=LOSS_RTOL)
    for r in recs:
        np.testing.assert_allclose(r["warm_loss"], r["ref_loss"],
                                   rtol=LOSS_RTOL, err_msg=r["mesh"])
        assert {"mesh", "batch", "step_ms", "rows_per_s", "loss",
                "struct_bytes_per_device", "struct_bytes_total"} <= set(r)
    # the (1, 2) mesh holds half the rows of every relation's structure
    assert recs[2]["struct_bytes_total"] == recs[0]["struct_bytes_total"]
    assert 2 * recs[2]["struct_bytes_per_device"] == (
        recs[2]["struct_bytes_total"])
    assert [s["weak_scaling_eff"] for s in out["summary"]][0] == 1.0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and lines[-1].startswith('{"summary": ')


def test_mesh_shapes_and_backends():
    assert spmd_scaling.mesh_shapes(8) == [(1, 1), (2, 1), (1, 2), (4, 1),
                                           (1, 4), (8, 1), (1, 8)]
    assert gang_backend("cpu", 4) == "gloo"
    assert gang_backend("cuda", 4) == "nccl"
    assert gang_backend("cuda:0", 1) == "nccl"
    assert gang_backend("cuda:0", 2) == "gloo"
    assert multihost_scaling.ladder(2) == [1, 2]
    assert multihost_scaling.ladder(6) == [1, 2, 4, 6]


def test_a_rank_a_card_is_refused_past_the_visible_cards():
    """``--device cuda`` puts rank r on ``cuda:r``: a mesh larger than the
    visible cards is refused before any rank starts."""
    with pytest.raises(ValueError, match="one a rank"):
        spmd_scaling.run(devices=2, preset=PRESET, device="cuda",
                         meshes=[(1, 1), (2, 1)])
    with pytest.raises(ValueError, match="one a rank"):
        multihost_scaling.run(multihost_scaling.parse_args(
            ["--procs", "2", "--devices_per_proc", "1", "--mesh_graph", "1",
             "--device", "cuda"]))
    with pytest.raises(ValueError, match="must be"):
        spmd_scaling.run(device="cpu", meshes=[(2, 1)])


def test_multihost_scaling_finishes(capsys):
    """1 and 2 processes on tiny for 1 epoch through the CLI's
    ``distributed: true`` ranks: both counts finish, with scaling_eff 1.0
    at 1 process."""
    recs = multihost_scaling.run(multihost_scaling.parse_args([
        "--procs", "2", "--devices_per_proc", "1", "--mesh_graph", "1",
        "--preset", PRESET, "--batch_per_data", "64", "--epochs", "1",
        "--warm_epochs", "1", "--device", "cpu",
        "--timeout", str(GANG_TIMEOUT_S)]))
    assert [r["procs"] for r in recs] == [1, 2]
    assert [r["ranks"] for r in recs] == [1, 2]
    assert recs[0]["scaling_eff"] == 1.0
    assert all(r["warm_s"] > 0 and r["epoch_s"] >= 0 for r in recs)
    assert {"procs", "epoch_s", "epochs_per_s", "warm_s",
            "scaling_eff"} <= set(recs[0])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '{"summary": ')
