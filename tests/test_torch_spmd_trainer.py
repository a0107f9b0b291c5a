"""Sharded training through the port's entry points: the CLI's
``num_devices`` ranks and ``distributed: true`` ranks of 2 "hosts" x 2
local ranks (mirroring ``tests/test_multihost.py``), on gloo CPU ranks,
held to the single-process run; the process-group entry; and the JAX
package's refusals, which are the only ones left.

Every rank draws the same epoch plans and its replicas take the same Adam
steps, so a sharded run reproduces the single-process run: the same
validation losses to rtol 1e-4 and the same test metrics to 1e-6 (the
sharded sums run in another float order).
"""

import json
import re

import numpy as np
import pytest
import torch

from pcgnn_tpu_torch import cli
from pcgnn_tpu_torch.parallel import distributed as tdist
from pcgnn_tpu_torch.parallel import spmd
from pcgnn_tpu_torch.parallel.mesh import (factor_mesh, rank_mesh,
                                           single_rank_mesh)
from pcgnn_tpu_torch.train.trainer import Trainer
from pcgnn_tpu_torch.utils.config import with_defaults
from pcgnn_tpu_torch.utils.multiproc import (free_port, gang_with_fresh_port,
                                             run_workers, worker_env)

CFG = dict(seed=7, data_name="synthetic:tiny", model="PCGNN", train_ratio=0.4,
           test_ratio=0.67, emb_size=16, lr=0.01, weight_decay=0.001,
           alpha=2.0, rho=0.5, epochs=4, valid_epochs=2, batch_size=64,
           patience=100, exp_num=0)
BASE_CFG = dict(CFG, model="GCN", lr=0.005, weight_decay=0.0005)
_LOSS = re.compile(r"Valid at epoch (\d+) \(loss ([0-9.]+)")


def _losses(text: str) -> list:
    return [float(m.group(2)) for m in _LOSS.finditer(text)]


def _single(cfg, tmp_path, capsys, name):
    """The single-process CLI run of ``cfg``: metrics, printed losses."""
    work = tmp_path / name
    work.mkdir()
    path = work / "c.json"
    path.write_text(json.dumps(dict(cfg, num_devices=1)))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        capsys.readouterr()
        metrics = cli.main(["--exp_config_path", str(path), "--device", "cpu"])
    return metrics, _losses(capsys.readouterr().out)


@pytest.mark.parametrize("cfg,n", [(CFG, 4), (dict(BASE_CFG, model="GCN"), 2),
                                   (dict(BASE_CFG, model="SAGE"), 2)],
                         ids=["pcgnn-4", "gcn-2", "sage-2"])
def test_num_devices_cli_matches_single_process(tmp_path, capsys, cfg, n):
    """``num_devices: n`` starts n CPU ranks (factor_mesh: (2, 2) for 4,
    (1, 2) for 2); their metrics agree (the CLI checks) and equal the
    single-process run's."""
    want, want_losses = _single(cfg, tmp_path, capsys, "single")
    work = tmp_path / "ranks"
    work.mkdir()
    path = work / "c.json"
    path.write_text(json.dumps(dict(cfg, num_devices=n)))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        capsys.readouterr()
        got = cli.main(["--exp_config_path", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    dd, dg = factor_mesh(n)
    assert f"{{'dcn': 1, 'data': {dd}, 'graph': {dg}}}" in out
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert len(want_losses) == 2
    np.testing.assert_allclose(_losses(out), want_losses, rtol=1e-4)
    # rank 0 alone wrote the result tree
    assert (work / "experimental_results").is_dir()


_DIST_WORKER = """
import json, os, sys
pid, port, out, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
os.environ["PCGNN_PROCESS_ID"] = str(pid)
os.makedirs(os.path.join(workdir, str(pid)), exist_ok=True)
os.chdir(os.path.join(workdir, str(pid)))
from pcgnn_tpu_torch.cli import run
from pcgnn_tpu_torch.utils.config import with_defaults
cfg = with_defaults(dict({cfg!r}, distributed=True,
                         coordinator_address=f"localhost:{{port}}",
                         num_processes=4, mesh_graph=2, ranks_per_host=2))
auc, recall, f1 = run(cfg, device="cpu")
with open(out, "w") as f:
    json.dump([auc, recall, f1], f)
"""


def test_distributed_two_hosts_matches_single_process(tmp_path, capsys):
    """``distributed: true`` on 4 ranks, 2 per host, ``mesh_graph: 2``:
    the ('dcn', 'data', 'graph') mesh is (2, 1, 2), graph groups stay
    within a host, every rank reports the same metrics, equal to the
    single-process run's."""
    want, want_losses = _single(CFG, tmp_path, capsys, "single")
    worker = tmp_path / "worker.py"
    worker.write_text(_DIST_WORKER.format(cfg=CFG))
    outs = [tmp_path / f"m{r}.json" for r in range(4)]
    logs = gang_with_fresh_port(lambda port: run_workers(
        str(worker), [(r, port, outs[r], tmp_path) for r in range(4)],
        env=worker_env(OMP_NUM_THREADS=1), timeout=300))
    metrics = [json.loads(o.read_text()) for o in outs]
    assert all(m == metrics[0] for m in metrics), metrics
    np.testing.assert_allclose(metrics[0], want, rtol=0, atol=1e-6)
    for r, log in enumerate(logs):
        assert ("{'dcn': 2, 'data': 1, 'graph': 2}: rank "
                f"{r}, data block {r // 2}, graph block {r % 2}") in log
    np.testing.assert_allclose(_losses(logs[0]), want_losses, rtol=1e-4)
    # only rank 0 writes checkpoints, tables and predictions (every rank's
    # ResultManager opens its logs with the config, as in the JAX package)
    for r in range(4):
        root = tmp_path / str(r) / "experimental_results"
        out = [p for d in ("saved_models", "test_df", "validation_df",
                           "predictions") for p in (root / d).glob("*")]
        assert bool(out) == (r == 0), (r, out)


@pytest.fixture
def one_rank_group():
    """This process as the only rank of a gloo group."""
    tdist.init_distributed(f"localhost:{free_port()}", 1, 0, backend="gloo")
    yield
    torch.distributed.destroy_process_group()


def test_one_rank_group_steps_equal_single_device_exactly(
        one_rank_group, tmp_path, monkeypatch):
    """A 1 x 1 mesh elides every collective, and its step is the
    single-device step bit for bit: loss and parameters after 3 steps, on
    the hub graph with bf16 stores (fused, store and hub lanes)."""
    monkeypatch.chdir(tmp_path)
    cfg = dict(CFG, data_name="synthetic:skew-tiny", ewin_dtype="bfloat16")
    single = Trainer(cfg, device="cpu")
    # ensure_initialized keeps the group this process joined
    rank = Trainer(dict(cfg, distributed=True, num_processes=1,
                        process_id=0, coordinator_address="localhost:1"),
                   device="cpu", graph=single.graph)
    assert rank.mesh.size == 1 and rank.sharded.fused is not None
    got = []
    for t in (single, rank):
        model = t.new_model()
        opt = t.new_optimizer(model)
        batches, weights = t.epoch_plan(0)
        losses = [t.step(model, opt, batches[i], t.labels[batches[i]],
                         weights[i]) for i in range(3)]
        got.append((torch.stack(losses), list(model.parameters())))
    assert torch.equal(got[0][0], got[1][0])
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)
    assert rank.mesh.stats.calls == {"graph": 0, "data": 0}


def test_ensure_initialized_is_idempotent(one_rank_group):
    tdist.ensure_initialized("localhost:1", 1, 0, backend="gloo")
    with pytest.raises(ValueError, match="world size"):
        tdist.ensure_initialized("localhost:1", 2, 0)
    with pytest.raises(ValueError, match="backend"):
        tdist.ensure_initialized(backend="nccl")
    with pytest.raises(ValueError, match="does not divide"):
        rank_mesh(graph=2)


def test_init_distributed_checks_its_arguments():
    with pytest.raises(ValueError, match="backend"):
        tdist.init_distributed("localhost:1", 1, 0, backend="mpi")
    with pytest.raises(ValueError, match="num_processes"):
        tdist.init_distributed("localhost:1", backend="gloo")
    assert tdist.default_backend("cpu") == "gloo"
    assert tdist.default_backend("cuda:3") == "nccl"
    assert cli.rank_device(None, 3) == "cuda:3"
    assert cli.rank_device("cuda", 1) == "cuda:1"
    assert cli.rank_device("cuda:0", 1) == "cuda:0"
    assert cli.rank_device("cpu", 2) == "cpu"


# -------------------------------------------------------------- refusals

def test_learn_features_is_refused_under_sharding(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for kw in (dict(num_devices=2), dict(distributed=True)):
        with pytest.raises(NotImplementedError, match="learn_features"):
            Trainer(dict(CFG, learn_features=True, **kw), device="cpu")


def test_num_devices_over_the_visible_cards_is_refused(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 devices are visible"):
        cli.run_local_ranks(with_defaults(dict(CFG, num_devices=2)))


def test_num_devices_without_a_group_is_refused(tmp_path, monkeypatch):
    """A rank is a process: a Trainer asked for 2 devices outside a group
    of 2 ranks raises instead of training on one."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="one process per device"):
        Trainer(dict(CFG, num_devices=2), device="cpu")


def test_num_sample_on_a_capped_homo_graph_is_refused():
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.models import build_model

    g = synthetic_fraud_graph("skew-tiny", seed=4)
    assert g.homo.has_hubs
    sg = spmd.shard_graph(g, single_rank_mesh(), pcgnn=False)
    model = build_model("SAGE", feat_dim=g.feat_dim, emb_dim=8, num_sample=5)
    with pytest.raises(ValueError, match="num_sample"):
        spmd.spmd_homo_forward(model, sg, torch.arange(8))


def test_a_stub_relation_is_refused():
    import dataclasses

    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.graph.csr import degree_stub

    g = synthetic_fraud_graph("tiny", seed=4)
    g = dataclasses.replace(g, homo=degree_stub(g.homo.deg.numpy()))
    with pytest.raises(ValueError, match="stub"):
        spmd.shard_graph(g, single_rank_mesh(), pcgnn=False)
