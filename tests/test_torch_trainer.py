"""Trainer, splits, metrics, pick, checkpoints and config: the port against
the JAX package (which takes its splits and metrics from scikit-learn)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcgnn_tpu.data import prep as jprep
from pcgnn_tpu.sampling import pick as jpick
from pcgnn_tpu.train import checkpoint as jckpt
from pcgnn_tpu.train import metrics as jmetrics
from pcgnn_tpu.train.results import ResultManager as JResults
from pcgnn_tpu.train.trainer import Trainer as JTrainer
from pcgnn_tpu.train.trainer import torch_adam
from pcgnn_tpu.utils import config as jconfig
from pcgnn_tpu_torch import cli
from pcgnn_tpu_torch.data import prep as tprep
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.interop import params_from_jax, params_to_jax
from pcgnn_tpu_torch.sampling import pick as tpick
from pcgnn_tpu_torch.train import checkpoint as tckpt
from pcgnn_tpu_torch.train import metrics as tmetrics
from pcgnn_tpu_torch.train.results import ResultManager as TResults
from pcgnn_tpu_torch.train.trainer import Trainer as TTrainer
from pcgnn_tpu_torch.train.trainer import make_optimizer
from pcgnn_tpu_torch.utils import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    cfg = dict(seed=2, data_name="synthetic:tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=6,
               valid_epochs=3, batch_size=64, patience=100, exp_num=0)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("n,rate,train_ratio,test_ratio,seed,unlabeled", [
    (512, 0.15, 0.4, 0.67, 2, 0),
    (4096, 0.1, 0.4, 0.67, 72, 0),
    (1001, 0.3, 0.25, 0.5, 7, 0),
    (3000, 0.07, 0.4, 0.67, 5, 331),      # amazon-style unlabeled prefix
    (97, 0.5, 0.6, 0.33, 11, 0),
])
def test_stratified_splits_match_sklearn(n, rate, train_ratio, test_ratio,
                                         seed, unlabeled):
    labels = (np.random.default_rng(seed).random(n) < rate).astype(np.int64)
    want = jprep.stratified_splits(labels, train_ratio, test_ratio, seed,
                                   num_unlabeled=unlabeled)
    got = tprep.stratified_splits(labels, train_ratio, test_ratio, seed,
                                  num_unlabeled=unlabeled)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    pj, nj = jprep.pos_neg_split(want[0], labels[want[0]])
    pt, nt = tprep.pos_neg_split(got[0], labels[got[0]])
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(nt, nj)


def test_normalize_features_matches_jax():
    x = np.random.default_rng(0).random((50, 7)).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_array_equal(tprep.normalize_features(x),
                                  jprep.normalize_features(x))


def _probs(rng, m, quant):
    p1 = np.round(rng.random(m) * quant) / quant    # ties in the scores
    p0 = rng.random(m)
    return np.stack([p0, p1], 1).astype(np.float32)


@pytest.mark.parametrize("m,rate,quant", [(500, 0.15, 20), (97, 0.5, 1000),
                                          (64, 0.05, 3)])
def test_metrics_match_sklearn(m, rate, quant):
    rng = np.random.default_rng(m)
    labels = (rng.random(m) < rate).astype(np.int64)
    labels[:2] = [0, 1]
    probs = _probs(rng, m, quant)
    want = jmetrics.compute_metrics(labels, probs)
    got = tmetrics.compute_metrics(labels, probs)
    for k in ("accuracy", "f1", "f1_macro", "precision", "precision_macro",
              "recall", "recall_macro", "auc", "gmean"):
        assert abs(getattr(got, k) - getattr(want, k)) <= 1e-12, k
    np.testing.assert_array_equal(got.predictions, want.predictions)
    assert got.line == want.line
    bf_t, th_t = tmetrics.get_best_f1(labels, probs[:, 1])
    bf_j, th_j = jmetrics.get_best_f1(labels, probs[:, 1])
    assert abs(bf_t - bf_j) <= 1e-12 and th_t == th_j
    # batched evaluation, plain and with both threshold modes
    for kw in ({}, {"sweep_thresh": True}, {"valid_thresh": 0.3}):
        rj = jmetrics.evaluate(lambda b: probs[b], np.arange(m), labels, 64,
                               print_line=False, **kw)
        rt = tmetrics.evaluate(lambda b: torch.from_numpy(probs)[b],
                               np.arange(m), labels, 64, print_line=False,
                               **kw)
        for k in ("f1", "f1_macro", "auc", "thresh"):
            a, b = getattr(rt, k), getattr(rj, k)
            assert (a is None and b is None) or abs(a - b) <= 1e-12, (kw, k)


def test_pick_probs_and_distribution():
    y = np.array([0, 1, 0, 1, 1])
    deg = np.array([10, 10, 20, 30, 30])
    want = np.asarray(jpick.pick_probs(jnp.asarray(deg), jnp.asarray(y)))
    got = tpick.pick_probs(torch.from_numpy(deg), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # inverse-CDF draws with replacement follow the weights (the random
    # streams differ between the packages, so parity is statistical)
    idx = torch.tensor([100, 200, 300])
    g = torch.Generator().manual_seed(0)
    draws = tpick.pick_step(g, idx, tpick.pick_cdf(
        torch.tensor([1.0, 2.0, 7.0])), 20000)
    freq = np.array([(draws == v).float().mean().item()
                     for v in (100, 200, 300)])
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.02)
    small = tpick.pick_step(g, torch.tensor([5, 9]),
                            tpick.pick_cdf(torch.ones(2)), 100)
    assert len(small) == 100 and set(small.tolist()) <= {5, 9}
    # a uniform draw at the very top of the CDF stays in range
    top = tpick.pick_step(g, idx, tpick.pick_cdf(
        torch.tensor([0.0, 0.0, 1e-30])), 50)
    assert (top == 300).all()


def test_pick_cdf_is_the_sequential_float64_sum():
    """The pick's CDF is the float64 running sum in index order (numpy's),
    whatever device sums it, so one seed gives one plan."""
    rng = np.random.default_rng(5)
    w = rng.random(100_000).astype(np.float32)
    cdf = tpick.pick_cdf(torch.from_numpy(w))
    assert cdf.dtype == torch.float64
    np.testing.assert_array_equal(cdf.numpy(), np.cumsum(w.astype(np.float64)))
    idx = torch.arange(len(w))
    draws = [tpick.pick_step(torch.Generator().manual_seed(3), idx,
                             tpick.pick_cdf(torch.from_numpy(w)), 5000)
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])


def test_adam_matches_jax_torch_adam():
    """The port's optimizer is the JAX package's ``torch_adam``: L2 weight
    decay added to the gradient before the moments.  Same gradients in, the
    same parameters out, over three steps, to a few float32 ulps (the two
    apply the bias corrections in another order)."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    tx = torch_adam(0.01, 0.001)
    pj, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(torch.nn.ParameterList([w]), 0.01, 0.001)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, upd)
        w.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(pj),
                                   rtol=1e-6, atol=1e-6)


def _trainers(tmp_path, **kw):
    cfg = _cfg(**kw)
    jt = JTrainer(cfg, result=JResults(cfg, root=str(tmp_path / "jax")))
    tt = TTrainer(cfg, device="cpu",
                  result=TResults(cfg, root=str(tmp_path / "torch")))
    return jt, tt


@pytest.mark.parametrize("ewin_dtype", ["bfloat16", "float32"])
def test_one_step_matches_jax_step1(tmp_path, ewin_dtype):
    """One Adam step of each trainer from the same params, batch and
    weights.  Loss: rtol 1e-5 (float32 sums in another order); gradients:
    rtol 1e-4, atol 1e-6.  The first Adam step moves a weight by
    lr * g / (|g| + 1e-8): about lr = 0.01 whatever the gradient's size, so
    the updated parameters agree to atol 1e-5 as long as no gradient
    component cancels to the size of eps (on these inputs none does, and
    they differ by about 1e-7)."""
    jt, tt = _trainers(tmp_path, ewin_dtype=ewin_dtype)
    np.testing.assert_array_equal(tt.idx_train, jt.idx_train)
    np.testing.assert_array_equal(tt.train_pos, jt.train_pos)
    assert (tt.sample_size, tt.num_batches) == (jt.sample_size,
                                                jt.num_batches)
    params = jt.model.init(jax.random.key(1))
    rng = np.random.default_rng(3)
    batch = np.concatenate([rng.choice(jt.idx_train, 60), [0, 0, 0, 0]])
    y = tt.graph.labels.numpy()[batch]
    w = np.concatenate([np.ones(60), np.zeros(4)]).astype(np.float32)
    jb, jy, jw = (jnp.asarray(batch, jnp.int32), jnp.asarray(y, jnp.int32),
                  jnp.asarray(w))
    new_j, _, loss_j = jt._step1_jit(params, jt.tx.init(params), jb, jy, jw,
                                     jax.random.key(0), jt._step_graph,
                                     jt._step_consts)
    c = jt._step_consts
    grads_j = jax.grad(jt.model.loss)(
        params, jt._step_graph, jb, jy, jw, train_pos=c["tp"],
        train_pos_valid=c["tpv"], train_pos_feats=c["tpf"])

    model = tt.new_model()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    opt = tt.new_optimizer(model)
    loss_t = tt.step(model, opt, torch.from_numpy(batch), torch.from_numpy(y),
                     torch.from_numpy(w))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    gj = params_from_jax(jax.tree.map(np.asarray, grads_j))
    pj = params_from_jax(jax.tree.map(np.asarray, new_j))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), pj[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_epoch_plan(tmp_path):
    tt = TTrainer(_cfg(), device="cpu",
                  result=TResults(_cfg(), root=str(tmp_path)))
    assert tt.sample_size == 2 * len(tt.train_pos)
    assert tt.num_batches == -(-tt.sample_size // 64)
    ids, w = tt.epoch_plan(0)
    assert ids.shape == w.shape == (tt.num_batches, 64)
    s = tt.sample_size
    flat_ids, flat_w = ids.reshape(-1), w.reshape(-1)
    assert flat_w[:s].eq(1).all() and flat_w[s:].eq(0).all()
    assert flat_ids[s:].eq(0).all()
    assert set(flat_ids[:s].tolist()) <= set(tt.idx_train.tolist())
    # deterministic per (seed, epoch), different across epochs
    assert torch.equal(tt.epoch_plan(0)[0], ids)
    assert not torch.equal(tt.epoch_plan(1)[0], ids)


def test_train_end_to_end_in_jax_auc_band(tmp_path):
    """The JAX package's own test holds PC-GNN on a separable tiny graph to
    AUC > 0.8 (tests/test_trainer.py); the port trains on the same graph
    and config to the same band, within 0.1 of the JAX trainer's AUC (the
    pick and shuffle streams differ)."""
    from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
    cfg = _cfg(epochs=40, valid_epochs=10)
    kw = dict(seed=0, feature_separation=2.5, homophily=0.7)
    jt = JTrainer(cfg, graph=jax_graph("tiny", **kw),
                  result=JResults(cfg, root=str(tmp_path / "jax")))
    auc_j, _, _ = jt.train()
    tt = TTrainer(cfg, graph=torch_graph("tiny", **kw), device="cpu",
                  result=TResults(cfg, root=str(tmp_path / "torch")))
    auc_t, recall, f1_macro = tt.train()
    assert auc_t > 0.8 and abs(auc_t - auc_j) <= 0.1, (auc_t, auc_j)
    assert np.isfinite([recall, f1_macro]).all()
    r = tt.result
    for path in (r.log_test_path, r.log_val_path, r.df_test_path,
                 r.df_val_path, r.model_path):
        assert os.path.exists(path), path
    assert len(tt.epoch_times) == 40
    assert len(r.load_df_test()) == 1
    assert r.get_best_model_path().endswith(".ckpt")


def test_checkpoints_load_across_packages(tmp_path):
    from pcgnn_tpu.models.pcgnn import PCGNN as JPCGNN
    from pcgnn_tpu_torch.models.pcgnn import PCGNN as TPCGNN
    params = jax.tree.map(np.asarray,
                          JPCGNN(16, 8, 3, 2.0, 0.5).init(jax.random.key(4)))
    jckpt.save_checkpoint(str(tmp_path / "j.ckpt"), params)
    model = TPCGNN(16, 8, 3, 2.0, 0.5)
    model.load_state_dict(params_from_jax(
        tckpt.load_checkpoint(str(tmp_path / "j.ckpt"))))
    tckpt.save_checkpoint(str(tmp_path / "t.ckpt"), params_to_jax(model))
    back = jckpt.load_checkpoint(str(tmp_path / "t.ckpt"))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    # tensors and nested containers write as numpy leaves
    tckpt.save_checkpoint(str(tmp_path / "x.ckpt"),
                          {"a": torch.arange(3), "b": [torch.ones(2)]})
    x = jckpt.load_checkpoint(str(tmp_path / "x.ckpt"))
    assert isinstance(x["a"], np.ndarray) and x["b"][0].tolist() == [1, 1]


def test_config_matches_jax(tmp_path):
    assert tconfig.DEFAULTS == jconfig.DEFAULTS
    cfg = dict(a=[1, 2], b="x", c=[3, 4])
    assert tconfig.grid(cfg) == jconfig.grid(cfg)
    assert tconfig.grid(dict(b="x", thresholds=[0.1, 0.2])) == jconfig.grid(
        dict(b="x", thresholds=[0.1, 0.2]))
    # a per-relation list rides along a sweep.  (The JAX package's grid
    # drops it when another key is swept, utils/config.py:117; the port
    # keeps it, as both docstrings say it should.)
    swept = tconfig.grid(dict(cfg, thresholds=[0.1, 0.2, 0.3]))
    assert len(swept) == 4
    assert all(c["thresholds"] == [0.1, 0.2, 0.3] for c in swept)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(dict(data_name="synthetic:tiny")))
    assert tconfig.load_config(str(path)) == jconfig.load_config(str(path))
    with pytest.raises(ValueError, match="model"):
        tconfig.with_defaults(dict(data_name="x", model=None))


@pytest.mark.parametrize("key,value", [("num_devices", 2),
                                       ("edge_windows", False),
                                       ("resume", True),
                                       ("profile_dir", "prof")])
def test_trainer_rejects_unported_config(tmp_path, key, value):
    """Multi-device training is ported with one process per rank: a
    trainer asked for 2 devices in a process that is not one of 2 ranks
    refuses (the CLI starts the ranks; ``tests/test_torch_spmd_trainer.py``
    trains them).  ``edge_windows: false`` is ported: the trainer builds no
    store and trains on the lanes without them.  ``resume`` and
    ``profile_dir`` are ported: a trainer takes them and trains."""
    if key == "profile_dir":
        value = str(tmp_path / value)
    cfg = _cfg(**{key: value})
    result = TResults(cfg, root=str(tmp_path))
    if key == "num_devices":
        with pytest.raises(RuntimeError, match="one process per device"):
            TTrainer(cfg, device="cpu", result=result)
        return
    t = TTrainer(cfg, device="cpu", result=result)
    if key == "edge_windows":
        g = t.graph
        assert g.fused is None and g.features_pad is None
        assert all(r.ewin is None for r in (*g.relations, g.homo))
        loss = t.run_epoch(t.new_model(), t.new_optimizer(t.model), 0)
        assert torch.isfinite(loss)
        return
    auc, _, _ = t.train()
    assert 0.0 <= auc <= 1.0
    written = (os.path.exists(t._resume_path()) if key == "resume"
               else len(os.listdir(value)) == 1)
    assert written


def test_unported_datasets_raise(tmp_path, monkeypatch):
    """Every dataset of the JAX package loads in the port: an unknown name
    raises as there, a real dataset whose files are missing raises the
    file error (``tests/test_torch_loaders.py`` loads fabricated ones);
    the stress presets load (cut small here): directed relations and a
    degree-only homo stub."""
    from pcgnn_tpu_torch.data import synthetic
    from pcgnn_tpu_torch.data.loaders import load_data
    with pytest.raises(ValueError, match="unknown dataset"):
        load_data("no-such-dataset")
    with pytest.raises(FileNotFoundError):
        load_data("yelp", str(tmp_path) + "/")
    monkeypatch.setitem(synthetic.PRESETS, "stress-1m",
                        (2048, 8, 0.05, (4096, 2048, 1024), 3))
    g = load_data("synthetic:stress-1m")
    assert g.num_nodes == 2048 and g.homo.is_stub
    assert not any(r.is_stub for r in g.relations)


def test_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(_cfg(epochs=2, valid_epochs=1)))
    auc, recall, f1 = cli.main(["--exp_config_path", str(path),
                                "--device", "cpu"])
    assert 0.0 <= auc <= 1.0
    assert "Test performance" in capsys.readouterr().out
    assert os.path.isdir(tmp_path / "experimental_results" / "test_log")


# ------------------------------ resume ------------------------------ #

def _resume_runs(tmp_path, cut, **kw):
    """An uncut run of ``_cfg(**kw)`` and the same run cut after ``cut``
    epochs and resumed, each in its own result root; returns the two
    trainers, their test results and their resume files."""
    cfg = _cfg(resume=True, **kw)
    runs = {}
    for tag in ("uncut", "cut"):
        root = str(tmp_path / tag)
        if tag == "cut":
            TTrainer(dict(cfg, epochs=cut), device="cpu",
                     result=TResults(cfg, root=root)).train()
        t = TTrainer(cfg, device="cpu", result=TResults(cfg, root=root))
        res = t.train()
        runs[tag] = (t, res, tckpt.load_checkpoint(t._resume_path()))
    return runs


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("kw", [dict(model="PCGNN"), dict(model="GCN"),
                                dict(model="SAGE", num_sample=4),
                                dict(model="PCGNN", learn_features=True)],
                         ids=["PCGNN", "GCN", "SAGE", "learned"])
def test_resumed_run_equals_uncut_run(tmp_path, kw):
    """A run cut after epoch 3 and resumed to 6 ends exactly equal to the
    uncut run on the CPU: the resume file (parameters, Adam state,
    selection state), the restored model and the test metrics."""
    runs = _resume_runs(tmp_path, cut=3, **kw)
    (tu, ru, su), (tc, rc, sc) = runs["uncut"], runs["cut"]
    assert su["epoch"] == sc["epoch"] == 5
    _assert_tree_equal(su, sc)
    assert su["opt_state"] and all(
        st["step"].dtype == np.float32 and st["step"] == 6 * tu.num_batches
        for st in su["opt_state"].values())
    if kw.get("learn_features"):
        assert "embed" in su["params"] and "embed" in su["opt_state"]
    assert ru == rc
    for (k, a), (_, b) in zip(tu.model.state_dict().items(),
                              tc.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert len(tc.epoch_times) == 3


def test_adam_state_round_trip():
    """``adam_state`` / ``load_adam_state`` give torch's Adam back exactly
    as it keeps its state (dtype and device of every tensor, ``step``
    included), so the next step is the same."""
    from pcgnn_tpu_torch.train.trainer import adam_state, load_adam_state
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt = make_optimizer(model, 0.01, 0.001)
    x = torch.randn(8, 4, generator=gen)

    def step(m, o):
        o.zero_grad()
        m(x).square().sum().backward()
        o.step()

    for _ in range(2):
        step(model, opt)
    saved = adam_state(model, opt)
    twin = copy.deepcopy(model)
    opt2 = make_optimizer(twin, 0.01, 0.001)
    load_adam_state(twin, opt2, saved)
    for p, q in zip(model.parameters(), twin.parameters()):
        for k, v in opt.state[p].items():
            w = opt2.state[q][k]
            assert (w.dtype, w.device, w.shape) == (v.dtype, v.device,
                                                    v.shape), k
            assert torch.equal(w, v), k
    step(model, opt)
    step(twin, opt2)
    for p, q in zip(model.parameters(), twin.parameters()):
        assert torch.equal(p, q)


def test_resume_continues_training(tmp_path, monkeypatch):
    """Mirror of the JAX package's test: a second run resumes from the
    first run's last epoch (a missing file starts fresh)."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(epochs=3, valid_epochs=1, resume=True)
    t1 = TTrainer(cfg, device="cpu")
    assert not os.path.exists(t1._resume_path())
    t1.train()
    t2 = TTrainer(dict(cfg, epochs=5), device="cpu")
    assert os.path.exists(t2._resume_path())
    assert t2._resume_path() == JTrainer(cfg)._resume_path()
    t2.train()
    st = tckpt.load_checkpoint(t2._resume_path())
    assert st["epoch"] == 4
    assert len(t2.epoch_times) == 2


# ---------------------------- profile_dir ---------------------------- #

@pytest.mark.parametrize("epochs,traced", [(5, 3), (3, 1)])
def test_profile_dir_writes_a_trace(tmp_path, epochs, traced):
    """The trace spans epochs 2-4 (from the start epoch); a run that ends
    before epoch 4 closes it when its epochs end.  Every traced step runs
    one Adam step."""
    prof = tmp_path / "prof"
    cfg = _cfg(epochs=epochs, valid_epochs=1, profile_dir=str(prof))
    t = TTrainer(cfg, device="cpu",
                 result=TResults(cfg, root=str(tmp_path / "r")))
    t.train()
    (path,) = prof.glob("trace-*.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = sum(1 for e in events if e.get("ph") == "X"
                and e.get("name", "").startswith("Optimizer.step#Adam"))
    assert steps == traced * t.num_batches


# -------------------------- files and the CLI -------------------------- #

def test_load_native_refuses_a_threshold_list(tmp_path, monkeypatch):
    """The JAX package's ``load_native`` fails inside numpy on a
    per-relation list; the port refuses it with its own message, through
    ``load_data`` and the trainer too."""
    from pcgnn_tpu.data import loaders as jloaders
    from pcgnn_tpu_torch.data import loaders as tloaders
    monkeypatch.chdir(tmp_path)
    tloaders.save_native("g.npz", torch_graph("tiny", seed=0))
    thr = [0.3, 0.5, 0.7]
    with pytest.raises(ValueError, match="broadcast"):
        jloaders.load_native("g.npz", threshold=thr)
    for call in (lambda: tloaders.load_native("g.npz", threshold=thr),
                 lambda: tloaders.load_data("g.npz", threshold=thr),
                 lambda: TTrainer(_cfg(data_name="g.npz", thresholds=thr),
                                  device="cpu")):
        with pytest.raises(ValueError, match="per-relation thresholds"):
            call()
    assert tloaders.load_native("g.npz", threshold=0.3).num_relations == 3


def test_cli_runs_the_yelpchi_config_on_fabricated_files(tmp_path,
                                                         monkeypatch, capsys):
    """``configs/pcgnn_yelpchi.json``'s keys, pointed at tiny YelpChi-format
    files (``data_prefix``), cut to 2 epochs, through the CLI on the CPU."""
    from tests.test_torch_loaders import write_pickled
    write_pickled(str(tmp_path / "data"), "yelp", n=300, f=32,
                  layout="review")
    cfg = tconfig.load_config(os.path.join(ROOT, "configs",
                                           "pcgnn_yelpchi.json"))
    assert cfg["data_name"] == "yelp"
    cfg.update(data_prefix=str(tmp_path / "data") + "/", epochs=2,
               valid_epochs=1, batch_size=64)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    auc, recall, f1 = cli.main(["--exp_config_path", str(path),
                                "--device", "cpu"])
    assert 0.0 <= auc <= 1.0 and np.isfinite([recall, f1]).all()
    out = capsys.readouterr().out
    assert "Valid at epoch 1" in out and "Test performance" in out
    assert os.listdir(tmp_path / "experimental_results" / "test_df") == [
        "PCGNN-yelp.csv"]
