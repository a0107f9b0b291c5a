"""The roofline toolkit, ``Trainer.single_step`` and ``prob2pred``: the port
against the JAX package, and the toolkit's refusals on the CPU.

Timing needs the card, so here ``measure`` and ``timed_ms`` must raise; the
card's own checks (a 1 GB copy and an 8192^3 bf16 product read a share of
their peak in (0.3, 1.05]) are in ``tests/test_torch_cuda.py``.
``single_step`` replays ``Trainer.step`` exactly on the CPU (the same
operations in the same order); against the JAX package's ``single_step``
the loss agrees to rtol 1e-5 (float32 sums in another order, and after the
first step Adam's updates of those sums).
"""

import jax
import numpy as np
import pytest
import torch

from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu.train import metrics as jmetrics
from pcgnn_tpu.train.results import ResultManager as JResults
from pcgnn_tpu.train.trainer import Trainer as JTrainer
from pcgnn_tpu.utils import roofline as jroof
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.interop import params_from_jax
from pcgnn_tpu_torch.train import metrics as tmetrics
from pcgnn_tpu_torch.train.results import ResultManager as TResults
from pcgnn_tpu_torch.train.trainer import Trainer as TTrainer
from pcgnn_tpu_torch.utils import roofline as troof


def _cfg(**kw):
    cfg = dict(seed=2, data_name="synthetic:tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=2,
               valid_epochs=1, batch_size=64, patience=100, exp_num=0)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("preset,seed,stores", [
    ("tiny", 1, False), ("small", 3, True), ("skew-tiny", 1, False)])
@pytest.mark.parametrize("batch_size,m_max,emb", [(1024, 53, 64),
                                                  (64, 7, 16)])
def test_step_streaming_bytes_matches_jax(preset, seed, stores, batch_size,
                                          m_max, emb):
    """The same float for the same graph (window widths come from dcap, so
    the stores change nothing)."""
    gj, gt = jax_graph(preset, seed=seed), torch_graph(preset, seed=seed)
    if stores:
        gj = jcsr.materialize_edge_windows(gj)
        gt = tcsr.materialize_edge_windows(gt)
    want = jroof.pcgnn_step_streaming_bytes(gj, batch_size, m_max, emb)
    got = troof.pcgnn_step_streaming_bytes(gt, batch_size, m_max, emb)
    assert isinstance(got, float) and got == want


@pytest.mark.parametrize("scored", [None, 0, 500])
def test_step_streaming_bytes_counts_the_scored_rows(scored):
    """``scored_rows`` takes the place of the table's rows in the score
    product's pass, and nothing else moves; by default it is the table."""
    g = torch_graph("tiny", seed=1)
    base = troof.pcgnn_step_streaming_bytes(g, 64, 7, 16)
    got = troof.pcgnn_step_streaming_bytes(g, 64, 7, 16, scored_rows=scored)
    rows = g.num_nodes if scored is None else scored
    assert got == base - (g.num_nodes - rows) * g.feat_dim * 4


@pytest.mark.parametrize("kind,peaks", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 989e12)),
    ("NVIDIA H100 PCIe", (2.0e12, 756e12)),
    ("NVIDIA H100 NVL", (3.9e12, 835e12)),
    ("NVIDIA H200", (4.8e12, 989e12)),
    ("NVIDIA A100-SXM4-80GB", (None, None)),
    ("", (None, None))])
def test_chip_peaks_by_card_name(monkeypatch, kind, peaks):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: kind)
    assert troof.chip_peaks(0) == peaks


def test_chip_peaks_reads_the_card_name(monkeypatch):
    """By default the name is the card's; with no card there are no
    peaks (the JAX function's answer on its CPU backend)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert troof.chip_peaks() == (3.35e12, 989e12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert troof.chip_peaks() == (None, None)


def test_measure_and_timed_ms_raise_on_the_cpu(monkeypatch):
    """A measurement that finds no card fails; it does not time the CPU."""
    x = torch.ones(8)
    with pytest.raises(RuntimeError, match="CUDA card"):
        troof.measure(torch.neg, x, analytic_bytes=64, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        troof.timed_ms(lambda: torch.neg(x))
    with pytest.raises(RuntimeError, match="CUDA card"):
        troof.measure(torch.neg, x, analytic_bytes=64)


@pytest.mark.parametrize("key,kw", [
    ("sol_frac", dict(analytic_bytes=3.35e12 * 1e-3 * 1.06)),
    ("mfu", dict(analytic_flops=989e12 * 1e-3 * 1.06))])
def test_measure_refuses_a_share_above_the_limit(monkeypatch, key, kw):
    """A call timed at 1 ms that would have moved 1.06 ms of the peak's
    bytes (or operations) raises; at 1.04 ms it is reported."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(troof, "timed_ms", lambda call, target_s: 1.0)
    with pytest.raises(RuntimeError, match=key):
        troof.measure(torch.neg, torch.ones(2), **kw)
    ok = {k: v / 1.06 * 1.04 for k, v in kw.items()}
    res = troof.measure(torch.neg, torch.ones(2), **ok)
    assert res[key] == pytest.approx(1.04)
    assert res["device"] == "NVIDIA H100 80GB HBM3"
    assert res["xla_bytes"] is None and res["wall_ms"] == 1.0


def _batch(t, seed=3):
    rng = np.random.default_rng(seed)
    batch = np.concatenate([rng.choice(t.idx_train, 60), [0, 0, 0, 0]])
    y = t.graph.labels.numpy()[batch]
    w = np.concatenate([np.ones(60), np.zeros(4)]).astype(np.float32)
    return batch, y, w


@pytest.mark.parametrize("model", ["PCGNN", "SAGE"])
@pytest.mark.parametrize("nscan", [1, 3])
def test_single_step_replays_trainer_steps(tmp_path, model, nscan):
    """``fn(*args)`` equals ``nscan`` ``Trainer.step`` calls on batches
    rolled by 0..nscan-1, exactly: the last loss, every parameter and
    every Adam moment."""
    cfg = _cfg(model=model, num_sample=3 if model == "SAGE" else None)
    t = TTrainer(cfg, device="cpu", result=TResults(cfg, root=str(tmp_path)))
    batch, y, w = _batch(t)
    m1, m2 = t.new_model(), t.new_model()
    o1, o2 = t.new_optimizer(m1), t.new_optimizer(m2)
    fn, args = t.single_step(m1, o1, batch, y, w, nscan=nscan)
    loss = fn(*args)
    b, yy, ww = (torch.from_numpy(a) for a in (batch, y, w))
    for i in range(nscan):
        want = t.step(m2, o2, torch.roll(b, i), torch.roll(yy, i),
                      torch.roll(ww, i), t.step_generator(0, i))
    assert torch.equal(loss, want)
    for (k, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p1, p2), k
        for s1, s2 in zip(o1.state[p1].values(), o2.state[p2].values()):
            assert torch.equal(s1, s2), k


@pytest.mark.parametrize("nscan", [1, 3])
def test_single_step_loss_matches_jax(tmp_path, nscan):
    """The last loss of ``nscan`` steps from the same parameters and batch
    in both packages (PC-GNN, bf16 stores)."""
    cfg = _cfg()
    jt = JTrainer(cfg, result=JResults(cfg, root=str(tmp_path / "jax")))
    tt = TTrainer(cfg, device="cpu",
                  result=TResults(cfg, root=str(tmp_path / "torch")))
    params = jt.model.init(jax.random.key(1))
    batch, y, w = _batch(tt)
    fj, aj = jt.single_step(params, jt.tx.init(params), batch, y, w,
                            nscan=nscan)
    loss_j = float(fj(*aj)[2])
    model = tt.new_model()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ft, at = tt.single_step(model, tt.new_optimizer(model), batch, y, w,
                            nscan=nscan)
    np.testing.assert_allclose(float(ft(*at)), loss_j, rtol=1e-5)


def test_prob2pred_matches_jax():
    rng = np.random.default_rng(0)
    p = np.concatenate([rng.random(200), [0.5, 0.3, 0.7]]).astype(np.float32)
    for thres in (0.5, 0.3, 0.7):
        got = tmetrics.prob2pred(p, thres)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jmetrics.prob2pred(p, thres))
    np.testing.assert_array_equal(tmetrics.prob2pred(p.tolist()),
                                  jmetrics.prob2pred(p))
