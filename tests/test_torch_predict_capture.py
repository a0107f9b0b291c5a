"""The stacked evaluate (``Trainer.evaluate`` over
``train.capture.PredictRunner``) on the CPU.

On the CPU the runner takes the eager forward per batch, with the hub lane
planned once per node set; the captured forward is held to this eager one
bit for bit on the card (``tests/test_torch_cuda.py``).  Here: the stacked
evaluate equals the per-batch ``evaluate`` over ``Trainer.predict`` bit for
bit in every single-device lane (the hub lane's float64 sums do not depend
on a chunk's width, and GraphSAGE's draws from the runner's generator,
seeded 0, equal a fresh generator's); the JAX package's evaluate of the
same checkpoint agrees within rtol 1e-6; the stack's plan bounds every
batch's own; a node count off a multiple of B is trimmed; ``evaluate`` is
``evaluate_probs`` of its probabilities; a capture off CUDA is refused.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgnn_tpu.train import checkpoint as jckpt
from pcgnn_tpu.train import metrics as jmetrics
from pcgnn_tpu.train.results import ResultManager as JResults
from pcgnn_tpu.train.trainer import Trainer as JTrainer
from pcgnn_tpu_torch.graph import csr
from pcgnn_tpu_torch.interop import params_from_jax
from pcgnn_tpu_torch.models import pcgnn as pcgnn_mod
from pcgnn_tpu_torch.ops import hub
from pcgnn_tpu_torch.train.capture import PredictRunner
from pcgnn_tpu_torch.train.metrics import evaluate, evaluate_probs
from pcgnn_tpu_torch.train.results import ResultManager
from pcgnn_tpu_torch.train.trainer import Trainer

METRICS = ("accuracy", "f1", "f1_macro", "precision", "precision_macro",
           "recall", "recall_macro", "auc", "gmean", "thresh")
METRIC_RTOL = 1e-6

# lane: (config changes, patches of (module, attribute, value))
LANES = {
    "fused_bf16": ({}, ()),
    "hub": ({"data_name": "synthetic:skew-tiny"}, ()),
    "learned": ({"learn_features": True}, ()),
    "no_stores": ({"edge_windows": False}, ()),
    "csr": ({"edge_windows": False},
            ((csr, "NBR2D_BUDGET_BYTES", 8), (csr, "FPAD_BUDGET_BYTES", 0),
             (pcgnn_mod, "SCORE_FROM_WINDOW_MIN_NODES", 0))),
    "gcn": ({"model": "GCN"}, ()),
    "sage_draws": ({"data_name": "synthetic:small", "model": "SAGE",
                    "num_sample": 5}, ()),
}


def _cfg(**kw):
    cfg = dict(seed=2, data_name="synthetic:tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=6,
               valid_epochs=3, batch_size=64, patience=100, exp_num=0)
    cfg.update(kw)
    return cfg


def _trainer(tmp_path, monkeypatch, lane):
    changes, patches = LANES[lane]
    for mod, name, value in patches:
        monkeypatch.setattr(mod, name, value)
    cfg = _cfg(**changes)
    return Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)),
                   device="cpu")


def _same(a, b) -> bool:
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


def _assert_same_result(got, want):
    assert np.array_equal(got.anomaly_confidence, want.anomaly_confidence)
    assert np.array_equal(got.predictions, want.predictions)
    for k in METRICS:
        assert _same(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("lane", sorted(LANES))
def test_stacked_evaluate_equals_per_batch_bit_for_bit(tmp_path, monkeypatch,
                                                       lane):
    """After an epoch of training, the stacked evaluate of the validation
    split (the F1 sweep) and of the test split (at the swept threshold)
    equals ``evaluate`` over ``Trainer.predict``, one forward a batch
    planning its own hub chunks: probabilities, predictions and every
    metric, bit for bit.  The runner ran every batch eagerly, with one
    plan a node set."""
    t = _trainer(tmp_path, monkeypatch, lane)
    assert not t.capture
    model = t.new_model()
    t.run_epoch(model, t.new_optimizer(model), 0)
    b = t.batch_size
    thresh = None
    for nodes, labels in ((t.idx_valid, t.y_valid), (t.idx_test, t.y_test)):
        kw = (dict(sweep_thresh=True) if thresh is None
              else dict(valid_thresh=thresh))
        want = evaluate(lambda batch: t.predict(model, batch), nodes, labels,
                        b, print_line=False, **kw)
        got = t.evaluate(model, nodes, labels, print_line=False, **kw)
        _assert_same_result(got, want)
        thresh = got.thresh
    r = t.predict_runner(model)
    batches = sum(-(-len(n) // b) for n in (t.idx_valid, t.idx_test))
    assert (r.captures, r.replays, r.eager_steps) == (0, 0, batches)
    if lane == "hub":
        assert r.plans[0] and all(p is None for p in r.plans[1:])
    else:
        assert all(p is None for p in r.plans)


@pytest.mark.parametrize("model", ["PCGNN", "GCN"])
def test_stacked_evaluate_matches_jax(tmp_path, model):
    """The JAX trainer's best checkpoint, evaluated by JAX ``evaluate``
    over its ``predict_fn`` and by the port's stacked evaluate: the same
    swept threshold, and every metric within rtol 1e-6."""
    cfg = _cfg(model=model, ewin_dtype="float32")
    jt = JTrainer(cfg, result=JResults(cfg, root=str(tmp_path / "j")))
    jt.train()
    params = jckpt.load_checkpoint(jt.result.model_path)
    jparams = jax.tree.map(jnp.asarray, params)
    tt = Trainer(cfg, device="cpu",
                 result=ResultManager(cfg, root=str(tmp_path / "t")))
    tm = tt.new_model()
    tm.load_state_dict(params_from_jax(params))
    thresh = None
    for split in ("valid", "test"):
        nodes, labels = (getattr(tt, f"idx_{split}"),
                         getattr(tt, f"y_{split}"))
        kw = (dict(sweep_thresh=True) if thresh is None
              else dict(valid_thresh=thresh))
        want = jmetrics.evaluate(
            lambda batch: jt.predict_fn(jparams, batch),
            getattr(jt, f"idx_{split}"), getattr(jt, f"y_{split}"),
            jt.batch_size, print_line=False, **kw)
        got = tt.evaluate(tm, nodes, labels, print_line=False, **kw)
        assert got.thresh == want.thresh
        for k in ("auc", "f1", "f1_macro", "recall", "precision", "gmean",
                  "accuracy"):
            np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                       rtol=METRIC_RTOL, err_msg=k)
        np.testing.assert_allclose(got.anomaly_confidence,
                                   want.anomaly_confidence, rtol=1e-5,
                                   atol=1e-6)
        thresh = got.thresh


def test_the_stack_plan_covers_every_batch(tmp_path, monkeypatch):
    """The validation stack's one plan bounds each batch's own
    ``plan_hub_chunks`` on every hub relation."""
    t = _trainer(tmp_path, monkeypatch, "hub")
    stack = t._stack(t.idx_valid)
    assert stack.shape == (-(-len(t.idx_valid) // t.batch_size),
                           t.batch_size)
    rels = t.model.hub_relations(t.graph)
    plans = hub.epoch_hub_plans(rels, stack)
    assert hub.plan_covers(t.predict_runner(t.model).plans, plans)
    seen = 0
    for batch in stack:
        own = tuple(
            hub.plan_hub_chunks(rel.deg[batch], rel.deg[batch]
                                > rel.window_width, hub.HUB_CHUNK,
                                hub.HUB_BLOCK) if rel.has_hubs else None
            for rel in rels)
        assert hub.plan_covers(plans, own), (plans, own)
        seen += sum(bool(p) for p in own)
    assert seen


def test_a_node_count_off_a_multiple_of_b_is_trimmed(tmp_path, monkeypatch):
    """B + 3 nodes run as two batches, the second padded with id 0: the
    result holds the B + 3 nodes' probabilities, those of ``predict``."""
    t = _trainer(tmp_path, monkeypatch, "fused_bf16")
    b = t.batch_size
    nodes, labels = t.idx_test[: b + 3], t.y_test[: b + 3]
    got = t.evaluate(t.model, nodes, labels, print_line=False)
    assert got.anomaly_confidence.shape == (b + 3,)
    want = evaluate(lambda batch: t.predict(t.model, batch), nodes, labels,
                    b, print_line=False)
    _assert_same_result(got, want)
    assert t.predict_runner(t.model).eager_steps == 2


@pytest.mark.parametrize("kw", [{}, {"sweep_thresh": True},
                                {"valid_thresh": 0.3}],
                         ids=["plain", "sweep", "valid_thresh"])
def test_evaluate_is_evaluate_probs_of_its_probabilities(kw):
    rng = np.random.default_rng(0)
    m = 150
    p1 = rng.random(m).astype(np.float32)
    probs = np.stack([1 - p1, p1], axis=1)
    labels = (rng.random(m) < 0.3).astype(np.int64)
    table = torch.from_numpy(probs)
    got = evaluate(lambda batch: table[batch], np.arange(m), labels, 64,
                   print_line=False, **kw)
    want = evaluate_probs(probs, labels, print_line=False, **kw)
    _assert_same_result(got, want)


def test_a_captured_forward_needs_a_cuda_device(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="CUDA device"):
        PredictRunner(lambda *a: None, (), torch.device("cpu"), capture=True,
                      draws=False)


def test_the_runner_is_kept_for_its_model(tmp_path, monkeypatch):
    """One runner a model while it holds the same tensors: a copy into
    its parameters keeps it, a parameter swapped for another tensor or
    another model gets a new one."""
    t = _trainer(tmp_path, monkeypatch, "fused_bf16")
    m = t.new_model()
    r = t.predict_runner(m)
    m.load_state_dict(t.new_model().state_dict())
    assert t.predict_runner(m) is r
    m.load_state_dict(t.new_model().state_dict(), assign=True)
    r2 = t.predict_runner(m)
    assert r2 is not r
    assert t.predict_runner(t.new_model()) is not r2
