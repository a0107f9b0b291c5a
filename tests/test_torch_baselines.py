"""The GraphSAGE and GCN baselines over the homo graph: the port against the
JAX package on the same numpy-made inputs, in the store lane (float32 and
bfloat16 homo stores) and the plain lane, with hub rows through
``hub_mean_sum``; and their trainer, interop and checkpoints.  On the CPU the
port takes the plain version of every kernel and the JAX hub lane its
clipping fetch.

Tolerances: ids, keep masks and counts are integers and must be equal.  No
selection is involved, so every row is compared: sums, logits and the loss
to rtol 1e-5 with atol 1e-6 (FWD), gradients to rtol 1e-4 with atol 1e-6
(GRAD).  ``num_sample`` draws from a ``torch.Generator``, which cannot replay
``jax.random``, so its test is statistical.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu.models.gcn import GCN as JGCN
from pcgnn_tpu.models.graphsage import GraphSage as JSage
from pcgnn_tpu.ops import aggregate as jagg
from pcgnn_tpu.ops import hub as jhub
from pcgnn_tpu.train import checkpoint as jckpt
from pcgnn_tpu.train.results import ResultManager as JResults
from pcgnn_tpu.train.trainer import Trainer as JTrainer
from pcgnn_tpu_torch import cli
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.interop import params_from_jax, params_to_jax
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.models.gcn import GCN as TGCN
from pcgnn_tpu_torch.models.graphsage import GraphSage as TSage
from pcgnn_tpu_torch.models.graphsage import subsample_valid
from pcgnn_tpu_torch.ops import aggregate as tagg
from pcgnn_tpu_torch.ops import hub as thub
from pcgnn_tpu_torch.train import checkpoint as tckpt
from pcgnn_tpu_torch.train.results import ResultManager as TResults
from pcgnn_tpu_torch.train.trainer import Trainer as TTrainer

EMB = 12
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# amazon_new-like's shape cut to test size: F = 25, 40% fraud, a dense homo
# graph (mean degree ~200, as amazon_new-like's ~265)
AMAZON_SMALL = dict(num_nodes=512, feat_dim=25, fraud_rate=0.4,
                    edges_per_relation=(15000, 30000, 20000))


def _pair(name):
    """(JAX graph, port graph) of one test graph, no stores."""
    if name == "amazon-small":
        return (jax_graph(None, seed=5, **AMAZON_SMALL),
                torch_graph(None, seed=5, **AMAZON_SMALL))
    seed = {"tiny": 0, "skew-tiny": 3}[name]
    return jax_graph(name, seed=seed), torch_graph(name, seed=seed)


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in ("tiny", "amazon-small",
                                           "skew-tiny")}


def _batch(gt, seed=0):
    """Random rows with duplicates, every homo hub row, and padded slots."""
    rng = np.random.default_rng(seed)
    rel = gt.homo
    hubs = np.flatnonzero(rel.deg.numpy() > rel.window_width)
    return np.concatenate([hubs, hubs[:1], rng.integers(0, gt.num_nodes, 40),
                           [0, 0, 0]])


# ------------------------------------------------------------ the ops

def test_union_self_window_matches_jax(pairs):
    """The self column is active exactly where the row's window lacks the
    self-loop: rows with and without one, and padding slots that hold N."""
    gj, gt = pairs["tiny"]
    rel_t, rel_j = gt.relations[0], gj.relations[0]
    batch = np.arange(40)
    nbr, valid = tagg.batch_neighbor_window(rel_t, torch.from_numpy(batch))
    nbr = nbr.clone()
    # drop row 3's self-loop from its window: the self column turns on
    nbr[3] = torch.where(nbr[3] == 3, 1, nbr[3])
    got = tagg.union_self_window(nbr, valid, torch.from_numpy(batch))
    want = jagg.union_self_window(jnp.asarray(nbr.numpy()),
                                  jnp.asarray(valid.numpy()),
                                  jnp.asarray(batch, jnp.int32))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    keep = got[1].numpy()
    assert keep[3, -1] and not keep[[0, 1, 2, 4], -1].any()
    assert got[0].dtype == torch.int32


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_self_union_feature_window_matches_jax(pairs, dtype):
    """The store's window with the conditional self column: keep exactly,
    rows to the stored values (a copy: equal, bf16 rounding included)."""
    gj, gt = pairs["tiny"]
    jdt, tdt = _DTYPES[dtype]
    rj = jcsr.attach_edge_windows(gj.homo, np.asarray(gj.features), dtype=jdt)
    rt = tcsr.attach_edge_windows(gt.homo, gt.features, dtype=tdt)
    batch = np.concatenate([np.arange(30), [511, 5, 5]])
    xw_j, keep_j = jagg.self_union_feature_window(
        rj, jnp.asarray(batch, jnp.int32), gj.features)
    xw_t, keep_t = tagg.self_union_feature_window(rt, torch.from_numpy(batch),
                                                  gt.features)
    keep = keep_t.numpy()
    np.testing.assert_array_equal(keep, np.asarray(keep_j))
    # slots past a row's degree hold the next run: compare the kept ones
    np.testing.assert_array_equal(xw_t.numpy()[keep], np.asarray(xw_j)[keep])
    assert xw_t.dtype == torch.float32
    assert not keep[:, -1].any()          # every tiny row has its self-loop


@pytest.mark.parametrize("chunk,block", [(32, 512), (2, 128)])
@pytest.mark.parametrize("include_self", [True, False])
def test_hub_mean_sum_matches_jax(pairs, chunk, block, include_self):
    """All-neighbor sums over skew-tiny's homo hub rows: counts exactly,
    sums to FWD, zeros at other rows; the self column joins once, only
    where no block of the row holds the self-loop (two hub rows lose
    theirs here)."""
    gj, gt = pairs["skew-tiny"]
    rj, rt = gj.homo, gt.homo
    assert rt.has_hubs
    batch = _batch(gt)
    is_hub = rt.deg.numpy()[batch] > rt.window_width
    x = gt.features.numpy()
    xp = np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)])
    # two hub rows lose their self-loop
    col = rt.col.numpy().copy()
    hubs = batch[is_hub][:2]
    for v in hubs:
        s, e = rt.indptr[v], rt.indptr[v + 1]
        run = col[s:e]
        run[run == v] = (v + 1) % gt.num_nodes
    rt2 = dataclasses.replace(rt, col=torch.from_numpy(col))
    rj2 = dataclasses.replace(rj, col=jnp.asarray(col))
    kw = dict(include_self=include_self, chunk=chunk, block=block)
    want = jhub.hub_mean_sum(rj2, jnp.asarray(batch, jnp.int32),
                             jnp.asarray(is_hub), jnp.asarray(xp), **kw)
    got = thub.hub_mean_sum(rt2, torch.from_numpy(batch),
                            torch.from_numpy(is_hub), torch.from_numpy(xp),
                            **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FWD)
    cnt, deg = got[1].numpy(), rt.deg.numpy()[batch]
    assert (cnt[~is_hub] == 0).all() and not got[0].numpy()[~is_hub].any()
    lost = np.isin(batch, hubs) & is_hub
    np.testing.assert_array_equal(cnt[is_hub & ~lost], deg[is_hub & ~lost])
    np.testing.assert_array_equal(cnt[lost], deg[lost] + include_self)


# ------------------------------------------------------------ the models

def _graphs(pair, lane, dtype):
    gj, gt = pair
    if lane == "plain":
        return gj, gt
    jdt, tdt = _DTYPES[dtype]
    gj = jcsr.materialize_edge_windows(gj, dtype=jdt)
    gt = tcsr.materialize_edge_windows(gt, dtype=tdt, relations=False,
                                       homo=True, fused=False)
    assert gt.homo.ewin is not None and gj.homo.ewin is not None
    return gj, gt


_MODELS = {"GCN": (JGCN, TGCN), "SAGE": (JSage, TSage)}
_LANES = [("plain", "float32"), ("store", "float32"), ("store", "bfloat16")]


@pytest.mark.parametrize("graph", ["tiny", "amazon-small", "skew-tiny"])
@pytest.mark.parametrize("lane,dtype", _LANES)
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_baseline_matches_jax(pairs, name, lane, dtype, graph):
    """Logits, probabilities, the loss and every gradient against the JAX
    model from the same params, in every lane; skew-tiny's homo hub rows
    go through hub_mean_sum."""
    gj, gt = _graphs(pairs[graph], lane, dtype)
    jcls, tcls = _MODELS[name]
    model_j = jcls(gt.feat_dim, EMB)
    params = jax.tree.map(np.asarray, model_j.init(jax.random.key(1)))
    model_t = tcls(gt.feat_dim, EMB)
    model_t.load_state_dict(params_from_jax(params))
    batch = _batch(gt, seed=len(graph))
    assert (graph == "skew-tiny") == gt.homo.has_hubs
    labels = gt.labels.numpy()[batch]
    w = np.ones(len(batch), np.float32)
    w[-3:] = 0.0
    jb, jy = jnp.asarray(batch, jnp.int32), jnp.asarray(labels, jnp.int32)
    tb, ty = torch.from_numpy(batch), torch.from_numpy(labels)

    logits_j, none = jax.jit(lambda p, g: model_j.forward(p, g, jb))(params,
                                                                      gj)
    assert none is None
    probs_j, _ = jax.jit(lambda p, g: model_j.to_prob(p, g, jb))(params, gj)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, g: model_j.loss(p, g, jb, jy, jnp.asarray(w))))(params, gj)
    logits_t, none = model_t(gt, tb)
    assert none is None
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), **FWD)
    with torch.no_grad():
        probs_t, _ = model_t.to_prob(gt, tb)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), **FWD)
    loss_t = model_t.loss(gt, tb, ty, torch.from_numpy(w))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **FWD)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    got = {k: p.grad for k, p in model_t.named_parameters()}
    assert set(got) == set(want) == {"enc.w", "head.w"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **GRAD,
                                   err_msg=k)


def test_heads_sigmoid_and_softmax(pairs):
    """GCN's probabilities are sigmoids of its logits, GraphSAGE's a softmax
    over the classes (rows sum to 1)."""
    _, gt = pairs["tiny"]
    batch = torch.arange(20)
    gen = torch.Generator().manual_seed(0)
    gcn, sage = TGCN(gt.feat_dim, 8, generator=gen), TSage(gt.feat_dim, 8,
                                                           generator=gen)
    with torch.no_grad():
        torch.testing.assert_close(gcn.to_prob(gt, batch)[0],
                                   torch.sigmoid(gcn(gt, batch)[0]))
        p = sage.to_prob(gt, batch)[0]
    torch.testing.assert_close(p.sum(1), torch.ones(20))


def test_sage_without_gcn_style_matches_jax(pairs):
    """``gcn_style=False``: no self union, the self features concatenated
    before the encoder ([2F, E])."""
    gj, gt = pairs["tiny"]
    model_j = JSage(gt.feat_dim, EMB, gcn_style=False)
    params = jax.tree.map(np.asarray, model_j.init(jax.random.key(2)))
    model_t = TSage(gt.feat_dim, EMB, gcn_style=False)
    assert model_t.enc.w.shape == (2 * gt.feat_dim, EMB)
    model_t.load_state_dict(params_from_jax(params))
    batch = _batch(gt)
    want, _ = model_j.forward(params, gj, jnp.asarray(batch, jnp.int32))
    with torch.no_grad():
        got, _ = model_t(gt, torch.from_numpy(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


# ------------------------------------------------------------ num_sample

def test_subsample_keeps_min_and_draws_uniformly():
    """Every row keeps exactly min(valid, num_sample) of its valid slots,
    never an invalid one, and each valid slot is kept with probability
    num_sample / valid (within 5 standard errors over the draws)."""
    d, k, draws = 12, 4, 4000
    nvalid = torch.tensor([0, 1, 4, 5, 9, 12])
    valid = torch.arange(d)[None, :] < nvalid[:, None]
    # slots 2 and 7 of the last row are not valid: a hole in the window
    valid[-1, [2, 7]] = False
    nvalid[-1] = 10
    gen = torch.Generator().manual_seed(0)
    hits = torch.zeros(valid.shape)
    for _ in range(draws):
        kept = subsample_valid(valid, k, gen)
        assert not (kept & ~valid).any()
        assert torch.equal(kept.sum(1), nvalid.clamp(max=k))
        hits += kept
    freq = hits / draws
    for i, nv in enumerate(nvalid.tolist()):
        if nv == 0:
            continue
        p = min(k, nv) / nv
        se = (p * (1 - p) / draws) ** 0.5
        f = freq[i][valid[i]]
        assert ((f - p).abs() <= 5 * se + 1e-12).all(), (i, f, p)


def test_sage_num_sample_in_the_model(pairs):
    """In the model: a generator's draw decides the subset (two seeds give
    two results, one seed one); no generator means seed 0; a num_sample at
    or above every row's degree keeps everything and gives the JAX
    package's logits; a capped relation is refused."""
    gj, gt = pairs["tiny"]
    batch = torch.arange(64)
    model = TSage(gt.feat_dim, 8, num_sample=3,
                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(gt, batch, generator=torch.Generator().manual_seed(1))[0]
        b = model(gt, batch, generator=torch.Generator().manual_seed(1))[0]
        c = model(gt, batch, generator=torch.Generator().manual_seed(2))[0]
        d0 = model(gt, batch)[0]
        e0 = model(gt, batch, generator=torch.Generator().manual_seed(0))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d0, e0)
    big = gt.homo.dmax
    model_j = JSage(gt.feat_dim, EMB, num_sample=big)
    params = jax.tree.map(np.asarray, model_j.init(jax.random.key(3)))
    model_t = TSage(gt.feat_dim, EMB, num_sample=big)
    model_t.load_state_dict(params_from_jax(params))
    want, _ = model_j.forward(params, gj, jnp.asarray(np.arange(64),
                                                      jnp.int32),
                              key=jax.random.key(9))
    with torch.no_grad():
        got, _ = model_t(gt, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    _, gs = pairs["skew-tiny"]
    with pytest.raises(ValueError, match="num_sample"):
        model_t(gs, batch)


# ------------------------------------------------------------ the trainer

def _cfg(**kw):
    cfg = dict(seed=2, data_name="synthetic:tiny", model="GCN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.005,
               weight_decay=0.0005, alpha=2.0, rho=0.5, epochs=2,
               valid_epochs=1, batch_size=64, patience=100, exp_num=0)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("name", ["GCN", "SAGE"])
def test_baseline_epoch_plan_is_a_padded_permutation(tmp_path, name):
    """No pick: the epoch is every training node once, shuffled, padded
    with id 0 at weight 0; the homo store is built and the relations'
    are not."""
    cfg = _cfg(model=name)
    t = TTrainer(cfg, device="cpu", result=TResults(cfg, root=str(tmp_path)))
    assert t.sample_size == len(t.idx_train)
    assert t.num_batches == -(-len(t.idx_train) // 64)
    assert t.graph.homo.ewin is not None
    assert all(r.ewin is None for r in t.graph.relations)
    ids, w = t.epoch_plan(0)
    s = t.sample_size
    flat_ids, flat_w = ids.reshape(-1), w.reshape(-1)
    assert sorted(flat_ids[:s].tolist()) == sorted(t.idx_train.tolist())
    assert flat_ids[s:].eq(0).all()
    assert flat_w[:s].eq(1).all() and flat_w[s:].eq(0).all()
    assert not torch.equal(ids, t.epoch_plan(1)[0])
    assert t.step_generator(0, 0) is None


@pytest.mark.parametrize("name", ["GCN", "SAGE"])
def test_baseline_step_matches_jax_step1(tmp_path, name):
    """One Adam step of each trainer from the same params, batch and
    weights (bf16 homo store): loss rtol 1e-5, gradients GRAD, parameters
    atol 1e-5."""
    cfg = _cfg(model=name)
    jt = JTrainer(cfg, result=JResults(cfg, root=str(tmp_path / "jax")))
    tt = TTrainer(cfg, device="cpu",
                  result=TResults(cfg, root=str(tmp_path / "torch")))
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
    grads_j = jax.jit(jax.grad(lambda p: jt.model.loss(
        p, jt._step_graph, jb, jy, jw)))(params)
    model = tt.new_model()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    opt = tt.new_optimizer(model)
    loss_t = tt.step(model, opt, torch.from_numpy(batch), torch.from_numpy(y),
                     torch.from_numpy(w))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    gj = params_from_jax(jax.tree.map(np.asarray, grads_j))
    pj = params_from_jax(jax.tree.map(np.asarray, new_j))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[k].numpy(), **GRAD,
                                   err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), pj[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_sage_num_sample_trains_with_a_generator_per_step(tmp_path):
    cfg = _cfg(model="SAGE", num_sample=3, edge_windows=False)
    t = TTrainer(cfg, device="cpu", result=TResults(cfg, root=str(tmp_path)))
    assert t.model.num_sample == 3 and t.graph.homo.ewin is None
    g0, g1 = t.step_generator(0, 0), t.step_generator(0, 1)
    assert not torch.equal(torch.rand(4, generator=g0),
                           torch.rand(4, generator=g1))
    assert torch.equal(torch.rand(4, generator=t.step_generator(1, 2)),
                       torch.rand(4, generator=t.step_generator(1, 2)))
    auc, recall, f1 = t.train()
    assert np.isfinite([auc, recall, f1]).all()


@pytest.mark.parametrize("name", ["GCN", "SAGE"])
def test_baseline_cli_runs_on_cpu(tmp_path, monkeypatch, capsys, name):
    """End to end through the command line on tiny: the result tree is
    written and the best checkpoint holds the {enc, head} tree."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(_cfg(model=name)))
    auc, recall, f1 = cli.main(["--exp_config_path", str(path),
                                "--device", "cpu"])
    assert 0.0 <= auc <= 1.0
    assert "Test performance" in capsys.readouterr().out
    root = tmp_path / "experimental_results"
    assert os.path.isdir(root / "test_log")
    ckpts = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".ckpt")]
    assert ckpts
    tree = tckpt.load_checkpoint(ckpts[0])
    assert set(tree) == {"enc", "head"}


@pytest.mark.parametrize("name", ["GCN", "SAGE"])
def test_baseline_checkpoints_load_across_packages(tmp_path, name):
    """The {enc: {w}, head: {w}} tree round-trips: JAX params -> pickle ->
    the port's model -> pickle -> the JAX package's loader, leaf for
    leaf."""
    jcls, _ = _MODELS[name]
    params = jax.tree.map(np.asarray, jcls(16, 8).init(jax.random.key(4)))
    jckpt.save_checkpoint(str(tmp_path / "j.ckpt"), params)
    model = build_model(name, feat_dim=16, emb_dim=8)
    model.load_state_dict(params_from_jax(
        tckpt.load_checkpoint(str(tmp_path / "j.ckpt"))))
    np.testing.assert_array_equal(model.enc.w.detach().numpy(),
                                  params["enc"]["w"])
    tckpt.save_checkpoint(str(tmp_path / "t.ckpt"), params_to_jax(model))
    back = jckpt.load_checkpoint(str(tmp_path / "t.ckpt"))
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
