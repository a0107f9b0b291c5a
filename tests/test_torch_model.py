"""PC-GNN forward, loss and gradients: the port against the JAX package.

Both packages get the same graph (same seed), the same parameters (the JAX
init carried over with ``interop.params_from_jax``), the same batch and the
same train positives, for float32 and bfloat16 stores and for both window
lanes (fused records and per-relation stores), in train and eval mode.

Tolerances: the float32 contractions and sums run in another order in each
framework, so logits, center scores and the loss agree to rtol 1e-5 with
atol 1e-6, and gradients, which sum over the batch, to rtol 1e-4 with
atol 1e-6.  Selection (which neighbors and train positives a row keeps) is
exact given the same scores, but the port rounds its selection scores from
float64 while the JAX package accumulates them in float32, so the two can
differ by an ulp.  A row whose keep decision sits on a distance gap under
1e-6 could flip on that ulp; the test finds such rows from the data, weighs
them 0 in the loss and leaves them out of the row-wise comparisons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgnn_tpu.data.prep import stratified_splits
from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu.models.pcgnn import PCGNN as JPCGNN
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.interop import params_from_jax, params_to_jax
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.models.pcgnn import PCGNN as TPCGNN

EMB, ALPHA, RHO = 12, 2.0, 0.5
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
NEAR_TIE = 1e-6
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def base():
    gj = jax_graph("tiny", seed=0)
    gt = torch_graph("tiny", seed=0)
    labels = np.asarray(gj.labels)
    idx_train, _, _ = stratified_splits(labels, 0.4, 0.67, 2)
    tp = idx_train[labels[idx_train] == 1]
    model_j = JPCGNN(gj.feat_dim, EMB, gj.num_relations, ALPHA, RHO)
    params = jax.tree.map(np.asarray, model_j.init(jax.random.key(0)))
    rng = np.random.default_rng(5)
    # 61 rows: duplicates from the sampler's replacement, and 3 padded
    # slots (node 0 at weight 0) as the epoch plan makes them
    batch = np.concatenate([rng.choice(idx_train, 58), [0, 0, 0]])
    weight = np.concatenate([np.ones(58, np.float32), np.zeros(3, np.float32)])
    return dict(gj=gj, gt=gt, labels=labels, tp=tp, model_j=model_j,
                params=params, batch=batch, weight=weight)


def _near_tie_rows(base, gt, train: bool) -> np.ndarray:
    """Rows whose choose or oversample decision sits on a distance gap
    under NEAR_TIE (scores computed in float64 from the stored values)."""
    x = gt.features.numpy().astype(np.float64)
    bf16 = gt.relations[0].ewin.dtype == torch.bfloat16
    sel = (gt.features.to(torch.bfloat16).double().numpy() if bf16 else x)
    w = base["params"]["label_clf"]
    s = sel @ w["w"][:, 0].astype(np.float64) + float(w["b"][0])
    batch, labels = base["batch"], base["labels"]
    flag = np.zeros(len(batch), bool)

    def gap_at(dists, k):
        ds = np.sort(dists)
        return 0 < k < len(ds) and ds[k] - ds[k - 1] < NEAR_TIE

    for rel in gt.relations:
        deg, keff = rel.deg.numpy(), rel.keff.numpy()
        nbr2d, ks = rel.nbr2d.numpy(), rel.ksample.numpy()
        for i, v in enumerate(batch):
            nb = nbr2d[v, :min(deg[v], rel.window_width)]
            flag[i] |= gap_at(np.abs(s[v] - s[nb]), keff[v])
            if train and labels[v] == 1:
                m = int(np.floor(np.float32(ks[v]) * np.float32(RHO)))
                flag[i] |= gap_at(np.abs(s[v] - s[base["tp"]]), m)
    return flag


def _graphs(base, dtype, lane):
    jdt, tdt = _DTYPES[dtype]
    fused = lane == "fused"
    gj = jcsr.materialize_edge_windows(base["gj"], dtype=jdt, fused=fused)
    gt = tcsr.materialize_edge_windows(base["gt"], dtype=tdt, fused=fused)
    assert (gj.fused is not None) == fused == (gt.fused is not None)
    return gj, gt


def _torch_model(base):
    m = TPCGNN(base["gt"].feat_dim, EMB, base["gt"].num_relations, ALPHA, RHO)
    m.load_state_dict(params_from_jax(base["params"]))
    return m


def _compare_rows(got, want, rows):
    np.testing.assert_allclose(got.detach().numpy()[rows],
                               np.asarray(want)[rows], **FWD)


@pytest.mark.parametrize("lane", ["fused", "relation"])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_train_forward_loss_and_grads_match_jax(base, dtype, lane):
    gj, gt = _graphs(base, dtype, lane)
    model_j, params = base["model_j"], base["params"]
    model_t = _torch_model(base)
    tp = base["tp"]
    assert 2 * model_t.minor_window(len(tp), gt.relations) < len(tp), \
        "the windowed candidate branch should run"
    ties = _near_tie_rows(base, gt, train=True)
    assert ties.sum() <= 3, ties.sum()
    keep = ~ties
    batch, y = base["batch"], base["labels"][base["batch"]]
    w = np.where(ties, 0.0, base["weight"]).astype(np.float32)
    jkw = dict(train_pos=jnp.asarray(tp, jnp.int32),
               train_pos_valid=jnp.ones(len(tp), bool),
               train_pos_feats=gj.features[jnp.asarray(tp, jnp.int32)])
    ttp = torch.from_numpy(tp)
    tkw = dict(train_pos=ttp, train_pos_valid=torch.ones(len(tp), dtype=bool),
               train_pos_feats=gt.features[ttp])
    jb, jy = jnp.asarray(batch, jnp.int32), jnp.asarray(y, jnp.int32)
    tb, ty = torch.from_numpy(batch), torch.from_numpy(y)

    logits_j, scores_j = model_j.forward(params, gj, jb, jy, train=True, **jkw)
    logits_t, scores_t = model_t(gt, tb, ty, train=True, **tkw)
    _compare_rows(logits_t, logits_j, keep)
    _compare_rows(scores_t, scores_j, keep)

    loss_j, grads_j = jax.value_and_grad(model_j.loss)(
        params, gj, jb, jy, jnp.asarray(w), **jkw)
    loss_t = model_t.loss(gt, tb, ty, torch.from_numpy(w), **tkw)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **FWD)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    got = {k: p.grad for k, p in model_t.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **GRAD,
                                   err_msg=k)


@pytest.mark.parametrize("lane", ["fused", "relation"])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_eval_probs_match_jax(base, dtype, lane):
    gj, gt = _graphs(base, dtype, lane)
    model_t = _torch_model(base)
    keep = ~_near_tie_rows(base, gt, train=False)
    batch = base["batch"]
    pj = base["model_j"].to_prob(base["params"], gj,
                                 jnp.asarray(batch, jnp.int32))
    with torch.no_grad():
        pt = model_t.to_prob(gt, torch.from_numpy(batch))
    for got, want in zip(pt, pj):
        _compare_rows(got, want, keep)


def test_params_round_trip_and_layout(base):
    model_t = _torch_model(base)
    back = params_to_jax(model_t)
    flat_j = jax.tree_util.tree_leaves_with_path(base["params"])
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # weights are [in, out], as in the JAX package
    f, r = base["gt"].feat_dim, base["gt"].num_relations
    assert model_t.intra[0].w.shape == (2 * f, EMB)
    assert model_t.inter.w.shape == (f + r * EMB, EMB)
    assert model_t.head.w.shape == (EMB, 2)
    # the port's own init has the JAX init's shapes and ranges: nn.Linear's
    # U(+-1/sqrt(fan_in)) for label_clf, Xavier-uniform for the rest
    fresh = TPCGNN(f, EMB, r, ALPHA, RHO,
                   generator=torch.Generator().manual_seed(0))
    xavier = lambda i, o: np.sqrt(6.0 / (i + o))
    bounds = {"label_clf.w": 1 / np.sqrt(f), "label_clf.b": 1 / np.sqrt(f),
              "inter.w": xavier(f + r * EMB, EMB), "head.w": xavier(EMB, 2)}
    bounds.update({f"intra.{i}.w": xavier(2 * f, EMB) for i in range(r)})
    want = params_from_jax(base["params"])
    for k, p in fresh.named_parameters():
        assert p.shape == want[k].shape, k
        assert float(p.detach().abs().max()) <= bounds[k], k
        assert float(np.abs(want[k].numpy()).max()) <= bounds[k], k


def test_bf16_selection_rounds_the_center_like_jax():
    """With a bf16 store the center's selection score is taken on its
    bf16-rounded features, as its stored neighbors' are.  Node 0
    (x = 1.003, bf16 1.0) keeps 2 of its 4 neighbors (itself and nodes 1-3
    at 0.9921875, 1.0078125, 1.5): rounded, nodes 1 and 2 tie at 2^-7 and
    the lower column (node 1) is kept; unrounded, node 2 would be nearer.
    The two choices give different aggregates, so the logits tell."""
    src, dst = np.array([0, 0, 0, 4]), np.array([1, 2, 3, 5])
    feats = np.array([[1.003, 0.25], [0.9921875, 0.25], [1.0078125, 0.25],
                      [1.5, 0.25], [0.0, 1.0], [0.0, 1.0]], np.float32)
    labels = np.zeros(6, np.int64)
    gj = jcsr.build_multirel([jcsr.csr_from_edges(src, dst, 6)] * 3,
                             jcsr.csr_from_edges(src, dst, 6), feats, labels)
    gt = tcsr.build_multirel([tcsr.csr_from_edges(src, dst, 6)] * 3,
                             tcsr.csr_from_edges(src, dst, 6), feats, labels)
    assert int(gt.relations[0].keff[0]) == 2
    gj = jcsr.materialize_edge_windows(gj, dtype=jnp.bfloat16)
    gt = tcsr.materialize_edge_windows(gt, dtype=torch.bfloat16)
    model_j = JPCGNN(2, 4, 3, ALPHA, RHO)
    params = jax.tree.map(np.array, model_j.init(jax.random.key(0)))
    params["label_clf"]["w"][:, 0] = [1.0, 0.0]
    params["label_clf"]["b"][0] = 0.0
    model_t = TPCGNN(2, 4, 3, ALPHA, RHO)
    model_t.load_state_dict(params_from_jax(params))
    batch = np.array([0, 4])
    pj = model_j.to_prob(params, gj, jnp.asarray(batch, jnp.int32))
    with torch.no_grad():
        pt = model_t.to_prob(gt, torch.from_numpy(batch))
    for got, want in zip(pt, pj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_minor_window_matches_jax(base):
    gj, gt = base["gj"], base["gt"]
    for p in (1, 5, len(base["tp"]), 10_000):
        assert _torch_model(base).minor_window(p, gt.relations) == \
            base["model_j"].minor_window(p, gj.relations)


def test_unported_lanes_raise():
    """Every lane that once raised here runs now: the hub lane on the skew
    preset, the score-table lane on a graph without stores, and the GCN
    and GraphSAGE baselines (their parity with the JAX package is held in
    tests/test_torch_lanes.py and tests/test_torch_baselines.py)."""
    g = tcsr.materialize_edge_windows(torch_graph("skew-tiny", seed=1))
    m = TPCGNN(g.feat_dim, 8, g.num_relations, ALPHA, RHO)
    batch = torch.arange(8)
    # hub rows go through the hub lane now: the skew preset's forward runs
    assert g.relations[0].has_hubs
    hubs = torch.nonzero(g.relations[0].deg > g.relations[0].window_width)
    with torch.no_grad():
        logits, _ = m(g, torch.cat([batch, hubs[:, 0]]), None, train=False)
    assert logits.shape == (8 + len(hubs), 2)
    assert torch.isfinite(logits).all()
    plain = torch_graph("skew-tiny", seed=1)
    assert all(r.ewin is None for r in plain.relations)
    with torch.no_grad():
        table, _ = m(plain, torch.cat([batch, hubs[:, 0]]), None,
                     train=False)
    assert table.shape == logits.shape and torch.isfinite(table).all()
    for name in ("GCN", "SAGE"):
        model = build_model(name, feat_dim=16, emb_dim=8)
        with torch.no_grad():
            out, none = model(plain, batch)
        assert out.shape == (8, 2) and none is None
