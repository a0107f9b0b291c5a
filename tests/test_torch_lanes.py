"""PC-GNN on graphs without an edge-window store on every relation: the
score-table lane, score-from-window without stores (with ``features_pad``,
with clamped ids, with partial store coverage), the CSR branch of the frozen
lanes, the one oversample call of each, and the degree-only stub of the stress presets.  The
port against the JAX package on the same numpy-made inputs; on the CPU the
port takes the plain version of every kernel, and the JAX hub lane its
clipping fetch.

Tolerances: ids, masks, counts and graph arrays are integers and must be
equal.  Logits, center scores and the loss agree to rtol 1e-5 with atol 1e-6
(FWD), gradients to rtol 1e-4 with atol 1e-6 (GRAD).  The port rounds its
selection scores once from float64, the JAX package accumulates them in
float32 (the score table from an [N, F] x [F, 2] dot), so the two can
differ by an ulp: a row whose keep decision sits on a distance gap under
1e-6 could flip on it.  Such rows are found from the data (over each row's
full neighbor list, with the values each lane scores), weigh 0 in the loss
and are left out of the row-wise comparisons.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgnn_tpu.data import synthetic as jsyn
from pcgnn_tpu.data.prep import stratified_splits
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu.models import pcgnn as jpcgnn
from pcgnn_tpu.ops import aggregate as jagg
from pcgnn_tpu.train.results import ResultManager as JResults
from pcgnn_tpu.train.trainer import Trainer as JTrainer
from pcgnn_tpu_torch.data import synthetic as tsyn
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.interop import params_from_jax
from pcgnn_tpu_torch.models import pcgnn as tpcgnn
from pcgnn_tpu_torch.ops import aggregate as tagg
from pcgnn_tpu_torch.train.results import ResultManager as TResults
from pcgnn_tpu_torch.train.trainer import Trainer as TTrainer

EMB, ALPHA, RHO = 12, 2.0, 0.5
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
NEAR_TIE = 1e-6
# a stress-1m preset cut to test size: 4,096 nodes, F = 16, directed
SMALL_STRESS = (4096, 16, 0.05, (16384, 8192, 4096), 3)


# ------------------------------------------------- stub and stress preset

def _small_stress(monkeypatch):
    monkeypatch.setitem(jsyn.PRESETS, "stress-1m", SMALL_STRESS)
    monkeypatch.setitem(tsyn.PRESETS, "stress-1m", SMALL_STRESS)


def test_degree_stub_matches_jax():
    deg = np.random.default_rng(0).integers(0, 40, 300)
    for thr in (0.5, 0.3):
        rj = jcsr.degree_stub(deg, threshold=thr)
        rt = tcsr.degree_stub(deg, threshold=thr)
        for name in ("num_nodes", "num_edges", "dmax", "ksample_max",
                     "ksample_cap", "is_stub", "window_width", "has_hubs"):
            assert getattr(rt, name) == getattr(rj, name), name
        for name in ("indptr", "deg", "keff", "ksample"):
            a = getattr(rt, name)
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(getattr(rj, name)))
        # sentinel slots only (the JAX stub's 2,048 are a TPU DMA span)
        assert (rt.col.numpy() == 300).all() and (np.asarray(rj.col) == 300).all()
        assert rt.nbr2d is None and rj.nbr2d is None


def test_stress_preset_matches_jax(monkeypatch):
    """The stress preset cut small: directed relations and the degree-only
    homo stub equal the JAX package's array for array, from one seed."""
    _small_stress(monkeypatch)
    gj = jsyn.synthetic_fraud_graph("stress-1m", seed=4)
    gt = tsyn.synthetic_fraud_graph("stress-1m", seed=4)
    np.testing.assert_array_equal(gt.features.numpy(), np.asarray(gj.features))
    np.testing.assert_array_equal(gt.labels.numpy(), np.asarray(gj.labels))
    for rj, rt in zip(gj.relations, gt.relations):
        assert rt.num_edges == rj.num_edges and rt.dmax == rj.dmax
        assert rt.dcap == rj.dcap and not rt.is_stub
        e = rj.num_edges
        for name in ("indptr", "deg", "keff", "ksample", "nbr2d"):
            np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                          np.asarray(getattr(rj, name)))
        np.testing.assert_array_equal(rt.col.numpy()[:e],
                                      np.asarray(rj.col)[:e])
    # directed: relation 0 holds its drawn edges plus self-loops, deduped,
    # so fewer than twice the drawn count
    assert gt.relations[0].num_edges < 16384 + 4096
    hj, ht = gj.homo, gt.homo
    assert ht.is_stub and hj.is_stub and ht.num_edges == 0
    for name in ("deg", "keff", "ksample"):
        np.testing.assert_array_equal(getattr(ht, name).numpy(),
                                      np.asarray(getattr(hj, name)))
    assert (ht.ksample_max, ht.ksample_cap) == (hj.ksample_max,
                                                hj.ksample_cap)


def test_window_consumers_refuse_the_stub(monkeypatch):
    _small_stress(monkeypatch)
    g = tsyn.synthetic_fraud_graph("stress-1m", seed=4)
    with pytest.raises(ValueError, match="stub"):
        tagg.batch_neighbor_window(g.homo, torch.arange(8))
    # no store is built on a stub, so GCN and GraphSAGE refuse it too
    g2 = tcsr.materialize_edge_windows(g, relations=False, homo=True)
    assert g2.homo.ewin is None and g2.homo.is_stub
    from pcgnn_tpu_torch.models import build_model
    for name in ("GCN", "SAGE"):
        model = build_model(name, feat_dim=g.feat_dim, emb_dim=8)
        with pytest.raises(ValueError, match="stub"):
            model(g2, torch.arange(8))


def test_trainer_trains_on_the_stress_preset(monkeypatch, tmp_path):
    """The (cut) stress preset trains through the port's Trainer on the
    CPU: pick weights from the stub's degrees, relation stores built."""
    _small_stress(monkeypatch)
    cfg = dict(seed=2, data_name="synthetic:stress-1m", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=2,
               valid_epochs=1, batch_size=256, patience=100, exp_num=0)
    t = TTrainer(cfg, device="cpu", result=TResults(cfg, root=str(tmp_path)))
    assert t.graph.homo.is_stub
    assert all(r.ewin is not None for r in t.graph.relations)
    torch.testing.assert_close(
        t.pick_weights[:5],
        t.graph.homo.deg[t.idx_train_dev[:5]].float()
        / t.pick_weights.new_tensor(
            np.where(t.y_train[:5] == 1, len(t.train_pos),
                     len(t.idx_train))))
    auc, recall, f1 = t.train()
    assert np.isfinite([auc, recall, f1]).all()


# ------------------------------------------------------------ the model

def _split(labels):
    idx_train, _, _ = stratified_splits(labels, 0.4, 0.67, 2)
    return idx_train, idx_train[labels[idx_train] == 1]


@pytest.fixture(scope="module")
def graphs():
    """Each preset's graph from both packages, no stores."""
    out = {}
    for preset, seed in (("tiny", 0), ("small", 1), ("skew-tiny", 3)):
        gj = jsyn.synthetic_fraud_graph(preset, seed=seed)
        gt = tsyn.synthetic_fraud_graph(preset, seed=seed)
        labels = np.asarray(gj.labels)
        idx_train, tp = _split(labels)
        rng = np.random.default_rng(seed + 10)
        hubs = [np.flatnonzero(r.deg.numpy() > r.window_width)
                for r in gt.relations if r.has_hubs]
        hubs = np.concatenate(hubs) if hubs else np.zeros(0, np.int64)
        batch = np.concatenate([hubs, rng.choice(idx_train, 50), [0, 0, 0]])
        weight = np.ones(len(batch), np.float32)
        weight[-3:] = 0.0
        y = labels[batch].copy()
        y[: len(hubs): 2] = 1        # fraud hub rows: the hub minor band
        model_j = jpcgnn.PCGNN(gj.feat_dim, EMB, gj.num_relations, ALPHA,
                               RHO)
        params = jax.tree.map(np.asarray,
                              model_j.init(jax.random.key(seed)))
        out[preset] = dict(gj=gj, gt=gt, labels=labels, tp=tp, batch=batch,
                           weight=weight, y=y, model_j=model_j,
                           params=params, hubs=hubs)
    return out


def _scores64(x: np.ndarray, params) -> np.ndarray:
    w = params["label_clf"]
    return x.astype(np.float64) @ w["w"][:, 0].astype(np.float64) + float(
        w["b"][0])


def _near_tie_rows(s, gt, batch, y, tp, train: bool, nbr_scores=None):
    """Rows whose choose or minor decision sits on a distance gap under
    NEAR_TIE, over each row's full CSR neighbor list.  ``s`` scores the
    centers and candidates; ``nbr_scores[r]`` relation r's neighbors (a
    bf16 store ranks rounded rows), ``s`` by default."""
    flag = np.zeros(len(batch), bool)

    def gap_at(dists, k):
        ds = np.sort(dists)
        return 0 < k < len(ds) and ds[k] - ds[k - 1] < NEAR_TIE

    for r, rel in enumerate(gt.relations):
        sn = s if nbr_scores is None else nbr_scores[r]
        indptr, col = rel.indptr.numpy(), rel.col.numpy()
        keff, ks = rel.keff.numpy(), rel.ksample.numpy()
        for i, v in enumerate(batch):
            nb = col[indptr[v]: indptr[v + 1]]
            flag[i] |= gap_at(np.abs(s[v] - sn[nb]), keff[v])
            if train and y[i] == 1:
                m = int(np.floor(np.float32(ks[v]) * np.float32(RHO)))
                flag[i] |= gap_at(np.abs(s[v] - s[tp]), m)
    return flag


def _torch_model(s):
    gt = s["gt"]
    m = tpcgnn.PCGNN(gt.feat_dim, EMB, gt.num_relations, ALPHA, RHO)
    m.load_state_dict(params_from_jax(s["params"]))
    return m


def _check_train(s, gj, gt, ties, max_ties=3):
    """Train forward, loss and every gradient, the port against
    ``jax.grad(PCGNN.loss)``; near-tie rows weigh 0 and are left out."""
    assert ties.sum() <= max_ties, ties.sum()
    keep = ~ties
    model_j, params, tp = s["model_j"], s["params"], s["tp"]
    batch, y = s["batch"], s["y"]
    w = np.where(ties, 0.0, s["weight"]).astype(np.float32)
    jb, jy = jnp.asarray(batch, jnp.int32), jnp.asarray(y, jnp.int32)
    tpj = jnp.asarray(tp, jnp.int32)
    jkw = dict(train_pos=tpj, train_pos_valid=jnp.ones(len(tp), bool),
               train_pos_feats=gj.features[tpj])
    ttp = torch.from_numpy(tp)
    tkw = dict(train_pos=ttp, train_pos_valid=torch.ones(len(tp), dtype=bool),
               train_pos_feats=gt.features[ttp])
    tb, ty = torch.from_numpy(batch), torch.from_numpy(y)
    model_t = _torch_model(s)

    fwd_j = jax.jit(lambda p, g: model_j.forward(p, g, jb, jy, train=True,
                                                 **jkw))
    logits_j, scores_j = fwd_j(params, gj)
    logits_t, scores_t = model_t(gt, tb, ty, train=True, **tkw)
    for got, want in ((logits_t, logits_j), (scores_t, scores_j)):
        np.testing.assert_allclose(got.detach().numpy()[keep],
                                   np.asarray(want)[keep], **FWD)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, g: model_j.loss(p, g, jb, jy, jnp.asarray(w), **jkw)))(
            params, gj)
    loss_t = model_t.loss(gt, tb, ty, torch.from_numpy(w), **tkw)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **FWD)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    got = {k: p.grad for k, p in model_t.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **GRAD,
                                   err_msg=k)
    return logits_t


def _check_eval(s, gj, gt, ties):
    keep = ~ties
    pj = jax.jit(lambda p, g: s["model_j"].to_prob(
        p, g, jnp.asarray(s["batch"], jnp.int32)))(s["params"], gj)
    with torch.no_grad():
        pt = _torch_model(s).to_prob(gt, torch.from_numpy(s["batch"]))
    for got, want in zip(pt, pj):
        np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                                   **FWD)
    return pt


@pytest.mark.parametrize("preset", ["tiny", "small", "skew-tiny"])
@pytest.mark.parametrize("train", [True, False])
def test_score_table_lane_matches_jax(graphs, preset, train):
    """The score-table lane (no stores, N under 200,000): one [N] score
    table per step; skew-tiny's hub rows read their neighbors' scores from
    its column and their train-positive flags from the next."""
    s = graphs[preset]
    gj, gt = s["gj"], s["gt"]
    assert all(r.ewin is None for r in gt.relations)
    assert gt.num_nodes < tpcgnn.SCORE_FROM_WINDOW_MIN_NODES
    sc = _scores64(gt.features.numpy(), s["params"])
    ties = _near_tie_rows(sc, gt, s["batch"], s["y"], s["tp"], train)
    if train:
        _check_train(s, gj, gt, ties)
    else:
        _check_eval(s, gj, gt, ties)
    if preset == "skew-tiny":
        assert len(s["hubs"]) >= 6


def test_score_table_self_loop_distance_is_zero(graphs, monkeypatch):
    """Centers, neighbors and candidates read one score table, so every
    row's self-loop is at distance 0 and is kept (keff >= 1).  The choose
    (``choose_ids_sum``'s plain version on the CPU) is spied on at its
    ``keep_nearest``."""
    s = graphs["tiny"]
    gt = s["gt"]
    calls = []
    keep_nearest = tagg.keep_nearest

    def spy(dist, k, valid):
        keep = keep_nearest(dist, k, valid)
        calls.append((dist, keep))
        return keep

    monkeypatch.setattr(tagg, "keep_nearest", spy)
    batch = torch.from_numpy(s["batch"][:-3])
    with torch.no_grad():
        _torch_model(s)(gt, batch, None, train=False)
    assert len(calls) == gt.num_relations
    for (dist, keep), rel in zip(calls, gt.relations):
        nbr = rel.nbr2d[batch]
        self_slot = nbr == batch[:, None].to(nbr.dtype)
        assert self_slot.any(1).all()
        assert (dist[self_slot] == 0).all() and keep[self_slot].all()


def test_trainer_step_without_stores_matches_jax(tmp_path):
    """One Adam step of each trainer with ``edge_windows: false`` (no store
    built, the score-table lane) from the same params, batch and weights."""
    cfg = dict(seed=2, data_name="synthetic:tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=2,
               valid_epochs=1, batch_size=64, patience=100, exp_num=0,
               edge_windows=False)
    jt = JTrainer(cfg, result=JResults(cfg, root=str(tmp_path / "jax")))
    tt = TTrainer(cfg, device="cpu",
                  result=TResults(cfg, root=str(tmp_path / "torch")))
    assert tt.graph.fused is None and tt.graph.features_pad is None
    assert all(r.ewin is None for r in tt.graph.relations)
    assert jt._step_graph.relations[0].ewin is None
    params = jt.model.init(jax.random.key(1))
    rng = np.random.default_rng(3)
    batch = np.concatenate([rng.choice(jt.idx_train, 60), [0, 0, 0, 0]])
    y = tt.graph.labels.numpy()[batch]
    sc = _scores64(tt.graph.features.numpy(), params)
    ties = _near_tie_rows(sc, tt.graph, batch, y, tt.train_pos, True)
    assert ties.sum() <= 2
    w = np.where(ties, 0, np.r_[np.ones(60), np.zeros(4)]).astype(np.float32)
    jb, jy, jw = (jnp.asarray(batch, jnp.int32), jnp.asarray(y, jnp.int32),
                  jnp.asarray(w))
    new_j, _, loss_j = jt._step1_jit(params, jt.tx.init(params), jb, jy, jw,
                                     jax.random.key(0), jt._step_graph,
                                     jt._step_consts)
    c = jt._step_consts
    grads_j = jax.jit(jax.grad(lambda p: jt.model.loss(
        p, jt._step_graph, jb, jy, jw, train_pos=c["tp"],
        train_pos_valid=c["tpv"], train_pos_feats=c["tpf"])))(params)
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


# ------------------------------------ score-from-window without stores

def _window_graphs(s, case, monkeypatch):
    """Both packages' graphs for one case of the score-from-window lane
    without full store coverage."""
    gj0, gt0 = s["gj"], s["gt"]
    if case == "clamp_ids":
        monkeypatch.setattr(jcsr, "FPAD_BUDGET_BYTES", 0)
        monkeypatch.setattr(tcsr, "FPAD_BUDGET_BYTES", 0)
    if case == "partial_bf16":
        # the biggest relation keeps a bf16 store, the total budget is
        # spent on it, and the others read table rows; both packages get
        # one budget, the JAX package's store of that relation (the port
        # decides coverage by the JAX package's accounting)
        big = max(range(3), key=lambda i: gt0.relations[i].num_edges)
        budget = int(jcsr.attach_edge_windows(
            gj0.relations[big], np.asarray(gj0.features),
            dtype=jnp.bfloat16).ewin.size) * 4
        gj = jcsr.materialize_edge_windows(gj0, dtype=jnp.bfloat16,
                                           total_budget_bytes=budget)
        gt = tcsr.materialize_edge_windows(gt0, dtype=torch.bfloat16,
                                           total_budget_bytes=budget)
        have = [r.ewin is not None for r in gt.relations]
        assert have == [r.ewin is not None for r in gj.relations]
        assert have == [i == big for i in range(3)]
        assert gt.relations[big].ewin.dtype == torch.bfloat16
        return gj, gt
    gj = jcsr.materialize_edge_windows(gj0, total_budget_bytes=0)
    gt = tcsr.materialize_edge_windows(gt0, total_budget_bytes=0)
    assert all(r.ewin is None for r in gt.relations) and gt.fused is None
    assert (gt.features_pad is None) == (case == "clamp_ids")
    assert (gj.features_pad is None) == (case == "clamp_ids")
    return gj, gt


@pytest.mark.parametrize("case", ["features_pad", "clamp_ids",
                                  "partial_bf16"])
@pytest.mark.parametrize("train", [True, False])
def test_score_from_window_without_stores_matches_jax(graphs, monkeypatch,
                                                      case, train):
    """SCORE_FROM_WINDOW_MIN_NODES patched to 0 in both packages: rows
    gathered by neighbor id are scored themselves.  With ``features_pad``,
    with clamped ids (no sentinel table: valid keeps the clamped rows out of
    every sum, and the minor dedup sees the unclamped ids), and with one
    relation's bf16 store (partial coverage: as in the JAX package, no
    selection score rounds, so the stored relation ranks bf16 rows against
    exact center scores)."""
    monkeypatch.setattr(jpcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 0)
    monkeypatch.setattr(tpcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 0)
    s = graphs["tiny"]
    gj, gt = _window_graphs(s, case, monkeypatch)
    x = gt.features.numpy()
    sc = _scores64(x, s["params"])
    nbr_scores = None
    if case == "partial_bf16":
        rounded = _scores64(gt.features.to(torch.bfloat16).float().numpy(),
                            s["params"])
        nbr_scores = [rounded if r.ewin is not None else sc
                      for r in gt.relations]
    ties = _near_tie_rows(sc, gt, s["batch"], s["y"], s["tp"], train,
                          nbr_scores)
    if train:
        _check_train(s, gj, gt, ties)
    else:
        _check_eval(s, gj, gt, ties)


def test_clamped_ids_reach_no_sum(graphs, monkeypatch):
    """In the clamp_ids lane, ids past N-1 read row N-1, which valid keeps
    out: the forward equals the features_pad lane's exactly."""
    monkeypatch.setattr(tpcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 0)
    s = graphs["tiny"]
    gt = s["gt"]
    padded = tcsr.materialize_edge_windows(gt, total_budget_bytes=0)
    assert padded.features_pad is not None and gt.features_pad is None
    model = _torch_model(s)
    tp = torch.from_numpy(s["tp"])
    kw = dict(train_pos=tp, train_pos_valid=torch.ones(len(tp), dtype=bool))
    tb, ty = torch.from_numpy(s["batch"]), torch.from_numpy(s["y"])
    with torch.no_grad():
        for a, b in zip(model(gt, tb, ty, train=True, **kw),
                        model(padded, tb, ty, train=True, **kw)):
            assert torch.equal(a, b)


# ------------------------------------------------ one oversample route

_FROZEN_LANES = ["score_table", "hub_no_stores", "plain", "csr", "fused"]


def _frozen_lane_graph(graphs, monkeypatch, lane):
    """(case, graph) of one frozen lane: the score table (tiny, and
    skew-tiny's hub graph, without stores), score-from-window over
    ``features_pad`` and over the CSR, and the fused store lane."""
    s = graphs["skew-tiny" if lane == "hub_no_stores" else "tiny"]
    if lane in ("plain", "csr"):
        monkeypatch.setattr(tpcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 0)
    if lane == "plain":
        return s, tcsr.materialize_edge_windows(s["gt"], total_budget_bytes=0)
    if lane == "csr":
        monkeypatch.setattr(tcsr, "NBR2D_BUDGET_BYTES", 8)
        gt = tsyn.synthetic_fraud_graph("tiny", seed=0)
        assert all(r.nbr2d is None for r in gt.relations)
        return s, gt
    if lane == "fused":
        gt = tcsr.materialize_edge_windows(s["gt"])
        assert gt.fused is not None
        return s, gt
    return s, s["gt"]


@pytest.mark.parametrize("lane", _FROZEN_LANES)
def test_training_forward_adds_its_minors_in_one_call(graphs, monkeypatch,
                                                      lane):
    """Every frozen lane's training forward adds its oversampled minors
    with exactly one call of ``oversample_minor_sums`` (one kernel on the
    card) and runs no step of the chain of ops itself."""
    s, gt = _frozen_lane_graph(graphs, monkeypatch, lane)
    calls = {"sums": 0, "chain": 0}

    def counting(name, key):
        fn = getattr(tpcgnn, name)

        def counted(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(tpcgnn, name, counted)

    counting("oversample_minor_sums", "sums")
    for name in ("oversample_candidates_values", "oversample_keep"):
        counting(name, "chain")
    model = _torch_model(s)
    tp = torch.from_numpy(s["tp"])
    with torch.no_grad():
        model(gt, torch.from_numpy(s["batch"]), torch.from_numpy(s["y"]),
              train=True, train_pos=tp,
              train_pos_valid=torch.ones(len(tp), dtype=bool))
    assert calls == {"sums": 1, "chain": 0}, calls


# ------------------------------------------------ CSR branch, frozen lanes

@pytest.mark.parametrize("preset", ["tiny", "skew-tiny"])
@pytest.mark.parametrize("lane", ["table", "window"])
def test_csr_branch_matches_dense_table_and_jax(graphs, monkeypatch, preset,
                                                lane):
    """NBR2D_BUDGET_BYTES patched down in both packages: no dense tables,
    so every relation reads its windows from the CSR (the ragged gather's
    plain version here).  The ids are the table's, so the logits equal the
    dense-table run's exactly, and the JAX package's to FWD."""
    if lane == "window":
        monkeypatch.setattr(jpcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 0)
        monkeypatch.setattr(tpcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 0)
    s = graphs[preset]
    monkeypatch.setattr(jcsr, "NBR2D_BUDGET_BYTES", 8)
    monkeypatch.setattr(tcsr, "NBR2D_BUDGET_BYTES", 8)
    sd = {"tiny": 0, "skew-tiny": 3}[preset]
    gj = jsyn.synthetic_fraud_graph(preset, seed=sd)
    gt = tsyn.synthetic_fraud_graph(preset, seed=sd)
    assert all(r.nbr2d is None for r in (*gt.relations, gt.homo))
    assert all(r.nbr2d is None for r in gj.relations)
    model = _torch_model(s)
    tp = torch.from_numpy(s["tp"])
    kw = dict(train_pos=tp, train_pos_valid=torch.ones(len(tp), dtype=bool),
              train_pos_feats=gt.features[tp])
    tb, ty = torch.from_numpy(s["batch"]), torch.from_numpy(s["y"])
    with torch.no_grad():
        got = model(gt, tb, ty, train=True, **kw)
        want = model(s["gt"], tb, ty, train=True, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    sc = _scores64(gt.features.numpy(), s["params"])
    ties = _near_tie_rows(sc, gt, s["batch"], s["y"], s["tp"], True)
    keep = ~ties
    tpj = jnp.asarray(s["tp"], jnp.int32)
    logits_j, _ = jax.jit(lambda p, g: s["model_j"].forward(
        p, g, jnp.asarray(s["batch"], jnp.int32),
        jnp.asarray(s["y"], jnp.int32), train=True, train_pos=tpj,
        train_pos_valid=jnp.ones(len(s["tp"]), bool)))(s["params"], gj)
    np.testing.assert_allclose(got[0].numpy()[keep],
                               np.asarray(logits_j)[keep], **FWD)


def test_no_dense_table_means_no_store(monkeypatch):
    """A relation without a dense table gets no store (the store's window
    ids come from the table), in both packages."""
    monkeypatch.setattr(jcsr, "NBR2D_BUDGET_BYTES", 8)
    monkeypatch.setattr(tcsr, "NBR2D_BUDGET_BYTES", 8)
    gt = tcsr.materialize_edge_windows(tsyn.synthetic_fraud_graph("tiny"),
                                       homo=True)
    gj = jcsr.materialize_edge_windows(jsyn.synthetic_fraud_graph("tiny"))
    assert all(r.ewin is None for r in (*gt.relations, gt.homo))
    assert all(r.ewin is None for r in (*gj.relations, gj.homo))
    np.testing.assert_array_equal(gt.features_pad.numpy(),
                                  np.asarray(gj.features_pad))


def test_materialize_builds_what_the_model_reads():
    """PC-GNN's stores on the relations (and the fused records), GCN's and
    GraphSAGE's on the homo graph alone; features_pad either way, equal to
    the JAX package's; and ``to`` carries it."""
    gt = tsyn.synthetic_fraud_graph("tiny", seed=0)
    pc = tcsr.materialize_edge_windows(gt)
    assert all(r.ewin is not None for r in pc.relations)
    assert pc.fused is not None and pc.homo.ewin is None
    base = tcsr.materialize_edge_windows(gt, relations=False, homo=True,
                                         fused=False)
    assert all(r.ewin is None for r in base.relations) and base.fused is None
    assert base.homo.ewin is not None
    gj = jcsr.materialize_edge_windows(jsyn.synthetic_fraud_graph("tiny",
                                                                  seed=0))
    np.testing.assert_array_equal(base.features_pad.numpy(),
                                  np.asarray(gj.features_pad))
    assert base.to("cpu").features_pad is not None
    # a homo graph that is one of the relations shares its store
    one = dataclasses.replace(gt, relations=gt.relations[:1],
                              homo=gt.relations[0])
    both = tcsr.materialize_edge_windows(one, homo=True)
    assert both.homo is both.relations[0] and both.homo.ewin is not None


# ---------------------------------- stress-10m's lane, at a patched size

# stress-10m cut to test size, directed, F = 16
SMALL_10M = (6000, 16, 0.05, (30000, 15000, 5000), 3)


def _stress_10m_lane(monkeypatch):
    """Both packages patched so that the cut stress-10m preset lands in the
    real one's lane: every dense neighbor table over NBR2D_BUDGET_BYTES (so
    no edge-window store either), the features over FPAD_BUDGET_BYTES (no
    sentinel-padded table, clamped ids), N over
    SCORE_FROM_WINDOW_MIN_NODES (scores from the gathered rows)."""
    for syn in (jsyn, tsyn):
        monkeypatch.setitem(syn.PRESETS, "stress-10m", SMALL_10M)
    for mod, name, value in ((jcsr, "NBR2D_BUDGET_BYTES", 8),
                             (tcsr, "NBR2D_BUDGET_BYTES", 8),
                             (jcsr, "FPAD_BUDGET_BYTES", 0),
                             (tcsr, "FPAD_BUDGET_BYTES", 0),
                             (jpcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 6000),
                             (tpcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 6000)):
        monkeypatch.setattr(mod, name, value)


STRESS_10M_CFG = dict(seed=2, data_name="synthetic:stress-10m",
                      model="PCGNN", train_ratio=0.4, test_ratio=0.67,
                      emb_size=16, lr=0.01, weight_decay=0.001, alpha=2.0,
                      rho=0.5, epochs=1, valid_epochs=1, batch_size=96,
                      patience=100, exp_num=0)


def _lane(g, n_min) -> dict:
    """The lane decisions that stress-10m's scale forces, as both packages'
    graphs show them."""
    return {"tables": [r.nbr2d is not None for r in g.relations],
            "stores": [r.ewin is not None for r in g.relations],
            "fused": getattr(g, "fused", None) is not None,
            "features_pad": g.features_pad is not None,
            "homo_stub": bool(g.homo.is_stub),
            "score_from_window": g.num_nodes >= n_min,
            "hubs": [bool(r.has_hubs) for r in g.relations],
            "dcap": [r.window_width for r in g.relations]}


def test_stress_10m_lane_matches_jax(monkeypatch, tmp_path):
    """The cut stress-10m preset, built through the port's native core,
    equals the JAX package's graph array for array, and both trainers
    decide stress-10m's lane: no table, no store, no padded table, the
    degree stub, scores from the rows, clamped ids."""
    from pcgnn_tpu_torch import native
    _stress_10m_lane(monkeypatch)
    assert native.available()
    jt = JTrainer(STRESS_10M_CFG,
                  result=JResults(STRESS_10M_CFG, root=str(tmp_path / "j")))
    tt = TTrainer(STRESS_10M_CFG, device="cpu",
                  result=TResults(STRESS_10M_CFG, root=str(tmp_path / "t")))
    gj, gt = jt.graph, tt.graph
    want = {"tables": [False] * 3, "stores": [False] * 3, "fused": False,
            "features_pad": False, "homo_stub": True,
            "score_from_window": True, "hubs": [False] * 3}
    lane_t = _lane(gt, tpcgnn.SCORE_FROM_WINDOW_MIN_NODES)
    lane_j = _lane(gj, jpcgnn.SCORE_FROM_WINDOW_MIN_NODES)
    assert lane_t == lane_j
    assert {k: lane_t[k] for k in want} == want
    np.testing.assert_array_equal(gt.features.numpy(),
                                  np.asarray(gj.features))
    np.testing.assert_array_equal(gt.labels.numpy(), np.asarray(gj.labels))
    for rt, rj in zip((*gt.relations, gt.homo), (*gj.relations, gj.homo)):
        assert (rt.num_edges, rt.dmax) == (rj.num_edges, rj.dmax)
        for name in ("indptr", "deg", "keff", "ksample"):
            np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                          np.asarray(getattr(rj, name)))
        e = rt.num_edges
        np.testing.assert_array_equal(rt.col.numpy()[:e],
                                      np.asarray(rj.col)[:e])
    np.testing.assert_array_equal(tt.idx_train, jt.idx_train)


def test_stress_10m_lane_trainer_steps_match_jax(monkeypatch, tmp_path):
    """Three Adam steps of each trainer in stress-10m's lane (the CSR read
    through the ragged gather's plain version, rows gathered with clamped
    ids) on the same batches: at each step both start from the JAX
    package's parameters, and the loss, every gradient and the parameters
    after Adam agree (tolerances of
    test_trainer_step_without_stores_matches_jax); near-tie rows weigh 0."""
    from pcgnn_tpu_torch.ops import ragged_gather as rg
    _stress_10m_lane(monkeypatch)
    jt = JTrainer(STRESS_10M_CFG,
                  result=JResults(STRESS_10M_CFG, root=str(tmp_path / "j")))
    tt = TTrainer(STRESS_10M_CFG, device="cpu",
                  result=TResults(STRESS_10M_CFG, root=str(tmp_path / "t")))
    calls = []
    plain = rg.ragged_gather_plain
    monkeypatch.setattr(rg, "ragged_gather_plain",
                        lambda *a: calls.append(a[2]) or plain(*a))
    c = jt._step_consts
    params = jt.model.init(jax.random.key(1))
    opt_j = jt.tx.init(params)
    model = tt.new_model()
    opt_t = tt.new_optimizer(model)
    grad_fn = jax.jit(jax.grad(lambda p, jb, jy, jw: jt.model.loss(
        p, jt._step_graph, jb, jy, jw, train_pos=c["tp"],
        train_pos_valid=c["tpv"], train_pos_feats=c["tpf"])))
    x = tt.graph.features.numpy()
    rng = np.random.default_rng(11)
    for step in range(3):
        batch = np.concatenate([rng.choice(jt.idx_train, 90), [0] * 6])
        y = tt.graph.labels.numpy()[batch]
        sc = _scores64(x, jax.tree.map(np.asarray, params))
        ties = _near_tie_rows(sc, tt.graph, batch, y, tt.train_pos, True)
        assert ties.sum() <= 3, (step, ties.sum())
        w = np.where(ties, 0, np.r_[np.ones(90), np.zeros(6)]).astype(
            np.float32)
        jb, jy, jw = (jnp.asarray(batch, jnp.int32),
                      jnp.asarray(y, jnp.int32), jnp.asarray(w))
        grads_j = grad_fn(params, jb, jy, jw)
        new_j, opt_j, loss_j = jt._step1_jit(
            params, opt_j, jb, jy, jw, jax.random.key(step),
            jt._step_graph, c)
        with torch.no_grad():
            for k, v in params_from_jax(
                    jax.tree.map(np.asarray, params)).items():
                dict(model.named_parameters())[k].copy_(v)
        calls.clear()
        loss_t = tt.step(model, opt_t, torch.from_numpy(batch),
                         torch.from_numpy(y), torch.from_numpy(w))
        # one CSR window read per relation, at its full dcap
        assert calls == [r.window_width for r in tt.graph.relations]
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
        gj = params_from_jax(jax.tree.map(np.asarray, grads_j))
        pj = params_from_jax(jax.tree.map(np.asarray, new_j))
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), gj[k].numpy(), **GRAD,
                                       err_msg=f"step {step} {k}")
            np.testing.assert_allclose(p.detach().numpy(), pj[k].numpy(),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"step {step} {k}")
        params = new_j
