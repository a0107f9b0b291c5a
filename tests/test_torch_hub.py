"""The hub lane and its ragged gather: the port against the JAX package.

On the CPU the port's ``ragged_gather`` takes its plain version; the JAX
Pallas kernel runs in interpret mode, as ``tests/test_ops.py`` runs it, and
the JAX hub lane takes its clipping fallback.  Ids are copies, so those
comparisons are exact.

The hub lane (``ops.hub``) and the model on hub graphs are held to the JAX
package with the tolerances of ``tests/test_torch_model.py``: keep masks,
selected minors and counts exactly (counts are sums of 0/1 terms), sums,
logits and the loss to rtol 1e-5 / atol 1e-6 (float32 sums in another
order), gradients to rtol 1e-4 / atol 1e-6.  The port rounds selection
scores once from float64 while the JAX package accumulates them in float32,
so a row whose keep decision sits on a distance gap under 1e-6 could flip on
an ulp; such rows are found from the data (over each row's FULL neighbor
list, hub rows included) and left out of the comparison.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgnn_tpu.data.prep import stratified_splits
from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu.models.pcgnn import PCGNN as JPCGNN
from pcgnn_tpu.ops import aggregate as jagg
from pcgnn_tpu.ops import hub as jhub
from pcgnn_tpu.ops.pallas.ragged_gather import ragged_window_gather
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.interop import params_from_jax
from pcgnn_tpu_torch.models.pcgnn import PCGNN as TPCGNN
from pcgnn_tpu_torch.ops import hub as thub
from pcgnn_tpu_torch.ops import ragged_gather as trg
from tests.oracle import pcgnn_forward_oracle

EMB, ALPHA, RHO = 12, 2.0, 0.5
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
NEAR_TIE = 1e-6
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------------------------ ragged gather

@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("b", [8, 37])
def test_ragged_gather_plain_matches_jax_kernel(d, b):
    """Ragged B, repeated rows, row 0's start repeated (as padded chunk rows
    read it), and starts up to the end the JAX kernel allows."""
    rng = np.random.default_rng(d + b)
    e = 8192
    col = rng.integers(0, 999, e).astype(np.int32)
    # the JAX kernel reads E >= align1024(start) + roundup1024(d) + 1024
    last = e - 1024 - ((d + 1023) // 1024) * 1024 + 1023
    starts = rng.integers(0, last, b).astype(np.int32)
    starts[1] = starts[0]
    starts[-1] = last
    starts[-2] = 0
    want = np.asarray(ragged_window_gather(jnp.asarray(col),
                                           jnp.asarray(starts), d,
                                           interpret=True))
    got = trg.ragged_gather(torch.from_numpy(col), torch.from_numpy(starts),
                            d, 1000)
    assert got.dtype == torch.int32 and got.shape == (b, d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block", [1, 100, 128, 1000])
def test_ragged_gather_matches_jax_hub_fetch_past_the_end(block):
    """Widths that are not multiples of 128, int32 and int64 starts, and
    reads past the end of ``col``: the port gives ``fill`` = N there, the
    JAX hub lane's fetch clips onto the CSR's N-valued padding."""
    rng = np.random.default_rng(block)
    n, e = 777, 3000
    col = np.full(e, n, np.int32)
    col[: e - 40] = rng.integers(0, n, e - 40)
    starts = np.concatenate([rng.integers(0, e, 20), [e - 1, e - 41, 0, 0]])
    for j in (0, 2):
        want = np.asarray(jhub._window_block(
            jnp.asarray(col), jnp.asarray(starts, jnp.int32), j, block))
        for dt in (torch.int32, torch.int64):
            st = torch.from_numpy(starts).to(dt)
            got = trg.ragged_gather(torch.from_numpy(col), st + j * block,
                                    block, n)
            np.testing.assert_array_equal(got.numpy(), want)
    # a fill that is not the padding value shows where the guard acts
    got = trg.ragged_gather(torch.from_numpy(col),
                            torch.tensor([e - 2, -3]), 5, -1).numpy()
    np.testing.assert_array_equal(got, [[n, n, -1, -1, -1],
                                        [-1, -1, -1, col[0], col[1]]])


def test_ragged_gather_wrapper_checks():
    col = torch.arange(64, dtype=torch.int32)
    starts = torch.tensor([0, 5])
    with pytest.raises(TypeError):
        trg.ragged_gather(col.long(), starts, 8, 64)
    with pytest.raises(TypeError):
        trg.ragged_gather(col, starts.float(), 8, 64)
    with pytest.raises(ValueError):
        trg.ragged_gather(col.view(8, 8), starts, 8, 64)
    with pytest.raises(ValueError):
        trg.ragged_gather(col[:0], starts, 8, 64)
    with pytest.raises(ValueError):
        trg.ragged_gather(col, starts, 8, 2 ** 31)
    # a tensor on neither the CPU nor a card is refused, not copied through
    # the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        trg.ragged_gather(col.to("meta"), starts.to("meta"), 8, 64)
    with pytest.raises(ValueError, match="starts on"):
        trg.ragged_gather(col, starts.to("meta"), 8, 64)
    before = trg.launches
    assert trg.ragged_gather(col, starts[:0], 8, 64).shape == (0, 8)
    assert trg.ragged_gather(col, starts, 0, 64).shape == (2, 0)
    assert trg.launches == before


# ------------------------------------------------------------ hub pieces

def test_keep_nearest_switch_matches_full_width():
    """Mirror of tests/test_hub.py: the truncated sort equals the
    full-width keep_nearest for every populated width, and the JAX
    lax.switch version."""
    rng = np.random.default_rng(7)
    block, dh = 128, 2048
    for jb in (0, 1, 2, 5, 16):
        deg = rng.integers(0, max(jb * block, 1), 32)
        dist = np.full((32, dh), np.inf, np.float32)
        for i, d in enumerate(deg):
            dist[i, :d] = np.round(rng.random(d), 2)      # ties included
        kf = rng.integers(0, np.maximum(deg, 1) + 1).astype(np.int32)
        full = jagg.keep_nearest(jnp.asarray(dist), jnp.asarray(kf),
                                 jnp.isfinite(jnp.asarray(dist)))
        want = jhub.keep_nearest_switch(jnp.asarray(dist), jnp.asarray(kf),
                                        jnp.int32(jb), block)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(full))
        got = thub.keep_nearest_switch(torch.from_numpy(dist),
                                       torch.from_numpy(kf), jb, block)
        assert got.shape == (32, dh)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"jb={jb}")


@pytest.mark.parametrize("p_valid", [40, 64])
def test_chunk_minor_band_matches_jax(p_valid):
    """Selected minors (through an identity feature table, so the sum IS
    the selection mask), counts and thresholds exactly, with forced ties at
    the band edge, non-fraud rows, m = 0, and m past the valid pool
    (threshold +inf); then a real feature table to FWD.  Every row is
    active here (``test_chunk_minor_band_padding_rows_match_jax`` takes
    padding rows)."""
    rng = np.random.default_rng(p_valid)
    h, p = 12, 64
    sp = np.round(rng.normal(size=p), 1).astype(np.float32)     # ties
    sp[p_valid:] = np.inf
    slot = rng.permutation(p).astype(np.int32)
    order = np.argsort(sp, kind="stable")
    sp_sorted, slot_sorted = sp[order], slot[order]
    c_s0 = np.round(rng.normal(size=h), 1).astype(np.float32)
    ks = rng.integers(0, 150, h).astype(np.int32)
    ks[:3] = [0, 1, 200]
    fraud = rng.random(h) < 0.8
    fraud[2] = True
    fraud[-2:] = False
    for feats in (np.eye(p, dtype=np.float32),
                  rng.normal(size=(p, 5)).astype(np.float32)):
        fs = feats[slot_sorted]
        want = jhub.chunk_minor_band(
            jnp.asarray(c_s0), jnp.asarray(ks), jnp.asarray(fraud),
            jnp.ones(h, bool), jnp.asarray(sp_sorted),
            jnp.asarray(slot_sorted), jnp.asarray(fs), RHO)
        got = thub.chunk_minor_band(
            torch.from_numpy(c_s0), torch.from_numpy(ks),
            torch.from_numpy(fraud), torch.ones(h, dtype=torch.bool),
            torch.from_numpy(sp_sorted), torch.from_numpy(slot_sorted),
            torch.from_numpy(fs), RHO)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        if feats.shape[1] == p:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            sel = got[0].numpy()[:, slot]     # by original candidate
        else:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       **FWD)
    assert np.isposinf(got[2].numpy()[2])
    assert np.isneginf(got[2].numpy()).sum() >= 3
    # the band edge held ties and the tie rule had to split them
    t = got[2].numpy()
    d = np.abs(c_s0[:, None] - sp[None, :])
    split = [(np.isfinite(t[i]) and sel[i][d[i] == t[i]].min() == 0
              and sel[i][d[i] == t[i]].max() == 1) for i in range(h)]
    assert any(split)


def test_chunk_minor_band_padding_rows_match_jax():
    """``active`` as the chunk's padding rows give it: inactive rows select
    nothing (count 0, sum 0, threshold -inf), fraud or not, and the rest
    equal the JAX function, exactly through an identity feature table."""
    rng = np.random.default_rng(4)
    h, p = 16, 48
    sp = np.round(rng.normal(size=p), 1).astype(np.float32)
    sp[40:] = np.inf
    slot = rng.permutation(p).astype(np.int32)
    order = np.argsort(sp, kind="stable")
    c_s0 = np.round(rng.normal(size=h), 1).astype(np.float32)
    ks = rng.integers(2, 90, h).astype(np.int32)
    fraud = np.ones(h, bool)
    active = np.arange(h) < 11
    fs = np.eye(p, dtype=np.float32)[slot[order]]
    want = jhub.chunk_minor_band(
        jnp.asarray(c_s0), jnp.asarray(ks), jnp.asarray(fraud),
        jnp.asarray(active), jnp.asarray(sp[order]),
        jnp.asarray(slot[order]), jnp.asarray(fs), RHO)
    got = thub.chunk_minor_band(
        torch.from_numpy(c_s0), torch.from_numpy(ks), torch.from_numpy(fraud),
        torch.from_numpy(active), torch.from_numpy(sp[order]),
        torch.from_numpy(slot[order]), torch.from_numpy(fs), RHO)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy()[~active] == 0).all()
    assert (got[0].numpy()[~active] == 0).all()
    assert np.isneginf(got[2].numpy()[~active]).all()
    assert (got[1].numpy()[active] > 0).all()


def test_plan_hub_chunks_orders_heaviest_first():
    """The order puts hub rows first, heaviest first (as the JAX lane's
    key); the plan of one batch is each chunk's block count from its head
    row, and the plan of a stack takes the most hub rows of any batch and,
    chunk by chunk, the widest head."""
    deg = torch.tensor([5, 900, 40, 700, 900, 3, 2000, 41], dtype=torch.int32)
    is_hub = deg > 40
    order = thub.hub_order(deg, is_hub)
    assert order.tolist()[:5] == [6, 1, 4, 3, 7]
    assert order.tolist()[5:] == [0, 2, 5]
    assert thub.plan_hub_chunks(deg, is_hub, 2, 512) == (4, 2, 1)
    assert thub.plan_hub_chunks(deg, deg > 5000, 2, 512) == ()
    # another batch: fewer hub rows, a wider second chunk
    deg2 = torch.tensor([1500, 1200, 3, 3, 3, 3, 3, 3], dtype=torch.int32)
    stack = torch.stack([deg, deg2])
    assert thub.plan_hub_chunks(stack, stack > 40, 2, 512) == (4, 2, 1)
    deg3 = torch.tensor([1500, 1200, 1100, 1100, 3, 3, 3, 3],
                        dtype=torch.int32)
    stack = torch.stack([deg, deg3])
    assert thub.plan_hub_chunks(stack, stack > 40, 2, 512) == (4, 3, 1)
    assert thub.plan_union(((4, 2), None), ((3, 3, 1), None)) == (
        (4, 3, 1), None)
    assert thub.plan_covers(((4, 3, 1), None), ((4, 2), None))
    assert not thub.plan_covers(((4, 2),), ((4, 2, 1),))
    assert not thub.plan_covers(((4, 2),), ((4, 3),))


# ------------------------------------------------------------ skew-tiny

@pytest.fixture(scope="module")
def skew():
    gj = jax_graph("skew-tiny", seed=3)
    gt = torch_graph("skew-tiny", seed=3)
    labels = np.asarray(gj.labels)
    idx_train, _, _ = stratified_splits(labels, 0.4, 0.67, 2)
    tp = idx_train[labels[idx_train] == 1]
    model_j = JPCGNN(gj.feat_dim, EMB, gj.num_relations, ALPHA, RHO)
    params = jax.tree.map(np.asarray, model_j.init(jax.random.key(0)))
    rel = gt.relations[0]
    hubs = np.flatnonzero(rel.deg.numpy() > rel.window_width)
    assert rel.has_hubs and len(hubs) >= 6
    rng = np.random.default_rng(5)
    # every hub row (one of them twice) among random training rows, and 3
    # padded slots (node 0 at weight 0) as the epoch plan makes them
    batch = np.concatenate([hubs, hubs[:1], rng.choice(idx_train, 40),
                            [0, 0, 0]])
    weight = np.ones(len(batch), np.float32)
    weight[-3:] = 0.0
    # half the hub rows are fraud centers, so their minors go through the
    # hub lane's band selection
    y = labels[batch].copy()
    y[: len(hubs): 2] = 1
    return dict(gj=gj, gt=gt, labels=labels, tp=tp, model_j=model_j,
                params=params, batch=batch, weight=weight, y=y, hubs=hubs)


def _scores64(gt, params, bf16: bool) -> np.ndarray:
    x = gt.features
    sel = (x.to(torch.bfloat16) if bf16 else x).double().numpy()
    w = params["label_clf"]
    return sel @ w["w"][:, 0].astype(np.float64) + float(w["b"][0])


def _near_tie_rows(gt, s, batch, y, tp, train: bool,
                   relations=None) -> np.ndarray:
    """Rows whose choose or minor decision sits on a distance gap under
    NEAR_TIE, over each row's full CSR neighbor list."""
    flag = np.zeros(len(batch), bool)

    def gap_at(dists, k):
        ds = np.sort(dists)
        return 0 < k < len(ds) and ds[k] - ds[k - 1] < NEAR_TIE

    for rel in relations or gt.relations:
        indptr, col = rel.indptr.numpy(), rel.col.numpy()
        keff, ks = rel.keff.numpy(), rel.ksample.numpy()
        for i, v in enumerate(batch):
            nb = col[indptr[v]: indptr[v + 1]]
            flag[i] |= gap_at(np.abs(s[v] - s[nb]), keff[v])
            if train and y[i] == 1:
                m = int(np.floor(np.float32(ks[v]) * np.float32(RHO)))
                flag[i] |= gap_at(np.abs(s[v] - s[tp]), m)
    return flag


def _hub_inputs(skew, bf16: bool, train: bool, jax_scores: bool):
    """Hub-lane inputs from numpy, with each package's own selection scores
    (float32 at precision "highest" in JAX, rounded once from float64 in the
    port), as each package's model would hand them over."""
    gt, params, tp = skew["gt"], skew["params"], skew["tp"]
    x = gt.features.numpy()
    n, f = x.shape
    w = params["label_clf"]
    if jax_scores:
        sel = jnp.asarray(x)
        if bf16:
            sel = sel.astype(jnp.bfloat16).astype(jnp.float32)
        s = np.asarray(jnp.dot(sel, jnp.asarray(w["w"][:, 0]),
                               precision="highest") + w["b"][0])
    else:
        s = _scores64(gt, params, bf16).astype(np.float32)
    cols = [x]
    if train:
        tp_mask = np.zeros((n, 1), np.float32)
        tp_mask[tp] = 1.0
        cols.append(tp_mask)
    xs = np.concatenate(cols, axis=1)
    xs = np.concatenate([xs, np.zeros((1, xs.shape[1]), np.float32)])
    minor_ctx = None
    if train:
        slot = np.argsort(s[tp], kind="stable").astype(np.int32)
        minor_ctx = (s[tp][slot], slot, x[tp][slot])
    return dict(xs=xs, f=f, center_s0=s[skew["batch"]],
                w0=w["w"][:, 0].copy(), b0=w["b"][0].copy(),
                minor_ctx=minor_ctx)


@pytest.mark.parametrize("chunk,block", [(32, 512), (2, 128)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_hub_choose_sum_matches_jax(skew, train, bf16, chunk, block):
    relj, relt = skew["gj"].relations[0], skew["gt"].relations[0]
    batch, y = skew["batch"], skew["y"]
    inp = _hub_inputs(skew, bf16, train, jax_scores=False)
    inj = _hub_inputs(skew, bf16, train, jax_scores=True)
    is_hub = relt.deg.numpy()[batch] > relt.window_width
    if chunk == 2:
        assert is_hub.sum() > 2 * chunk
        assert relt.dmax > 3 * block
    kw = dict(round_sel=bf16, rho=RHO, chunk=chunk, block=block)
    want = jhub.hub_choose_sum(
        relj, jnp.asarray(batch, jnp.int32), jnp.asarray(is_hub),
        jnp.asarray(inj["xs"]), inj["f"], jnp.asarray(inj["center_s0"]),
        w0=jnp.asarray(inj["w0"]), b0=jnp.asarray(inj["b0"]),
        minor_ctx=(tuple(jnp.asarray(a) for a in inj["minor_ctx"])
                   if train else None),
        batch_labels=jnp.asarray(y, jnp.int32) if train else None,
        tp_col=inj["f"] if train else None, **kw)
    got = thub.hub_choose_sum(
        relt, torch.from_numpy(batch), torch.from_numpy(is_hub),
        torch.from_numpy(inp["xs"]), inp["f"],
        torch.from_numpy(inp["center_s0"]), w0=torch.from_numpy(inp["w0"]),
        b0=torch.tensor(inp["b0"]),
        minor_ctx=(tuple(torch.from_numpy(a) for a in inp["minor_ctx"])
                   if train else None),
        batch_labels=torch.from_numpy(y) if train else None, **kw)
    ok = ~_near_tie_rows(skew["gt"], _scores64(skew["gt"], skew["params"],
                                               bf16),
                         batch, y, skew["tp"], train, [relt])
    assert (~ok).sum() <= 2
    num, cnt = got[0].numpy(), got[1].numpy()
    assert (num[~is_hub] == 0).all() and (cnt[~is_hub] == 0).all()
    np.testing.assert_array_equal(cnt[ok], np.asarray(want[1])[ok])
    np.testing.assert_allclose(num[ok], np.asarray(want[0])[ok], **FWD)
    assert cnt[is_hub].min() > 0


def _graphs(skew, dtype, lane):
    jdt, tdt = _DTYPES[dtype]
    fused = lane == "fused"
    gj = jcsr.materialize_edge_windows(skew["gj"], dtype=jdt, fused=fused)
    gt = tcsr.materialize_edge_windows(skew["gt"], dtype=tdt, fused=fused)
    assert (gj.fused is not None) == fused == (gt.fused is not None)
    return gj, gt


def _torch_model(skew):
    m = TPCGNN(skew["gt"].feat_dim, EMB, skew["gt"].num_relations, ALPHA, RHO)
    m.load_state_dict(params_from_jax(skew["params"]))
    return m


@pytest.mark.parametrize("lane", ["fused", "relation"])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_train_forward_loss_and_grads_match_jax(skew, dtype, lane):
    gj, gt = _graphs(skew, dtype, lane)
    model_j, params = skew["model_j"], skew["params"]
    model_t = _torch_model(skew)
    tp, batch, y = skew["tp"], skew["batch"], skew["y"]
    s = _scores64(gt, params, dtype == "bfloat16")
    ties = _near_tie_rows(gt, s, batch, y, tp, train=True)
    assert ties.sum() <= 3, ties.sum()
    keep = ~ties
    w = np.where(ties, 0.0, skew["weight"]).astype(np.float32)
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
    for got, want in ((logits_t, logits_j), (scores_t, scores_j)):
        np.testing.assert_allclose(got.detach().numpy()[keep],
                                   np.asarray(want)[keep], **FWD)

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
def test_eval_probs_match_jax(skew, dtype, lane):
    gj, gt = _graphs(skew, dtype, lane)
    model_t = _torch_model(skew)
    batch = skew["batch"]
    s = _scores64(gt, skew["params"], dtype == "bfloat16")
    keep = ~_near_tie_rows(gt, s, batch, skew["y"], skew["tp"], train=False)
    pj = skew["model_j"].to_prob(skew["params"], gj,
                                 jnp.asarray(batch, jnp.int32))
    with torch.no_grad():
        pt = model_t.to_prob(gt, torch.from_numpy(batch))
    for got, want in zip(pt, pj):
        np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                                   **FWD)


# ------------------------------------------------------------ epoch plans

def _plan_batches(skew):
    """Four batches of relation 0 of skew-tiny, each of 48 rows: no hub
    row; the heaviest hub 5 times (more than one chunk of 2) among
    training rows; every hub; and 40 hub rows drawn with repeats (more
    than ``HUB_CHUNK``)."""
    rng = np.random.default_rng(9)
    gt, hubs = skew["gt"], skew["hubs"]
    rel = gt.relations[0]
    deg = rel.deg.numpy()
    plain = np.flatnonzero(deg <= rel.window_width)
    heavy = hubs[np.argmax(deg[hubs])]
    rows = [rng.choice(plain, 48),
            np.concatenate([[heavy] * 5, rng.choice(plain, 43)]),
            np.concatenate([hubs, rng.choice(plain, 48 - len(hubs))]),
            np.concatenate([rng.choice(hubs, 40), rng.choice(plain, 8)])]
    for b in rows:
        rng.shuffle(b)
    n_hub = [int((deg[b] > rel.window_width).sum()) for b in rows]
    assert n_hub[0] == 0 and n_hub[1] == 5 and n_hub[3] > thub.HUB_CHUNK
    return np.stack(rows)


@pytest.mark.parametrize("chunk,block", [(2, 128), (thub.HUB_CHUNK, 128)])
def test_epoch_plan_bounds_every_batch(skew, chunk, block, monkeypatch):
    """The epoch plan holds as many chunks as the batch with the most hub
    rows fills, each as wide as that chunk's widest head in any batch; it
    comes back in one read-back for all relations, and a graph without
    hubs reads nothing back."""
    gt = skew["gt"]
    rel = gt.relations[0]
    batches = torch.from_numpy(_plan_batches(skew))
    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: reads.append(t.shape) or real(t))
    plans = thub.epoch_hub_plans(gt.relations, batches, chunk, block)
    assert len(reads) == 1
    assert [p is None for p in plans] == [not r.has_hubs
                                          for r in gt.relations]
    plan = plans[0]
    deg = rel.deg.numpy()
    for b in batches.numpy():
        d = np.sort(deg[b][deg[b] > rel.window_width])[::-1]
        assert len(plan) * chunk >= len(d)
        for c in range(-(-len(d) // chunk)):
            assert plan[c] * block >= d[c * chunk]
        own = thub.plan_hub_chunks(rel.deg[torch.from_numpy(b)],
                                   torch.from_numpy(deg[b]
                                                    > rel.window_width),
                                   chunk, block)
        assert thub.plan_covers((plan,), (own,))
    assert len(plan) == -(-max((deg[b] > rel.window_width).sum()
                              for b in batches.numpy()) // chunk)
    tiny = torch_graph("tiny", seed=0)
    assert not any(r.has_hubs for r in tiny.relations)
    reads.clear()
    assert thub.epoch_hub_plans(tiny.relations, batches % tiny.num_nodes) \
        == (None,) * tiny.num_relations
    assert reads == []


def _recording(monkeypatch):
    """Record each hub chunk's fetched ids and keep mask."""
    seen = {"ids": [], "keep": [], "shapes": []}
    gather, switch = thub.ragged_gather, thub.keep_nearest_switch

    def rec_gather(col, starts, d, fill):
        out = gather(col, starts, d, fill)
        seen["ids"].append(out)
        seen["shapes"].append((tuple(starts.shape), d))
        return out

    def rec_switch(dist, kf, jb, block):
        keep = switch(dist, kf, jb, block)
        seen["keep"].append(keep)
        return keep

    monkeypatch.setattr(thub, "ragged_gather", rec_gather)
    monkeypatch.setattr(thub, "keep_nearest_switch", rec_switch)
    return seen


def _hub_call(skew, batch, lane, train, plan, chunk, block, inp):
    relt = skew["gt"].relations[0]
    tb = torch.from_numpy(batch)
    is_hub = relt.deg[tb] > relt.window_width
    if lane == "mean":
        return thub.hub_mean_sum(relt, tb, is_hub,
                                 torch.from_numpy(inp["xs"][:, :inp["f"]]),
                                 chunk=chunk, block=block, plan=plan)
    y = torch.from_numpy(skew["labels"][batch])
    return thub.hub_choose_sum(
        relt, tb, is_hub, torch.from_numpy(inp["xs"]), inp["f"],
        torch.from_numpy(inp["center_s0"]), w0=torch.from_numpy(inp["w0"]),
        b0=torch.tensor(inp["b0"]),
        minor_ctx=(tuple(torch.from_numpy(a) for a in inp["minor_ctx"])
                   if train else None),
        batch_labels=y if train else None, rho=RHO, chunk=chunk,
        block=block, plan=plan)


@pytest.mark.parametrize("lane,train", [("choose", True), ("choose", False),
                                        ("mean", False)])
@pytest.mark.parametrize("chunk,block", [(2, 128), (thub.HUB_CHUNK, 128)])
def test_hub_lane_under_the_epoch_plan(skew, monkeypatch, lane, train, chunk,
                                       block):
    """Each batch's hub lane under the epoch plan (padding chunks and
    rows, wider chunks) equals the lane under the batch's own plan: the
    same ids and keep masks on every hub row, nothing kept past them,
    counts exactly and the float64-rounded sums to 1e-6; and both equal
    the JAX lane (rows on a near tie left out, as above)."""
    relj, relt = skew["gj"].relations[0], skew["gt"].relations[0]
    batches = _plan_batches(skew)
    plan = thub.epoch_hub_plans(skew["gt"].relations,
                                torch.from_numpy(batches), chunk, block)[0]
    seen = _recording(monkeypatch)
    deg = relt.deg.numpy()
    for batch in batches:
        n_hub = int((deg[batch] > relt.window_width).sum())
        sk = dict(skew, batch=batch)
        inp = _hub_inputs(sk, False, train, jax_scores=False)
        got = {}
        for name, p in (("own", None), ("epoch", plan)):
            for v in seen.values():
                v.clear()
            got[name] = _hub_call(skew, batch, lane, train, p, chunk, block,
                                  inp)
            got[name + "_ids"] = list(seen["ids"])
            got[name + "_keep"] = list(seen["keep"])
        assert len(got["epoch_ids"]) == len(plan)
        np.testing.assert_array_equal(got["epoch"][1].numpy(),
                                      got["own"][1].numpy())
        np.testing.assert_allclose(got["epoch"][0].numpy(),
                                   got["own"][0].numpy(), rtol=1e-6,
                                   atol=1e-7)
        if lane == "choose":
            for c, (ids, keep) in enumerate(zip(got["own_ids"],
                                                got["own_keep"])):
                rows = min(chunk, n_hub - c * chunk)
                w = ids.shape[1]
                np.testing.assert_array_equal(
                    got["epoch_ids"][c][:rows, :w].numpy(),
                    ids[:rows].numpy())
                np.testing.assert_array_equal(
                    got["epoch_keep"][c][:rows, :w].numpy(),
                    keep[:rows].numpy())
            for c, keep in enumerate(got["epoch_keep"]):
                own_w = (got["own_keep"][c].shape[1]
                         if c < len(got["own_keep"]) else 0)
                assert not keep[:, own_w:].any()
                assert not keep[max(n_hub - c * chunk, 0):].any()
        # against the JAX lane
        inj = _hub_inputs(sk, False, train, jax_scores=True)
        is_hub = jnp.asarray(deg[batch] > relt.window_width)
        jb = jnp.asarray(batch, jnp.int32)
        if lane == "mean":
            want = jhub.hub_mean_sum(relj, jb, is_hub,
                                     jnp.asarray(inj["xs"][:, :inj["f"]]),
                                     chunk=chunk, block=block)
            ok = np.ones(len(batch), bool)
        else:
            y = skew["labels"][batch]
            want = jhub.hub_choose_sum(
                relj, jb, is_hub, jnp.asarray(inj["xs"]), inj["f"],
                jnp.asarray(inj["center_s0"]), w0=jnp.asarray(inj["w0"]),
                b0=jnp.asarray(inj["b0"]),
                minor_ctx=(tuple(jnp.asarray(a) for a in inj["minor_ctx"])
                           if train else None),
                batch_labels=jnp.asarray(y, jnp.int32) if train else None,
                tp_col=inj["f"] if train else None, rho=RHO, chunk=chunk,
                block=block)
            ok = ~_near_tie_rows(skew["gt"],
                                 _scores64(skew["gt"], skew["params"], False),
                                 batch, y, skew["tp"], train, [relt])
            assert (~ok).sum() <= 2
        for name in ("own", "epoch"):
            num, cnt = got[name][0].numpy(), got[name][1].numpy()
            np.testing.assert_array_equal(cnt[ok], np.asarray(want[1])[ok])
            np.testing.assert_allclose(num[ok], np.asarray(want[0])[ok],
                                       **FWD)


def test_hub_lane_shapes_are_fixed_under_a_plan(skew, monkeypatch):
    """Under one plan, three batches with different hub counts (0, 5 and
    more than a chunk) make the same ragged-gather calls and keep-mask
    shapes, and the same output shapes."""
    batches = _plan_batches(skew)
    plan = thub.epoch_hub_plans(skew["gt"].relations,
                                torch.from_numpy(batches), 2, 128)[0]
    seen = _recording(monkeypatch)
    shapes = []
    for batch in batches[[0, 1, 3]]:
        for v in seen.values():
            v.clear()
        inp = _hub_inputs(dict(skew, batch=batch), False, True,
                          jax_scores=False)
        num, cnt = _hub_call(skew, batch, "choose", True, plan, 2, 128, inp)
        shapes.append((list(seen["shapes"]),
                       [tuple(k.shape) for k in seen["keep"]],
                       tuple(num.shape), tuple(cnt.shape)))
    assert shapes[0] == shapes[1] == shapes[2]
    assert len(shapes[0][0]) == len(plan) > 2


# ------------------------------------------------------------ mirrors

def _one_relation_pair(src, dst, n, cap, feats, labels):
    relj = jcsr.csr_from_edges(src, dst, n, window_cap=cap)
    relt = tcsr.csr_from_edges(src, dst, n, window_cap=cap)
    assert relj.has_hubs and relt.has_hubs
    gj = jcsr.materialize_edge_windows(
        jcsr.build_multirel([relj], relj, feats, labels))
    gt = tcsr.materialize_edge_windows(
        tcsr.build_multirel([relt], relt, feats, labels))
    return relj, gj, gt


def _forward_pair(gj, gt, feats, f, train_pos, batch, labels, seed):
    model_j = JPCGNN(f, 8, 1, ALPHA, RHO)
    params = jax.tree.map(np.asarray, model_j.init(jax.random.key(seed)))
    model_t = TPCGNN(f, 8, 1, ALPHA, RHO)
    model_t.load_state_dict(params_from_jax(params))
    logits_j, _ = model_j.forward(
        params, gj, jnp.asarray(batch, jnp.int32),
        jnp.asarray(labels[batch]), train=True,
        train_pos=jnp.asarray(train_pos, jnp.int32),
        train_pos_valid=jnp.ones(len(train_pos), bool))
    with torch.no_grad():
        logits_t, _ = model_t(
            gt, torch.from_numpy(batch), torch.from_numpy(labels[batch]),
            train=True, train_pos=torch.from_numpy(train_pos),
            train_pos_valid=torch.ones(len(train_pos), dtype=bool))
    return params, logits_j, logits_t


def test_fraud_hub_minor_dedup_parity():
    """Mirror of tests/test_hub.py: a fraud hub whose kept neighbors overlap
    its selected minors.  The port subtracts the duplicates as the JAX lane
    and the reference's set union do, and the subtraction really runs."""
    n, f = 400, 12
    rng = np.random.default_rng(11)
    hub_dst = np.arange(1, 301)
    src = np.concatenate([np.zeros(300, np.int64), np.arange(n)])
    dst = np.concatenate([hub_dst, (np.arange(n) + 1) % n])
    labels = (rng.random(n) < 0.3).astype(np.int64)
    labels[0] = 1
    feats = rng.normal(size=(n, f)).astype(np.float32)
    relj, gj, gt = _one_relation_pair(src, dst, n, 64, feats, labels)
    nb_fraud = hub_dst[labels[hub_dst] == 1]
    others = np.setdiff1d(np.flatnonzero(labels == 1),
                          np.concatenate([[0], nb_fraud]))
    train_pos = np.sort(np.concatenate([nb_fraud[:50], others[:10]]))
    batch = np.concatenate([[0], rng.integers(0, n, 15)])
    params, logits_j, logits_t = _forward_pair(gj, gt, feats, f, train_pos,
                                               batch, labels, 3)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **FWD)
    o_logits, _ = pcgnn_forward_oracle(params, feats, [relj], batch,
                                       labels[batch], train_pos, rho=RHO)
    np.testing.assert_allclose(logits_t.numpy(), o_logits, atol=1e-4)
    # the hub row's count is keff + m less the duplicates it subtracted
    rel = gt.relations[0]
    w = params["label_clf"]
    s = (feats.astype(np.float64) @ w["w"][:, 0] + w["b"][0]).astype(
        np.float32)
    xs = thub.hub_table(gt.features, torch.from_numpy(train_pos),
                        torch.ones(len(train_pos), dtype=torch.bool))
    slot = np.argsort(s[train_pos], kind="stable")
    ctx = (torch.from_numpy(s[train_pos][slot]),
           torch.from_numpy(slot.astype(np.int32)),
           torch.from_numpy(feats[train_pos][slot]))
    tb = torch.from_numpy(batch)
    _, cnt = thub.hub_choose_sum(
        rel, tb, rel.deg[tb] > rel.window_width, xs, f,
        torch.from_numpy(s[batch]), w0=torch.from_numpy(w["w"][:, 0].copy()),
        b0=torch.tensor(w["b"][0]), minor_ctx=ctx,
        batch_labels=torch.from_numpy(labels[batch]), rho=RHO)
    m = min(math.floor(int(rel.ksample[0]) * RHO), len(train_pos))
    assert 0 < cnt[0].item() < int(rel.keff[0]) + m


def test_hub_minor_band_wide_m_and_ties_match_oracle():
    """Mirror of tests/test_hub.py: the hub row asks for far more minors
    than the compact window holds, and coarsely quantized features force
    exact score ties, resolved by candidate position."""
    n, f = 500, 8
    rng = np.random.default_rng(21)
    hub_deg = 360
    src = np.concatenate([np.zeros(hub_deg, np.int64), np.arange(n)])
    dst = np.concatenate([rng.integers(1, n, hub_deg), (np.arange(n) + 1) % n])
    feats = np.round(rng.normal(size=(n, f)), 1).astype(np.float32)
    labels = (rng.random(n) < 0.4).astype(np.int64)
    labels[0] = 1
    relj, gj, gt = _one_relation_pair(src, dst, n, 48, feats, labels)
    train_pos = np.sort(rng.choice(np.flatnonzero(labels == 1), 120,
                                   replace=False))
    m_max = TPCGNN(f, 8, 1, ALPHA, RHO).minor_window(len(train_pos),
                                                     gt.relations)
    assert m_max < 90 and m_max <= 12
    batch = np.concatenate([[0], rng.integers(0, n, 31)])
    params, logits_j, logits_t = _forward_pair(gj, gt, feats, f, train_pos,
                                               batch, labels, 5)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **FWD)
    o_logits, _ = pcgnn_forward_oracle(params, feats, [relj], batch,
                                       labels[batch], train_pos, rho=RHO)
    np.testing.assert_allclose(logits_t.numpy(), o_logits, atol=1e-4)


def test_trainer_trains_on_skew_preset(tmp_path):
    """Mirror of tests/test_hub.py: the port's Trainer runs (pick, steps
    through the hub lane, Adam, validation, restore-best test) on the hub
    preset and gives finite metrics."""
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer

    cfg = dict(seed=2, data_name="synthetic:skew-tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=4,
               valid_epochs=2, batch_size=128, patience=100, exp_num=0)
    t = Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)),
                device="cpu")
    assert t.graph.relations[0].has_hubs
    auc, recall, f1 = t.train()
    assert np.isfinite([auc, recall, f1]).all()
    assert 0.0 <= auc <= 1.0


def test_hub_table_layout_matches_jax_forward():
    """The hub lane's table: exact features, the VALID train positives as
    column F (invalid entries fall into the sliced-away slot N, as in the
    JAX forward), and a zero sentinel row N."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32))
    tp = torch.tensor([1, 3, 3, 7, 0])
    tpv = torch.tensor([True, True, True, False, False])
    xs = thub.hub_table(x, tp, tpv)
    assert xs.shape == (11, 5)
    assert torch.equal(xs[:10, :4], x) and not xs[10].any()
    jmask = jnp.zeros((11,), jnp.float32).at[
        jnp.where(jnp.asarray(tpv.numpy()), jnp.asarray(tp.numpy()), 10)
    ].set(1.0, mode="drop")
    np.testing.assert_array_equal(xs[:10, 4].numpy(), np.asarray(jmask)[:10])
    assert xs[:, 4].nonzero()[:, 0].tolist() == [1, 3]
    assert torch.equal(thub.hub_table(x), torch.cat([x, torch.zeros(1, 4)]))
