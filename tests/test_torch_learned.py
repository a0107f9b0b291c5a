"""The learned-feature lane (trainable node table, dense mask-GEMM): the
port against the JAX package on the same numpy-made inputs.

The JAX side runs as its own tests run it on the CPU: ``scatter_batch_mask``
takes its scatter path there, and the Pallas mask kernel runs in interpret
mode.  On the CPU the port takes the plain version of every kernel.

Tolerances: masks, neighbor ids and valid masks are built from integers and
must be equal.  The float32 contractions run in another order in each
framework, so logits, center scores, aggregates and the loss agree to rtol
1e-5 with atol 1e-6 (FWD), and gradients, which sum over the batch, to rtol
1e-4 with atol 1e-6 (GRAD).  The port rounds its selection scores once from
float64 while the JAX package accumulates them in float32, so a row whose
keep decision sits on a distance gap under 1e-6 could flip on an ulp; such
rows are found from the data, weigh 0 in the loss and are left out of the
row-wise comparisons.
"""

import dataclasses

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
from pcgnn_tpu.ops.pallas.mask_build import build_batch_mask as jax_mask
from pcgnn_tpu.train import checkpoint as jckpt
from pcgnn_tpu.train.results import ResultManager as JResults
from pcgnn_tpu.train.trainer import Trainer as JTrainer
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.interop import params_from_jax, params_to_jax
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.models.pcgnn import PCGNN as TPCGNN
from pcgnn_tpu_torch.ops import aggregate as tagg
from pcgnn_tpu_torch.ops import mask_build
from pcgnn_tpu_torch.train import checkpoint as tckpt
from pcgnn_tpu_torch.train.results import ResultManager as TResults
from pcgnn_tpu_torch.train.trainer import Trainer as TTrainer

EMB, ALPHA, RHO = 12, 2.0, 0.5
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
NEAR_TIE = 1e-6


# ----------------------------------------------------------------- masks --

def _mask_inputs(b, d, n, minors, seed):
    """Window ids with sentinel padding, a duplicate kept pair, a row whose
    slots are all dropped and a row of kept sentinels; minors as [M] or
    [B, M] (or none)."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (b, d)).astype(np.int32)
    keep = rng.random((b, d)) < 0.5
    nbr[:, -1] = n
    keep[:, -1] = False
    if d > 1:
        nbr[0, 1] = nbr[0, 0]
        keep[0, :2] = True
    if b > 2:
        keep[1] = False
        nbr[2] = n
        keep[2] = True
    m = 4
    mids = kmin = None
    if minors == "1d":
        mids = rng.choice(n, m, replace=False).astype(np.int32)
        mids[0] = nbr[0, 0]                 # a minor that is also kept
    elif minors == "2d":
        mids = rng.integers(0, n, (b, m)).astype(np.int32)
        mids[0, 0] = nbr[0, 0]
    if minors:
        kmin = rng.random((b, m)) < 0.5
        kmin[0, 0] = True
        kmin[1:3] = False
    return nbr, keep, mids, kmin


_MASK_CASES = [(8, 5, 40, None), (13, 7, 200, None), (6, 5, 30, "1d"),
               (6, 5, 30, "2d"), (1, 9, 17, "2d"), (5, 1, 7, "1d")]


@pytest.mark.parametrize("b,d,n,minors", _MASK_CASES)
def test_scatter_batch_mask_equals_jax(b, d, n, minors):
    """The port's mask equals the JAX scatter path's and the Pallas
    kernel's (interpret mode) exactly, minors folded in by columns."""
    nbr, keep, mids, kmin = _mask_inputs(b, d, n, minors, b * 100 + d)
    jargs = [jnp.asarray(a) for a in (nbr, keep)]
    targs = [torch.from_numpy(a) for a in (nbr, keep)]
    if minors:
        jargs += [jnp.asarray(mids), jnp.asarray(kmin)]
        targs += [torch.from_numpy(mids), torch.from_numpy(kmin)]
    want = np.asarray(jagg.scatter_batch_mask(n, *jargs))
    got = tagg.scatter_batch_mask(n, *targs)
    assert got.dtype == torch.float32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), want)
    all_ids, all_keep = nbr, keep
    if minors:
        full = np.broadcast_to(mids, kmin.shape) if mids.ndim == 1 else mids
        all_ids = np.concatenate([nbr, full], axis=1)
        all_keep = np.concatenate([keep, kmin], axis=1)
    kern = np.asarray(jax_mask(jnp.asarray(all_ids), jnp.asarray(all_keep),
                               n, interpret=True))
    np.testing.assert_array_equal(got.numpy(), kern)
    if d > 1:
        assert got[0, int(nbr[0, 0])] == 1.0      # duplicates collapse
    if b > 2:
        assert not got[1:3].any()                 # dropped, sentinel rows


def test_scatter_mask_set_semantics():
    nbr = torch.tensor([[1, 2, 2, 5], [0, 5, 5, 5]], dtype=torch.int32)
    keep = torch.tensor([[True, True, True, False],
                         [True, False, False, False]])
    mask = tagg.scatter_batch_mask(5, nbr, keep)
    assert mask.shape == (2, 5)
    assert mask[0].tolist() == [0, 1, 1, 0, 0]
    assert mask[1].tolist() == [1, 0, 0, 0, 0]


def test_mask_plain_version_domain():
    """Ids outside [0, N) set nothing; S = 0 gives zero rows; B = 0 and
    N = 0 give empty masks."""
    nbr = torch.tensor([[-1, 3, 4, 7, 2], [0, -5, 100, 4, 4]],
                       dtype=torch.int32)
    keep = torch.ones_like(nbr, dtype=torch.bool)
    got = mask_build.build_batch_mask(nbr, keep, 4)
    want = torch.tensor([[0, 0, 1, 1], [1, 0, 0, 0]], dtype=torch.float32)
    assert torch.equal(got, want)
    empty_s = torch.zeros((3, 0), dtype=torch.int32)
    assert torch.equal(
        mask_build.build_batch_mask(empty_s, empty_s.bool(), 6),
        torch.zeros((3, 6)))
    assert mask_build.build_batch_mask(nbr[:0], keep[:0], 4).shape == (0, 4)
    assert mask_build.build_batch_mask(nbr, keep, 0).shape == (2, 0)


def test_mask_wrapper_raises_on_bad_arguments():
    nbr = torch.zeros((2, 3), dtype=torch.int32)
    keep = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(TypeError):
        mask_build.build_batch_mask(nbr.long(), keep, 4)
    with pytest.raises(TypeError):
        mask_build.build_batch_mask(nbr, keep.int(), 4)
    with pytest.raises(ValueError):
        mask_build.build_batch_mask(nbr, keep[:, :2], 4)
    with pytest.raises(ValueError):
        mask_build.build_batch_mask(nbr[0], keep[0], 4)
    with pytest.raises(ValueError):
        mask_build.build_batch_mask(nbr, keep, -1)
    # a device that is neither the CPU nor a card is refused, not computed
    with pytest.raises(ValueError, match="unsupported device"):
        mask_build.build_batch_mask(nbr.to("meta"), keep.to("meta"), 4)
    assert mask_build.launches == 0


@pytest.mark.parametrize("norm", ["mean", "sqrt"])
def test_masked_mean_aggregate_equals_jax(norm):
    rng = np.random.default_rng(1)
    mask = (rng.random((9, 40)) < 0.3).astype(np.float32)
    mask[4] = 0.0                                 # an empty row
    x = rng.normal(size=(40, 7)).astype(np.float32)
    want = np.asarray(jagg.masked_mean_aggregate(jnp.asarray(mask),
                                                 jnp.asarray(x), norm=norm))
    got = tagg.masked_mean_aggregate(torch.from_numpy(mask),
                                     torch.from_numpy(x), norm=norm)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    assert not got[4].any()
    with pytest.raises(ValueError, match="norm"):
        tagg.masked_mean_aggregate(torch.from_numpy(mask),
                                   torch.from_numpy(x), norm="max")


def _jax_and_torch_args(nbr, keep, mids, kmin):
    jargs = [jnp.asarray(a) for a in (nbr, keep)]
    targs = [torch.from_numpy(a) for a in (nbr, keep)]
    if mids is not None:
        jargs += [jnp.asarray(mids), jnp.asarray(kmin)]
        targs += [torch.from_numpy(mids), torch.from_numpy(kmin)]
    return jargs, targs


@pytest.mark.parametrize("b,d,n,minors", _MASK_CASES)
def test_mask_counts_equal_jax_row_sums(b, d, n, minors):
    """The counts that come with the mask are the JAX mask's row sums
    exactly: distinct kept ids in [0, N), a minor that is also a kept
    neighbor counted once, all-dropped and sentinel-only rows 0."""
    nbr, keep, mids, kmin = _mask_inputs(b, d, n, minors, b * 100 + d)
    jargs, targs = _jax_and_torch_args(nbr, keep, mids, kmin)
    want = np.asarray(jnp.sum(jagg.scatter_batch_mask(n, *jargs), 1))
    mask, counts = tagg.scatter_batch_mask_counts(n, *targs)
    assert counts.dtype == torch.float32 and counts.shape == (b,)
    np.testing.assert_array_equal(counts.numpy(), want)
    assert torch.equal(counts, mask.sum(1))
    if b > 2:
        assert not counts[1:3].any()


@pytest.mark.parametrize("b,d,n,minors",
                         [c for c in _MASK_CASES if c[3] is not None])
def test_two_group_mask_equals_concatenated(b, d, n, minors):
    """The window and the minors passed as two column groups give the mask
    and counts of one build over the concatenated columns, and the JAX
    package's mask exactly."""
    nbr, keep, mids, kmin = _mask_inputs(b, d, n, minors, b * 100 + d + 1)
    jargs, targs = _jax_and_torch_args(nbr, keep, mids, kmin)
    mask, counts = mask_build.build_batch_mask_counts(
        *targs[:2], n, *targs[2:])
    full = np.broadcast_to(mids, kmin.shape) if mids.ndim == 1 else mids
    cat_mask, cat_counts = mask_build.build_batch_mask_counts(
        torch.from_numpy(np.concatenate([nbr, full], 1)),
        torch.from_numpy(np.concatenate([keep, kmin], 1)), n)
    assert torch.equal(mask, cat_mask) and torch.equal(counts, cat_counts)
    want = np.asarray(jagg.scatter_batch_mask(n, *jargs))
    np.testing.assert_array_equal(mask.numpy(), want)
    if d > 1:     # the duplicate minor, kept in both groups, gives one 1.0
        assert mask[0, int(nbr[0, 0])] == 1.0


@pytest.mark.parametrize("norm", ["mean", "sqrt"])
def test_masked_mean_aggregate_with_counts_equals_jax(norm):
    """With the build's counts passed in, the product divided by them
    equals the JAX package's scaled-mask GEMM to FWD, and the counts, not
    a row sum of the mask, set the divisor."""
    nbr, keep, mids, kmin = _mask_inputs(11, 6, 50, "2d", 5)
    jargs, targs = _jax_and_torch_args(nbr, keep, mids, kmin)
    x = np.random.default_rng(2).normal(size=(50, 7)).astype(np.float32)
    want = np.asarray(jagg.masked_mean_aggregate(
        jagg.scatter_batch_mask(50, *jargs), jnp.asarray(x), norm=norm))
    mask, counts = tagg.scatter_batch_mask_counts(50, *targs)
    xt = torch.from_numpy(x)
    got = tagg.masked_mean_aggregate(mask, xt, norm=norm, counts=counts)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    assert not got[1:3].any()                     # empty rows stay 0
    doubled = tagg.masked_mean_aggregate(mask, xt, norm=norm,
                                         counts=4 * counts)
    scale = 4.0 if norm == "mean" else 2.0
    rows = counts >= 1
    torch.testing.assert_close(doubled[rows] * scale, got[rows], **FWD)


def test_mask_wrapper_raises_on_bad_minors():
    nbr = torch.zeros((2, 3), dtype=torch.int32)
    keep = torch.ones((2, 3), dtype=torch.bool)
    mids = torch.zeros(4, dtype=torch.int32)
    kmin = torch.ones((2, 4), dtype=torch.bool)
    for args, err in [((mids, None), ValueError),          # one without other
                      ((mids.long(), kmin), TypeError),
                      ((mids, kmin.int()), TypeError),
                      ((mids[:3], kmin), ValueError),       # M differs
                      ((mids, kmin[:1]), ValueError),       # B differs
                      ((mids.view(2, 2), kmin), ValueError),
                      ((mids, kmin[0]), ValueError)]:
        with pytest.raises(err):
            mask_build.build_batch_mask_counts(nbr, keep, 4, *args)
    mask, counts = mask_build.build_batch_mask_counts(
        nbr, keep, 4, mids.view(1, 4).expand(2, 4).contiguous(), kmin)
    assert mask[:, 0].tolist() == [1.0, 1.0] and counts.tolist() == [1, 1]
    assert mask_build.launches == 0


def test_window_path_equals_mask_path():
    """The frozen lane's scatter-free sums (window + deduplicated minors)
    equal the learned lane's mask GEMM on the same selection."""
    rng = np.random.default_rng(3)
    n, b, d, p, f = 30, 6, 5, 8, 4
    # CSR windows hold distinct ids; a minor may repeat a kept neighbor
    nbr = torch.from_numpy(np.stack([rng.choice(n, d, replace=False)
                                     for _ in range(b)]).astype(np.int32))
    keep = torch.from_numpy(rng.random((b, d)) < 0.6)
    minor_ids = torch.from_numpy(rng.choice(n, p, replace=False)
                                 .astype(np.int32))
    if nbr[0, 0] not in minor_ids:
        minor_ids[0] = nbr[0, 0]
    keep[0, 0] = True
    keep_minor = torch.from_numpy(rng.random((b, p)) < 0.5)
    keep_minor[0, 0] = True
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))

    mask = tagg.scatter_batch_mask(n, nbr, keep, minor_ids, keep_minor)
    want = tagg.masked_mean_aggregate(mask, x)

    cand_ids = minor_ids[None, :].expand(b, p)
    km = tagg.dedup_minor_keep(nbr, keep, n, cand_ids, keep_minor)
    x_pad = torch.cat([x, x.new_zeros((1, f))])
    num, cnt = tagg.window_sum_from_gathered(x_pad[nbr.long()], keep)
    slots = torch.arange(p, dtype=torch.int32)[None, :].expand(b, p)
    [(mn, mc)] = tagg.minor_sum_compact_multi(x[minor_ids.long()], slots,
                                              [km])
    got = (num + mn) / (cnt + mc).clamp(min=1.0)[:, None]
    torch.testing.assert_close(got, want, **FWD)


# ------------------------------------------------------ neighbor windows --

@pytest.mark.parametrize("branch", ["dense", "csr"])
def test_batch_neighbor_window_equals_jax(monkeypatch, branch):
    """Both branches give the JAX package's ids and valid masks exactly;
    the CSR branch runs when the dense table is over its budget."""
    if branch == "csr":
        monkeypatch.setattr(jcsr, "NBR2D_BUDGET_BYTES", 8)
        monkeypatch.setattr(tcsr, "NBR2D_BUDGET_BYTES", 8)
    gj, gt = jax_graph("tiny", seed=1), torch_graph("tiny", seed=1)
    rng = np.random.default_rng(0)
    for rj, rt in zip((*gj.relations, gj.homo), (*gt.relations, gt.homo)):
        assert (rt.nbr2d is None) == (rj.nbr2d is None) == (branch == "csr")
        deg = rt.deg.numpy()
        # duplicates, the last node (its window reaches the end of col) and
        # the widest row
        batch = np.concatenate([rng.integers(0, rt.num_nodes, 61), [5, 5],
                                [rt.num_nodes - 1, int(np.argmax(deg))]])
        nj, vj = jagg.batch_neighbor_window(rj, jnp.asarray(batch, jnp.int32))
        nt, vt = tagg.batch_neighbor_window(rt, torch.from_numpy(batch))
        assert nt.dtype == torch.int32 and vt.dtype == torch.bool
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_batch_neighbor_window_guards():
    g = torch_graph("skew-tiny", seed=1)
    rel = g.relations[0]
    assert rel.has_hubs
    batch = torch.arange(8)
    with pytest.raises(ValueError, match="hub-aware"):
        tagg.batch_neighbor_window(rel, batch)
    nbr, valid = tagg.batch_neighbor_window(rel, batch, allow_capped=True)
    assert nbr.shape == valid.shape == (8, rel.window_width)
    stub = dataclasses.replace(torch_graph("tiny").relations[0], is_stub=True)
    with pytest.raises(ValueError, match="stub"):
        tagg.batch_neighbor_window(stub, batch)


# ---------------------------------------------------------------- model --

@pytest.fixture(scope="module")
def learned():
    gj, gt = jax_graph("tiny", seed=0), torch_graph("tiny", seed=0)
    labels = np.asarray(gj.labels)
    idx_train, _, _ = stratified_splits(labels, 0.4, 0.67, 2)
    tp = idx_train[labels[idx_train] == 1]
    model_j = JPCGNN(gj.feat_dim, EMB, gj.num_relations, ALPHA, RHO,
                     learn_features=True)
    params = jax.tree.map(np.array, model_j.init(jax.random.key(0),
                                                 features=gj.features))
    # a table that has moved away from the features: selection must score
    # the current table, not the dataset features
    rng = np.random.default_rng(7)
    params["embed"] += 0.3 * rng.normal(size=params["embed"].shape).astype(
        np.float32)
    batch = np.concatenate([rng.choice(idx_train, 58), [0, 0, 0]])
    weight = np.concatenate([np.ones(58, np.float32), np.zeros(3, np.float32)])
    return dict(gj=gj, gt=gt, labels=labels, tp=tp, model_j=model_j,
                params=params, batch=batch, weight=weight)


def _torch_learned(s):
    m = TPCGNN(s["gt"].feat_dim, EMB, s["gt"].num_relations, ALPHA, RHO,
               learn_features=True, features=s["gt"].features)
    m.load_state_dict(params_from_jax(s["params"]))
    return m


def _near_tie_rows(s, train: bool) -> np.ndarray:
    """Rows whose choose or oversample decision sits on a distance gap
    under NEAR_TIE, scored in float64 from the current table."""
    w = s["params"]["label_clf"]
    x = s["params"]["embed"].astype(np.float64)
    sc = x @ w["w"][:, 0].astype(np.float64) + float(w["b"][0])
    batch, labels = s["batch"], s["labels"]
    flag = np.zeros(len(batch), bool)

    def gap_at(dists, k):
        ds = np.sort(dists)
        return 0 < k < len(ds) and ds[k] - ds[k - 1] < NEAR_TIE

    for rel in s["gt"].relations:
        deg, keff = rel.deg.numpy(), rel.keff.numpy()
        nbr2d, ks = rel.nbr2d.numpy(), rel.ksample.numpy()
        for i, v in enumerate(batch):
            flag[i] |= gap_at(np.abs(sc[v] - sc[nbr2d[v, :deg[v]]]), keff[v])
            if train and labels[v] == 1:
                m = int(np.floor(np.float32(ks[v]) * np.float32(RHO)))
                flag[i] |= gap_at(np.abs(sc[v] - sc[s["tp"]]), m)
    return flag


def _rows_close(got, want, rows):
    np.testing.assert_allclose(got.detach().numpy()[rows],
                               np.asarray(want)[rows], **FWD)


def test_learned_train_forward_loss_and_grads_equal_jax(learned):
    s = learned
    model_j, params, tp = s["model_j"], s["params"], s["tp"]
    model_t = _torch_learned(s)
    ties = _near_tie_rows(s, train=True)
    assert ties.sum() <= 3, ties.sum()
    w = np.where(ties, 0.0, s["weight"]).astype(np.float32)
    batch, y = s["batch"], s["labels"][s["batch"]]
    jkw = dict(train_pos=jnp.asarray(tp, jnp.int32),
               train_pos_valid=jnp.ones(len(tp), bool))
    tkw = dict(train_pos=torch.from_numpy(tp),
               train_pos_valid=torch.ones(len(tp), dtype=bool))
    jb, jy = jnp.asarray(batch, jnp.int32), jnp.asarray(y, jnp.int32)
    tb, ty = torch.from_numpy(batch), torch.from_numpy(y)

    logits_j, scores_j = jax.jit(lambda p: model_j.forward(
        p, s["gj"], jb, jy, train=True, **jkw))(params)
    logits_t, scores_t = model_t(s["gt"], tb, ty, train=True, **tkw)
    _rows_close(logits_t, logits_j, ~ties)
    _rows_close(scores_t, scores_j, ~ties)

    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: model_j.loss(
        p, s["gj"], jb, jy, jnp.asarray(w), **jkw)))(params)
    loss_t = model_t.loss(s["gt"], tb, ty, torch.from_numpy(w), **tkw)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **FWD)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    got = {k: p.grad for k, p in model_t.named_parameters()}
    assert set(got) == set(want) and "embed" in got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **GRAD,
                                   err_msg=k)


def test_learned_eval_probs_equal_jax(learned):
    s = learned
    keep = ~_near_tie_rows(s, train=False)
    pj = jax.jit(lambda p: s["model_j"].to_prob(
        p, s["gj"], jnp.asarray(s["batch"], jnp.int32)))(s["params"])
    with torch.no_grad():
        pt = _torch_learned(s).to_prob(s["gt"], torch.from_numpy(s["batch"]))
    for got, want in zip(pt, pj):
        _rows_close(got, want, keep)


def test_learned_forward_equals_frozen_at_init():
    """At init the table is the features, so the learned lane equals the
    frozen window lane with float32 stores (same selection; the mask's set
    semantics is the frozen lane's minor dedup)."""
    g = torch_graph("tiny", seed=0)
    gen = torch.Generator().manual_seed(0)
    frozen = TPCGNN(g.feat_dim, 16, 3, ALPHA, RHO, generator=gen)
    model = TPCGNN(g.feat_dim, 16, 3, ALPHA, RHO, learn_features=True,
                   features=g.features)
    model.load_state_dict(dict(frozen.state_dict(), embed=g.features))
    stores = tcsr.materialize_edge_windows(g, dtype=torch.float32)
    rng = np.random.default_rng(3)
    batch = torch.from_numpy(rng.integers(0, g.num_nodes, 48))
    y = g.labels[batch]
    tp = torch.nonzero(g.labels == 1)[:24, 0]
    kw = dict(train_pos=tp, train_pos_valid=torch.ones(len(tp), dtype=bool))
    with torch.no_grad():
        l1, c1 = model(g, batch, y, train=True, **kw)
        l0, c0 = frozen(stores, batch, y, train=True, **kw)
    torch.testing.assert_close(c1, c0, **FWD)
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)


def test_learned_forward_through_the_csr_branch(monkeypatch):
    """With the dense neighbor table over its budget the learned lane reads
    its windows from the CSR and gives the table's logits exactly (the ids
    are the same); against the JAX package on that graph as well."""
    monkeypatch.setattr(jcsr, "NBR2D_BUDGET_BYTES", 8)
    monkeypatch.setattr(tcsr, "NBR2D_BUDGET_BYTES", 8)
    gj, gt = jax_graph("tiny", seed=0), torch_graph("tiny", seed=0)
    monkeypatch.undo()
    dense = torch_graph("tiny", seed=0)
    assert all(r.nbr2d is None for r in gt.relations)
    model_j = JPCGNN(gt.feat_dim, EMB, 3, ALPHA, RHO, learn_features=True)
    params = jax.tree.map(np.asarray, model_j.init(jax.random.key(2),
                                                   features=gj.features))
    model_t = TPCGNN(gt.feat_dim, EMB, 3, ALPHA, RHO, learn_features=True,
                     features=gt.features)
    model_t.load_state_dict(params_from_jax(params))
    batch = np.random.default_rng(4).integers(0, gt.num_nodes, 40)
    with torch.no_grad():
        got = model_t(gt, torch.from_numpy(batch), None, train=False)
        want = model_t(dense, torch.from_numpy(batch), None, train=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    logits_j, _ = jax.jit(lambda p: model_j.forward(
        p, gj, jnp.asarray(batch, jnp.int32), None, train=False))(params)
    s = dict(params=params, batch=batch, labels=np.asarray(gj.labels),
             gt=dense, tp=np.zeros(0, np.int64))
    _rows_close(got[0], logits_j, ~_near_tie_rows(s, train=False))


def test_gradients_reach_neighbor_only_rows():
    """Gradients reach embed rows that enter the loss only as aggregated
    neighbors (not as centers, not as candidate minors)."""
    g = torch_graph("tiny", seed=0)
    model = TPCGNN(g.feat_dim, 16, 3, ALPHA, RHO, learn_features=True,
                   features=g.features,
                   generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.integers(0, g.num_nodes, 32))
    tp = torch.nonzero(g.labels == 1)[:24, 0]
    model.loss(g, batch, g.labels[batch], train_pos=tp,
               train_pos_valid=torch.ones(len(tp), dtype=bool)).backward()
    ge = model.embed.grad
    assert torch.isfinite(ge).all()
    nbr_only = set()
    for rel in g.relations:
        for v in batch.tolist():
            nbr_only.update(rel.col[rel.indptr[v]:rel.indptr[v + 1]].tolist())
    nbr_only -= set(batch.tolist()) | set(tp.tolist())
    rows = sorted(nbr_only)
    assert rows, "test graph degenerate"
    assert ge[rows].abs().sum(1).gt(0).any(), \
        "no gradient reached neighbor-only rows"
    # the label classifier learns only through the center scores, and
    # every parameter gets a gradient
    assert all(p.grad is not None for p in model.parameters())


def test_learned_rejects_capped_relations_and_needs_a_table():
    g = torch_graph("skew-tiny", seed=3)
    model = build_model("PCGNN", feat_dim=g.feat_dim, emb_dim=8,
                        num_relations=3, alpha=ALPHA, rho=RHO,
                        learn_features=True, features=g.features)
    with pytest.raises(ValueError, match="hub"):
        model(g, torch.arange(8), torch.zeros(8, dtype=torch.int64),
              train=True, train_pos=torch.arange(4),
              train_pos_valid=torch.ones(4, dtype=bool))
    with pytest.raises(ValueError, match="features"):
        TPCGNN(16, 8, 3, ALPHA, RHO, learn_features=True)


# -------------------------------------------------------------- trainer --

def _cfg(**kw):
    cfg = dict(seed=2, data_name="synthetic:tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=4,
               valid_epochs=2, batch_size=64, patience=100, exp_num=0,
               learn_features=True)
    cfg.update(kw)
    return cfg


def test_trainer_learn_features_end_to_end(tmp_path):
    cfg = _cfg()
    t = TTrainer(cfg, device="cpu", result=TResults(cfg, root=str(tmp_path)))
    # no stores: the learned lane reads the trainable table
    assert t.graph.fused is None
    assert all(r.ewin is None for r in t.graph.relations)
    assert "tpf" not in t.consts
    auc, recall, f1 = t.train()
    assert np.isfinite([auc, recall, f1]).all()
    assert t.model.learn_features
    moved = (t.model.embed.detach() - t.graph.features).abs().max()
    assert float(moved) > 1e-3
    ckpt = tckpt.load_checkpoint(t.result.model_path)
    assert ckpt["embed"].shape == tuple(t.graph.features.shape)
    np.testing.assert_array_equal(ckpt["embed"], t.model.embed.detach())


def test_one_step_matches_jax_step1(tmp_path):
    """One Adam step of each trainer from the same params (the table
    included), batch and weights.  Loss rtol 1e-5, gradients GRAD.  The
    first Adam step moves a weight by lr * g / (|g| + 1e-8); weight decay
    keeps every table gradient away from 0, so parameters agree to 1e-5."""
    cfg = _cfg()
    jt = JTrainer(cfg, result=JResults(cfg, root=str(tmp_path / "jax")))
    tt = TTrainer(cfg, device="cpu",
                  result=TResults(cfg, root=str(tmp_path / "torch")))
    np.testing.assert_array_equal(tt.train_pos, jt.train_pos)
    params = jt.model.init(jax.random.key(1), features=jt.graph.features)
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
    grads_j = jax.jit(jax.grad(lambda p: jt.model.loss(
        p, jt._step_graph, jb, jy, jw, train_pos=c["tp"],
        train_pos_valid=c["tpv"])))(params)

    model = tt.new_model()
    assert torch.equal(model.embed.detach(), tt.graph.features)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    opt = tt.new_optimizer(model)
    loss_t = tt.step(model, opt, torch.from_numpy(batch), torch.from_numpy(y),
                     torch.from_numpy(w))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    gj = params_from_jax(jax.tree.map(np.asarray, grads_j))
    pj = params_from_jax(jax.tree.map(np.asarray, new_j))
    assert "embed" in gj
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[k].numpy(), **GRAD,
                                   err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), pj[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_learned_checkpoints_load_across_packages(tmp_path):
    feats = np.random.default_rng(0).normal(size=(40, 16)).astype(np.float32)
    params = jax.tree.map(np.asarray, JPCGNN(
        16, 8, 3, 2.0, 0.5, learn_features=True).init(jax.random.key(4),
                                                      features=feats))
    jckpt.save_checkpoint(str(tmp_path / "j.ckpt"), params)
    model = TPCGNN(16, 8, 3, 2.0, 0.5, learn_features=True,
                   features=torch.zeros(40, 16))
    model.load_state_dict(params_from_jax(
        tckpt.load_checkpoint(str(tmp_path / "j.ckpt"))))
    np.testing.assert_array_equal(model.embed.detach().numpy(), feats)
    tckpt.save_checkpoint(str(tmp_path / "t.ckpt"), params_to_jax(model))
    back = jckpt.load_checkpoint(str(tmp_path / "t.ckpt"))
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
