"""The full-graph ops and the rest of the ops surface: the port against the
JAX package on the same numpy inputs.

Presets ``tiny``, ``small`` and ``skew-tiny`` (whose relation 0 has hub
rows) from the same seed in both packages, float32 and bfloat16 stores, and
a relation without its dense table.  On the CPU the JAX window gather takes
its XLA fallback and the port's its plain version: both are copies.

Tolerances:
  * exact: ``edge_rows``, the flat and window distances, the ranks (with
    quantized scores, so ties occur), keep masks, candidate ids, slots and
    valid flags, and the dedup thresholds: the same float32 operations on
    the same values, or integer work;
  * rtol 1e-5, atol 1e-6: the means and sums (float32 sums taken in
    another order);
  * atol 1e-5: the edge-window distances, whose neighbor scores the JAX
    package contracts in float32 and the port in float64 rounded once.

The two packages pad the flat edge list to different lengths (a layout of
each), so per-edge results are compared on the real edges, and the port's
padding edges are checked on their own.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcgnn_tpu.ops as jops
import pcgnn_tpu_torch.ops as tops
from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu.ops import aggregate as jagg
from pcgnn_tpu.ops import sddmm as jsd
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.ops import aggregate as tagg
from pcgnn_tpu_torch.ops import sddmm as tsd

MEAN = dict(rtol=1e-5, atol=1e-6)
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_SEEDS = {"tiny": 1, "small": 3, "skew-tiny": 1}


@pytest.fixture(scope="module")
def pairs():
    return {p: (jax_graph(p, seed=s), torch_graph(p, seed=s))
            for p, s in _SEEDS.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _csr_only(rel):
    """The relation without its dense neighbor table (the CSR lane)."""
    return dataclasses.replace(rel, nbr2d=None)


def _relations(pair):
    """(name, JAX relation, port relation) of every relation, the homo
    graph, and relation 1 without its dense table."""
    gj, gt = pair
    out = [(f"rel{r}", rj, rt)
           for r, (rj, rt) in enumerate(zip(gj.relations, gt.relations))]
    out.append(("homo", gj.homo, gt.homo))
    out.append(("csr_only", _csr_only(gj.relations[1]),
                _csr_only(gt.relations[1])))
    return out


def _stored(pair, dtype):
    """(JAX, port) relations with edge-window stores of ``dtype``."""
    gj, gt = pair
    jdt, tdt = _DTYPES[dtype]
    feats = np.asarray(gj.features)
    return [(jcsr.attach_edge_windows(rj, feats, dtype=jdt),
             tcsr.attach_edge_windows(rt, gt.features, dtype=tdt))
            for rj, rt in zip(gj.relations, gt.relations)]


def _edges(a, rel):
    """The real edges' entries of a per-edge [E_pad] array."""
    return _np(a)[:rel.num_edges]


def _keep(k, rel):
    """A per-edge filter of the real edges, padded to the relation's own
    E_pad (padding edges are dropped whatever their flag)."""
    return np.concatenate([k, np.ones(rel.e_pad - len(k), bool)])


def _scores(n, seed, levels=None):
    """[n] float32 scores; quantized to ``levels`` values to make ties."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(n).astype(np.float32)
    if levels:
        s = (rng.integers(0, levels, n) / levels).astype(np.float32)
    return s


@pytest.mark.parametrize("preset", sorted(_SEEDS))
def test_edge_rows_matches_jax(pairs, preset):
    for name, rj, rt in _relations(pairs[preset]):
        got = rt.edge_rows()
        assert got.dtype == torch.int32 and got.shape == (rt.e_pad,), name
        np.testing.assert_array_equal(_edges(got, rt),
                                      _edges(rj.edge_rows(), rj), err_msg=name)
        assert (got.numpy()[rt.num_edges:] == rt.num_nodes).all()


@pytest.mark.parametrize("preset", sorted(_SEEDS))
def test_segment_mean_spmm_matches_jax(pairs, preset):
    """Every lowering the JAX function would pick: the window form where a
    hub-free relation has its dense table, the segment form on hub
    relations, without the table, and with any ``keep`` filter."""
    gj, gt = pairs[preset]
    x = gt.features
    rng = np.random.default_rng(5)
    for name, rj, rt in _relations(pairs[preset]):
        e = rt.num_edges
        keeps = [None, np.ones(e, bool), rng.random(e) < 0.6]
        for k in keeps:
            want = jagg.segment_mean_spmm(
                rj, gj.features,
                None if k is None else jnp.asarray(_keep(k, rj)))
            got = tagg.segment_mean_spmm(
                rt, x, None if k is None else torch.from_numpy(_keep(k, rt)))
            assert got.shape == (rt.num_nodes, gt.feat_dim)
            np.testing.assert_allclose(got.numpy(), _np(want), **MEAN,
                                       err_msg=f"{name} keep={k is not None}")


def test_window_form_equals_segment_form(pairs):
    """The window lowering against the forced segment lowering (an all-true
    ``keep``), in the port, and ``_window_mean_all_nodes`` against the
    JAX function's rows."""
    gj, gt = pairs["small"]
    for rj, rt in zip(gj.relations, gt.relations):
        fp = tagg._pad_row(gt.features)
        win = tagg._window_mean_all_nodes(rt, fp)
        seg = tagg.segment_mean_spmm(rt, gt.features,
                                     torch.ones(rt.e_pad, dtype=torch.bool))
        np.testing.assert_allclose(win.numpy(), seg.numpy(), **MEAN)
        want = jagg._window_mean_all_nodes(rj, jnp.asarray(fp.numpy()))
        np.testing.assert_allclose(win.numpy(), _np(want)[:rt.num_nodes],
                                   **MEAN)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_spmm_ewin_form_matches_jax(pairs, dtype):
    """The edge-window form against the JAX one, and exactly against the
    port's window form on the table the store holds (bf16-rounded in a
    bf16 store): the same values summed the same way."""
    gj, gt = pairs["small"]
    _, tdt = _DTYPES[dtype]
    snap = gt.features.to(tdt).float()
    for rj, rt in _stored(pairs["small"], dtype):
        assert rt.ewin is not None and rj.ewin is not None
        want = jagg.segment_mean_spmm(rj, gj.features,
                                      assume_ewin_features=True)
        got = tagg.segment_mean_spmm(rt, gt.features,
                                     assume_ewin_features=True)
        np.testing.assert_allclose(got.numpy(), _np(want), **MEAN)
        assert torch.equal(got, tagg.segment_mean_spmm(rt, snap))
    # the store holds F columns: another width is refused, as in JAX
    for fn, rel, x in ((jagg.segment_mean_spmm, rj, gj.features[:, 1:]),
                       (tagg.segment_mean_spmm, rt, gt.features[:, 1:])):
        with pytest.raises(ValueError, match="feature width"):
            fn(rel, x, assume_ewin_features=True)


@pytest.mark.parametrize("chunks", [(100, 4096), (1, 333)])
def test_chunk_widths_give_the_same_bits(pairs, monkeypatch, chunks):
    """The node chunk widths of the full-graph mean and of the window
    SDDMM change no value: 100 and 1 leave a ragged last chunk."""
    gj, gt = pairs["tiny"]
    rt = tcsr.attach_edge_windows(gt.relations[1], gt.features,
                                  dtype=torch.bfloat16)
    s0 = torch.from_numpy(_scores(rt.num_nodes, 0))
    w0 = torch.from_numpy(_scores(gt.feat_dim, 1))
    b0 = torch.tensor(0.25)
    runs = []
    for c in chunks:
        monkeypatch.setattr(tagg, "SPMM_NODE_CHUNK", c)
        monkeypatch.setattr(tsd, "SDDMM_NODE_CHUNK", c)
        runs.append([tagg.segment_mean_spmm(rt, gt.features),
                     tagg.segment_mean_spmm(rt, gt.features,
                                            assume_ewin_features=True),
                     *tsd.edge_abs_diff_window(rt, s0),
                     *tsd.edge_abs_diff_window_ewin(rt, s0, w0, b0)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_stub_and_tableless_relations_raise(pairs):
    """A degree-only stub refuses the full-graph mean and the window
    SDDMM, and a relation without its dense table the window SDDMM, with
    the JAX package's messages; neither form needs a store check."""
    gj, gt = pairs["tiny"]
    deg = gt.homo.deg.numpy()
    sj, st = jcsr.degree_stub(deg), tcsr.degree_stub(deg)
    s0 = np.zeros(len(deg), np.float32)
    cases = [(jagg.segment_mean_spmm, tagg.segment_mean_spmm, sj, st,
              (gj.features,), (gt.features,)),
             (jsd.edge_abs_diff_window, tsd.edge_abs_diff_window, sj, st,
              (jnp.asarray(s0),), (torch.from_numpy(s0),)),
             (jsd.edge_abs_diff_window, tsd.edge_abs_diff_window,
              _csr_only(gj.relations[0]), _csr_only(gt.relations[0]),
              (jnp.asarray(s0),), (torch.from_numpy(s0),)),
             (jsd.edge_abs_diff_window_ewin, tsd.edge_abs_diff_window_ewin,
              gj.relations[0], gt.relations[0],
              (jnp.asarray(s0), jnp.zeros(16), jnp.float32(0)),
              (torch.from_numpy(s0), torch.zeros(16), torch.tensor(0.0)))]
    for fj, ft, rj, rt, aj, at in cases:
        with pytest.raises(ValueError) as want:
            fj(rj, *aj)
        with pytest.raises(ValueError) as got:
            ft(rt, *at)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("preset", sorted(_SEEDS))
def test_edge_abs_diff_matches_jax(pairs, preset):
    for name, rj, rt in _relations(pairs[preset]):
        s0 = _scores(rt.num_nodes, 2)
        want = jsd.edge_abs_diff(rj, jnp.asarray(s0))
        got = tsd.edge_abs_diff(rt, torch.from_numpy(s0))
        np.testing.assert_array_equal(_edges(got, rt), _edges(want, rj),
                                      err_msg=name)
        assert np.isinf(got.numpy()[rt.num_edges:]).all()


@pytest.mark.parametrize("preset", sorted(_SEEDS))
def test_edge_abs_diff_window_matches_jax(pairs, preset):
    """The window form, exactly (capped windows on skew-tiny's hub
    relation), and each valid slot equal to the flat form at its edge."""
    for name, rj, rt in _relations(pairs[preset])[:-1]:
        s0 = _scores(rt.num_nodes, 3)
        dj, vj = jsd.edge_abs_diff_window(rj, jnp.asarray(s0))
        dt, vt = tsd.edge_abs_diff_window(rt, torch.from_numpy(s0))
        np.testing.assert_array_equal(vt.numpy(), _np(vj), err_msg=name)
        np.testing.assert_array_equal(dt.numpy(), _np(dj), err_msg=name)
        flat = tsd.edge_abs_diff(rt, torch.from_numpy(s0)).numpy()
        v = vt.numpy()
        pos = (rt.indptr.numpy()[:-1, None]
               + np.arange(v.shape[1])[None, :])[v]
        np.testing.assert_array_equal(dt.numpy()[v], flat[pos])
        assert np.isinf(dt.numpy()[~v]).all()


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_edge_abs_diff_window_ewin_matches_jax(pairs, dtype):
    """Neighbor scores from the store's windows: valid masks exactly,
    distances to atol 1e-5 at valid slots, against the JAX form and
    against the port's window form on the scores of the stored table."""
    gj, gt = pairs["small"]
    _, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(6)
    w0 = (rng.standard_normal(gt.feat_dim) / 4).astype(np.float32)
    b0 = np.float32(0.25)
    snap = gt.features.to(tdt).float()
    s0 = tagg.selection_score(snap, torch.from_numpy(w0), torch.tensor(b0))
    for rj, rt in _stored(pairs["small"], dtype):
        dj, vj = jsd.edge_abs_diff_window_ewin(
            rj, jnp.asarray(s0.numpy()), jnp.asarray(w0), b0)
        dt, vt = tsd.edge_abs_diff_window_ewin(
            rt, s0, torch.from_numpy(w0), torch.tensor(b0))
        v = vt.numpy()
        np.testing.assert_array_equal(v, _np(vj))
        np.testing.assert_allclose(dt.numpy()[v], _np(dj)[v], rtol=0,
                                   atol=1e-5)
        dw, vw = tsd.edge_abs_diff_window(rt, s0)
        assert torch.equal(vw, vt)
        np.testing.assert_allclose(dt.numpy()[v], dw.numpy()[v], rtol=0,
                                   atol=1e-5)
        assert np.isinf(dt.numpy()[~v]).all()


@pytest.mark.parametrize("preset", sorted(_SEEDS))
def test_edge_ranks_global_matches_jax(pairs, preset):
    """Ranks within each row, exactly, on distances from scores quantized
    to 7 values (many ties, broken by edge order)."""
    for name, rj, rt in _relations(pairs[preset]):
        s0 = _scores(rt.num_nodes, 4, levels=7)
        dist = tsd.edge_abs_diff(rt, torch.from_numpy(s0))
        want = jsd.edge_ranks_global(
            rj, jsd.edge_abs_diff(rj, jnp.asarray(s0)))
        got = tsd.edge_ranks_global(rt, dist)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_edges(got, rt), _edges(want, rj),
                                      err_msg=name)
        # padding edges sort last, in edge order
        np.testing.assert_array_equal(got.numpy()[rt.num_edges:],
                                      np.arange(rt.e_pad - rt.num_edges))
        ip, d = rt.indptr.numpy(), dist.numpy()
        for v in (0, 1, rt.num_nodes - 1):
            span = d[ip[v]:ip[v + 1]]
            want_v = np.empty(len(span), int)
            want_v[np.argsort(span, kind="stable")] = np.arange(len(span))
            np.testing.assert_array_equal(got.numpy()[ip[v]:ip[v + 1]],
                                          want_v)


def _batch_inputs(pair, seed):
    gj, gt = pair
    rng = np.random.default_rng(seed)
    n = gt.num_nodes
    batch = rng.integers(0, n, 57).astype(np.int64)
    s0p = np.concatenate([_scores(n, seed, levels=9), [0.0]]).astype(
        np.float32)
    tp = np.sort(rng.choice(n, 40, replace=False)).astype(np.int64)
    tpv = np.arange(40) < 37
    return batch, s0p, tp, tpv


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_choose_keep_mask_matches_jax(pairs, preset):
    gj, gt = pairs[preset]
    batch, s0p, _, _ = _batch_inputs(pairs[preset], 7)
    for rj, rt in zip(gj.relations, gt.relations):
        nbr_j, valid_j = jagg.batch_neighbor_window(rj, jnp.asarray(batch))
        nbr_t, valid_t = tagg.batch_neighbor_window(rt,
                                                    torch.from_numpy(batch))
        want = jagg.choose_keep_mask(rj, jnp.asarray(batch), nbr_j, valid_j,
                                     jnp.asarray(s0p))
        got = tagg.choose_keep_mask(rt, torch.from_numpy(batch), nbr_t,
                                    valid_t, torch.from_numpy(s0p))
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("fn,m_max", [
    ("oversample_candidates", 6),          # windowed branch
    ("oversample_candidates", 25),         # 2 * m_max >= P: dense form
    ("oversample_candidates_dense", 6),    # JAX: top_k
    ("oversample_candidates_dense", 25),   # JAX: one stable sort
    ("oversample_candidates_dense", 50),   # fewer candidates: padded
])
def test_oversample_candidates_id_forms_match_jax(pairs, fn, m_max):
    """The id forms, with scores quantized to 9 values (ties go to the
    lowest slot): ids, valid flags, slots and distances exactly."""
    batch, s0p, tp, tpv = _batch_inputs(pairs["tiny"], 8)
    want = getattr(jagg, fn)(jnp.asarray(batch), jnp.asarray(s0p),
                             jnp.asarray(tp, jnp.int32), jnp.asarray(tpv),
                             m_max)
    got = getattr(tagg, fn)(torch.from_numpy(batch), torch.from_numpy(s0p),
                            torch.from_numpy(tp), torch.from_numpy(tpv), m_max)
    for name, w, g in zip(("ids", "valid", "dist", "slots"), want, got):
        assert g.shape == (len(batch), m_max), name
        np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=name)


_MINORS = ["none", "shared", "per_row"]


def _mean_inputs(seed):
    rng = np.random.default_rng(seed)
    b, d, n, f, m = 23, 17, 60, 8, 9
    xp = np.concatenate([rng.uniform(0.5, 1.5, (n, f)),
                         np.zeros((1, f))]).astype(np.float32)
    nbr = rng.integers(0, n + 1, (b, d)).astype(np.int32)
    keep = rng.random((b, d)) < 0.5
    keep[0] = False                        # a row with no kept neighbor
    return rng, xp, nbr, keep, b, n, m


@pytest.mark.parametrize("minors", _MINORS)
@pytest.mark.parametrize("norm", ["mean", "sqrt"])
def test_window_mean_aggregate_matches_jax(norm, minors):
    rng, xp, nbr, keep, b, n, m = _mean_inputs(11)
    mids = {"none": None, "shared": rng.integers(0, n, m),
            "per_row": rng.integers(0, n, (b, m))}[minors]
    km = None if mids is None else rng.random((b, m)) < 0.5
    want = jagg.window_mean_aggregate(
        jnp.asarray(nbr), jnp.asarray(keep), jnp.asarray(xp),
        None if mids is None else jnp.asarray(mids, jnp.int32),
        None if km is None else jnp.asarray(km), norm=norm)
    got = tagg.window_mean_aggregate(
        torch.from_numpy(nbr), torch.from_numpy(keep), torch.from_numpy(xp),
        None if mids is None else torch.from_numpy(mids),
        None if km is None else torch.from_numpy(km), norm=norm)
    np.testing.assert_allclose(got.numpy(), _np(want), **MEAN)


@pytest.mark.parametrize("minors", ["none", "per_row"])
@pytest.mark.parametrize("norm", ["mean", "sqrt"])
def test_window_mean_from_gathered_matches_jax(norm, minors):
    rng, xp, nbr, keep, b, n, m = _mean_inputs(12)
    xw = xp[nbr]
    mxw = None if minors == "none" else xp[rng.integers(0, n, (b, m))]
    km = None if mxw is None else rng.random((b, m)) < 0.5
    want = jagg.window_mean_from_gathered(
        jnp.asarray(xw), jnp.asarray(keep),
        None if mxw is None else jnp.asarray(mxw),
        None if km is None else jnp.asarray(km), norm=norm)
    got = tagg.window_mean_from_gathered(
        torch.from_numpy(xw), torch.from_numpy(keep),
        None if mxw is None else torch.from_numpy(mxw),
        None if km is None else torch.from_numpy(km), norm=norm)
    np.testing.assert_allclose(got.numpy(), _np(want), **MEAN)
    with pytest.raises(ValueError, match="unknown norm"):
        tagg.window_mean_from_gathered(torch.from_numpy(xw),
                                       torch.from_numpy(keep), norm="max")


@pytest.mark.parametrize("m", [40, tagg.MINOR_CHUNK, 300])
def test_minor_sum_compact_matches_jax(m):
    """M below, at and above ``MINOR_CHUNK`` (blockwise, ragged)."""
    rng = np.random.default_rng(m)
    b, p, f = 19, 70, 12
    tp = rng.uniform(0.5, 1.5, (p, f)).astype(np.float32)
    slots = rng.integers(-2, p + 2, (b, m)).astype(np.int32)
    keep = rng.random((b, m)) < 0.4
    nj, cj = jagg.minor_sum_compact(jnp.asarray(tp), jnp.asarray(slots),
                                    jnp.asarray(keep))
    nt, ct = tagg.minor_sum_compact(torch.from_numpy(tp),
                                    torch.from_numpy(slots),
                                    torch.from_numpy(keep))
    np.testing.assert_allclose(nt.numpy(), _np(nj), **MEAN)
    np.testing.assert_array_equal(ct.numpy(), _np(cj))


@pytest.mark.parametrize("rho", [0.5, 0.3, 1.0])
def test_minor_dedup_threshold_matches_jax(pairs, rho):
    """Exactly, on compact candidate windows of the tiny graph: rows that
    select every valid candidate (+inf), rows that select none (-inf:
    not fraud, or m = 0) and the rest."""
    gj, gt = pairs["tiny"]
    batch, s0p, tp, tpv = _batch_inputs(pairs["tiny"], 9)
    labels = gt.labels.numpy()[batch].astype(np.int32)
    labels[:20] = 1
    rj, rt = gj.relations[2], gt.relations[2]
    ids, valid, dist, _ = tagg.oversample_candidates(
        torch.from_numpy(batch), torch.from_numpy(s0p), torch.from_numpy(tp),
        torch.from_numpy(tpv), 3)
    want = jagg.minor_dedup_threshold(
        rj, jnp.asarray(batch), jnp.asarray(labels),
        jnp.asarray(valid.numpy()), jnp.asarray(dist.numpy()), rho)
    got = tagg.minor_dedup_threshold(rt, torch.from_numpy(batch),
                                     torch.from_numpy(labels), valid, dist,
                                     rho)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    g = got.numpy()
    assert np.isneginf(g).any() and np.isfinite(g).any()
    if rho == 1.0:
        assert np.isposinf(g).any()


def test_ops_surface_matches_jax():
    """``pcgnn_tpu_torch.ops`` exports the names ``pcgnn_tpu.ops`` does."""
    def public(mod):
        return {k for k in vars(mod) if not k.startswith("_")
                and callable(getattr(mod, k))}
    assert public(jops) <= public(tops)
    assert tops.edge_ranks_global is tsd.edge_ranks_global
    assert tops.segment_mean_spmm is tagg.segment_mean_spmm
