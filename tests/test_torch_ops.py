"""Selection and aggregation ops: the port against the JAX package on the
same numpy inputs.

Selection (keep masks, candidate ids, slots, valid flags and the distances
the candidates were sorted by) is exact: the same values go through the same
comparisons and tie rules.  The sums are float32 contractions taken in
another order by each framework; their inputs are positive here, so no sum
cancels and rtol 1e-6 bounds the difference.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgnn_tpu.ops import aggregate as jagg
from pcgnn_tpu_torch.ops import aggregate as tagg

_INF = np.float32(np.inf)


def _tied_dist(rng, b, d):
    """[b, d] distances from four values (many ties), +inf past each row's
    random valid prefix, and per-row keep counts k in [0, d + 1]."""
    dist = rng.choice(np.float32([0.0, 0.5, 1.0, 1.5]), size=(b, d))
    deg = rng.integers(0, d + 1, b)
    valid = np.arange(d)[None, :] < deg[:, None]
    dist = np.where(valid, dist, _INF).astype(np.float32)
    k = rng.integers(0, d + 2, b).astype(np.int32)
    return dist, k, valid


@pytest.mark.parametrize("b,d", [(50, 17), (7, 1), (33, 212)])
def test_keep_nearest_matches_jax_and_rank_rule(b, d):
    rng = np.random.default_rng(d)
    dist, k, valid = _tied_dist(rng, b, d)
    want = np.asarray(jagg.keep_nearest(jnp.asarray(dist), jnp.asarray(k),
                                        jnp.asarray(valid)))
    ranks_j = np.asarray(jagg.row_ranks(jnp.asarray(dist)))
    got = tagg.keep_nearest(torch.from_numpy(dist), torch.from_numpy(k),
                            torch.from_numpy(valid)).numpy()
    ranks_t = tagg.row_ranks(torch.from_numpy(dist)).numpy()
    np.testing.assert_array_equal(ranks_t, ranks_j)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, valid & (ranks_t < k[:, None]))


def _candidates(rng, p, n_valid, b, levels):
    """Train-positive scores quantized to ``levels`` values (ties inside and
    across the window) with the last ``p - n_valid`` slots invalid."""
    cand_s0 = (rng.integers(0, levels, p) / levels).astype(np.float32)
    center = (rng.integers(0, levels, b) / levels).astype(np.float32)
    tp = rng.choice(10_000, p, replace=False).astype(np.int64)
    tpv = np.arange(p) < n_valid
    return center, cand_s0, tp, tpv


def _run_both(fn_name, center, cand_s0, tp, tpv, m_max):
    want = getattr(jagg, fn_name)(jnp.asarray(center), jnp.asarray(cand_s0),
                                  jnp.asarray(tp, jnp.int32), jnp.asarray(tpv),
                                  m_max)
    got = getattr(tagg, fn_name)(torch.from_numpy(center),
                                 torch.from_numpy(cand_s0),
                                 torch.from_numpy(tp), torch.from_numpy(tpv),
                                 m_max)
    for name, w, g in zip(("ids", "valid", "dist", "slots"), want, got):
        assert g.shape == (len(center), m_max), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    return got


@pytest.mark.parametrize("p,n_valid,m_max,levels", [
    (300, 280, 7, 40),      # windowed branch, heavy ties
    (1000, 1000, 53, 997),  # windowed, the yelp-like m_max
    (10, 9, 6, 5),          # 2*m_max >= p: dense branch
    (4, 3, 6, 3),           # fewer candidates than m_max: padded
])
def test_oversample_candidates_match_jax(p, n_valid, m_max, levels):
    rng = np.random.default_rng(p + m_max)
    args = _candidates(rng, p, n_valid, 61, levels)
    ids, valid, dist, slots = _run_both("oversample_candidates_values", *args,
                                        m_max)
    # valid slots point at the ids they carry, and distances ascend
    tp = torch.from_numpy(args[2]).to(torch.int32)
    assert torch.equal(tp[slots.long()][valid], ids[valid])
    assert (dist[:, 1:] >= dist[:, :-1]).all()


@pytest.mark.parametrize("p,m_max", [(50, 6), (12, 6)])
def test_oversample_candidates_dense_matches_jax(p, m_max):
    """The dense form itself (JAX: top_k below the switch, one stable sort
    above it; the port: one stable sort) keeps the lowest slot on ties."""
    rng = np.random.default_rng(p)
    _run_both("oversample_candidates_dense_values",
              *_candidates(rng, p, p - 2, 29, 7), m_max)


@pytest.mark.parametrize("rho", [0.5, 0.3, 0.7])
def test_oversample_keep_matches_jax(rho):
    rng = np.random.default_rng(0)
    b, m = 64, 12
    ksample = rng.integers(0, 30, b).astype(np.int32)
    labels = rng.integers(0, 2, b).astype(np.int32)
    cand_valid = rng.random((b, m)) < 0.9
    want = jagg.oversample_keep(None, None, jnp.asarray(labels),
                                jnp.asarray(cand_valid), rho,
                                ksample_b=jnp.asarray(ksample))
    got = tagg.oversample_keep(None, None, torch.from_numpy(labels),
                               torch.from_numpy(cand_valid), rho,
                               ksample_b=torch.from_numpy(ksample))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [40, tagg.MINOR_CHUNK, 300])
def test_dedup_minor_keep_matches_jax(m):
    assert tagg.MINOR_CHUNK == jagg.MINOR_CHUNK
    rng = np.random.default_rng(m)
    b, d, n = 24, 19, 60
    nbr = rng.integers(0, n + 1, (b, d)).astype(np.int32)
    keep = rng.random((b, d)) < 0.6
    cand = rng.integers(0, n, (b, m)).astype(np.int32)
    keep_minor = rng.random((b, m)) < 0.7
    want = jagg.dedup_minor_keep(jnp.asarray(nbr), jnp.asarray(keep), n,
                                 jnp.asarray(cand), jnp.asarray(keep_minor))
    got = tagg.dedup_minor_keep(torch.from_numpy(nbr), torch.from_numpy(keep),
                                n, torch.from_numpy(cand),
                                torch.from_numpy(keep_minor))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) != keep_minor).any()   # some duplicates dropped


def test_window_sum_from_gathered_matches_jax():
    rng = np.random.default_rng(1)
    xw = rng.uniform(0.5, 1.5, (37, 49, 32)).astype(np.float32)
    keep = rng.random((37, 49)) < 0.5
    num_j, cnt_j = jagg.window_sum_from_gathered(jnp.asarray(xw),
                                                 jnp.asarray(keep))
    num_t, cnt_t = tagg.window_sum_from_gathered(torch.from_numpy(xw),
                                                 torch.from_numpy(keep))
    np.testing.assert_allclose(num_t.numpy(), np.asarray(num_j), rtol=1e-6)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))


@pytest.mark.parametrize("m", [53, 300])
def test_minor_sum_compact_multi_matches_jax(m):
    rng = np.random.default_rng(m)
    b, p, f = 29, 80, 16
    tp = rng.uniform(0.5, 1.5, (p, f)).astype(np.float32)
    slots = rng.integers(-3, p + 3, (b, m)).astype(np.int32)   # clamped
    keeps = [rng.random((b, m)) < q for q in (0.2, 0.5, 0.9)]
    want = jagg.minor_sum_compact_multi(jnp.asarray(tp), jnp.asarray(slots),
                                        [jnp.asarray(k) for k in keeps])
    got = tagg.minor_sum_compact_multi(torch.from_numpy(tp),
                                       torch.from_numpy(slots),
                                       [torch.from_numpy(k) for k in keeps])
    assert len(got) == 3
    for (nj, cj), (nt, ct) in zip(want, got):
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-6)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def _grid_graph(preset, store):
    """The preset's graph with features on a grid of quarters (plus 2^-10
    on the features the score weighs, under a float32 store among
    bfloat16 ones, so rounding to bfloat16 moves them) and the stores of
    ``store``: every score and sum below is exact in float32, so both
    packages rank the same distances, with many ties."""
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.graph import csr
    g = synthetic_fraud_graph(preset, seed=5)
    x = (g.features * 4).round().clamp(-8, 8) / 4
    if store == "mixed":
        x[:, :3] += 2.0 ** -10
    g = dataclasses.replace(g, features=x)
    dtype = torch.bfloat16 if store == "bfloat16" else torch.float32
    return csr.materialize_edge_windows(g, dtype=dtype)


@pytest.mark.parametrize("preset,store", [
    ("tiny", "bfloat16"), ("small", "float32"), ("skew-tiny", "bfloat16"),
    ("tiny", "mixed")])
def test_choose_window_sum_matches_jax(preset, store):
    """The port's choose of a relation's window (``choose_window_sum``, the
    plain version on the CPU) against the JAX package's score,
    ``keep_nearest`` and ``window_sum_from_gathered`` of the same window:
    the store's real windows (slots past a row's degree hold the next
    node's run; self-loops at distance 0; skew-tiny's hub rows), and rows
    edited to k = 0, k at and above the valid count, degree 0 and forced
    hub rows.  Keep masks and counts are exact, sums within rtol 1e-6."""
    g = _grid_graph(preset, store)
    rng = np.random.default_rng(len(preset))
    n, f = g.features.shape
    batch = torch.from_numpy(rng.choice(n, min(n, 400), replace=False))
    w0 = torch.zeros(f)
    w0[:3] = torch.tensor([0.5, -0.5, 0.5])
    b0 = torch.tensor(0.125)
    rnd = store != "float32"
    centers = g.features[batch]
    if rnd:
        centers = centers.to(torch.bfloat16).to(torch.float32)
    center_s0 = tagg.selection_score(centers, w0, b0)
    rec = tagg.batch_record_window(g, batch)
    for r, rel in enumerate(g.relations):
        d = max(rel.window_width, 1)
        raw = rec[:, g.fused_off[r]: g.fused_off[r + 1]]
        deg = rel.deg[batch].clone()
        keff = rel.keff[batch].clone()
        keff[10:15] = 0
        keff[15:20] = deg[15:20].clamp(max=d)
        keff[20:25] = d + 1
        deg[25:30] = 0
        deg[30:35] = d + 3                     # hub rows, kept out
        hub_cap = rel.window_width
        num, cnt, keep = tagg.choose_window_sum(
            raw, d, f, center_s0, w0, b0, deg, keff, hub_cap=hub_cap,
            round_bf16=store == "mixed")
        xw = raw[:, : d * f].reshape(-1, d, f).numpy()
        rows = jnp.asarray(xw)
        if store == "mixed":
            rows = rows.astype(jnp.bfloat16).astype(jnp.float32)
        s = jnp.dot(rows, jnp.asarray(w0.numpy()),
                    precision="highest") + float(b0)
        degn = deg.numpy()
        valid = ((np.arange(d)[None, :] < np.minimum(degn, d)[:, None])
                 & (degn <= hub_cap)[:, None])
        dist = jnp.where(jnp.asarray(valid),
                         jnp.abs(jnp.asarray(center_s0.numpy())[:, None] - s),
                         jnp.inf)
        want = jagg.keep_nearest(dist, jnp.asarray(keff.numpy()),
                                 jnp.asarray(valid))
        num_j, cnt_j = jagg.window_sum_from_gathered(jnp.asarray(xw), want)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
        np.testing.assert_allclose(num.numpy(), np.asarray(num_j), rtol=1e-6)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
        # the cases are there: ties, self-loops, partial keeps and hubs
        assert (dist == 0).any() and keep.any()
        assert not keep[10:15].any() and not keep[25:35].any()
        assert (keep.sum(1) < torch.from_numpy(valid).sum(1)).any()
        assert (np.asarray(dist)[valid] == np.roll(np.asarray(dist), 1,
                                                   1)[valid]).any()


def test_choose_window_sum_launches_nothing_on_the_cpu():
    """A CPU forward through the store lane takes the plain version: the
    kernel's counter, ``launch_counts()["choose_window"]``, stays put."""
    from pcgnn_tpu_torch.models.pcgnn import PCGNN
    from pcgnn_tpu_torch.train.capture import launch_counts
    g = _grid_graph("tiny", "bfloat16")
    model = PCGNN(g.feat_dim, 8, g.num_relations, alpha=2.0, rho=0.5,
                  generator=torch.Generator().manual_seed(0))
    before = launch_counts()
    logits, _ = model(g, torch.arange(64), None, train=False)
    assert logits.shape == (64, 2)
    assert launch_counts() == before and "choose_window" in before


# the tables the lanes without stores read rows from: the features (ids
# clamped, no sentinel row), their sentinel copy (``features_pad``),
# ``hub_table``'s with and without the train-positive column, and the
# score table's (score column F)
_ID_TABLES = ["clamp_ids", "features_pad", "hub_table", "hub_table_tp",
              "score_table"]


def _ids_case(table, seed):
    """(xs, ids, f, centers, w0, b0, deg, keff, hub cap, score column,
    valid, clamp_ids) of a batch of 200 rows over a 3,000-node table of
    ``table``'s layout, in two relations of widths 17 and 90 (past the
    rank select's 64), the wider with hub rows past its cap.  Values are
    quarters (ties); rows 0-19 take their own node at slot 0 and slots
    1-2 (a self-loop and ties); keff is 0 on rows 20-29, the valid count
    on 30-39, past the width on 40-49; padding slots hold N."""
    from pcgnn_tpu_torch.ops.hub import hub_table
    rng = np.random.default_rng(seed)
    n, f, b = 3000, 6, 200
    x = torch.from_numpy((rng.integers(-8, 9, (n, f)) / 4).astype(
        np.float32))
    w0 = torch.from_numpy(rng.normal(size=f).astype(np.float32))
    b0 = torch.tensor(0.125)
    s0 = tagg.selection_score(x, w0, b0)
    tp = torch.from_numpy(rng.choice(n, 300, replace=False))
    tpv = torch.from_numpy(rng.random(300) < 0.9)
    xs, score_col = {
        "clamp_ids": (x, None),
        "features_pad": (torch.cat([x, x.new_zeros((1, f))]), None),
        "hub_table": (hub_table(x), None),
        "hub_table_tp": (hub_table(x, tp, tpv), None),
        "score_table": (hub_table(x, tp, tpv, s0=s0), f)}[table]
    batch = torch.from_numpy(rng.choice(n, b, replace=False))
    center = s0[batch]
    rels = []
    for d, cap in ((17, None), (90, 90)):
        deg = torch.from_numpy(rng.integers(0, d + 9 if cap else d + 1,
                                            b).astype(np.int32))
        deg[:20] = deg[:20].clamp(min=3)
        nbr = torch.from_numpy(rng.integers(0, n, (b, d)).astype(np.int32))
        nbr[:20, :3] = batch[:20, None].to(torch.int32)
        keff = ((deg + 1) // 2).to(torch.int32)
        keff[20:30] = 0
        keff[30:40] = deg[30:40].clamp(max=d)
        keff[40:50] = d + 1
        valid = torch.arange(d)[None, :] < deg.clamp(max=d)[:, None]
        if cap is not None:
            valid = valid & ~(deg > cap)[:, None]
            assert (deg > cap).any()
        rels.append((torch.where(valid, nbr, n), deg, keff, cap, valid))
    return xs, f, center, w0, b0, score_col, rels, table == "clamp_ids"


@pytest.mark.parametrize("table", _ID_TABLES)
def test_choose_ids_sum_equals_the_chain_it_replaced(table):
    """``choose_ids_sum`` on the CPU (its plain version) against the chain
    ``PCGNN.forward`` ran before it, written out here: the rows gathered at
    the ids (clamped to N - 1 without a sentinel row), the score column or
    ``selection_score`` of the rows, ``keep_nearest`` over the valid slots
    less the hub rows, and ``window_sum_from_gathered``.  Keep masks,
    sums and counts are equal bit for bit, in every table layout, with
    hub rows, padding ids N, keff 0, keff at and past the valid count, and
    a window past 64 slots."""
    xs, f, center, w0, b0, score_col, rels, clamp_ids = _ids_case(table, 9)
    n = 3000
    for nbr, deg, keff, cap, valid in rels:
        got = tagg.choose_ids_sum(xs, nbr, f, center, w0, b0, deg, keff,
                                  hub_cap=cap, score_col=score_col)
        rows = xs[nbr.clamp(max=n - 1) if clamp_ids else nbr]
        xw = rows[..., :f]
        nbr_s0 = (tagg.selection_score(xw, w0, b0) if score_col is None
                  else rows[..., score_col])
        dist = torch.where(valid, (center[:, None] - nbr_s0).abs(),
                           float("inf"))
        keep = tagg.keep_nearest(dist, keff, valid)
        num, cnt = tagg.window_sum_from_gathered(xw, keep)
        assert torch.equal(got[2], keep), (table, nbr.shape)
        assert torch.equal(got[0], num) and torch.equal(got[1], cnt)
        bare = tagg.choose_ids_sum(xs, nbr, f, center, w0, b0, deg, keff,
                                   hub_cap=cap, score_col=score_col,
                                   want_keep=False)
        assert bare[2] is None and torch.equal(bare[0], num)
        # the cases are there: self-loops kept, ties, partial keeps, hubs
        assert keep[:20, 0][keff[:20] > 0].any()
        assert not keep[20:30].any()
        assert (keep.sum(1) < valid.sum(1)).any()
        assert (keep[30:50].sum(1) == valid[30:50].sum(1)).all()
        if cap is not None:
            assert not keep[deg > cap].any()
        assert (nbr == n).any()


def test_choose_ids_sum_launches_nothing_on_the_cpu(monkeypatch):
    """A CPU training forward through the CSR lane takes the plain
    versions: ``launch_counts()["choose_window_ids"]`` and
    ``["selection_score"]`` stay put."""
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.models import pcgnn
    from pcgnn_tpu_torch.models.pcgnn import PCGNN
    from pcgnn_tpu_torch.train.capture import launch_counts
    g = synthetic_fraud_graph("tiny", seed=1)
    g = dataclasses.replace(g, relations=tuple(
        dataclasses.replace(r, nbr2d=None) for r in g.relations))
    model = PCGNN(g.feat_dim, 8, g.num_relations, alpha=2.0, rho=0.5,
                  generator=torch.Generator().manual_seed(0))
    tp = torch.nonzero(g.labels == 1)[:, 0]
    monkeypatch.setattr(pcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 0)
    before = launch_counts()
    loss = model.loss(g, torch.arange(64), g.labels[:64], train_pos=tp,
                      train_pos_valid=torch.ones_like(tp, dtype=torch.bool))
    assert torch.isfinite(loss)
    assert launch_counts() == before
    assert {"choose_window_ids", "selection_score"} <= set(before)


@pytest.mark.parametrize("shape,view", [
    ((300, 32), None), ((7, 9, 25), None), ((40, 12, 34), (Ellipsis, 32)),
    ((5, 1, 64), None)])
def test_selection_score_on_the_cpu_is_the_float64_expression(shape, view):
    """On the CPU ``selection_score`` stays the float64 expression, on
    contiguous rows and on strided views (a hub table's rows, their first
    F of F + 2 columns), and launches nothing."""
    from pcgnn_tpu_torch.ops import choose_window
    rng = np.random.default_rng(len(shape))
    a = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    rows = a if view is None else a[..., : view[1]]
    f = rows.shape[-1]
    w0 = torch.from_numpy(rng.normal(size=(f, 2)).astype(np.float32))[:, 0]
    b0 = torch.tensor(-0.375)
    before = choose_window.score_launches
    got = tagg.selection_score(rows, w0, b0)
    want = (rows.double() @ w0.double() + b0.double()).float()
    assert got.dtype == torch.float32 and got.shape == rows.shape[:-1]
    assert torch.equal(got, want)
    assert choose_window.score_launches == before


def test_selection_score_refuses_a_device_without_its_kernel():
    """Off the CPU, ``selection_score`` is the card's kernel or nothing: a
    tensor on a device with neither raises, and launches nothing."""
    from pcgnn_tpu_torch.ops import choose_window
    rows = torch.empty((4, 8), device="meta")
    w0 = torch.empty(8, device="meta")
    before = choose_window.score_launches
    with pytest.raises(ValueError, match="unsupported device"):
        tagg.selection_score(rows, w0, torch.empty((), device="meta"))
    assert choose_window.score_launches == before


def _minor_case(form, seed):
    """Inputs of one step's oversampled minors: train positives (a tenth
    invalid) whose scores take few values (``bf16``: scores of
    bfloat16-rounded rows, many of them equal), centers at those values
    (ties in distance on both sides of a center), random labels, and three
    relations whose neighbors include train positives, each row's first
    the one at its center's score (candidates that are kept neighbors):
    relation 0 has hub rows past its cap,
    relation 1 reads its ids through ``nbr2d`` at the batch, relation 2
    hands them as [B, D] rows."""
    p, m_max, levels = {"windowed": (1000, 53, 97), "ties": (300, 7, 40),
                        "dense": (40, 20, 7), "padded": (10, 6, 5),
                        "bf16": (700, 60, 0)}[form]
    rng = np.random.default_rng(seed)
    n, b, f = 3000, 48, 6
    tp = rng.choice(n, p, replace=False).astype(np.int64)
    tpv = rng.random(p) < 0.9
    rows = rng.uniform(0.5, 1.5, (p, f)).astype(np.float32)
    if form == "bf16":
        rows = (rows[rng.integers(0, 40, p)]
                + rng.choice(np.float32([0, 2.0 ** -12]), (p, f)))
        w0 = rng.normal(size=f).astype(np.float32)
        s0 = tagg.selection_score(
            torch.from_numpy(rows).to(torch.bfloat16).to(torch.float32),
            torch.from_numpy(w0), torch.tensor(0.25)).numpy()
    else:
        s0 = (rng.integers(0, levels, p) / levels).astype(np.float32)
    # each center at a valid train positive's score, which is a neighbor
    near = rng.choice(np.flatnonzero(tpv), b)
    center = s0[near] + rng.choice(np.float32([0, 0, 1e-3]), b)
    batch = rng.choice(n, b, replace=False).astype(np.int64)
    labels = rng.integers(0, 2, b).astype(np.int64)
    labels[:4] = 1
    rels = []
    for r in range(3):
        d = int(rng.integers(5, 40))
        nbr2d = rng.integers(0, n + 1, (n, d)).astype(np.int32)
        nbr2d[:, 1:3] = rng.choice(tp, (n, 2))
        nbr2d[batch, 0] = tp[near]
        deg = rng.integers(0, d + 6, n).astype(np.int32)
        ksample = rng.integers(0, 2 * m_max + 4, n).astype(np.int32)
        keep = rng.random((b, d)) < 0.6
        rels.append((nbr2d, deg, ksample, keep, d if r == 0 else None))
    return (center.astype(np.float32), s0, tp, tpv, rows, m_max, batch,
            labels, rels)


@pytest.mark.parametrize("form", ["windowed", "ties", "dense", "padded",
                                  "bf16"])
def test_oversample_minor_sums_match_jax(form):
    """``oversample_minor_sums`` (its plain version on the CPU) against the
    JAX package's chain on the same inputs: ``oversample_candidates_values``
    -> ``oversample_keep`` (hub rows masked) -> ``dedup_minor_keep`` ->
    ``minor_sum_compact_multi``, added to each relation's sums.  Counts are
    exact, sums within rtol 1e-6 (positive values).  The windowed form
    (2 m_max < P) and the dense one, non-fraud rows, hub rows, ties and
    kept neighbors among the candidates are all there."""
    from pcgnn_tpu_torch.graph.csr import RelGraph
    (center, s0, tp, tpv, rows, m_max, batch, labels,
     rels) = _minor_case(form, seed=len(form))
    rho = 0.5
    b, f = len(batch), rows.shape[1]
    cand_ids, cand_valid, _, cand_slots = jagg.oversample_candidates_values(
        jnp.asarray(center), jnp.asarray(s0), jnp.asarray(tp, jnp.int32),
        jnp.asarray(tpv), m_max)
    rng = np.random.default_rng(1)
    keeps, trels, sums, base = [], [], [], []
    for r, (nbr2d, deg, ksample, keep, cap) in enumerate(rels):
        km = jagg.oversample_keep(None, None, jnp.asarray(labels), cand_valid,
                                  rho, ksample_b=jnp.asarray(ksample[batch]))
        if cap is not None:
            km = km & ~jnp.asarray(deg[batch] > cap)[:, None]
        dedup = jagg.dedup_minor_keep(
            jnp.asarray(nbr2d[batch]), jnp.asarray(keep), len(deg),
            cand_ids, km)
        if r == 0:
            # candidates that are kept neighbors are there, and dropped
            assert (np.asarray(dedup) != np.asarray(km)).any()
        keeps.append(dedup)
        z = torch.zeros(1, dtype=torch.int32)
        rel = RelGraph(
            indptr=z, col=z, deg=torch.from_numpy(deg), keff=z,
            ksample=torch.from_numpy(ksample), num_nodes=len(deg),
            num_edges=0, dmax=nbr2d.shape[1] + 6,
            dcap=cap if cap is not None else nbr2d.shape[1] + 6,
            nbr2d=torch.from_numpy(nbr2d))
        assert rel.has_hubs == (cap is not None)
        ids = None if r == 1 else torch.from_numpy(nbr2d[batch])
        trels.append((rel, ids, torch.from_numpy(keep)))
        num0 = rng.uniform(0.5, 1.5, (b, f)).astype(np.float32)
        cnt0 = rng.integers(0, 9, b).astype(np.float32)
        base.append((num0, cnt0))
        sums.append((torch.from_numpy(num0.copy()),
                     torch.from_numpy(cnt0.copy())))
    want = jagg.minor_sum_compact_multi(jnp.asarray(rows), cand_slots, keeps)
    s0_t, tpv_t = torch.from_numpy(s0), torch.from_numpy(tpv)
    tagg.oversample_minor_sums(
        torch.from_numpy(center), s0_t, torch.from_numpy(tp), tpv_t,
        torch.from_numpy(rows), m_max, torch.from_numpy(batch),
        torch.from_numpy(labels), rho, trels, sums,
        ranked=tagg.rank_train_positives(s0_t, tpv_t))
    for (num, cnt), (num0, cnt0), (mn, mc) in zip(sums, base, want):
        np.testing.assert_array_equal(cnt.numpy(), cnt0 + np.asarray(mc))
        np.testing.assert_allclose(num.numpy(), num0 + np.asarray(mn),
                                   rtol=1e-6)
        # non-fraud rows take no minor
        assert (cnt.numpy()[labels != 1] == cnt0[labels != 1]).all()
    # hub rows of relation 0 take none; fraud rows elsewhere take some
    hub = rels[0][1][batch] > rels[0][4]
    assert hub.any() and (np.asarray(want[0][1])[hub] == 0).all()
    assert (np.asarray(want[1][1]) > 0).any()
    if form == "bf16":
        assert len(np.unique(s0)) < len(s0) // 4      # many equal scores
    assert (2 * m_max < len(tp)) == (form in ("windowed", "ties", "bf16"))


def test_oversample_minor_sums_launch_nothing_on_the_cpu():
    """A CPU training forward through the store lane takes the plain
    version: ``launch_counts()["oversample_minors"]`` stays put."""
    from pcgnn_tpu_torch.models.pcgnn import PCGNN
    from pcgnn_tpu_torch.train.capture import launch_counts
    g = _grid_graph("tiny", "bfloat16")
    model = PCGNN(g.feat_dim, 8, g.num_relations, alpha=2.0, rho=0.5,
                  generator=torch.Generator().manual_seed(0))
    tp = torch.nonzero(g.labels == 1)[:, 0]
    before = launch_counts()
    loss = model.loss(g, torch.arange(64), g.labels[:64], train_pos=tp,
                      train_pos_valid=torch.ones_like(tp, dtype=torch.bool))
    assert torch.isfinite(loss)
    assert launch_counts() == before and "oversample_minors" in before
