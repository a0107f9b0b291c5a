"""Selection and aggregation ops: the port against the JAX package on the
same numpy inputs.

Selection (keep masks, candidate ids, slots, valid flags and the distances
the candidates were sorted by) is exact: the same values go through the same
comparisons and tie rules.  The sums are float32 contractions taken in
another order by each framework; their inputs are positive here, so no sum
cancels and rtol 1e-6 bounds the difference.
"""

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
