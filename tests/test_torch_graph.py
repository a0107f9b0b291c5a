"""Graph build parity: the port's CSR and synthetic data against the JAX
package's, from the same seed.

Every array here is integer structure or a copy of generated numpy data, so
equality is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.graph import csr as tcsr

_INT_FIELDS = ("dmax", "dcap", "ksample_max", "ksample_cap", "num_nodes",
               "num_edges", "window_width", "has_hubs")


def _assert_rel_equal(rj, rt):
    for name in _INT_FIELDS:
        assert getattr(rt, name) == getattr(rj, name), name
    e = rj.num_edges
    np.testing.assert_array_equal(rt.indptr.numpy(), np.asarray(rj.indptr))
    np.testing.assert_array_equal(rt.col.numpy()[:e], np.asarray(rj.col)[:e])
    # the padding past the last edge holds the sentinel id N and covers one
    # window read from the last row's start
    assert (rt.col.numpy()[e:] == rj.num_nodes).all()
    assert rt.col.shape[0] >= e + max(rj.dmax, 1)
    for name in ("deg", "keff", "ksample", "nbr2d"):
        a = getattr(rt, name)
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(rj, name)),
                                      err_msg=name)


@pytest.mark.parametrize("preset,seed", [("tiny", 0), ("small", 3),
                                         ("skew-tiny", 1)])
def test_synthetic_graph_matches_jax(preset, seed):
    gj = jax_graph(preset, seed=seed)
    gt = torch_graph(preset, seed=seed)
    assert gt.num_relations == gj.num_relations
    assert gt.feat_dim == gj.feat_dim
    np.testing.assert_array_equal(gt.features.numpy(), np.asarray(gj.features))
    np.testing.assert_array_equal(gt.labels.numpy(), np.asarray(gj.labels))
    for rj, rt in zip(gj.relations, gt.relations):
        _assert_rel_equal(rj, rt)
    _assert_rel_equal(gj.homo, gt.homo)
    if preset == "skew-tiny":
        assert gt.relations[0].has_hubs     # the cap policy was exercised


@pytest.mark.parametrize("threshold", [0.5, [0.3, 0.6, 0.9]])
def test_csr_from_edges_matches_jax(threshold):
    rng = np.random.default_rng(7)
    n = 300
    src = rng.integers(0, n, 2000)
    dst = rng.integers(0, n, 2000)
    for r in range(3):
        thr = tcsr.rel_threshold(threshold, r)
        assert thr == jcsr.rel_threshold(threshold, r)
        kw = dict(threshold=thr, window_cap=[None, 8, None][r],
                  symmetrize=bool(r != 2), add_self_loops=bool(r != 1))
        _assert_rel_equal(jcsr.csr_from_edges(src, dst, n, **kw),
                          tcsr.csr_from_edges(src, dst, n, **kw))
    assert tcsr.rel_threshold(threshold, None) == jcsr.rel_threshold(
        threshold, None)


def test_window_cap_policy_matches_jax():
    rng = np.random.default_rng(0)
    deg = rng.integers(1, 40, 5000)
    deg[:10] = 5000                       # a heavy tail
    for cap in (None, 7, 10_000):
        for d in (deg, deg[10:], np.zeros(0, np.int64)):
            dmax = int(d.max()) if d.size else 0
            assert tcsr._window_cap(d, dmax, cap) == jcsr._window_cap(
                d, dmax, cap)


def test_dense_neighbor_table_budget_gate(monkeypatch):
    indptr = np.array([0, 2, 3, 3], np.int64)
    col = np.array([1, 2, 0], np.int64)
    np.testing.assert_array_equal(
        tcsr._dense_neighbor_table(indptr, col, 3, 2),
        jcsr._dense_neighbor_table(indptr, col, 3, 2))
    # a table over the budget is not built, in both packages
    monkeypatch.setattr(tcsr, "NBR2D_BUDGET_BYTES", 8)
    monkeypatch.setattr(jcsr, "NBR2D_BUDGET_BYTES", 8)
    assert tcsr._dense_neighbor_table(indptr, col, 3, 2) is None
    assert jcsr._dense_neighbor_table(indptr, col, 3, 2) is None
    assert tcsr.csr_from_edges(col, col, 3).nbr2d is None
    assert tcsr.EWIN_BUDGET_BYTES == jcsr.EWIN_BUDGET_BYTES
    assert tcsr.EWIN_TOTAL_BUDGET_BYTES == jcsr.EWIN_TOTAL_BUDGET_BYTES


def test_graph_to_device_keeps_shared_homo():
    g = torch_graph("tiny", seed=0)
    shared = dataclasses.replace(g, homo=g.relations[0])
    moved = shared.to("cpu")
    assert moved.homo is moved.relations[0]
    assert moved.features.device == torch.device("cpu")
    assert moved.homo is not g.homo
