"""The generator's arrays give the program the graph of its own synthetic
presets, and the reference works out the same CSR from them."""

import numpy as np
import pytest
import torch

from pcgnn_tpu_torch.data.synthetic import PRESETS as PORT_PRESETS
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.graph.csr import build_multirel, csr_from_edges
from portbench import gen
from portbench.reference import graph as refgraph
from portbench.tests.helpers import PRESETS

REL_FIELDS = ("indptr", "col", "deg", "keff", "ksample", "nbr2d")


def port_graph(raw):
    n = raw.num_nodes
    rels = [csr_from_edges(s, d, n) for s, d in zip(raw.srcs, raw.dsts)]
    homo = csr_from_edges(np.concatenate(raw.srcs), np.concatenate(raw.dsts),
                          n)
    return build_multirel(rels, homo, raw.features, raw.labels)


def same_rel(a, b):
    for f in REL_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.dcap, a.dmax, a.num_edges) == (b.dcap, b.dmax, b.num_edges)


@pytest.mark.parametrize("preset", ["tiny", "skew-tiny", "small"])
@pytest.mark.parametrize("seed", [0, 2, 2**31 + 5])
def test_generator_gives_the_presets_graph(preset, seed):
    stats, hubs = PRESETS[preset]
    n, f, rate, epr, _ = PORT_PRESETS[preset]
    assert (stats["num_nodes"], stats["feat_dim"], stats["fraud_rate"],
            tuple(stats["edges_per_relation"])) == (n, f, rate, epr)
    raw = gen.draw_graph(seed, **stats, hubs=hubs)
    want = synthetic_fraud_graph(preset, seed=seed)
    got = port_graph(raw)
    assert torch.equal(got.features, want.features)
    assert torch.equal(got.labels, want.labels)
    for a, b in zip(got.relations, want.relations):
        same_rel(a, b)
    same_rel(got.homo, want.homo)


@pytest.mark.parametrize("preset", ["tiny", "skew-tiny"])
def test_reference_csr_equals_the_programs(preset):
    stats, hubs = PRESETS[preset]
    raw = gen.draw_graph(3, **stats, hubs=hubs)
    port = port_graph(raw)
    for s, d, rel in zip(raw.srcs, raw.dsts, port.relations):
        r = refgraph.csr(s, d, raw.num_nodes, 0.5, "cpu")
        e = rel.num_edges
        assert torch.equal(r.indptr, rel.indptr.long())
        assert torch.equal(r.col, rel.col[:e].long())
        assert torch.equal(r.keff, rel.keff.long())
        assert torch.equal(r.ksample, rel.ksample.long())
        assert r.dcap == rel.window_width
    if preset == "skew-tiny":
        assert any(r.has_hubs for r in port.relations)


def test_reference_split_and_normalization_equal_the_programs():
    from pcgnn_tpu_torch.data.prep import (normalize_features,
                                           stratified_splits)
    raw = gen.draw_graph(7, **PRESETS["small"][0])
    for unl in (0, 100):
        want = stratified_splits(raw.labels, 0.4, 0.67, 7, unl)
        got = refgraph.splits(raw.labels, 0.4, 0.67, 7, unl)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    assert np.array_equal(refgraph.normalize_rows(raw.features),
                          normalize_features(raw.features))
