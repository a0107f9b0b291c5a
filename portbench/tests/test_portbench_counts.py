"""The roofline counts of ``portbench/counts``."""

import numpy as np
import pytest
import torch

from pcgnn_tpu_torch.graph.csr import csr_from_edges
from portbench import harness
from portbench.counts import gcn, pcgnn, peaks, ragged_gather, step
from portbench.counts import window_gather
from portbench.reference import graph as refgraph
from portbench.tests.helpers import GCN, small_cell

BW = 3.35e12


@pytest.mark.parametrize("rows,width,us", [(1024, 8896, 10.88),
                                           (256, 44280, 13.54),
                                           (1024, 8512, 10.41),
                                           (256, 23925, 7.31)])
def test_kernel1_copy_bound(rows, width, us):
    got = window_gather.copy_bytes(rows, width) / BW * 1e6
    assert got == pytest.approx(us, abs=0.005)


def test_peaks_by_card_name():
    assert peaks.peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    assert peaks.peaks("NVIDIA H100 PCIe") == (2.0e12, 51e12)
    assert peaks.peaks("cpu") is None


def test_kernel2_counts_only_real_hub_rows():
    cfg, traffic = small_cell("pcgnn-yelpchi.hubs", "skew-tiny", 64)
    run = harness.Run(cfg, traffic, 5, torch.device("cpu"))
    run.setup()
    run.reference()
    deg, cap = run.hub_cap[0]
    hubs = torch.nonzero(deg > cap)[:, 0]
    plain = torch.nonzero(deg <= cap)[:, 0]
    b = torch.cat([hubs[:3], plain[:5], hubs[3:4]])[None, :]
    w = torch.ones(b.shape, dtype=torch.float32)
    w[0, -1] = 0.0                      # a padding slot: not counted
    want = int(deg[hubs[:3]].sum())
    assert run.degree_sum([(b, w)], hubs_only=True) == want
    assert ragged_gather.id_bytes(want) == 8 * want


def test_step_count_is_its_terms_at_the_tiny_preset():
    f, e, r, w, p = 16, 64, 3, 3 * 20 * 16, 30
    terms = pcgnn.byte_terms(rows=100, steps=4, feat_dim=f, record_width=w,
                             train_pos=p, hub_neighbors=50, params=9000)
    assert terms == {"records": 100 * w * 2,
                     "ids_labels_weights": 100 * 20,
                     "center_rows": 100 * f * 4,
                     "train_pos_rows": 4 * p * f * 4,
                     "hub_neighbor_rows": 50 * (f * 4 + 4),
                     "params_and_moments": 4 * 9000 * 24}
    fwd = 2 * (f * 2 + r * 2 * f * e + (f + r * e) * e + e * 2)
    assert pcgnn.flops(rows=10, feat_dim=f, emb=e, relations=r) == \
        10 * (2 * fwd + 2 * (e * 2 + r * e * e))
    assert step.least_seconds(3.35e6, 1.0, (3.35e12, 67e12)) == \
        pytest.approx(1e-6)


@pytest.mark.parametrize("workload", ["pcgnn-yelpchi.train", GCN])
def test_params_count_matches_the_model(workload):
    cfg, traffic = small_cell(workload, "tiny", 16)
    run = harness.Run(cfg, traffic, 5, torch.device("cpu"))
    run.setup()
    tr = run.traced(2)
    run.counted(tr)
    f, e = 16, 64
    if workload == GCN:
        # enc.w and head.w; the one relation is the homo graph
        assert tr["reference"] == "gcn" and tr["params"] == f * e + e * 2
        assert len(run.ref.relations) == 1
        assert torch.equal(run.ref.relations[0].deg, run.ref.homo_deg)
    else:
        assert tr["reference"] == "pcgnn"
        assert tr["params"] == f * 2 + 2 + 3 * 2 * f * e \
            + (f + 3 * e) * e + e * 2
    assert tr["record_width"] == sum(
        min(int(r.deg.max()), r.dcap) for r in run.ref.relations) * f


def record(kw: dict, **more) -> dict:
    """A traced slice's record with the fields the step counts read."""
    return {"reference": "pcgnn", "emb": 64, "relations": 3, "stores": True,
            "neighbors": 0, **kw, **more}


# the store cells' shapes (PERF.md section 4) over a 20-epoch slice, and
# the terms and operations the parent's ``counts/step.py`` gave for them
STORE_CELLS = [
    (dict(rows=122880, steps=120, feat_dim=32, record_width=8512,
          train_pos=2670, hub_neighbors=0, params=22978),
     {"records": 2091909120, "ids_labels_weights": 2457600,
      "center_rows": 15728640, "train_pos_rows": 41011200,
      "hub_neighbor_rows": 0, "params_and_moments": 66176640},
     16231956480),
    (dict(rows=15360, steps=60, feat_dim=25, record_width=23925,
          train_pos=330, hub_neighbors=0, params=17474),
     {"records": 734976000, "ids_labels_weights": 307200,
      "center_rows": 1536000, "train_pos_rows": 1980000,
      "hub_neighbor_rows": 0, "params_and_moments": 25162560},
     1835458560),
    (dict(rows=122880, steps=120, feat_dim=32, record_width=8896,
          train_pos=2670, hub_neighbors=1234567, params=22978),
     {"records": 2186280960, "ids_labels_weights": 2457600,
      "center_rows": 15728640, "train_pos_rows": 41011200,
      "hub_neighbor_rows": 162962844, "params_and_moments": 66176640},
     16231956480),
]


@pytest.mark.parametrize("kw,terms,ops", STORE_CELLS)
def test_store_cells_byte_terms_unchanged(kw, terms, ops):
    assert pcgnn.byte_terms(**kw) == terms
    # by the configuration's reference, from a traced record
    assert step.count(record(kw)) == (terms, ops)


def test_no_store_count_unchanged():
    # the stress cell's CSR lane over a 9-epoch slice, and what the
    # parent's count gave for it
    kw = dict(rows=3604480, steps=3519, feat_dim=64, record_width=0,
              train_pos=199870, hub_neighbors=0, params=65858)
    terms = {"ids_labels_weights": 72089600, "center_rows": 922746880,
             "train_pos_rows": 180055687680, "hub_neighbor_rows": 0,
             "params_and_moments": 5562103248,
             "neighbor_rows": 68669212300}
    got = step.count(record(kw, stores=False, neighbors=264112355))
    assert got == (terms, 683755438080)


def test_gcn_count_by_hand():
    # 5 real rows in 2 steps, F 4, E 8, windows of 3 rows; hub rows'
    # degrees sum to 2; enc.w [4, 8] and head.w [8, 2]
    kw = dict(rows=5, steps=2, feat_dim=4, record_width=12, hub_neighbors=2,
              params=48)
    want = {"windows": 5 * 12 * 2, "hub_neighbor_rows": 2 * (16 + 4),
            "center_rows": 5 * 16, "ids_labels_weights": 5 * 20,
            "params_and_moments": 2 * 48 * 24}
    assert gcn.byte_terms(**kw) == want
    # forward 2 (4 x 8 + 8 x 2) = 96, the weight gradients 96, the input
    # gradient into z 2 x 8 x 2 = 32: 224 a row
    assert gcn.flops(rows=5, feat_dim=4, emb=8) == 1120
    t = {"reference": "gcn", "emb": 8, "relations": 3, "stores": True,
         "neighbors": 11, "train_pos": 3, **kw}
    assert step.count(t) == (want, 1120)
    # no store: the neighbors' float32 rows and int32 ids, the hub rows'
    # apart, in the windows' place
    terms, _ = step.count({**t, "stores": False})
    assert "windows" not in terms
    assert terms["neighbor_rows"] == (11 - 2) * (16 + 4)
    assert {k: v for k, v in terms.items() if k != "neighbor_rows"} == {
        k: v for k, v in want.items() if k != "windows"}


def hand_graph():
    """Two directed relations on five nodes, degrees worked out by hand
    (self-loops added, each edge once): r0 0->1, 0->2, 1->2, 3->0, 0->1
    again: [3, 2, 1, 2, 1]; r1 4->0, 4->1, 4->2, 2->4: [1, 1, 2, 1, 4]."""
    return ([np.array([0, 0, 1, 3, 0]), np.array([4, 4, 4, 2])],
            [np.array([1, 2, 2, 0, 1]), np.array([0, 1, 2, 4])])


def test_no_store_counts_by_hand():
    srcs, dsts = hand_graph()
    rels = [refgraph.csr(s, d, 5, 0.5, "cpu", directed=True)
            for s, d in zip(srcs, dsts)]
    assert [r.deg.tolist() for r in rels] == [[3, 2, 1, 2, 1],
                                              [1, 1, 2, 1, 4]]
    for r, s, d in zip(rels, srcs, dsts):
        mine = csr_from_edges(s, d, 5, symmetrize=False)
        assert mine.deg.tolist() == r.deg.tolist()
    run = harness.Run.__new__(harness.Run)
    run.device = torch.device("cpu")
    run.hub_cap = [(r.deg, 3) for r in rels]
    # a plan of two steps: rows 0, 3, 4 and 4, 2 real; the last slot of
    # each a padding slot (weight 0)
    b = torch.tensor([[0, 3, 4, 1], [4, 2, 0, 0]])
    w = torch.tensor([[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 0.0]])
    # r0: 3 + 2 + 1 + 1 + 1 = 8; r1: 1 + 1 + 4 + 4 + 2 = 12
    assert run.degree_sum([(b, w)]) == 20
    # the hub rows (degree over the cap 3): node 4 of r1, twice
    assert run.degree_sum([(b, w)], hubs_only=True) == 8
    assert ragged_gather.id_bytes(20) == 160
    f = 64
    terms = pcgnn.byte_terms(rows=5, steps=2, feat_dim=f, record_width=0,
                             train_pos=3, hub_neighbors=8, params=100,
                             neighbors=20)
    assert "records" not in terms
    assert terms["neighbor_rows"] == (20 - 8) * (4 * f + 4)
    assert terms["hub_neighbor_rows"] == 8 * (4 * f + 4)
