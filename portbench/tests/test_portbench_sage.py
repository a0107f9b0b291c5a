"""The GraphSAGE cell: its plain reference against the port's GraphSage
through the harness, its aggregate by hand, and its step count."""

import dataclasses

import numpy as np
import pytest
import torch

from pcgnn_tpu_torch.models.graphsage import GraphSage
from portbench import check, gen, harness
from portbench.counts import gcn as gcncount
from portbench.counts import sage as sagecount
from portbench.counts import step
from portbench.reference import sage as sageref
from portbench.tests.helpers import small_cell

SAGE = "sage-amazon.train"


@pytest.mark.parametrize("stores", [True, False])
def test_sage_reference_follows_the_programs_graphsage(stores):
    # the port's GraphSage through the harness, with a bf16 homo store and
    # with none, against the plain GraphSAGE: first loss, first gradient,
    # the update after three steps, the validation probabilities
    cfg, traffic = small_cell(SAGE, "tiny", 16)
    cfg["model"]["edge_windows"] = stores
    run = harness.Run(cfg, traffic, 2**31 + 11, torch.device("cpu"))
    run.setup()
    assert isinstance(run.model, GraphSage) and run.model.num_sample is None
    g = run.t.graph
    assert (g.homo.ewin is not None) == stores
    assert all(r.ewin is None for r in g.relations) and g.fused is None
    assert set(run.rec["params0"]) == {"enc.w", "head.w"}
    run.window(0.2)
    run.close()
    run.reference()
    assert run.refmod is sageref
    assert run.ref.permutation and run.ref.sample_size == len(
        run.ref.idx_train)
    assert (run.ref.stored is run.ref.features) != stores
    prog = check.program_readings(run.rec, "cpu")
    sound = check.reference_readings(run.refmod, run.ref, run.rec,
                                     cfg["model"])
    gaps = check.gaps(prog, sound)
    assert all(v < 1e-6 for v in gaps.values()), gaps
    # the reference rounds to the store's precision: read exact, it
    # departs where the program reads bf16
    exact = dataclasses.replace(run.ref, stored=run.ref.features)
    off = check.gaps(prog, check.reference_readings(
        run.refmod, exact, run.rec, cfg["model"]))
    assert (off["prob_gap"] > 1e-5) == stores, off


def test_sage_aggregate_by_hand():
    # four nodes, edges 0-1, 0-2, 1-2 in one relation and 2-3 in the
    # other, self-loops: node 2 takes the mean of all four rows, node 3 of
    # rows 2 and 3; a mean, not a sum over a square root
    raw = gen.RawGraph(features=np.arange(8, dtype=np.float32).reshape(4, 2),
                       labels=np.array([0, 1, 0, 1]),
                       srcs=(np.array([0, 0, 1]), np.array([2])),
                       dsts=(np.array([1, 2, 2]), np.array([3])))
    cfg = {"seed": 2, "graph": {}, "model": {
        "train_ratio": 0.5, "test_ratio": 0.5, "edge_windows": False}}
    g = sageref.build_graph(raw, cfg, "cpu")
    assert g.relations[0].deg.tolist() == [3, 3, 4, 2]
    x = torch.as_tensor(raw.features)
    agg = sageref.aggregate(g, torch.tensor([0, 2, 3]), False)
    torch.testing.assert_close(agg[0], x[:3].mean(0))
    torch.testing.assert_close(agg[1], x.mean(0))
    torch.testing.assert_close(agg[2], (x[2] + x[3]) / 2)
    # a row that lacks its self-loop takes its own row as one more
    # column: node 3's row holds node 2 alone
    rel = g.relations[0]
    cut = dataclasses.replace(
        rel, col=rel.col[:-1], deg=torch.tensor([3, 3, 4, 1]),
        indptr=torch.tensor([0, 3, 6, 10, 11]))
    assert cut.col[cut.indptr[3]:].tolist() == [2]
    lone = dataclasses.replace(g, relations=[cut])
    torch.testing.assert_close(
        sageref.aggregate(lone, torch.tensor([3]), False)[0],
        (x[2] + x[3]) / 2)
    # the fraud probability is the softmax's share of class 1 of
    # relu(agg W_enc) W_head
    params = {"enc.w": torch.eye(2), "head.w": torch.tensor([[1.0, -1.0],
                                                             [0.5, 2.0]])}
    nodes = torch.tensor([0, 1, 2, 3])
    logits = torch.relu(sageref.aggregate(g, nodes, False)) @ params["head.w"]
    torch.testing.assert_close(
        sageref.fraud_probabilities(g, params, nodes, {}),
        torch.softmax(logits, dim=1)[:, 1])


def test_sage_count_is_gcns():
    # the same bytes and products as GCN's step, with a store and without
    t = {"reference": "sage", "rows": 5, "steps": 2, "feat_dim": 4,
         "emb": 8, "record_width": 12, "hub_neighbors": 2, "params": 48,
         "relations": 3, "stores": True, "neighbors": 11, "train_pos": 3}
    for stores in (True, False):
        rec = {**t, "stores": stores}
        assert step.count(rec) == gcncount.count(rec) == sagecount.count(rec)
    assert step.count(t)[1] == gcncount.flops(rows=5, feat_dim=4, emb=8)
