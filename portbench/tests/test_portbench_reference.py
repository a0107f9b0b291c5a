"""The plain reference against the program's CPU path at a small size:
the steps the harness records, and whole runs through the harness."""

import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from portbench import check, gen, harness
from portbench.reference import gcn as gcnref
from portbench.reference import graph as refgraph
from portbench.reference import pcgnn as ref
from portbench.reference import plain
from portbench.tests.helpers import (CELLS, GCN, PCGNN_CELLS, STRESS, lane,
                                     run_small, small_cell, stress_lane)


@pytest.mark.parametrize("workload,preset,batch", CELLS)
def test_reference_follows_the_programs_steps(monkeypatch, workload, preset,
                                              batch):
    lane(monkeypatch, workload)
    cfg, traffic = small_cell(workload, preset, batch)
    run = harness.Run(cfg, traffic, 5, torch.device("cpu"))
    run.setup()
    run.close()
    run.reference()
    g = run.ref
    prog = check.program_readings(run.rec, "cpu")
    sound = check.reference_readings(run.refmod, g, run.rec, cfg["model"])
    gaps = check.gaps(prog, sound)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-6
    assert gaps["update_gap"] < 1e-6
    assert gaps["prob_gap"] < 1e-6
    assert check.pick_bad(g, run.rec["plan_batches"],
                          run.rec["plan_weights"],
                          run.rec["plan_labels"]) == 0


def test_hub_rows_take_the_hub_lane():
    cfg, traffic = small_cell("pcgnn-yelpchi.hubs", "skew-tiny", 64)
    run = harness.Run(cfg, traffic, 5, torch.device("cpu"))
    run.setup()
    run.reference()
    b = run.rec["plan_batches"]
    deg, cap = run.hub_cap[0]
    assert int((deg[b] > cap).sum()) > 0


@pytest.mark.parametrize("workload,preset,batch", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_is_correct(monkeypatch, workload, preset, batch,
                                traced):
    lane(monkeypatch, workload)
    line, rows = run_small(workload, preset, batch, seed=11, traced=traced)
    assert line["correct"], rows
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "compared"
    if not traced:
        assert set(line["metrics"]) == {"train_edges_per_s", "epoch_ms_p95",
                                        "validate_ms_p95", "setup_s"}
        assert all(math.isfinite(m["value"]) and m["value"] > 0
                   for m in line["metrics"].values())
    else:
        assert "breakdown" in line


def test_the_reference_is_built_after_the_window():
    # set-up builds the program alone; the reference's graph comes once
    # the window has closed, outside setup_s, and is the check's
    line, _ = run_small("pcgnn-yelpchi.train", "tiny", 16, seed=3)
    assert line["correct"]
    assert "reference graph" not in line["setup_laps"]
    assert line["reference_s"]["graph"] > 0
    cfg, traffic = small_cell("pcgnn-yelpchi.train", "tiny", 16)
    run = harness.Run(cfg, traffic, 3, torch.device("cpu"))
    run.setup()
    assert run.ref is None
    run.window(0.05)
    run.close()
    run.reference()
    g = run.ref
    run.reference()
    assert run.ref is g and run.edges_per_epoch > 0


def test_tf32_rounding_keeps_ten_bits():
    a = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 3.0],
                     dtype=torch.float32)
    got = plain.tf32(a)
    assert got.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 3.0]
    x = torch.randn(64, 64, dtype=torch.float32)
    r = plain.tf32(x)
    assert float(((r - x).abs() / x.abs()).max()) <= 2**-11
    mant = r.view(torch.int32) & 0x1FFF
    assert int(mant.abs().max()) == 0
    assert np.isfinite(r.numpy()).all()


def test_every_seed_trains_the_same_epochs():
    # the seed draws the initial weights; the epochs are the trainer's
    # own (epoch 0 recorded, the window from epoch 1), the same on every
    # seed
    cfg, traffic = small_cell("pcgnn-yelpchi.train", "tiny", 16)
    a, b = (harness.Run(cfg, traffic, s, torch.device("cpu"))
            for s in (1, 2**31 + 2))
    for run in (a, b):
        run.setup()
        run.reference()
    assert torch.equal(a.ref.features, b.ref.features)
    assert np.array_equal(a.ref.idx_train, b.ref.idx_train)
    assert a.t.num_batches == b.t.num_batches
    assert a.edges_per_epoch == b.edges_per_epoch
    assert torch.equal(a.rec["plan_batches"], b.rec["plan_batches"])
    assert a.epoch == b.epoch == 1
    assert not torch.equal(a.rec["params0"]["inter.w"],
                           b.rec["params0"]["inter.w"])


def test_the_recorded_epoch_starts_again_from_the_initial_state():
    # set-up runs epoch 0, puts the weights and Adam's state back, and
    # records epoch 0 again: run from the initial state once more, it
    # gives the recorded losses
    cfg, traffic = small_cell("pcgnn-yelpchi.train", "tiny", 16)
    run = harness.Run(cfg, traffic, 7, torch.device("cpu"))
    run.setup()
    run.restart()
    for k, v in run.model.state_dict().items():
        assert torch.equal(v, run.rec["params0"][k]), k
    assert all(not torch.is_tensor(v) or not v.any()
               for st in run.optimizer.state.values() for v in st.values())
    run.tap.on = True
    run.t.run_epoch(run.model, run.optimizer, 0)
    _, _, _, losses = run.tap.last(run.t.num_batches)
    assert losses[:3].tolist() == run.rec["losses"]


def test_the_cut_stress_cell_takes_the_csr_lane(monkeypatch):
    # the lane stress-10m's scale forces: no dense table, no store, no
    # padded table, a degree-only homo graph; its directed relations and
    # homo degrees are the reference's, worked out apart
    stress_lane(monkeypatch)
    cfg, traffic = small_cell(STRESS, "stress-small", 96)
    assert cfg["graph"]["directed"] and not cfg["model"]["edge_windows"]
    run = harness.Run(cfg, traffic, 5, torch.device("cpu"))
    run.setup()
    run.reference()
    g = run.t.graph
    assert [r.nbr2d is None for r in g.relations] == [True] * 3
    assert [r.ewin is None for r in g.relations] == [True] * 3
    assert g.fused is None and g.features_pad is None
    assert g.homo.is_stub and not any(r.has_hubs for r in g.relations)
    for mine, theirs in zip(g.relations, run.ref.relations):
        e = mine.num_edges
        assert torch.equal(mine.indptr.long(), theirs.indptr)
        assert torch.equal(mine.col[:e].long(), theirs.col)
        assert torch.equal(mine.keff.long(), theirs.keff)
    assert torch.equal(g.homo.deg.long(), run.ref.homo_deg)
    # directed: fewer than twice the drawn edges with the self-loops
    assert run.ref.relations[0].col.shape[0] < 30000 + 6000
    assert run.t.num_batches == 3


def dense_aggregate(g, rel, nodes, s, labels_b, rho, low):
    """The reference's aggregate as it was, over [B, N] masks: the oracle
    of the gathered one."""
    n = g.features.shape[0]
    b = nodes.shape[0]
    deg = rel.deg[nodes]
    width = int(deg.max())
    slot = torch.arange(width)
    valid = slot[None, :] < deg[:, None]
    nbr = torch.where(valid, rel.indptr[nodes][:, None] + slot[None, :], 0)
    nbr = torch.where(valid, rel.col[nbr], 0)
    dist = (s[nodes][:, None] - s[nbr]).abs()
    dist = torch.where(valid, dist, float("inf"))
    rank = lambda d: torch.argsort(torch.argsort(d, dim=1, stable=True),
                                   dim=1, stable=True)
    kept = valid & (rank(dist) < rel.keff[nodes][:, None])
    rows = torch.arange(b)[:, None].expand_as(nbr)
    kept_mask = torch.zeros((b, n), dtype=torch.bool)
    kept_mask[rows[kept], nbr[kept]] = True
    minor_mask = torch.zeros_like(kept_mask)
    if labels_b is not None:
        tp = g.train_pos
        dm = (s[nodes][:, None] - s[tp][None, :]).abs()
        m = torch.floor(rel.ksample[nodes].float() * rho).long()
        take = (rank(dm) < m[:, None]) & (labels_b == 1)[:, None]
        trows = torch.arange(b)[:, None].expand_as(take)
        minor_mask[trows[take], tp[None, :].expand_as(take)[take]] = True
    minor_mask &= ~kept_mask
    hub = (deg > rel.dcap)[:, None]
    kept_f = kept_mask.float()
    num = (torch.where(hub, ref.mm(kept_f, g.features, low),
                       ref.mm(kept_f, g.stored, low))
           + ref.mm(minor_mask.float(), g.features, low))
    cnt = kept_mask.sum(1) + minor_mask.sum(1)
    return num / cnt.clamp(min=1)[:, None].float()


@pytest.mark.parametrize("workload,preset,batch", PCGNN_CELLS)
@pytest.mark.parametrize("low", [False, True])
def test_gathered_aggregate_equals_the_dense_one(workload, preset, batch,
                                                 low):
    cfg, traffic = small_cell(workload, preset, batch)
    draws = {k: v for k, v in cfg["graph"].items() if k != "directed"}
    raw = gen.draw_graph(cfg["seed"], **draws, **traffic["graph"])
    g = ref.build_graph(raw, cfg, "cpu")
    p0 = ref.initial_weights(3, raw, cfg, "cpu")
    s = ref.scores(g, p0["label_clf.w"][:, 0], p0["label_clf.b"][0])
    gen_ = np.random.default_rng(4)
    # the heaviest rows in every batch, frauds among them, and a repeat
    deg = sum(r.deg for r in g.relations)
    nodes = torch.cat([torch.topk(deg, 4).indices,
                       torch.as_tensor(gen_.choice(g.idx_train, batch)),
                       g.train_pos[:3], g.train_pos[:1]])
    labels = g.labels[nodes]
    assert int(labels.sum()) >= 4
    for rel in g.relations:
        for labels_b in (labels, None):
            got = ref.aggregate(g, rel, nodes, s, labels_b, 0.5, low)
            want = dense_aggregate(g, rel, nodes, s, labels_b, 0.5, low)
            torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-6)


INTERFACE = ("build_graph", "edges_per_epoch", "initial_weights", "steps",
             "fraud_probabilities")


def test_every_configuration_names_its_reference_and_count():
    # each configuration's reference (``pcgnn`` where it names none) is a
    # module of reference/ with the interface the harness and the check
    # call, and its step count the module of the same name under counts/
    b = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    for c in b["configs"]:
        cfg = harness.load_json(harness.HERE.parent / c["file"])
        name = cfg.get("reference", "pcgnn")
        assert (harness.HERE / "reference" / f"{name}.py").is_file(), name
        assert (harness.HERE / "counts" / f"{name}.py").is_file(), name
        mod = harness.reference_module(cfg)
        assert mod.__name__ == f"portbench.reference.{name}"
        assert all(callable(getattr(mod, f, None)) for f in INTERFACE), name
        count = importlib.import_module(f"portbench.counts.{name}")
        assert callable(getattr(count, "count", None)), name
    assert harness.reference_module({}) is ref


def test_reference_graph_semantics_by_hand():
    # 0->1, 0->2, 1->2, 3->0 and a repeat of 0->1 on four nodes
    src, dst = np.array([0, 0, 1, 3, 0]), np.array([1, 2, 2, 0, 1])
    d = refgraph.csr(src, dst, 4, 0.5, "cpu", directed=True)
    assert d.deg.tolist() == [3, 2, 1, 2]
    assert d.col.tolist() == [0, 1, 2, 1, 2, 2, 0, 3]
    u = refgraph.csr(src, dst, 4, 0.5, "cpu")
    assert u.deg.tolist() == [4, 3, 3, 2]
    # k = ceil(deg / 2); keff = deg where deg <= k + 1
    assert d.ksample.tolist() == [2, 1, 1, 1]
    assert d.keff.tolist() == [3, 2, 1, 2]


def gcn_cell(stores: bool) -> tuple:
    cfg, traffic = small_cell(GCN, "tiny", 16)
    cfg["model"]["edge_windows"] = stores
    return cfg, traffic


@pytest.mark.parametrize("stores", [True, False])
def test_gcn_reference_follows_the_programs_gcn(stores):
    # the port's GCN through the harness, with a bf16 homo store and with
    # none, against the plain GCN: first loss, first gradient, the update
    # after three steps, the validation probabilities
    cfg, traffic = gcn_cell(stores)
    run = harness.Run(cfg, traffic, 2**31 + 9, torch.device("cpu"))
    run.setup()
    g = run.t.graph
    assert (g.homo.ewin is not None) == stores
    assert all(r.ewin is None for r in g.relations) and g.fused is None
    assert set(run.rec["params0"]) == {"enc.w", "head.w"}
    run.window(0.2)
    run.close()
    run.reference()
    assert run.ref.permutation and run.ref.sample_size == len(
        run.ref.idx_train)
    # bf16-rounded window rows only under the bf16 store
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


def test_gcn_aggregate_by_hand():
    # three nodes, edges 0-1 and 1-2, self-loops: node 1 sums all three
    # rows over sqrt(3); node 0 rows 0 and 1 over sqrt(2)
    raw = gen.RawGraph(features=np.arange(6, dtype=np.float32).reshape(3, 2),
                       labels=np.array([0, 1, 0]),
                       srcs=(np.array([0]), np.array([1])),
                       dsts=(np.array([1]), np.array([2])))
    cfg = {"seed": 2, "graph": {}, "model": {
        "train_ratio": 0.34, "test_ratio": 0.5, "edge_windows": False}}
    g = gcnref.build_graph(raw, cfg, "cpu")
    assert g.relations[0].deg.tolist() == [2, 3, 2]
    agg = gcnref.aggregate(g, torch.tensor([0, 1]), False)
    x = torch.as_tensor(raw.features)
    torch.testing.assert_close(agg[0], (x[0] + x[1]) / 2 ** 0.5)
    torch.testing.assert_close(agg[1], x.sum(0) / 3 ** 0.5)
    assert gcnref.edges_per_epoch(g) == float(
        g.relations[0].deg[torch.as_tensor(g.idx_train)].sum())


def permuted_plan(g, batch: int) -> tuple:
    """A plan that takes every training node of ``g`` once, padded with
    id 0 at weight 0, as the trainer lays out a baseline's epoch."""
    tr = torch.as_tensor(g.idx_train)[torch.randperm(len(g.idx_train))]
    nb = -(-len(tr) // batch)
    ids = torch.zeros(nb * batch, dtype=torch.int64)
    ids[: len(tr)] = tr
    w = torch.zeros(nb * batch)
    w[: len(tr)] = 1.0
    return ids.view(nb, batch), w.view(nb, batch), g.labels[ids].view(
        nb, batch)


def test_pick_bad_holds_a_gcn_plan_to_every_training_node_once():
    cfg, traffic = small_cell(GCN, "tiny", 16)
    draws = {k: v for k, v in cfg["graph"].items() if k != "directed"}
    raw = gen.draw_graph(cfg["seed"], **draws, **traffic["graph"])
    g = gcnref.build_graph(raw, cfg, "cpu")
    b, w, y = permuted_plan(g, 16)
    assert check.pick_bad(g, b, w, y) == 0

    def bad(ids, graph=g):
        return check.pick_bad(graph, ids.view(b.shape), w,
                              g.labels[ids].view(b.shape))
    # slot 1 takes slot 0's node: that node repeated, slot 1's missing
    rep = b.clone().view(-1)
    rep[1] = rep[0]
    assert bad(rep) == 2
    # slots 5 and 7 take slot 6's node: two repeats, two missing
    rep2 = b.clone().view(-1)
    rep2[5] = rep2[7] = rep2[6]
    assert bad(rep2) == 4
    # the same plans under the pick's rule, which draws with replacement
    pick = dataclasses.replace(g)
    pick.permutation = False
    assert bad(rep, pick) == bad(rep2, pick) == 0


def test_pick_bad_reads_nothing_on_a_pcgnn_plan():
    cfg, traffic = small_cell("pcgnn-yelpchi.train", "tiny", 16)
    run = harness.Run(cfg, traffic, 5, torch.device("cpu"))
    run.setup()
    run.reference()
    assert not run.ref.permutation
    b = run.rec["plan_batches"]
    # the pick draws with replacement: repeats are its own
    real = b.reshape(-1)[: run.ref.sample_size]
    assert len(set(real.tolist())) < real.numel()
    assert check.pick_bad(run.ref, b, run.rec["plan_weights"],
                          run.rec["plan_labels"]) == 0


@pytest.mark.parametrize("workload", [GCN, "pcgnn-yelpchi.train"])
def test_the_stores_check_reads_the_graphs_the_model_reads(monkeypatch,
                                                          workload):
    from pcgnn_tpu_torch.train import trainer
    cfg, traffic = small_cell(workload, "tiny", 16)
    harness.Run(cfg, traffic, 5, torch.device("cpu")).setup()
    # the program builds no store where the configuration states one
    monkeypatch.setattr(trainer, "materialize_edge_windows",
                        lambda graph, **kw: graph)
    with pytest.raises(RuntimeError, match="edge_windows True"):
        harness.Run(cfg, traffic, 5, torch.device("cpu")).setup()
