"""The readers of the program's own spans, read-backs and section maps
(``portbench/spans.py``) on a fixed record, the same record without them
(a program that leaves none: every such reader finds nothing), and the
accepted readers and breakdown beside them."""

import copy

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness, trace
from portbench.spans import find_replays, parse_marker, replay_sections
from portbench.tests.helpers import bench

NEW = ("epoch_pick_ms", "epoch_plan_ms", "epoch_launch_ms", "epoch_idle_ms",
       "epoch_readbacks", "validate_metrics_ms", "step_choose_ms",
       "step_oversample_ms", "step_backward_ms", "step_hub_ms")
# a graph of 20 nodes: five a section, 10-14 in none
MAP = "pcgnn.runner.sections:20:choose=0-5,hub=5-10,backward=15-20"


def _replay(lo: float, us: tuple, cid: int) -> list:
    """A replay's 20 device operations from ``lo`` us, each section's five
    ``us`` long together, back to back, launched by the call ``cid``."""
    ops = []
    for sec, d in zip(("score", "ragged_gather_kernel", "add", "mm_backward"),
                      us):
        for j in range(5):
            ops.append((f"{sec}_{j}", lo + d * j / 5, lo + d * (j + 1) / 5,
                        "kernel", cid))
        lo += d
    return ops


def program_rec():
    """One epoch of two replays and one validation, in microseconds: the
    plan reads back once, the load copies and fills, the step's graph of
    20 nodes runs twice back to back, the epoch ends on a mean and the
    loss's read-back."""
    cpu = [("pcgnn.epoch", 1.0, 80.0), ("pcgnn.epoch.pick", 2.0, 10.0),
           ("aten::randperm", 3.0, 9.0),
           ("pcgnn.runner.plan", 11.0, 20.0),
           ("pcgnn.hub.readback", 12.0, 19.0),
           ("cudaMemcpyAsync", 13.0, 14.0),
           ("pcgnn.runner.load", 21.0, 25.0),
           ("cudaMemcpyAsync", 22.0, 23.0),
           ("cudaLaunchKernel", 24.0, 24.5)]
    for lo in (26.0, 31.0):
        cpu += [("pcgnn.runner.step", lo, lo + 4.0),
                (MAP, lo + 0.5, lo + 0.5),
                ("cudaGraphLaunch_v10000", lo + 2.0, lo + 3.0)]
    cpu += [("cudaLaunchKernel", 81.0, 82.0),
            ("cudaMemcpyAsync", 84.0, 85.0),
            ("pcgnn.evaluate", 101.0, 190.0),
            ("pcgnn.evaluate.readback", 140.0, 148.0),
            ("pcgnn.evaluate.metrics", 150.0, 160.0)]
    dev = ([("Memcpy DtoH", 14.0, 15.0, "memcpy", 1),
            ("Memcpy HtoD", 23.0, 24.0, "memcpy", 2),
            ("fill", 25.0, 26.0, "kernel", 3)]
           + _replay(30.0, (2.0, 3.0, 1.0, 4.0), 4)
           + _replay(40.0, (3.0, 1.0, 1.0, 2.0), 5)
           + [("mean", 82.0, 83.0, "kernel", 6),
              ("Memcpy DtoH", 85.0, 86.0, "memcpy", 7),
              ("gemm", 110.0, 130.0, "kernel", 8)])
    return {"peaks": (3.35e12, 67e12), "trace": {
        "device_ops": dev, "cpu_ops": cpu, "wall": (0.0, 200.0),
        "graph_launches": [(28.0, 4), (33.0, 5)],
        "spans": {"portbench.epoch": [(0.0, 100.0)],
                  "portbench.validate": [(100.0, 200.0)]},
        "epoch_host_ms": [0.08], "captures": 0, "steps": 2, "rows": 100,
        "record_width": 670, "hub_neighbors": 4188, "reference": "pcgnn",
        "stores": True,
        "neighbors": 9000, "feat_dim": 16,
        "emb": 64, "relations": 3, "train_pos": 10, "params": 1000}}


def without_program(rec):
    rec = copy.deepcopy(rec)
    t = rec["trace"]
    t["cpu_ops"] = [o for o in t["cpu_ops"] if not o[0].startswith("pcgnn.")]
    return rec


def test_every_new_metric_is_declared_with_its_cells():
    # each declared, read from the program's spans or the trace; the
    # cells a list names are held to what its metric reads by
    # test_metric_lists_follow_their_workloads
    declared = {m["name"]: m for m in bench()["per_layer"]}
    assert set(NEW) <= set(declared)
    assert {declared[n]["source"] for n in NEW} == {"program_span",
                                                    "device_trace"}
    for n in NEW:
        assert declared[n].get("workloads", [n]), n


@pytest.mark.parametrize("name,want", [
    ("epoch_pick_ms", 0.008), ("epoch_plan_ms", 0.009),
    ("epoch_launch_ms", 0.008),
    # device busy in [1, 80]: 14-15, 23-24, 25-26, 30-47: 20 of 79
    ("epoch_idle_ms", 0.059), ("epoch_readbacks", 1.0),
    ("validate_metrics_ms", 0.010),
    # replays: score 2 and 3 us, the ragged gather 3 and 1, backward 4 and 2
    ("step_choose_ms", 0.0025), ("step_oversample_ms", 0.0),
    ("step_backward_ms", 0.003), ("step_hub_ms", 0.002)])
def test_new_reader_on_a_fixed_record(name, want):
    assert harness.reader(name)(program_rec()) == pytest.approx(want)
    assert harness.reader(name)(without_program(program_rec())) is None


def _with_epoch(t, at, stray=None, scale=1.0, drift=0.0):
    """``t`` with a copy of its epoch at ``at`` us, its operations
    ``scale`` times as long and ``drift`` us earlier on the card's clock,
    its calls' correlation ids ``at`` further, and a stray operation at
    ``stray`` us into it."""
    t["cpu_ops"] += [(n, s + at, e + at) for n, s, e in t["cpu_ops"]
                     if s < 100.0]
    t["graph_launches"] += [(s + at, c + int(at))
                            for s, c in t["graph_launches"] if s < 100.0]
    t["device_ops"] += [(n, s + at - drift, s + at - drift + scale * (e - s),
                         k, c + int(at))
                        for n, s, e, k, c in t["device_ops"] if s < 100.0]
    if stray is not None:
        t["device_ops"].append(("stray", at + stray, at + stray + 0.1, "k",
                                -1))
    t["spans"]["portbench.epoch"].append((at, at + 100.0))


def test_replays_are_found_by_count():
    # a replay is the operations its graph launch's correlation id marks,
    # as many as its map counts
    t = program_rec()["trace"]
    got = replay_sections(t)
    assert got == pytest.approx({"choose": 0.0025, "hub": 0.002,
                                 "other": 0.001, "backward": 0.003})
    assert parse_marker(MAP) == (["choose"] * 5 + ["hub"] * 5
                                 + ["other"] * 5 + ["backward"] * 5)
    assert [len(ops) for _, ops in find_replays(t)] == [20, 20]
    # an operation no graph launch accounts for, among the replays'
    t["device_ops"].append(("stray", 41.0, 41.5, "kernel", 9))
    assert replay_sections(t) == pytest.approx(got)
    # an epoch with a stray operation before its replays, its operations
    # twice as long, and one whose operations the card's clock puts 30 us
    # early, before its host span: every replay is found (eight replays,
    # 1 + 1 + 2 + 1 times)
    t = program_rec()["trace"]
    _with_epoch(t, 300.0)
    _with_epoch(t, 600.0, stray=26.5, scale=2.0)
    _with_epoch(t, 900.0, drift=30.0)
    assert len(find_replays(t)) == 8
    assert replay_sections(t) == pytest.approx(
        {k: 5 / 4 * v for k, v in got.items()})
    # a launch call the card ran no operation for, and operations the
    # profiler lost before the replays: nothing to count, nothing slips
    t = program_rec()["trace"]
    t["cpu_ops"].append(("cudaLaunchKernel", 24.6, 24.7))
    t["device_ops"] = t["device_ops"][3:]
    assert replay_sections(t) == pytest.approx(got)


def test_a_replay_not_found_reads_nothing():
    """Where one replay's operations are not all found, no section is
    read: an average over the replays found would rest on part of them."""
    # a replay with no map beside it (a program that leaves no marker)
    t = program_rec()["trace"]
    t["cpu_ops"] = [o for o in t["cpu_ops"] if o[0] != MAP]
    assert find_replays(t) is None and replay_sections(t) is None
    # an operation of the second replay lost from the trace
    t = program_rec()["trace"]
    t["device_ops"] = [o for o in t["device_ops"] if o[0] != "add_2"
                       or o[1] < 40.0]
    assert find_replays(t) is None and replay_sections(t) is None
    # the same, in one epoch of four: the other three do not stand in
    t = program_rec()["trace"]
    for at in (300.0, 600.0, 900.0):
        _with_epoch(t, at)
    assert len(find_replays(t)) == 8
    t["device_ops"] = [o for o in t["device_ops"] if o[0] != "score_0"
                       or o[1] < 600.0 or o[1] > 700.0]
    assert find_replays(t) is None and replay_sections(t) is None
    # a trace whose operations carry no correlation id
    t = program_rec()["trace"]
    t["device_ops"] = [o[:4] for o in t["device_ops"]]
    assert replay_sections(t) is None
    # no epoch span holds a replay
    t = program_rec()["trace"]
    t["spans"]["portbench.epoch"] = [(100.0, 200.0)]
    assert replay_sections(t) is None


def test_accepted_readers_and_breakdown_beside_the_programs_spans():
    """The accepted readers read no host operator: the same values with
    and without the program's spans.  The breakdown keeps its device ops
    and gaps; a gap that began in no operator now names the program's
    innermost span."""
    rec, bare = program_rec(), without_program(program_rec())
    # the CSR lane's section reader reads the program's maps too
    accepted = [m["name"] for m in bench()["per_layer"]
                if m["name"] not in NEW + ("step_gather_ms",)]
    for name in accepted:
        assert harness.reader(name)(rec) == harness.reader(name)(bare), name
    lo, hi = rec["trace"]["wall"]
    a = trace.breakdown(rec["trace"], lo, hi)
    b = trace.breakdown(bare["trace"], lo, hi)
    assert a["device_ops"] == b["device_ops"]
    assert [g[1] for g in a["idle_gaps"]] == [g[1] for g in b["idle_gaps"]]
    pairs = [(g[0], h[0]) for g, h in zip(a["idle_gaps"], b["idle_gaps"])]
    for now, before in pairs:
        where, op = before.split(": ", 1)
        assert now == before or (op == "no operator" and now.startswith(
            f"{where}: pcgnn.")), (now, before)
    assert ("portbench.epoch: pcgnn.runner.step",
            "portbench.epoch: no operator") in pairs
    assert ("portbench.validate: pcgnn.evaluate",
            "portbench.validate: no operator") in pairs


def test_trace_events_keep_the_programs_spans(tmp_path):
    """Through ``trace.events`` unchanged: the program's spans of a CPU
    epoch and evaluation arrive among the host's operators."""
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    cfg = dict(seed=2, data_name="synthetic:skew-tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=1,
               valid_epochs=10 ** 9, batch_size=64, patience=10 ** 9,
               exp_num=0)
    t = Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)),
                device="cpu")
    model = t.new_model()
    opt = t.new_optimizer(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.run_epoch(model, opt, 0)
        t.evaluate(model, t.idx_valid, t.y_valid)
    ev = trace.events(prof)
    rec = {"trace": {**ev, "spans": {"portbench.epoch": [],
                                     "portbench.validate": []}}}
    assert harness.reader("epoch_readbacks")(rec) == 1.0
    assert harness.reader("epoch_pick_ms")(rec) > 0
    assert harness.reader("validate_metrics_ms")(rec) > 0
    assert harness.reader("epoch_launch_ms")(rec) > 0
