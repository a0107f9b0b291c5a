"""The port's spans and section map on the CPU (``utils/profiling.py``).

Spans are operator ranges while a profiler records and one shared null
context otherwise; ``run_epoch`` and ``evaluate`` leave them nested as
their calls nest.  A ``*.readback`` span marks the hub plan's copy (none
on a graph without hubs) and evaluate's.  The section map's arithmetic is held
with a fake node counter, and the training step's sections with a counter
of the aten operations the eager step runs.  The replays' device
operations against the captured map are a card test
(``tests/test_torch_cuda.py``).
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from pcgnn_tpu_torch.train.capture import sections_marker
from pcgnn_tpu_torch.train.results import ResultManager
from pcgnn_tpu_torch.train.trainer import Trainer, train_step
from pcgnn_tpu_torch.utils import profiling
from pcgnn_tpu_torch.utils.profiling import (in_section, node_sections,
                                             recording_sections, section,
                                             span)


def _trainer(tmp_path, data_name):
    cfg = dict(seed=2, data_name=data_name, model="PCGNN", train_ratio=0.4,
               test_ratio=0.67, emb_size=16, lr=0.01, weight_decay=0.001,
               alpha=2.0, rho=0.5, epochs=2, valid_epochs=10 ** 9,
               batch_size=64, patience=10 ** 9, exp_num=0)
    return Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)),
                   device="cpu")


def _spans(prof) -> list:
    """(name, start, end) of every ``pcgnn.*`` range, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("pcgnn.") and e.device_type().name == "CPU":
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return sorted(out, key=lambda x: x[1])


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_span_off_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert span("pcgnn.a") is span("pcgnn.b") is profiling._NULL
    with span("pcgnn.off"):
        pass
    profiling.marker("pcgnn.off.marker")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert span("pcgnn.on") is not profiling._NULL
        with span("pcgnn.on"):
            profiling.marker("pcgnn.on.marker")
    names = [s[0] for s in _spans(prof)]
    assert names == ["pcgnn.on", "pcgnn.on.marker"]
    # an operator range, not a user annotation: it sits among the host's
    # operators
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "pcgnn.on"]
    assert len(ev) == 1 and not ev[0].is_user_annotation()


def test_epoch_and_evaluate_spans_nest(tmp_path):
    t = _trainer(tmp_path, "synthetic:skew-tiny")
    model = t.new_model()
    opt = t.new_optimizer(model)
    t.run_epoch(model, opt, 0)
    t.evaluate(model, t.idx_valid, t.y_valid)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.run_epoch(model, opt, 1)
        t.evaluate(model, t.idx_valid, t.y_valid)
    sp = _spans(prof)
    (epoch,) = [s for s in sp if s[0] == "pcgnn.epoch"]
    (ev,) = [s for s in sp if s[0] == "pcgnn.evaluate"]
    assert epoch[2] <= ev[1]
    kids = [s for s in sp if _inside(s, epoch) and s is not epoch]
    top = [s for s in kids if not any(_inside(s, o) and o is not s
                                      for o in kids)]
    # the eager runner loads no static buffers
    want = (["pcgnn.epoch.pick", "pcgnn.runner.plan"]
            + ["pcgnn.runner.step"] * t.num_batches)
    assert [s[0] for s in top] == want
    # the plan's one read-back is its child
    (rb,) = [s for s in kids if s[0] == "pcgnn.hub.readback"]
    assert _inside(rb, top[1])
    for a, b in zip(top, top[1:]):
        assert a[2] <= b[1]
    kids = [s for s in sp if _inside(s, ev) and s is not ev]
    names = [s[0] for s in kids]
    assert names[0] == "pcgnn.evaluate.stack"
    assert names[-2:] == ["pcgnn.evaluate.readback", "pcgnn.evaluate.metrics"]
    assert "pcgnn.runner.plan" in names
    assert names.count("pcgnn.runner.step") == len(
        t._stack(t.idx_valid))


@pytest.mark.parametrize("data_name,per_epoch", [("synthetic:tiny", 0),
                                                 ("synthetic:skew-tiny", 1)])
def test_readbacks_per_epoch_and_evaluate(tmp_path, data_name, per_epoch):
    """Each deliberate device-to-host copy is a ``*.readback`` span: the
    hub plan's, once an epoch on a graph with hubs, and evaluate's
    probabilities after its stack's plan."""
    t = _trainer(tmp_path, data_name)
    assert any(r.has_hubs for r in t.graph.relations) == bool(per_epoch)
    model = t.new_model()
    opt = t.new_optimizer(model)
    t.evaluate(model, t.idx_valid, t.y_valid)     # makes the forward's runner
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for epoch in range(3):
            t.run_epoch(model, opt, epoch)
        t.evaluate(model, t.idx_valid, t.y_valid)
    sp = _spans(prof)
    copies = [s for s in sp if s[0].endswith(".readback")]
    epochs = [s for s in sp if s[0] == "pcgnn.epoch"]
    (ev,) = [s for s in sp if s[0] == "pcgnn.evaluate"]
    assert len(epochs) == 3
    for ep in epochs:
        assert sum(_inside(c, ep) for c in copies) == per_epoch
    inside = [c[0] for c in copies if _inside(c, ev)]
    assert inside == ["pcgnn.hub.readback"] * per_epoch + [
        "pcgnn.evaluate.readback"]
    assert len(copies) == 4 * per_epoch + 1


def _fake_counter():
    n = [0]

    def add(k):
        n[0] += k
    return n, add


def test_section_map_arithmetic():
    n, add = _fake_counter()
    assert section("gather") is None              # no capture: a no-op
    with recording_sections(lambda: n[0]) as rec:
        with pytest.raises(RuntimeError):
            with recording_sections(lambda: 0):
                pass
        add(2)                                     # before any section
        assert section("io") is None
        add(3)
        assert section("gather") == "io"
        add(4)
        section("choose")
        section("choose")                          # nothing made between
        add(1)
        hub_part = in_section("hub")(lambda k: add(k))
        hub_part(5)                                # inside choose
        add(2)                                     # choose again
        section(None)
        add(1)                                     # outside every section
        section("io")
        add(2)
        section("io")                              # merges with its run
        add(1)
        got = rec.close()
    assert section("io") is None
    assert got == {"nodes": 21, "runs": [
        ("io", 2, 5), ("gather", 5, 9), ("choose", 9, 10), ("hub", 10, 15),
        ("choose", 15, 17), ("io", 18, 21)]}
    runs = got["runs"]
    assert all(a[2] <= b[1] for a, b in zip(runs, runs[1:]))
    names = node_sections(got)
    assert names[:2] == ["other"] * 2 and names[17] == "other"
    assert names.count("choose") == 3 and names.count("hub") == 5
    assert sections_marker(got) == (
        "pcgnn.runner.sections:21:io=2-5,gather=5-9,choose=9-10,"
        "hub=10-15,choose=15-17,io=18-21")


def test_in_section_restores_on_raise():
    n, add = _fake_counter()

    @in_section("hub")
    def boom():
        add(1)
        raise ValueError("x")

    with recording_sections(lambda: n[0]) as rec:
        section("choose")
        with pytest.raises(ValueError):
            boom()
        assert rec.current == "choose"
        assert boom.__name__ == "boom"


class _OpCount(TorchDispatchMode):
    """Counts the aten operations run: the eager step's stand-in for the
    nodes a capture makes."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("data_name,hub", [("synthetic:tiny", False),
                                           ("synthetic:skew-tiny", True)])
def test_train_step_sections(tmp_path, data_name, hub):
    """The eager PC-GNN step marks every section of the map, each run of
    operations in the order the step makes them, and leaves few
    operations outside them."""
    t = _trainer(tmp_path, data_name)
    model = t.new_model()
    opt = t.new_optimizer(model)
    batches, weights = t.epoch_plan(0)
    b, w = batches[0], weights[0]
    plans = t.runner(model, opt).plan(batches)
    train_step(model, opt, t.graph, b, t.labels[b], w, t.consts,
               hub_plans=plans)
    count = _OpCount()
    with count, recording_sections(lambda: count.n) as rec:
        train_step(model, opt, t.graph, b, t.labels[b], w, t.consts,
                   hub_plans=plans)
        got = rec.close()
    names = node_sections(got)
    want = {"gather", "choose", "oversample", "dense", "backward", "adam"}
    assert set(names) - {"other"} == want | ({"hub"} if hub else set())
    assert names.count("other") <= 0.05 * len(names)
    order = [r[0] for r in got["runs"]]
    assert order[-2:] == ["backward", "adam"]
    assert order[0] == "gather"
