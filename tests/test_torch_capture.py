"""The trainer's epoch runner (``train.capture.StepRunner``) on the CPU.

On the CPU the runner takes the eager step (``train_step``) with the hub
lane planned once per stack of batches; the captured CUDA graph is held to
this eager step bit for bit on the card (``tests/test_torch_cuda.py``).
Here: the epoch plan gives the same parameters as per-step plans (the hub
lane's float64 sums do not depend on a chunk's width), the plan only grows,
GraphSAGE's draws from the runner's one generator equal a fresh generator
a step, Adam state loads in place, and the capture is refused off a single
CUDA device.
"""

import numpy as np
import pytest
import torch

from pcgnn_tpu_torch.ops import hub
from pcgnn_tpu_torch.train.capture import StepRunner
from pcgnn_tpu_torch.train.results import ResultManager
from pcgnn_tpu_torch.train.trainer import (Trainer, adam_state,
                                           load_adam_state, make_optimizer,
                                           train_step)


def _cfg(**kw):
    cfg = dict(seed=2, data_name="synthetic:skew-tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=2,
               valid_epochs=10 ** 9, batch_size=64, patience=10 ** 9,
               exp_num=0)
    cfg.update(kw)
    return cfg


def _trainer(tmp_path, **kw):
    cfg = _cfg(**kw)
    return Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)),
                   device="cpu")


def _eager_epochs(t, model, opt, epochs=2):
    """The epochs as before the epoch plan: ``train_step`` a batch, each
    planning its own hub chunks, GraphSAGE's draws from a fresh generator
    a step."""
    losses = []
    for e in range(epochs):
        batches, weights = t.epoch_plan(e)
        losses.append(torch.stack([
            train_step(model, opt, t.graph, b, t.labels[b], w, t.consts,
                       t.step_generator(e, i))
            for i, (b, w) in enumerate(zip(batches, weights))]).mean())
    return torch.stack(losses)


@pytest.mark.parametrize("kw", [{}, {"edge_windows": False},
                                {"model": "GCN"},
                                {"data_name": "synthetic:small",
                                 "model": "SAGE", "num_sample": 5}],
                         ids=["pcgnn", "score_table", "gcn", "sage_draws"])
def test_epoch_plan_equals_per_step_plans(tmp_path, kw):
    """Two epochs through ``run_epoch`` (one hub plan an epoch, padded
    chunks) give the same losses and parameters, bit for bit, as the same
    steps each planning its own batch; GraphSAGE's draws from the runner's
    generator, seeded a step, equal a fresh generator a step."""
    t = _trainer(tmp_path, **kw)
    assert not t.capture
    m1, m2 = t.new_model(), t.new_model()
    o1, o2 = t.new_optimizer(m1), t.new_optimizer(m2)
    got = torch.stack([t.run_epoch(m1, o1, e) for e in range(2)])
    want = _eager_epochs(t, m2, o2)
    assert torch.equal(got, want)
    for (name, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), name
    r = t.runner(m1, o1)
    assert r.eager_steps == 2 * t.num_batches and r.captures == 0
    if "data_name" not in kw:
        # skew-tiny: the epoch planned relation 0's hub chunks
        plans = r.stats()["plans"]
        assert plans[0] and all(p is None for p in plans[1:])


def test_the_runner_keeps_the_largest_plan(tmp_path):
    """The runner's plan is the union of every stack's: it grows with a
    wider or longer stack and stays when a smaller one follows, so every
    step of a run takes the same widths, captured or eager."""
    t = _trainer(tmp_path)
    rel = t.graph.relations[0]
    order = torch.argsort(rel.deg, descending=True)
    plain = torch.nonzero(rel.deg <= rel.window_width)[:, 0][:60]
    small = torch.cat([order[4:6], plain])[None]
    big = torch.cat([order[:1].repeat(40), plain[:20]])[None]
    m = t.new_model()
    r = t.runner(m, t.new_optimizer(m))
    p_small = r.plan(small)
    p_big = hub.epoch_hub_plans(t.graph.relations, big)
    assert r.plan(big) == hub.plan_union(p_small, p_big)
    assert r.plan(small) == hub.plan_union(p_small, p_big)
    assert len(r.plans[0]) == 2 > len(p_small[0])
    assert hub.plan_covers(r.plans, p_small)


def test_the_runner_is_kept_for_its_pair(tmp_path):
    t = _trainer(tmp_path)
    m = t.new_model()
    o = t.new_optimizer(m)
    r = t.runner(m, o)
    assert t.runner(m, o) is r
    m2 = t.new_model()
    assert t.runner(m2, t.new_optimizer(m2)) is not r


def test_single_step_runs_the_rolled_batches(tmp_path):
    """``single_step``'s steps are the runner's over the nscan rolled
    batches, with one plan for all of them: the same bits as ``train_step``
    on each rolled batch."""
    t = _trainer(tmp_path)
    rng = np.random.default_rng(0)
    batch = rng.choice(t.idx_train, t.batch_size)
    y = t.graph.labels.numpy()[batch]
    w = np.ones(t.batch_size, np.float32)
    m1, m2 = t.new_model(), t.new_model()
    fn, args = t.single_step(m1, t.new_optimizer(m1), batch, y, w, nscan=3)
    loss = fn(*args)
    o2 = t.new_optimizer(m2)
    b, yy, ww = args[2:]
    for i in range(3):
        want = train_step(m2, o2, t.graph, torch.roll(b, i),
                          torch.roll(yy, i), torch.roll(ww, i), t.consts)
    assert torch.equal(loss, want)
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)


def test_step_hook_brackets_every_step(tmp_path):
    t = _trainer(tmp_path)
    m = t.new_model()
    o = t.new_optimizer(m)
    seen = []
    t.runner(m, o).step_hook = seen.append
    t.run_epoch(m, o, 0)
    assert seen == ["start", "end"] * t.num_batches


def test_make_optimizer_is_capturable_only_on_cuda():
    """Adam keeps its step count on the card when the model is there (a
    graph can then hold the update); the CPU refuses ``capturable``."""
    opt = make_optimizer(torch.nn.Linear(4, 2), 0.01, 0.0)
    assert opt.defaults["capturable"] is False
    w = torch.zeros(2, requires_grad=True)
    bad = torch.optim.Adam([w], capturable=True)
    w.sum().backward()
    with pytest.raises(Exception, match="capturable"):
        bad.step()


def test_load_adam_state_in_place(tmp_path):
    """Into an optimizer that has state, ``load_adam_state`` copies the
    values into the tensors it holds (a captured step reads those), and
    the next step equals one from a fresh optimizer loaded the other
    way."""
    t = _trainer(tmp_path)
    m = t.new_model()
    o = t.new_optimizer(m)
    t.run_epoch(m, o, 0)
    saved = adam_state(m, o), {k: v.clone() for k, v in
                               m.state_dict().items()}
    t.run_epoch(m, o, 1)
    held = [v for p in m.parameters() for v in o.state[p].values()]
    load_adam_state(m, o, saved[0])
    m.load_state_dict(saved[1])
    assert all(a is b for a, b in zip(
        held, [v for p in m.parameters() for v in o.state[p].values()]))
    m2 = t.new_model()
    m2.load_state_dict(saved[1])
    o2 = t.new_optimizer(m2)
    load_adam_state(m2, o2, saved[0])
    for p, q in zip(m.parameters(), m2.parameters()):
        for k, v in o.state[p].items():
            assert torch.equal(v, o2.state[q][k]), k
    assert torch.equal(t.run_epoch(m, o, 1), t.run_epoch(m2, o2, 1))


def test_capture_needs_a_single_cuda_device(tmp_path):
    with pytest.raises(ValueError, match="single CUDA device"):
        Trainer(_cfg(), result=ResultManager(_cfg(), root=str(tmp_path)),
                device="cpu", capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        StepRunner(lambda *a: None, (), torch.device("cpu"), capture=True,
                   draws=False)
