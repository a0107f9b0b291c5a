"""A run with the timed path broken underneath comes out not correct, for
each fault a one-card training cell can have, and the control (the
reference in TF32 in the program's place) fails the cells' limits."""

import pytest
import torch

from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.train.trainer import Trainer
from portbench import calibrate
from portbench.tests.helpers import CELLS, lane, run_small, small_cell


def model_class(name: str) -> type:
    """The class the port's registry builds for a configuration's
    ``model``."""
    return type(build_model(name, feat_dim=1, emb_dim=1, num_relations=1,
                            alpha=2.0, rho=0.5))


def state_unchanged(monkeypatch, model):
    # the step computes its loss and gradients and leaves the parameters
    # and Adam's state as they were
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def half_batch(monkeypatch, model):
    # the second half of every batch left out, the mean over the rest
    loss = model.loss

    def halved(self, graph, batch, y, w=None, **kw):
        w = torch.ones_like(y, dtype=torch.float32) if w is None else w
        w = w.clone()
        w[w.shape[0] // 2:] = 0.0
        return loss(self, graph, batch, y, w, **kw)
    monkeypatch.setattr(model, "loss", halved)


def stale_row(monkeypatch, model):
    # after the first epoch (on the card, the one that captures), every
    # step reads the batch of the step before it: a replay that takes a
    # stale row of the static buffers
    run_epoch, loss = Trainer.run_epoch, model.loss
    seen = {"epochs": 0, "last": None}

    def counted(self, *args, **kw):
        seen["epochs"] += 1
        return run_epoch(self, *args, **kw)

    def stale(self, graph, batch, y, w=None, **kw):
        last, seen["last"] = seen["last"], (batch, y, w)
        if seen["epochs"] > 1 and last is not None:
            batch, y, w = last
        return loss(self, graph, batch, y, w, **kw)
    monkeypatch.setattr(Trainer, "run_epoch", counted)
    monkeypatch.setattr(model, "loss", stale)


def answer_altered(monkeypatch, model):
    # one validation answer altered where it is produced
    to_prob = model.to_prob

    def altered(self, graph, batch, **kw):
        probs, scores = to_prob(self, graph, batch, **kw)
        probs = probs.clone()
        probs[0, 1] = (probs[0, 1] + 0.5) % 1.0
        return probs, scores
    monkeypatch.setattr(model, "to_prob", altered)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   stale_row, answer_altered])
@pytest.mark.parametrize("workload,preset,batch", CELLS)
def test_a_broken_step_is_not_correct(monkeypatch, fault, workload, preset,
                                      batch):
    lane(monkeypatch, workload)
    cfg, _ = small_cell(workload, preset, batch)
    # the fault in the step of the cell's own model
    fault(monkeypatch, model_class(cfg["model"]["model"]))
    line, rows = run_small(workload, preset, batch, seed=21)
    assert line["correct"] is False, rows


@pytest.mark.parametrize("workload,preset,batch", CELLS)
def test_the_control_fails_the_limits(monkeypatch, workload, preset, batch):
    # the control: the reference in TF32 in the program's place, read as
    # the calibration reads it on the card, here at a small size
    lane(monkeypatch, workload)
    cfg, traffic = small_cell(workload, preset, batch)
    limits = traffic["limits"]
    lines = list(calibrate.readings(cfg, traffic, [31, 32, 33], 0.3, 3,
                                    torch.device("cpu")))
    for line in lines:
        assert all(v <= limits[k] for k, v in line["program"].items()), line
        assert any(v > limits[k] for k, v in line["control"].items()), line
        for fault in ("half_batch", "wrong_row"):
            got = line["faults"][fault]
            assert any(v > limits[k] for k, v in got.items()), line
        assert line["faults"]["answer_altered"]["prob_gap"] > \
            limits["prob_gap"]
