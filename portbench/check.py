"""The comparison that decides ``correct``.

The program's outputs, recorded from its timed path, against the plain
reference the configuration names (a module of ``reference/``, reached
only through its interface) on the same raw arrays and initial weights.
The training numbers come from epoch 0 as set-up runs it the second
time, from the initial weights and a fresh Adam state, every step a
replay of the captured step the window replays (``harness.Run.warm_up``):

* ``pick_bad``: slots of the first epoch's plan whose id is not a training
  node of the reference's split, whose weight is not 1 (0 on the padding
  past the plan's ``sample_size`` real slots: PC-GNN's ``2 |train
  positives|`` picks), or whose label is not the node's; and where the
  reference's plan is a permutation (``permutation``: GCN's, every
  training node once), each training node missing from the real slots
  and each repeat of one; an exact comparison, limit 0;
* ``loss_gap``: the relative gap of the first step's loss;
* ``grad_gap``: the first step's gradient, as Adam's first moment holds it
  after that step, by the worst leaf: the gap between the two norms over
  the larger of the reference leaf's norm and the median leaf's;
* ``update_gap``: each leaf's change over the first three steps, the gap
  between the two norms over the reference leaf's, at the median leaf;
* ``prob_gap``: the largest absolute gap of a validation node's fraud
  probability, at the window's last validation, from the parameters the
  program held then.

A model of the homo graph (GCN) is compared by the same numbers: its
reference's one relation is the homo graph, and its plan a permutation.

The second and third steps' losses, and the worst leaf's change, are
followed and not compared: after one Adam step the two sides' weights
differ in the last bit, a selection score then moves by one float32 step
now and then, a few choices flip, and those numbers swing from seed to
seed (the first step's loss and the median leaf's change stay steady).
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone; they are left out of
``update_gap`` (none is, in the configurations here).  The limits are in
the cell's traffic file, under ``limits``.
"""

from __future__ import annotations

import numpy as np
import torch


def worst_leaf_gap(prog: dict, refv: dict) -> float:
    """Largest |norm(prog leaf) - norm(ref leaf)| over max(norm(ref leaf),
    median ref leaf norm)."""
    rn = {k: float(refv[k].double().norm()) for k in refv}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
               for k in rn)


def median_leaf_gap(prog: dict, refv: dict, keep) -> float:
    """The median, over the leaves in ``keep``, of |norm(prog leaf) -
    norm(ref leaf)| over norm(ref leaf)."""
    gaps = [abs(float(prog[k].double().norm()) - float(refv[k].double()
                                                       .norm()))
            / float(refv[k].double().norm()) for k in refv if k in keep]
    return float(np.median(gaps))


def moving_leaves(grad: dict) -> set:
    """Leaves whose gradient norm reaches a thousandth of the median
    leaf's."""
    norms = {k: float(v.double().norm()) for k, v in grad.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v >= 1e-3 * med}


def pick_bad(g, batches, weights, ys) -> int:
    """Slots of one epoch's plan that break the plan's guarantees (module
    docstring)."""
    ids = batches.reshape(-1).cpu().numpy()
    w = weights.reshape(-1).cpu().numpy()
    y = ys.reshape(-1).cpu().numpy()
    s = g.sample_size
    train = np.zeros(g.features.shape[0], bool)
    train[g.idx_train] = True
    labels = g.labels.cpu().numpy()
    bad = int((~train[ids[:s]]).sum()) + int((w[:s] != 1.0).sum())
    bad += int((w[s:] != 0.0).sum()) + int((y != labels[ids]).sum())
    if g.permutation:
        seen = np.bincount(ids[:s], minlength=train.shape[0])[g.idx_train]
        bad += int((seen == 0).sum()) + int(np.maximum(seen - 1, 0).sum())
    return bad


def reference_readings(ref, g, rec: dict, hyper: dict,
                       low: bool = False) -> dict:
    """Reference module ``ref``'s own outputs on its graph ``g`` for what
    ``rec`` recorded (``low``: the control, TF32 products)."""
    dev = g.features.device
    steps = ref.steps(
        g, {k: v.to(dev) for k, v in rec["params0"].items()},
        [b.to(dev) for b in rec["batches"]],
        [w.to(dev) for w in rec["weights"]], hyper, low)
    nodes = torch.as_tensor(g.idx_valid, device=dev)
    probs = ref.fraud_probabilities(
        g, {k: v.to(dev) for k, v in rec["valid_params"].items()}, nodes,
        hyper, low)
    return {"losses": steps["losses"], "grad": steps["grad"],
            "change": {k: steps["params"][k] - rec["params0"][k].to(dev)
                       for k in steps["params"]},
            "probs": probs}


def gaps(prog: dict, refr: dict) -> dict:
    """The compared numbers of program outputs ``prog`` (the same keys as
    ``reference_readings`` gives) against reference readings ``refr``."""
    loss = abs(prog["losses"][0] - refr["losses"][0]) / abs(
        refr["losses"][0])
    moving = moving_leaves(refr["grad"])
    dev = refr["probs"].device
    return {
        "loss_gap": loss,
        "grad_gap": worst_leaf_gap(prog["grad"], refr["grad"]),
        "update_gap": median_leaf_gap(prog["change"], refr["change"],
                                      moving),
        "prob_gap": float((prog["probs"].to(dev) - refr["probs"]).abs()
                          .max()),
    }


def program_readings(rec: dict, device) -> dict:
    """What the program produced, from the recorded timed path: the
    first three losses, the first gradient (Adam's first moment after
    step 1 over 1 - beta1), the change after step 3, the validation
    probabilities."""
    return {
        "losses": [float(x) for x in rec["losses"]],
        "grad": {k: v.to(device) / 0.1 for k, v in rec["exp_avg1"].items()},
        "change": {k: rec["params3"][k].to(device) - rec["params0"][k]
                   .to(device) for k in rec["params3"]},
        "probs": torch.as_tensor(rec["valid_probs"], device=device),
    }


def compare(ref, g, rec: dict, hyper: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) of one run's record against
    reference module ``ref`` on its graph ``g``."""
    dev = g.features.device
    numbers = {"pick_bad": pick_bad(g, rec["plan_batches"],
                                    rec["plan_weights"], rec["plan_labels"])}
    numbers.update(gaps(program_readings(rec, dev),
                        reference_readings(ref, g, rec, hyper)))
    rows = [(k, numbers[k], limits[k]) for k in
            ("pick_bad", "loss_gap", "grad_gap", "update_gap", "prob_gap")]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
