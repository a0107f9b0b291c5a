"""The plain reference against the program's CPU path at a small size:
the steps the harness records, and whole runs through the harness."""

import math

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import pcgnn as ref
from portbench.tests.helpers import run_small, small_cell


@pytest.mark.parametrize("workload,preset,batch", [
    ("pcgnn-yelpchi.train", "tiny", 16),
    ("pcgnn-amazon.train", "tiny", 16),
    ("pcgnn-yelpchi.hubs", "skew-tiny", 64),
])
def test_reference_follows_the_programs_steps(workload, preset, batch):
    cfg, traffic = small_cell(workload, preset, batch)
    run = harness.Run(cfg, traffic, 5, torch.device("cpu"))
    run.setup()
    run.close()
    g = run.ref
    prog = check.program_readings(run.rec, "cpu")
    sound = check.reference_readings(g, run.rec, cfg["model"])
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
    b = run.rec["plan_batches"]
    deg, cap = run.hub_cap[0]
    assert int((deg[b] > cap).sum()) > 0


@pytest.mark.parametrize("workload,preset,batch", [
    ("pcgnn-yelpchi.train", "tiny", 16),
    ("pcgnn-amazon.train", "tiny", 16),
    ("pcgnn-yelpchi.hubs", "skew-tiny", 64),
])
@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_is_correct(workload, preset, batch, traced):
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


def test_tf32_rounding_keeps_ten_bits():
    a = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 3.0],
                     dtype=torch.float32)
    got = ref.tf32(a)
    assert got.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 3.0]
    x = torch.randn(64, 64, dtype=torch.float32)
    r = ref.tf32(x)
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
    a.setup()
    b.setup()
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
