"""The roofline counts of ``portbench/counts``."""

import pytest
import torch

from portbench import harness
from portbench.counts import peaks, ragged_gather, step, window_gather
from portbench.tests.helpers import small_cell

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
    deg, cap = run.hub_cap[0]
    hubs = torch.nonzero(deg > cap)[:, 0]
    plain = torch.nonzero(deg <= cap)[:, 0]
    b = torch.cat([hubs[:3], plain[:5], hubs[3:4]])[None, :]
    w = torch.ones(b.shape, dtype=torch.float32)
    w[0, -1] = 0.0                      # a padding slot: not counted
    want = int(deg[hubs[:3]].sum())
    assert run._hub_neighbors([(b, w)]) == want
    assert ragged_gather.id_bytes(want) == 8 * want


def test_step_count_is_its_terms_at_the_tiny_preset():
    f, e, r, w, p = 16, 64, 3, 3 * 20 * 16, 30
    terms = step.byte_terms(rows=100, steps=4, feat_dim=f, record_width=w,
                            train_pos=p, hub_neighbors=50, params=9000)
    assert terms == {"records": 100 * w * 2,
                     "ids_labels_weights": 100 * 20,
                     "center_rows": 100 * f * 4,
                     "train_pos_rows": 4 * p * f * 4,
                     "hub_neighbor_rows": 50 * (f * 4 + 4),
                     "params_and_moments": 4 * 9000 * 24}
    fwd = 2 * (f * 2 + r * 2 * f * e + (f + r * e) * e + e * 2)
    assert step.flops(rows=10, feat_dim=f, emb=e, relations=r) == \
        10 * (2 * fwd + 2 * (e * 2 + r * e * e))
    assert step.least_seconds(3.35e6, 1.0, (3.35e12, 67e12)) == \
        pytest.approx(1e-6)


def test_params_count_matches_the_model():
    cfg, traffic = small_cell("pcgnn-yelpchi.train", "tiny", 16)
    run = harness.Run(cfg, traffic, 5, torch.device("cpu"))
    run.setup()
    tr = run.traced(2)
    f, e = 16, 64
    assert tr["params"] == f * 2 + 2 + 3 * 2 * f * e + (f + 3 * e) * e \
        + e * 2
    assert tr["record_width"] == sum(
        min(int(r.deg.max()), r.dcap) for r in run.ref.relations) * f
