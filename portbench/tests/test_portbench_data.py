"""The harness is driven by data: every cell, configuration and metric of
``BENCHMARK.json`` resolves to its file; the readers give known values on
canned records; the command refuses a machine with no card."""

import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness, stats
from portbench.tests.helpers import HERE, ROOT, bench, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_resolves_to_its_file():
    b = bench()
    assert b["command"] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"]
    for c in b["configs"]:
        cfg = load(ROOT / c["file"])
        assert c["file"].startswith("portbench/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        cell, cfg, traffic = harness.cell_files(b, w["name"], ROOT)
        assert set(traffic["limits"]) == {"pick_bad", "loss_gap", "grad_gap",
                                          "update_gap", "prob_gap"}
        assert w["chips"] == 1
        assert harness.cell_metrics(b, w["name"], False)
        assert harness.cell_metrics(b, w["name"], True)
    for m in b["end_to_end"] + b["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert callable(harness.reader(m["name"]))
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert [w["name"] for w in b["workloads"]] == [
        "pcgnn-yelpchi.train", "pcgnn-amazon.train", "pcgnn-yelpchi.hubs"]


def test_metric_lists_follow_their_workloads():
    b = bench()
    layer = {m["name"] for m in harness.cell_metrics(
        b, "pcgnn-yelpchi.train", True)}
    assert "ragged_gather_roofline" not in layer
    assert "ragged_gather_roofline" in {m["name"] for m in harness.cell_metrics(
        b, "pcgnn-yelpchi.hubs", True)}


def window_rec():
    return {"window": {"seconds": 2.0, "epochs": 40, "edges_per_epoch": 1e6,
                       "epoch_ms": list(range(1, 41)),
                       "validate_ms": [5.0, 7.0, 9.0, 100.0],
                       "setup_s": 12.5}, "peaks": (3.35e12, 67e12)}


def test_end_to_end_readers():
    rec = window_rec()
    assert harness.reader("train_edges_per_s")(rec) == 2e7
    # the 95th percentile over all 40 epochs, linear between ranks
    assert harness.reader("epoch_ms_p95")(rec) == pytest.approx(38.05)
    assert harness.reader("validate_ms_p95")(rec) == pytest.approx(86.35)
    assert harness.reader("setup_s")(rec) == 12.5


def trace_rec():
    ops = [("window_gather_kernel", 10.0, 20.0, "kernel"),
           ("sort", 15.0, 30.0, "kernel"),
           ("ragged_gather_kernel", 40.0, 50.0, "kernel"),
           ("Memcpy DtoH", 55.0, 60.0, "memcpy"),
           ("gemm", 110.0, 130.0, "kernel")]
    return {"peaks": (3.35e12, 67e12), "trace": {
        "device_ops": ops, "wall": (0.0, 200.0),
        "spans": {"portbench.epoch": [(0.0, 100.0)],
                  "portbench.validate": [(100.0, 200.0)]},
        "epoch_host_ms": [3.0, 1.0, 2.0, 10.0], "captures": 2, "steps": 2,
        "rows": 100, "record_width": 670, "hub_neighbors": 4188,
        "feat_dim": 16, "emb": 64, "relations": 3, "train_pos": 10,
        "params": 1000}}


def test_layer_readers_on_a_canned_trace():
    rec = trace_rec()
    r = harness.reader
    # union of [10, 30], [40, 50], [55, 60], [110, 130] = 55 of 200 us
    assert r("device_idle_share")(rec) == pytest.approx(100 * 145 / 200)
    assert r("epoch_host_ms")(rec) == 2.5
    assert r("step_captures")(rec) == 2
    assert r("step_kernels")(rec) == 1.5          # 3 kernels, 2 steps
    assert r("validate_device_ms")(rec) == pytest.approx(0.020)
    # 100 rows x 670 bf16 elements read and written: 268,000 bytes
    assert r("window_gather_roofline")(rec) == pytest.approx(
        100 * 268000 / 3.35e12 * 1e6 / 10.0)
    assert r("ragged_gather_roofline")(rec) == pytest.approx(
        100 * 8 * 4188 / 3.35e12 * 1e6 / 10.0)
    assert 0 < r("step_mfu")(rec) < 100


def test_readers_find_nothing_without_their_kernels():
    rec = trace_rec()
    rec["trace"]["device_ops"] = [o for o in rec["trace"]["device_ops"]
                                  if "gather" not in o[0]]
    assert harness.reader("window_gather_roofline")(rec) is None
    assert harness.reader("ragged_gather_roofline")(rec) is None
    rec["trace"]["device_ops"] = []
    assert harness.reader("device_idle_share")(rec) is None
    assert harness.reader("step_kernels")(rec) is None


def test_interval_helpers():
    assert stats.union([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert stats.clip([(0, 5), (8, 9)], 2, 8.5) == [(2, 5), (8, 8.5)]
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile([], 95) is None


def command(cwd, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "pcgnn-yelpchi.train", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_the_command_refuses_a_machine_without_a_card():
    out = command(ROOT)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert out.stdout.strip() == ""


def test_the_command_fails_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
