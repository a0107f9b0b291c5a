"""The harness is driven by data: every cell, configuration and metric of
``BENCHMARK.json`` resolves to its file; the readers give known values on
canned records; the command refuses a machine with no card."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness, stats
from portbench.counts import pcgnn, step
from portbench.tests.helpers import HERE, ROOT, bench, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_resolves_to_its_file():
    b = bench()
    assert b["command"] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"]
    configs = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    for names in (configs, cells):
        assert 1 <= len(names) <= 24 and len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for c in b["configs"]:
        cfg = load(ROOT / c["file"])
        assert c["file"].startswith("portbench/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        cell, cfg, traffic = harness.cell_files(b, w["name"], ROOT)
        assert set(traffic["limits"]) == {"pick_bad", "loss_gap", "grad_gap",
                                          "update_gap", "prob_gap"}
        assert w["chips"] in (1, 4)
        assert harness.cell_metrics(b, w["name"], False)
        assert harness.cell_metrics(b, w["name"], True)
    # the driver's rule: a quarter of the cells on four chips, or one
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(cells) // 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert callable(harness.reader(m["name"]))
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_metric_lists_follow_their_workloads():
    # each list of cells names the cells that exist and have what its
    # metric reads, and every such cell, read from the cells' files:
    # kernel 1's share where a store is read, kernel 2's where hubs or no
    # store send rows through it, the CSR lane's gather section where
    # there is no store, the choose, oversample and hub sections where
    # the model is PC-GNN's (with hubs for the hub section)
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    need = {
        "window_gather_roofline": lambda cfg, tr: cfg["model"]["edge_windows"],
        "ragged_gather_roofline": lambda cfg, tr: (
            bool(tr["graph"]["hubs"]) or not cfg["model"]["edge_windows"]),
        "step_gather_ms": lambda cfg, tr: not cfg["model"]["edge_windows"],
        "step_choose_ms": lambda cfg, tr: pcgnn_model(cfg),
        "step_oversample_ms": lambda cfg, tr: pcgnn_model(cfg),
        "step_hub_ms": lambda cfg, tr: (pcgnn_model(cfg)
                                        and bool(tr["graph"]["hubs"])),
    }
    for m in b["per_layer"] + b["end_to_end"]:
        listed = m.get("workloads")
        if listed is None:
            assert m["name"] not in need, m["name"]
            continue
        assert listed and len(listed) == len(set(listed)), m["name"]
        assert set(listed) <= cells, (m["name"], set(listed) - cells)
    for w in b["workloads"]:
        _, cfg, traffic = harness.cell_files(b, w["name"], ROOT)
        got = {m["name"] for m in harness.cell_metrics(b, w["name"], True)}
        for name, has in need.items():
            assert (name in got) == bool(has(cfg, traffic)), (name, w["name"])
        assert "step_mfu" in got


def pcgnn_model(cfg: dict) -> bool:
    return cfg["model"]["model"] == "PCGNN"


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
        "reference": "pcgnn", "stores": True, "neighbors": 9000,
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


def test_csr_lane_readers_on_a_canned_trace():
    rec = trace_rec()
    t = rec["trace"]
    t.update(stores=False, record_width=0, hub_neighbors=0)
    r = harness.reader
    # every real row's ids, 9,000, read and written as int32 in 10 us,
    # not the hub rows' alone
    assert r("ragged_gather_roofline")(rec) == pytest.approx(
        100 * 8 * 9000 / 3.35e12 * 1e6 / 10.0)
    # the neighbors' float32 rows and int32 ids in place of the records
    terms = pcgnn.byte_terms(rows=100, steps=2, feat_dim=16, record_width=0,
                             train_pos=10, hub_neighbors=0, params=1000,
                             neighbors=9000)
    assert terms["neighbor_rows"] == 9000 * 68 and "records" not in terms
    fl = pcgnn.flops(rows=100, feat_dim=16, emb=64, relations=3)
    assert r("step_mfu")(rec) == pytest.approx(
        100 * step.least_seconds(sum(terms.values()), fl, (3.35e12, 67e12))
        * 1e6 / 100.0)


def test_readers_find_nothing_without_their_kernels():
    rec = trace_rec()
    rec["trace"]["device_ops"] = [o for o in rec["trace"]["device_ops"]
                                  if "gather" not in o[0]]
    assert harness.reader("window_gather_roofline")(rec) is None
    assert harness.reader("ragged_gather_roofline")(rec) is None
    rec["trace"]["stores"] = False
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


COPY_REFERENCE = '''"""PC-GNN's reference under another name: a configuration names it."""
from portbench.reference import pcgnn
from portbench.reference.pcgnn import (build_graph, edges_per_epoch,
                                       fraud_probabilities, initial_weights)

CALLS = []


def steps(*args, **kw):
    CALLS.append("steps")
    return pcgnn.steps(*args, **kw)
'''

COPY_COUNT = '''"""PC-GNN's step count under the name of its reference's copy."""
from portbench.counts.pcgnn import count
'''

# the tests that read the benchmark's structure from its files, run again
# in a copy that holds one more configuration and cell
STRUCTURAL = ("test_every_entry_resolves_to_its_file",
              "test_metric_lists_follow_their_workloads",
              "test_every_configuration_names_its_reference_and_count",
              "test_every_new_metric_is_declared_with_its_cells")

STRUCTURE = '''import sys
import portbench
import pytest
assert portbench.__file__.startswith(sys.argv[1]), portbench.__file__
tests = [f"portbench/tests/{m}.py" for m in ("test_portbench_data",
         "test_portbench_reference", "test_portbench_spans")]
sys.exit(pytest.main(tests + ["-q", "-p", "no:cacheprovider", "-k",
                              " or ".join(sys.argv[2:])]))
'''

DRIVE = '''import json, sys, torch
import portbench
from portbench.reference import pcgnn_named, plain
from portbench.tests.helpers import run_small
assert portbench.__file__.startswith(sys.argv[1]), portbench.__file__
plain.BIAS_CORRECTION_DTYPE = torch.float64
line, rows = run_small("pcgnn-yelpchi-directed.train", "tiny", 16, seed=6)
print(json.dumps({"correct": line["correct"], "calls": pcgnn_named.CALLS}))
'''


def test_a_configuration_that_differs_needs_new_files_alone(tmp_path):
    # a configuration whose graph is directed, with no store and a
    # reference of its own name, added to a copy of the benchmark as new
    # files and registry entries; no file the benchmark had is edited, and
    # the structural tests, run in the copy, read the new cell from its
    # files and pass
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    had = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
           if p.is_file()}
    cfg = load(HERE / "configs" / "pcgnn-yelpchi.json")
    cfg.update(name="pcgnn-yelpchi-directed", reference="pcgnn_named")
    cfg["graph"]["directed"] = True
    cfg["model"]["edge_windows"] = False
    new = {"configs/pcgnn-yelpchi-directed.json": json.dumps(cfg),
           "workloads/pcgnn-yelpchi-directed.train.json": (
               HERE / "workloads" / "pcgnn-yelpchi.train.json").read_text(),
           "reference/pcgnn_named.py": COPY_REFERENCE,
           "counts/pcgnn_named.py": COPY_COUNT}
    for name, text in new.items():
        (tmp_path / "portbench" / name).write_text(text)
    b = bench()
    b["configs"].append({"name": cfg["name"], "source": cfg["source"],
                         "file": "portbench/configs/pcgnn-yelpchi-directed"
                                 ".json", "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "pcgnn-yelpchi-directed.train",
                           "config": cfg["name"], "traffic": "train",
                           "chips": 1, "why": "a test"})
    # the per-layer metrics a PC-GNN cell without a store reads
    for m in b["per_layer"]:
        if m["name"] in ("ragged_gather_roofline", "step_gather_ms",
                         "step_choose_ms", "step_oversample_ms"):
            m["workloads"].append("pcgnn-yelpchi-directed.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    out = subprocess.run([sys.executable, "-c", DRIVE, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "calls": ["steps"]}
    out = subprocess.run([sys.executable, "-c", STRUCTURE, str(tmp_path),
                          *STRUCTURAL], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert f"{len(STRUCTURAL)} passed" in out.stdout, out.stdout[-3000:]
    assert all(p.read_bytes() == v for p, v in had.items())
