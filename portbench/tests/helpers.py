"""Small cells for the CPU tests: the configurations' files with the
graph cut to a test preset's size."""

import copy
import json
import time
from pathlib import Path

import torch

from portbench import harness

# the tests run side by side: a few threads each
torch.set_num_threads(2)

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

# preset statistics of pcgnn_tpu_torch/data/synthetic.py, as the
# generator takes them
PRESETS = {
    "tiny": ({"num_nodes": 512, "feat_dim": 16, "fraud_rate": 0.15,
              "edges_per_relation": [2048, 3072, 1024]}, {}),
    "small": ({"num_nodes": 4096, "feat_dim": 32, "fraud_rate": 0.1,
               "edges_per_relation": [16384, 32768, 8192]}, {}),
    "skew-tiny": ({"num_nodes": 2048, "feat_dim": 16, "fraud_rate": 0.15,
                   "edges_per_relation": [8192, 6144, 4096]},
                  {"0": [6, 512]}),
    # stress-10m cut as the port's lane tests cut it (SMALL_10M)
    "stress-small": ({"num_nodes": 6000, "feat_dim": 16, "fraud_rate": 0.05,
                      "edges_per_relation": [30000, 15000, 5000]}, {}),
}

STRESS = "pcgnn-stress10m.train"
GCN = "gcn-amazon.train"


def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def files(workload: str) -> tuple:
    """(configuration, traffic) of ``workload`` as its files state them."""
    _, cfg, traffic = harness.cell_files(bench(), workload, ROOT)
    return cfg, traffic


def directed(workload: str) -> bool:
    """Whether the configuration of ``workload`` states a directed graph,
    the CSR lane's property (stress-10m's)."""
    return bool(files(workload)[0]["graph"].get("directed"))


def cpu_cut(workload: str) -> tuple:
    """(preset, batch) of the CPU cut of ``workload``, from what its files
    state: a directed graph takes ``stress-small`` at 96 and the CSR
    lane's patches (``lane``), hubs in the traffic ``skew-tiny`` at 64,
    every other cell ``tiny`` at 16."""
    if directed(workload):
        return "stress-small", 96
    if files(workload)[1]["graph"]["hubs"]:
        return "skew-tiny", 64
    return "tiny", 16


def reference_name(workload: str) -> str:
    """The reference the configuration of ``workload`` names."""
    return files(workload)[0].get("reference", "pcgnn")


# (workload, preset, batch) of each cell's CPU cut, every cell of
# BENCHMARK.json; PC-GNN's cells are those of its reference
CELLS = [(w["name"], *cpu_cut(w["name"])) for w in bench()["workloads"]]
PCGNN_CELLS = [c for c in CELLS if reference_name(c[0]) == "pcgnn"]


def stress_lane(monkeypatch) -> None:
    """The port's budgets patched as its lane tests patch them, so that a
    cut cell with a directed graph lands in the lane the stress cell's
    scale forces: every dense neighbor table over ``NBR2D_BUDGET_BYTES``
    (kernel 2 reads the CSR), no padded feature table, and N at
    ``SCORE_FROM_WINDOW_MIN_NODES`` (scores from the gathered rows, ids
    clamped)."""
    from pcgnn_tpu_torch.graph import csr
    from pcgnn_tpu_torch.models import pcgnn
    monkeypatch.setattr(csr, "NBR2D_BUDGET_BYTES", 8)
    monkeypatch.setattr(csr, "FPAD_BUDGET_BYTES", 0)
    monkeypatch.setattr(pcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 6000)


def lane(monkeypatch, workload: str) -> None:
    """The patches the CPU cut of ``workload`` needs to take its lane: the
    CSR lane's where its graph is directed."""
    if directed(workload):
        stress_lane(monkeypatch)


def small_cell(workload: str, preset: str, batch_size: int) -> tuple:
    """(configuration, traffic) of ``workload`` with the graph of
    ``preset`` and batches of ``batch_size``."""
    b = bench()
    _, cfg, traffic = harness.cell_files(b, workload, ROOT)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    graph, hubs = PRESETS[preset]
    # the statistics cut, the semantics (``directed``) kept
    cfg["graph"] = {**cfg["graph"], **graph}
    cfg["model"]["batch_size"] = batch_size
    # a validation every other epoch, so a short window holds several
    cfg["model"]["valid_epochs"] = 2
    traffic["graph"]["hubs"] = dict(hubs)
    traffic["traced_epochs"] = 12
    return cfg, traffic


def run_small(workload: str, preset: str, batch_size: int, *, seed: int,
              traced: bool = False, seconds: float = 2.0):
    """One run on the CPU: (result line, compared rows)."""
    cfg, traffic = small_cell(workload, preset, batch_size)
    metrics = harness.cell_metrics(bench(), workload, traced)
    return harness.run_cell(cfg, traffic, metrics, seed, seconds, traced,
                            "cpu", time.perf_counter())


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)
