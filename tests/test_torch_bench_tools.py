"""The port's measurement scripts (``pcgnn_tpu_torch/benchmarks``) on the
CPU, against the JAX package's scripts where they compute the same thing,
and the port's ``conf_gmean`` against the reference's.

Timing needs the card, so ``utils.roofline.measure`` / ``timed_ms`` are
faked here (they record the bytes a row counts and run the call once);
what is checked is what the scripts compute and count:

  * ``roofline``: every op name of the JAX script, each row's byte count
    against a hand count (the neighbor-window gather reads its table at
    most once);
  * ``measure_reference``: the same candidate edges and the same loss per
    batch as the JAX script (both plain torch from ``torch.manual_seed(0)``
    on equal graphs, splits and pick weights: exact);
  * ``spmd_overhead``: in a process of its own, a 1-rank gloo group whose
    sharded step returns the single step's loss exactly.
"""

import builtins
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pcgnn_tpu.train import metrics as jmetrics
from pcgnn_tpu_torch.benchmarks import measure_reference as tmr
from pcgnn_tpu_torch.benchmarks import roofline as troofline
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.graph.csr import materialize_edge_windows
from pcgnn_tpu_torch.train import metrics as tmetrics
from pcgnn_tpu_torch.train.trainer import Trainer
from pcgnn_tpu_torch.utils import roofline
from pcgnn_tpu_torch.utils.multiproc import worker_env

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def counted(monkeypatch):
    """Fake ``measure``: runs the call once and records its counts."""
    calls = []

    def measure(fn, *args, analytic_bytes=None, analytic_flops=None,
                device=None, target_s=0.15):
        fn(*args)
        calls.append((analytic_bytes, analytic_flops))
        return {"wall_ms": 1.0, "analytic_bytes": analytic_bytes,
                "flops": analytic_flops, "sol_frac": 0.5,
                "device": "fake"}

    monkeypatch.setattr(roofline, "measure", measure)
    monkeypatch.setattr(troofline, "ANCHOR_M", 128)
    return calls


def _jax_kernel_names():
    src = (ROOT / "benchmarks/roofline.py").read_text()
    return re.findall(r'"kernel": "(\w+)"', src)


@pytest.mark.parametrize("preset,dtype", [("tiny", torch.float32),
                                          ("small", torch.bfloat16)])
def test_roofline_rows_and_bytes(counted, preset, dtype):
    """Every op of the JAX script, in its order, each counted by hand."""
    g = materialize_edge_windows(synthetic_fraud_graph(preset, seed=2),
                                 dtype=dtype)
    bsz, emb = 64, 16
    rows = troofline.bench_relation_kernels(g, bsz)
    rows += troofline.bench_train_step(preset, bsz, emb, "cpu", graph=g)
    assert [r["kernel"] for r in rows] == _jax_kernel_names()
    assert len(rows) == 15
    got = {r["kernel"]: r["analytic_bytes"] for r in rows}

    n, f = g.num_nodes, g.feat_dim
    rel = max(g.relations, key=lambda r: r.num_edges)
    d = max(rel.window_width, 1)
    es = 2 if dtype == torch.bfloat16 else 4
    m = 128
    assert got["matmul_anchor"] == 3 * m * m * 2
    assert rows[0]["flops"] == 2 * m ** 3
    # the [N+1, F+1] table read at most once: on tiny B * D exceeds N + 1
    table = (n + 1) if preset == "tiny" else bsz * d
    assert (bsz * d > n + 1) == (preset == "tiny")
    assert got["window_gather"] == (table * (f + 1) * 4
                                    + bsz * d * (f + 1) * 4 + bsz * d * 4)
    assert got["window_gather_ewin"] == bsz * (rel.ewin_dp * (es + 4) + 8)
    w = g.fused.shape[1]
    assert got["fused_record_fetch"] == bsz * (w * (es + 4) + 8)
    assert got["choose_keep_nearest"] == bsz * d * 6 + bsz * 4
    e_pad = rel.col.shape[0]
    spmm = e_pad * (f * 4 + 8) + n * (f * 4 + 4)
    assert got["spmm_window_form"] == spmm
    assert got["spmm_segment_form"] == spmm
    assert got["spmm_ewin_form"] == e_pad * (f * es + 8) + n * (f * 4 + 4)
    assert got["sddmm_window_form"] == n * d * 13
    assert got["sddmm_ewin_form"] == n * d * (f * es + 5)
    assert got["sddmm_flat_form"] == e_pad * 12
    step = rows[-1]["analytic_bytes"] / 16
    t = Trainer(dict(seed=2, data_name=f"synthetic:{preset}", model="PCGNN",
                     train_ratio=0.4, test_ratio=0.67, emb_size=emb,
                     lr=0.01, weight_decay=0.001, epochs=1, batch_size=bsz,
                     valid_epochs=1, patience=1, exp_num=0),
                graph=g, device="cpu")
    m_max = t.new_model().minor_window(int(t.train_pos_dev.shape[0]),
                                       g.relations)
    assert step == roofline.pcgnn_step_streaming_bytes(g, bsz, m_max, emb)
    for k in ("loss_fwd", "loss_grad", "train_step"):
        assert got[k] == step
    assert rows[-1]["wall_ms"] == 1.0 / 16


def test_roofline_main_writes_out_only_if_given(counted, tmp_path,
                                                monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = ["--preset", "tiny", "--batch_size", "32", "--emb_size", "8",
            "--device", "cpu"]
    assert troofline.main(args) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["kernel"] for x in lines] == _jax_kernel_names()
    assert all("card" in x for x in lines)
    assert list(tmp_path.glob("*.json")) == []
    assert troofline.main(args + ["--out", "r.json"]) == 0
    out = json.loads((tmp_path / "r.json").read_text())
    assert out["preset"] == "tiny" and len(out["kernels"]) == 15


def test_measure_reference_equals_the_jax_script(monkeypatch, tmp_path):
    """The JAX script (its file written to a temporary path, not the
    repository's ``BASELINE_MEASURED.json``) and the port's on the same
    small preset: the same candidate edges and losses, batch by batch."""
    jmr = _load("measure_reference")
    seen = []
    orig = jmr.reference_style_batch

    def record(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    written = tmp_path / "baseline.json"
    monkeypatch.setattr(jmr, "reference_style_batch", record)
    monkeypatch.setattr(jmr, "open", lambda path, mode="r": builtins.open(
        written, mode), raising=False)
    baseline = (ROOT / "BASELINE_MEASURED.json").read_bytes()
    jmr.main(preset="small", batch_size=128, emb=16, max_batches=3)
    out, batches = tmr.run("small", 128, 16, 3)
    assert (ROOT / "BASELINE_MEASURED.json").read_bytes() == baseline
    assert len(batches) == 3 and batches == seen
    assert out["candidate_edges"] == sum(e for _, e in seen)
    want = json.loads(written.read_text())
    assert out["num_batches_timed"] == want["num_batches_timed"]
    assert out["host"] == want["host"] == "cpu (torch)"
    assert out["cpu_model"]


def test_measure_reference_writes_out_only_if_given(monkeypatch, tmp_path,
                                                    capsys):
    monkeypatch.chdir(tmp_path)
    args = ["--preset", "tiny", "--batch_size", "64", "--emb", "8",
            "--max_batches", "1"]
    assert tmr.main(args) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["reference_edges_per_s"] > 0
    assert list(tmp_path.glob("*.json")) == []
    assert tmr.main(args + ["--out", "m.json"]) == 0
    assert json.loads((tmp_path / "m.json").read_text())["preset"] == "tiny"


_SPMD_WORKER = """
import json, sys
from pcgnn_tpu_torch.utils import roofline
roofline.timed_ms = lambda call, **kw: (call(), 2.0)[1]
from pcgnn_tpu_torch.benchmarks import spmd_overhead
sys.exit(spmd_overhead.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("preset,nscan", [("tiny", 3), ("skew-tiny", 2)])
def test_spmd_overhead_one_rank_gloo_equals_single(preset, nscan):
    """A 1-rank gloo group at the (1, 1) mesh: the sharded step's loss
    equals the single step's, bit for bit; the JAX script's keys."""
    out = subprocess.run(
        [sys.executable, "-c", _SPMD_WORKER, "--preset", preset,
         "--batch_size", "64", "--nscan", str(nscan), "--device", "cpu"],
        env=worker_env(OMP_NUM_THREADS=1), capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"metric", "preset", "batch_size", "single_chip_step_ms",
            "spmd_1x1_step_ms", "overhead_pct", "device"} <= set(res)
    assert res["metric"] == "spmd_1x1_step_overhead"
    assert res["backend"] == "gloo" and res["nscan"] == nscan
    assert res["loss_single"] == res["loss_spmd"]
    assert np.isfinite(res["loss_single"])
    assert res["single_chip_step_ms"] == 2.0 / nscan


def test_kernel_ms_raises_on_the_cpu(monkeypatch):
    """The probes' device time needs the card; it does not time the CPU,
    nor does ``measure`` with argument sets."""
    x = torch.ones(8)
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.kernel_ms(torch.neg, [(x,)])
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.measure(torch.neg, arg_sets=[(x,), (x,)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.kernel_ms(torch.neg, [(x,)])


# ------------------------------------------------------------ conf_gmean

def test_conf_gmean_one_class_is_zero_where_the_reference_raises():
    """One class in labels and predictions: sklearn's confusion matrix is
    1x1 and the reference's ``conf.ravel()`` unpacking raises; the port
    returns the formula's value for a zero denominator, 0.0."""
    for cls in (0, 1):
        labels = np.full(7, cls)
        probs = np.zeros((7, 2))
        probs[:, cls] = 1.0
        with pytest.raises(ValueError):
            jmetrics.compute_metrics(labels, probs)
        assert tmetrics.conf_gmean(labels, probs.argmax(1)) == 0.0
        assert tmetrics.compute_metrics(labels, probs).gmean == 0.0


@pytest.mark.parametrize("seed", range(5))
def test_conf_gmean_two_classes_equals_the_reference(seed):
    from sklearn.metrics import confusion_matrix
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 60))
    labels = rng.integers(0, 2, m)
    labels[:2] = (0, 1)
    probs = rng.random((m, 2))
    preds = probs.argmax(1)
    want = jmetrics.conf_gmean(confusion_matrix(labels, preds))
    assert abs(tmetrics.conf_gmean(labels, preds) - want) <= 1e-12
    assert abs(tmetrics.compute_metrics(labels, probs).gmean
               - jmetrics.compute_metrics(labels, probs).gmean) <= 1e-12
