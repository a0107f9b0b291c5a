"""The port's bench (``pcgnn_tpu_torch.bench``) against the repository's
``bench.py`` and the JAX package's trainer, on the CPU.

The bench times the card, so its timing is faked here (the refusal of the
CPU is patched over for the run and tested on its own): what is checked
is what the bench computes.  ``edges_per_epoch`` is deterministic (pick
weights from degrees and labels, no random draw), so it is held to the
JAX ``Trainer``'s ``bench.py:71-79`` computation to relative 1e-9.
``epoch_block`` runs the same steps as a loop of ``run_epoch``: equal
bits.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pcgnn_tpu.train.trainer import Trainer as JaxTrainer
from pcgnn_tpu_torch import bench
from pcgnn_tpu_torch.train.trainer import Trainer
from pcgnn_tpu_torch.utils import roofline

ROOT = Path(__file__).resolve().parents[1]


def _bench_py_keys() -> list:
    """The keys of ``bench.py``'s JSON line, read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    return [k.value for k in call.args[0].keys]


@pytest.fixture
def timed_on_cpu(monkeypatch):
    """The bench's timing faked on the CPU: the card check passes, the
    barrier is a no-op, ``measure`` runs the call once and records its
    byte count."""
    calls = []

    def measure(fn, *args, analytic_bytes=None, device=None, **kw):
        fn(*args)
        calls.append(analytic_bytes)
        return {"wall_ms": 32.0, "sol_frac": 0.01, "achieved_gbps": 5.0,
                "peak_gbps": 3350.0, "device": "fake card"}

    monkeypatch.setattr(roofline, "_card", lambda device=None:
                        torch.device("cpu"))
    monkeypatch.setattr(roofline, "measure", measure)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return calls


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_edges_per_epoch_matches_jax(preset):
    cfg = bench.bench_config(preset, 1024, 1, 64)
    jt = JaxTrainer(cfg)
    # bench.py:71-79
    w = np.asarray(jt.pick_weights, dtype=np.float64)
    p = w / w.sum()
    per_sample = 0.0
    for rel in jt.graph.relations:
        deg = np.asarray(rel.deg, dtype=np.float64)[jt.idx_train]
        per_sample += float((p * deg).sum())
    want = per_sample * jt.sample_size
    got = bench.edges_per_epoch(Trainer(cfg, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_edges_per_epoch_of_a_baseline_counts_the_homo_graph():
    cfg = dict(bench.bench_config("tiny", 64, 1, 16), model="GCN")
    t = Trainer(cfg, device="cpu")
    want = float(t.graph.homo.deg.numpy()[t.idx_train].sum())
    assert bench.edges_per_epoch(t) == want


def test_epoch_block_equals_a_loop_of_run_epoch():
    """Epochs 1-3 as one block and as three ``run_epoch`` calls, from the
    same weights: the same parameters and the last epoch's loss, to the
    bit; no epoch gives a zero loss."""
    t = Trainer(bench.bench_config("tiny", 64, 4, 16), device="cpu")
    model_a, model_b = t.new_model(), t.new_model()
    opt_a, opt_b = t.new_optimizer(model_a), t.new_optimizer(model_b)
    loss_a = t.epoch_block(model_a, opt_a, 1, 3)
    for epoch in range(1, 4):
        loss_b = t.run_epoch(model_b, opt_b, epoch)
    assert torch.equal(loss_a, loss_b) and float(loss_a) > 0
    for (name, a), b in zip(model_a.named_parameters(),
                            model_b.parameters()):
        assert torch.equal(a, b), name
    assert float(t.epoch_block(model_a, opt_a, 4, 0)) == 0.0


def test_line_has_bench_py_keys(timed_on_cpu, tmp_path):
    """One run on tiny: exactly bench.py's 13 keys in its order, the
    throughput from the two blocks, the roofline's time per step, and the
    step bytes times nscan handed to ``measure``."""
    line = bench.run(preset="tiny", batch_size=64, epochs=1, emb_size=16,
                     baseline=str(tmp_path / "absent.json"), device="cpu")
    assert list(line) == _bench_py_keys()
    assert len(line) == 13
    assert line["metric"] == "pcgnn_train_edges_per_s"
    assert line["unit"] == "edges/s" and line["value"] > 0
    assert line["preset"] == "tiny" and line["batch_size"] == 64
    assert line["roofline_step_ms"] == 32.0 / bench.NSCAN
    assert line["hbm_bw_util"] == 0.01 and line["device"] == "fake card"
    t = Trainer(bench.bench_config("tiny", 64, 1, 16), device="cpu")
    m_max = t.new_model().minor_window(int(t.train_pos_dev.shape[0]),
                                       t.graph.relations)
    want = roofline.pcgnn_step_streaming_bytes(t.graph, 64, m_max, 16)
    assert timed_on_cpu == [want * bench.NSCAN]


@pytest.mark.parametrize("ref", [None, 2000.0], ids=["absent", "file"])
def test_vs_baseline_reads_the_baseline_file(timed_on_cpu, tmp_path, ref):
    path = tmp_path / "reference.json"
    if ref is not None:
        path.write_text(json.dumps({"reference_edges_per_s": ref,
                                    "host": "cpu (torch)"}))
        assert bench.reference_edges_per_s(str(path)) == ref
    else:
        assert bench.reference_edges_per_s(str(path)) is None
    line = bench.run(preset="tiny", batch_size=64, epochs=1, emb_size=16,
                     baseline=str(path), device="cpu")
    want = 1.0 if ref is None else round(line["value"] / ref, 3)
    assert line["vs_baseline"] == pytest.approx(want, rel=1e-3)


def test_default_baseline_is_the_repository_file():
    assert Path(bench.BASELINE_PATH) == ROOT / "BASELINE_MEASURED.json"
    with open(ROOT / "BASELINE_MEASURED.json") as f:
        want = json.load(f)["reference_edges_per_s"]
    assert bench.reference_edges_per_s(bench.BASELINE_PATH) == want


def test_the_cpu_is_refused_before_any_work(monkeypatch):
    """``--device cpu`` raises as ``utils.roofline.measure`` does, before a
    trainer is built."""
    def no_trainer(*a, **k):
        raise AssertionError("the bench built a trainer on the CPU")

    monkeypatch.setattr("pcgnn_tpu_torch.train.trainer.Trainer", no_trainer)
    with pytest.raises(RuntimeError, match="times a CUDA card"):
        bench.main(["--preset", "tiny", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="times a CUDA card"):
        bench.run(preset="tiny", device="cpu")


def test_graph_pickle_round_trip(timed_on_cpu, tmp_path):
    """``save_graph`` writes numpy leaves without stores; ``load_graph``
    gives the same arrays back; the bench on it counts the same edges."""
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.graph.csr import materialize_edge_windows
    g = materialize_edge_windows(synthetic_fraud_graph("tiny", seed=2),
                                 dtype=torch.bfloat16)
    path = tmp_path / "tiny.pkl"
    bench.save_graph(g, str(path))
    back = bench.load_graph(str(path))
    assert back.fused is None and back.relations[0].ewin is None
    assert torch.equal(back.features, g.features)
    for a, b in zip(back.relations, g.relations):
        for f in ("indptr", "col", "deg", "keff", "ksample", "nbr2d"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    cfg = bench.bench_config("tiny", 64, 1, 16)
    assert (bench.edges_per_epoch(Trainer(cfg, graph=back, device="cpu"))
            == bench.edges_per_epoch(Trainer(cfg, device="cpu")))
    line = bench.run(preset="tiny", batch_size=64, epochs=1, emb_size=16,
                     graph_pickle=str(path), baseline=None, device="cpu")
    assert line["value"] > 0


def test_chip_smoke_takes_the_bench_edges():
    """One copy of the edges-per-epoch definition: ``chip_smoke.py``
    imports the bench's."""
    src = (ROOT / "chip_smoke.py").read_text()
    assert "def edges_per_epoch" not in src
    assert "from pcgnn_tpu_torch.bench import edges_per_epoch" in src
