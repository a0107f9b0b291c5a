"""The port stands alone: it imports neither JAX nor the JAX package (nor
the libraries only the JAX package's helpers use), and its entry points
never fall back to the CPU on their own."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pcgnn_tpu_torch
from pcgnn_tpu_torch import cli
from pcgnn_tpu_torch.train.trainer import Trainer, resolve_device

ROOT = Path(__file__).resolve().parents[1]
# JAX, the JAX package and its measurement scripts (``benchmarks/``), and
# the libraries its numpy helpers import that the GPU machine does not have
FORBIDDEN = {"jax", "jaxlib", "pcgnn_tpu", "benchmarks", "optax", "flax",
             "sklearn", "pandas", "ml_dtypes"}


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        pcgnn_tpu_torch.__path__, "pcgnn_tpu_torch."))


def _port_sources():
    files = sorted((ROOT / "pcgnn_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "chunk_sweep.py",
                    ROOT / "build_profile.py",
                    ROOT / "tests/test_torch_cuda.py"]


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert {"pcgnn_tpu_torch.ops.window_gather", "pcgnn_tpu_torch.ops.hub",
            "pcgnn_tpu_torch.ops.ragged_gather",
            "pcgnn_tpu_torch.ops.mask_build", "pcgnn_tpu_torch.models.gcn",
            "pcgnn_tpu_torch.models.graphsage",
            "pcgnn_tpu_torch.data.process", "pcgnn_tpu_torch.data.verify",
            "pcgnn_tpu_torch.train.analysis",
            "pcgnn_tpu_torch.train.eval_tools",
            "pcgnn_tpu_torch.train.legacy_log",
            "pcgnn_tpu_torch.utils.expgen", "pcgnn_tpu_torch.utils.fleet",
            "pcgnn_tpu_torch.utils.profiling", "pcgnn_tpu_torch.ops.sddmm",
            "pcgnn_tpu_torch.utils.roofline",
            "pcgnn_tpu_torch.parallel.mesh",
            "pcgnn_tpu_torch.parallel.distributed",
            "pcgnn_tpu_torch.parallel.spmd",
            "pcgnn_tpu_torch.utils.multiproc",
            "pcgnn_tpu_torch.native", "pcgnn_tpu_torch.ops.gather_probe",
            "pcgnn_tpu_torch.benchmarks",
            "pcgnn_tpu_torch.benchmarks.gather_kernel_probe",
            "pcgnn_tpu_torch.benchmarks.gather_probe",
            "pcgnn_tpu_torch.benchmarks.roofline",
            "pcgnn_tpu_torch.benchmarks.spmd_overhead",
            "pcgnn_tpu_torch.benchmarks.measure_reference",
            "pcgnn_tpu_torch.bench",
            "pcgnn_tpu_torch.benchmarks.quality_run",
            "pcgnn_tpu_torch.benchmarks.quality_protocol",
            "pcgnn_tpu_torch.benchmarks.spmd_scaling",
            "pcgnn_tpu_torch.benchmarks.multihost_scaling",
            "pcgnn_tpu_torch.graft_entry"} <= set(mods)
    assert len(mods) >= 59
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r} + ['chip_smoke', 'chunk_sweep', 'build_profile']\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_source_imports_jax_or_the_jax_package():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_no_gpu_means_an_error_not_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg = dict(seed=2, data_name="synthetic:tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=8, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=1,
               valid_epochs=1, batch_size=64, patience=10, exp_num=0)
    for kw in ({}, {"device": "cuda"}, {"device": None}):
        with pytest.raises(RuntimeError, match="no GPU"):
            Trainer(cfg, **kw)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main(["--exp_config_path", str(path)])
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    """chip_smoke.py exits non-zero and prints no result line when
    torch.cuda.is_available() is false."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chunk_sweep_refuses_without_a_card(monkeypatch, capsys):
    """chunk_sweep.py, which times the card, exits non-zero and prints no
    result when torch.cuda.is_available() is false."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["chunk_sweep.py"])
    sys.path.insert(0, str(ROOT))
    try:
        import chunk_sweep
    finally:
        sys.path.remove(str(ROOT))
    assert chunk_sweep.main() != 0
    assert capsys.readouterr().out == ""
