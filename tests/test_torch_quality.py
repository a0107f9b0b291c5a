"""The port's quality harnesses (``benchmarks/quality_run.py`` and
``quality_protocol.py`` of ``pcgnn_tpu_torch``) on the CPU at the
``tiny`` presets, against the JAX scripts' formats and the JAX package's
aggregation.

Training results are the port's own (it cannot reproduce jax.random's
draws): what is held is the table each script writes, where it writes it,
its rows, and, for the protocol, that its summary is the JAX package's
pandas ``summarize`` of the same test tables.
"""

import json
import math
import re
from pathlib import Path

import numpy as np
import pandas as pd

from pcgnn_tpu.train import analysis as janalysis
from pcgnn_tpu_torch.benchmarks import quality_protocol, quality_run
from pcgnn_tpu_torch.train import analysis as tanalysis

ROOT = Path(__file__).resolve().parents[1]
TINY = {"synthetic:yelp-like": "synthetic:tiny",
        "synthetic:amazon-like": "synthetic:tiny",
        "synthetic:yelp-skew": "synthetic:skew-tiny"}
CELL = r"\d\.\d{4}±\d\.\d{4}"


def _jax_table_header(name: str) -> list:
    """The table's header and rule lines of the JAX script ``name``."""
    src = (ROOT / "benchmarks" / f"{name}.py").read_text()
    return re.findall(r'"(\|[^"]*\|)"', src)[:2]


def test_settings_are_the_jax_scripts():
    src = (ROOT / "benchmarks" / "quality_run.py").read_text()
    rows = re.findall(r'\("(synthetic:[\w-]+)", "(\w+)", ([\d.]+), '
                      r'([\d.]+), ([\d.]+), (\d+)\)', src)
    assert [(d, m, float(tr), float(lr), float(wd), int(b))
            for d, m, tr, lr, wd, b in rows] == quality_run.SETTINGS
    assert quality_protocol.DATASETS == (
        "synthetic:yelp-like", "synthetic:yelp-skew",
        "synthetic:amazon-like", "synthetic:amazon_new-like")


def test_quality_run_rows_and_table(tmp_path, monkeypatch, capsys):
    """Five settings x 2 seeds x 2 epochs on tiny: the JAX script's line
    per run, its rows, and its table, written to ``--out`` only (the
    runs' result trees beside it; nothing in the working directory)."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = tmp_path / "out" / "RESULTS.md"
    settings = [(TINY[d], *rest) for d, *rest in quality_run.SETTINGS]
    rows, runs = quality_run.run(seeds=[2, 3], epochs=2, valid_epochs=1,
                                 patience=100, out=str(out), device="cpu",
                                 settings=settings)
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if re.match(r"\[(PCGNN|GCN|SAGE) ", ln)]
    assert list(cwd.iterdir()) == []
    assert sorted(p.name for p in out.parent.iterdir()) == [
        "RESULTS.md", "experimental_results"]
    assert len(runs) == len(printed) == 10 and len(rows) == 5
    for line, r in zip(printed, runs):
        assert re.fullmatch(
            rf"\[{r['model']} {r['data']} seed={r['seed']}\] "
            rf"auc={r['auc']:.4f} f1_mac={r['f1_macro']:.4f} "
            rf"gmean={r['gmean']:.4f} \(\d+s\)", line)
        assert r["epochs_run"] == 2 and r["peak_mem_bytes"] is None
    for row, (data, model, tr, *_), k in zip(rows, settings, range(5)):
        assert set(row) == {"data", "model", "train_ratio", "seeds", "auc",
                            "f1_macro", "gmean", "recall", "sec_per_run"}
        assert (row["data"], row["model"], row["seeds"]) == (data, model, 2)
        pair = [r["auc"] for r in runs[2 * k: 2 * k + 2]]
        np.testing.assert_allclose(row["auc"], (np.mean(pair),
                                                np.std(pair, ddof=1)))
        json.dumps(row)
    text = out.read_text().splitlines()
    assert text[0].startswith("# RESULTS — pcgnn_tpu_torch quality runs")
    assert text[2].startswith("Device: cpu; epochs<=2, patience 100, "
                              "valid every 1; seeds [2, 3].")
    assert text[4:6] == _jax_table_header("quality_run")
    assert len(text) == 11
    for line, row in zip(text[6:], rows):
        assert re.fullmatch(rf"\| {row['data']} \| {row['model']} \| "
                            rf"{CELL} \| {CELL} \| {CELL} \| {CELL} \| "
                            rf"\d+ \|", line), line


def test_quality_run_default_out_is_not_results_md():
    assert quality_run.DEFAULT_OUT.startswith("build")
    assert quality_protocol.DEFAULT_WORKDIR.startswith("build")


def test_quality_protocol_on_tiny(tmp_path, capsys):
    """Two seeds of one tiny dataset through the CLI, seed-major: both runs
    rc 0; the summary equals the JAX package's pandas ``summarize`` of the
    same test tables, and the table has one row in the JAX format."""
    work = tmp_path / "work"
    res = quality_protocol.run(workdir=str(work),
                               datasets=["synthetic:tiny"], seeds="2",
                               epochs=2, device="cpu", run_timeout=300)
    assert [(name, rc) for name, rc, _ in res["runs"]] == [
        ("synthetic_tiny-tr0.4-seed2.json", 0),
        ("synthetic_tiny-tr0.4-seed3.json", 0)]
    assert (res["done"], res["failed"], res["skipped"]) == (2, 0, 0)
    cfg = json.loads((work / "configs" /
                      "synthetic_tiny-tr0.4-seed3.json").read_text())
    assert (cfg["epochs"], cfg["valid_epochs"], cfg["seed"]) == (2, 2, 3)
    rows = tanalysis.load_all_test_dfs(str(work / "experimental_results"))
    assert len(rows) == 2
    df = pd.DataFrame(rows)
    for m in janalysis.METRICS:
        df[m] = df[m].astype(float)
    agg = janalysis.summarize(df)
    summary = res["summary"]
    assert list(summary) == [("PCGNN", "synthetic:tiny", "0.4")]
    for group, metrics in summary.items():
        assert set(metrics) == set(janalysis.METRICS)
        for m, stats in metrics.items():
            for k in tanalysis.STATS:
                np.testing.assert_allclose(stats[k], agg.loc[group][(m, k)],
                                           rtol=1e-12)
    text = Path(res["out"]).read_text().splitlines()
    assert Path(res["out"]) == work / "RESULTS_QUALITY.md"
    assert text[4:6] == _jax_table_header("quality_protocol")
    (row,) = text[6:]
    auc = summary[("PCGNN", "synthetic:tiny", "0.4")]["auc"]
    assert re.fullmatch(rf"\| synthetic:tiny \| PCGNN \| 0.4 \| 2 \| "
                        rf"{auc['mean']:.4f}±{auc['std']:.4f} \| {CELL} \| "
                        rf"{CELL} \|", row), row
    assert math.isfinite(auc["mean"])
    out = capsys.readouterr().out
    assert "runs: 2 ok, 0 failed, 0 skipped (budget)" in out


def test_quality_protocol_wall_budget_skips(tmp_path):
    """Past the wall budget no run is launched; nothing aggregates."""
    res = quality_protocol.run(workdir=str(tmp_path),
                               datasets=["synthetic:tiny"], seeds="2",
                               max_hours=-1.0, device="cpu")
    assert (res["done"], res["failed"], res["skipped"]) == (0, 0, 2)
    assert res["summary"] == {} and res["out"] is None
