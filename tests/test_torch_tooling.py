"""The port's run tools against the JAX package's: experiment generation,
the fleet runner, result analysis, the legacy log, threshold transfer and
the profiling utilities.

Files, report lines and thresholds must be equal; metrics allclose at rtol
1e-6.
"""

import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from pcgnn_tpu.train import LegacyLog as JLegacyLog
from pcgnn_tpu.train import analysis as janalysis
from pcgnn_tpu.train import checkpoint as jckpt
from pcgnn_tpu.train import eval_tools as jeval
from pcgnn_tpu.train.results import ResultManager as JResults
from pcgnn_tpu.train.trainer import Trainer as JTrainer
from pcgnn_tpu.utils import expgen as jexpgen
from pcgnn_tpu_torch.train import LegacyLog as TLegacyLog
from pcgnn_tpu_torch.train import analysis as tanalysis
from pcgnn_tpu_torch.train import eval_tools as teval
from pcgnn_tpu_torch.train.results import ResultManager as TResults
from pcgnn_tpu_torch.train.results import write_table
from pcgnn_tpu_torch.train.trainer import Trainer as TTrainer
from pcgnn_tpu_torch.utils import expgen as texpgen
from pcgnn_tpu_torch.utils import fleet as tfleet
from pcgnn_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
METRIC_RTOL = 1e-6


def test_expgen_matches_jax(tmp_path):
    """The same file names and contents as the JAX package's generator."""
    kw = dict(datasets=("yelp", "amazon_new", "synthetic:yelp-like",
                        "tfinance"), seeds=[2, 3], train_ratios=[0.1, 0.4])
    tp = texpgen.generate(str(tmp_path / "t"), **kw)
    jp = jexpgen.generate(str(tmp_path / "j"), **kw)
    assert [Path(p).name for p in tp] == [Path(p).name for p in jp]
    for a, b in zip(tp, jp):
        assert Path(a).read_text() == Path(b).read_text()
    assert (texpgen.SEEDS, texpgen.TRAIN_RATIOS, texpgen.DATASET_HP,
            texpgen.FIXED) == (jexpgen.SEEDS, jexpgen.TRAIN_RATIOS,
                               jexpgen.DATASET_HP, jexpgen.FIXED)


def test_expgen_grid(tmp_path, capsys):
    paths = texpgen.generate(str(tmp_path), datasets=("yelp", "amazon_new"),
                             seeds=[2, 3], train_ratios=[0.1, 0.4])
    assert len(paths) == 8
    cfg = json.load(open(paths[0]))
    for k in ("seed", "data_name", "model", "train_ratio", "test_ratio",
              "emb_size", "lr", "weight_decay", "alpha", "rho", "epochs",
              "valid_epochs", "batch_size", "patience", "exp_num"):
        assert k in cfg, k
    yelp = [json.load(open(p)) for p in paths if "yelp" in p]
    amzn = [json.load(open(p)) for p in paths if "amazon_new" in p]
    assert all(c["batch_size"] == 1024 and c["lr"] == 0.01 for c in yelp)
    assert all(c["batch_size"] == 256 and c["lr"] == 0.005 for c in amzn)
    assert sorted(c["exp_num"] for c in yelp + amzn) == list(range(8))
    texpgen.main(["--out_dir", str(tmp_path / "cli"), "--datasets", "yelp",
                  "--train_ratios", "0.4"])
    assert "wrote 10 configs" in capsys.readouterr().out


def test_fleet_dry_run(tmp_path, capsys):
    texpgen.generate(str(tmp_path), datasets=("yelp",), seeds=[2, 3],
                     train_ratios=[0.4])
    assert tfleet.run_configs(str(tmp_path), jobs=2, dry_run=True) == 0
    out = capsys.readouterr().out
    assert "2 configs, 2 concurrent job(s)" in out
    launches = [ln for ln in out.splitlines() if ln.startswith("launch:")]
    assert len(launches) == 2
    assert all("-m pcgnn_tpu_torch.cli --exp_config_path=" in ln
               for ln in launches)


def test_fleet_empty_dir(tmp_path, capsys):
    assert tfleet.run_configs(str(tmp_path)) == 0
    assert "no configs" in capsys.readouterr().out


def test_fleet_counts_failed_runs(tmp_path, monkeypatch, capsys):
    """Each config runs as a CLI subprocess; one that fails (an unknown
    dataset, or no GPU here) is counted."""
    cfg_dir = tmp_path / "cfgs"
    cfg_dir.mkdir()
    (cfg_dir / "bad.json").write_text(json.dumps(
        dict(data_name="no-such-dataset", model="PCGNN", epochs=1)))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    assert tfleet.run_configs(str(cfg_dir), python=sys.executable) == 1
    assert "done; 1 failed" in capsys.readouterr().out


def _table_rows(model, data, train_ratio, aucs, seeds=(2, 3, 5)):
    """Rows as the port's ``ResultManager.write_test_log`` writes them:
    metrics, then the config's keys as strings."""
    return [dict(exp_id=f"{model}-{data}-x{seed}", epoch_best=10, auc=auc,
                 f1_macro=auc - 0.1, recall=auc - 0.2, gmean=auc - 0.15,
                 model=model, data_name=data, train_ratio=str(train_ratio),
                 seed=str(seed))
            for seed, auc in zip(seeds, aucs)]


def test_analysis_matches_numpy_and_jax(tmp_path, capsys):
    d = tmp_path / "test_df"
    d.mkdir()
    pc = _table_rows("PCGNN", "yelp", 0.4, [0.90, 0.92, 0.94])
    pc[1]["recall"] = math.nan          # skipped, as pandas skips it
    write_table(str(d / "PCGNN-yelp.csv"), pc)
    write_table(str(d / "GCN-yelp.csv"),
                _table_rows("GCN", "yelp", 0.4, [0.80, 0.80, 0.80])
                + _table_rows("GCN", "yelp", 0.1, [0.7], seeds=(2,)))
    rows = tanalysis.load_all_test_dfs(str(tmp_path))
    assert len(rows) == 7
    summary = tanalysis.summarize(rows)
    assert list(summary) == [("GCN", "yelp", "0.1"), ("GCN", "yelp", "0.4"),
                             ("PCGNN", "yelp", "0.4")]
    s = summary[("PCGNN", "yelp", "0.4")]
    aucs = np.array([0.90, 0.92, 0.94])
    np.testing.assert_allclose(s["auc"]["mean"], aucs.mean(), rtol=1e-12)
    np.testing.assert_allclose(s["auc"]["std"], aucs.std(ddof=1), rtol=1e-12)
    assert s["auc"]["count"] == 3 and s["recall"]["count"] == 2
    np.testing.assert_allclose(s["recall"]["mean"], np.mean([0.70, 0.74]),
                               rtol=1e-12)
    assert summary[("GCN", "yelp", "0.4")]["auc"]["std"] == 0.0
    one = summary[("GCN", "yelp", "0.1")]["auc"]
    assert one["count"] == 1 and math.isnan(one["std"])
    # the JAX package's pandas aggregation of the same rows
    df = pd.DataFrame(rows)
    for m in janalysis.METRICS:
        df[m] = df[m].astype(float)
    agg = janalysis.summarize(df)
    for group, metrics in summary.items():
        for m, stats in metrics.items():
            for k in tanalysis.STATS:
                np.testing.assert_allclose(stats[k], agg.loc[group][(m, k)],
                                           rtol=METRIC_RTOL, equal_nan=True)
    assert tanalysis.METRICS == janalysis.METRICS
    assert tanalysis.GROUP_KEYS == janalysis.GROUP_KEYS
    tanalysis.main(["--results", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[2].startswith("PCGNN yelp 0.4  auc 0.9200")


def test_analysis_of_a_real_result_tree(tmp_path, monkeypatch, capsys):
    """The tables the trainer writes aggregate: two seeds of one setting."""
    monkeypatch.chdir(tmp_path)
    for seed in (2, 3):
        cfg = _cfg(seed=seed, epochs=2, valid_epochs=1)
        TTrainer(cfg, device="cpu").train()
    rows = tanalysis.load_all_test_dfs()
    summary = tanalysis.summarize(rows)
    (group,) = summary
    assert group == ("PCGNN", "synthetic:tiny", "0.4")
    assert summary[group]["auc"]["count"] == 2
    aucs = [float(r["auc"]) for r in rows]
    np.testing.assert_allclose(summary[group]["auc"]["mean"], np.mean(aucs))


def test_analysis_empty(tmp_path, capsys):
    assert tanalysis.load_all_test_dfs(str(tmp_path)) == []
    assert tanalysis.summarize([]) == {}
    tanalysis.main(["--results", str(tmp_path)])
    assert "no test results found" in capsys.readouterr().out


def _log_tree(root):
    return {str(p.relative_to(root).parent): p.read_text()
            for p in sorted(Path(root).rglob("*.log"))}


def test_legacy_log_matches_jax(tmp_path, capsys):
    trees = {}
    for tag, cls in (("jax", JLegacyLog), ("torch", TLegacyLog)):
        lg = cls(model_name="PCGNN", data_name="yelp",
                 root=str(tmp_path / tag))
        lg.write_train_log("t1", print_line=False)
        lg.write_train_log("t2", print_line=False)
        lg.write_valid_log("v1")
        lg.write_test_log("x1", print_line=False)
        lg.multi_run_log("m1", print_line=False)
        assert lg.log_file_name.startswith("(PCGNN)")
        trees[tag] = _log_tree(tmp_path / tag)
    assert trees["torch"] == trees["jax"]
    assert trees["torch"] == {"log(yelp, PCGNN)/multiple-run": "m1\n",
                              "log(yelp, PCGNN)/test": "x1\n",
                              "log(yelp, PCGNN)/train": "t1\nt2\n",
                              "log(yelp, PCGNN)/valid": "v1\n"}
    assert capsys.readouterr().out == "v1\nv1\n"


def _cfg(**kw):
    cfg = dict(seed=2, data_name="synthetic:tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=6,
               valid_epochs=3, batch_size=64, patience=100, exp_num=0)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("model", ["PCGNN", "GCN"])
def test_threshold_transfer_eval_matches_jax(tmp_path, model):
    """The JAX trainer's best checkpoint, evaluated by both packages: the
    same calibrated threshold, and metrics within rtol 1e-6."""
    cfg = _cfg(model=model, ewin_dtype="float32")
    jt = JTrainer(cfg, result=JResults(cfg, root=str(tmp_path / "j")))
    jt.train()
    tt = TTrainer(cfg, device="cpu",
                  result=TResults(cfg, root=str(tmp_path / "t")))
    path = jt.result.model_path
    jv, jtest, jthr = jeval.threshold_transfer_eval(jt, path)
    tv, ttest, tthr = teval.threshold_transfer_eval(tt, path)
    assert tthr == jthr
    for a, b in ((tv, jv), (ttest, jtest)):
        for k in ("auc", "f1", "f1_macro", "recall", "precision", "gmean"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=METRIC_RTOL, err_msg=k)
        np.testing.assert_allclose(a.anomaly_confidence, b.anomaly_confidence,
                                   rtol=1e-5, atol=1e-6)
    # the trainer's own model file is the default checkpoint
    jckpt.save_checkpoint(tt.result.model_path, jckpt.load_checkpoint(path))
    assert teval.threshold_transfer_eval(tt)[2] == tthr


def test_model_select(tmp_path):
    cfg = _cfg()
    r = TResults(cfg, root=str(tmp_path))
    r.df_test = [dict(exp_id="a", auc="0.7"), dict(exp_id="b", auc="0.9"),
                 dict(exp_id="c", auc="0.8")]
    assert teval.model_select(r) == os.path.join(r.dirs["models"], "b.ckpt")


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("my_range"):
            (x @ x).sum()
    (path,) = tmp_path.glob("trace-*.json")
    assert str(path) == prof.trace_path
    names = {e.get("name") for e in _trace_events(path)}
    assert "my_range" in names and "aten::mm" in names
    # a block that raises writes no trace and re-raises
    with pytest.raises(KeyError):
        with profiling.trace(str(tmp_path / "err")):
            raise KeyError("x")
    assert not list((tmp_path / "err").glob("*.json"))
