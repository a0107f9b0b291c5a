"""One run of one cell: set-up, the timed window or the traced slice, the
check, the result line.  ``run.py`` is the command; this module holds the
parts, so the tests drive a run on the CPU at a small size."""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import check, gen, stats, trace
from portbench.counts import peaks as peaks_mod

HERE = Path(__file__).resolve().parent
# top-level module names that may not be loaded once the window closes:
# JAX and the JAX package (compared whole: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "pcgnn_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, name: str, root: Path | None = None) -> tuple:
    """(workload entry, configuration file, traffic file) of cell
    ``name``, from the checkout at ``root`` (default: the working
    directory)."""
    root = Path.cwd() if root is None else root
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (cell, load_json(root / conf["file"]),
            load_json(HERE / "workloads" / f"{name}.json"))


def cell_metrics(bench: dict, name: str, traced: bool) -> list:
    """The metrics a run of cell ``name`` reports: its end-to-end ones, or
    with ``traced`` its per-layer ones."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def reference_module(cfg: dict):
    """The plain reference the configuration names (``reference/``)."""
    return importlib.import_module(
        f"portbench.reference.{cfg.get('reference', 'pcgnn')}")


def trainer_config(model: dict, seed: int) -> dict:
    """The trainer's configuration from the model section: PC-GNN's own
    keys (``alpha``, ``rho``) and the store's precision only where the
    section has them."""
    keys = ("data_name", "model", "train_ratio", "test_ratio", "emb_size",
            "lr", "weight_decay", "valid_epochs", "batch_size",
            "edge_windows")
    # early stopping and checkpoints stay off: the window runs its own loop
    return {**{k: model[k] for k in keys},
            **{k: model[k] for k in ("alpha", "rho", "ewin_dtype")
               if k in model},
            "seed": seed, "epochs": 10**9, "patience": 10**9, "exp_num": 0}


class Tap:
    """The inputs and losses of a runner's last stack of steps: the static
    buffers of a capturing runner, or the calls of an eager one (recorded
    while ``on``)."""

    def __init__(self, runner):
        self.runner, self.calls, self.on = runner, [], False
        if not runner.capture:
            fn = runner.fn

            def tapped(batch, y, w, generator, hub_plans):
                out = fn(batch, y, w, generator, hub_plans)
                if self.on:
                    self.calls.append((batch.clone(), y.clone(), w.clone(),
                                       out.detach().clone()))
                return out
            runner.fn = tapped

    def last(self, n: int) -> tuple:
        """(batches, labels, weights, losses) of the last ``n`` steps."""
        if self.runner.capture:
            b, y, w, loss = self.runner.bufs
            return (b[:n].clone(), y[:n].clone(), w[:n].clone(),
                    loss[:n].clone())
        calls, self.calls = self.calls[-n:], []
        return tuple(torch.stack([c[i] for c in calls]) for i in range(4))


def leaves(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class Run:
    """The program under test, set up from the seed (``setup``), with the
    records the check needs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        # the dataset (its draws, the split, the trainer's seed) is the
        # configuration's; the run's seed draws the initial weights.  The
        # epochs are the trainer's own, 0, 1, 2, ... (each epoch's picks
        # seeded by its index), so every seed trains the same work
        self.seed = int(cfg["seed"])
        self.run_seed = seed % 2**63
        self.epoch = 0
        self.model_cfg = cfg["model"]
        self.refmod = reference_module(cfg)
        # the graph's semantics and the lane the configuration states: its
        # relations directed or not, edge-window stores or none
        self.directed = bool(cfg["graph"].get("directed"))
        self.stores = bool(self.model_cfg["edge_windows"])
        self.rec: dict = {}
        self.ref = None

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = now - self._lap
        self._lap = now

    def setup(self) -> None:
        self.laps, self._lap = {}, time.perf_counter()
        from pcgnn_tpu_torch.data.synthetic import stub_degrees
        from pcgnn_tpu_torch.graph.csr import (build_multirel, csr_from_edges,
                                               degree_stub)
        from pcgnn_tpu_torch.train.trainer import Trainer
        self.lap("import")
        mc, dev = self.model_cfg, self.device
        draws = {k: v for k, v in self.cfg["graph"].items() if k != "directed"}
        raw = gen.draw_graph(self.seed, **draws, **self.traffic["graph"])
        self.raw = raw
        self.lap("draws")
        n = raw.num_nodes
        thr = mc.get("threshold", 0.5)
        thr = thr if isinstance(thr, list) else [thr] * len(raw.srcs)
        # what the port's loader builds: directed relations with a
        # degree-only homo graph (data/synthetic.py's stress presets), or
        # symmetric ones with the homo graph's CSR
        rels = [csr_from_edges(s, d, n, threshold=t,
                               symmetrize=not self.directed, device=dev)
                for s, d, t in zip(raw.srcs, raw.dsts, thr)]
        if self.directed:
            homo = degree_stub(stub_degrees(raw.srcs, raw.dsts, n),
                               device=dev)
        else:
            homo = csr_from_edges(np.concatenate(raw.srcs),
                                  np.concatenate(raw.dsts), n, device=dev)
        graph = build_multirel(rels, homo, raw.features, raw.labels,
                               device=dev)
        self.lap("program graph")
        self.t = Trainer(trainer_config(mc, self.seed), graph=graph,
                         device=dev)
        # the stores of the graphs the model reads: PC-GNN's relations,
        # the homo graph of GCN and GraphSAGE
        reads = type(self.t.model).hub_relations(self.t.graph)
        stored = [r.ewin is not None for r in reads]
        if stored != [self.stores] * len(stored):
            raise RuntimeError(
                f"the configuration states edge_windows {self.stores}, the "
                f"program stored the graphs its model reads {stored}: the "
                f"reference would follow another lane than the program "
                f"takes")
        self.lap("trainer")
        self.model = self.t.new_model()
        self.lap("model")
        p0 = self.refmod.initial_weights(self.run_seed, raw, self.cfg, dev)
        self.lap("weights")
        self.model.load_state_dict(p0)
        self.optimizer = self.t.new_optimizer(self.model)
        self.rec["params0"] = {k: v.clone() for k, v in p0.items()}
        self.runner = self.t.runner(self.model, self.optimizer)
        self.tap = Tap(self.runner)
        self.lap("optimizer and runner")
        self.warm_up()

    def reference(self) -> None:
        """The reference's graph (``self.ref``), built from the raw draws
        once the window has closed, so that its seconds are not set-up's:
        the edges an epoch brings, and each relation's degrees and window
        cap, which the traced slice's counts read (``counted``)."""
        if self.ref is not None:
            return
        a = time.perf_counter()
        g = self.refmod.build_graph(self.raw, self.cfg, self.device)
        self.edges_per_epoch = self.refmod.edges_per_epoch(g)
        self.hub_cap = [(r.deg, r.dcap) for r in g.relations]
        self.ref = g
        self.reference_s = time.perf_counter() - a

    def _step_hook(self, what: str) -> None:
        if what != "end":
            return
        self._steps += 1
        if self._steps == 1:
            st = self.optimizer.state
            self.rec["exp_avg1"] = {
                k: (st[p]["exp_avg"].detach().clone() if p in st
                    else torch.zeros_like(p))
                for k, p in self.model.named_parameters()}
        elif self._steps == 3:
            self.rec["params3"] = leaves(self.model)

    def warm_up(self) -> None:
        """Epoch 0 twice and one validation: every capture the first
        epoch and the forward need.  The first run of epoch 0 warms up and
        captures the step (its first step runs eagerly, the rest replay);
        then ``record``."""
        float(self.t.run_epoch(self.model, self.optimizer, 0))
        self.lap("capture epoch")
        self.record()

    def reseed(self, seed: int) -> None:
        """The run of ``seed`` on this set-up: its initial weights, then
        ``record`` (the calibration reads many seeds in one process; the
        dataset, and so the set-up, is the same for every seed)."""
        self.run_seed = seed % 2**63
        p0 = self.refmod.initial_weights(self.run_seed, self.raw, self.cfg,
                                         self.device)
        self.rec = {"params0": {k: v.clone() for k, v in p0.items()}}
        self.record()

    def record(self) -> None:
        """The parameters and Adam's state put back as they were
        (``restart``) and epoch 0 run again, every step a replay of the
        captured graph on the card: that run is recorded for the check
        (its first three steps and its plan), a validation follows, and
        the window goes on from epoch 1 as ``Trainer.train`` would."""
        t, nb = self.t, self.t.num_batches
        self.restart()
        self._steps = 0
        self.runner.step_hook = self._step_hook
        self.tap.on = True
        float(t.run_epoch(self.model, self.optimizer, 0))
        self.tap.on = False
        self.runner.step_hook = None
        b, y, w, losses = self.tap.last(nb)
        if self._steps < 3:
            raise RuntimeError(f"the first epoch ran {self._steps} steps; "
                               f"the check follows three")
        self.rec.update(batches=list(b[:3]), weights=list(w[:3]),
                        losses=losses[:3].tolist(), plan_batches=b,
                        plan_labels=y, plan_weights=w)
        self.epoch = 1
        self.lap("recorded epoch")
        self.validate()
        self.lap("warm-up validation")

    def restart(self) -> None:
        """Put the parameters back to the initial weights and Adam's
        state back to before its first step, in place: the captured step
        reads and writes these same tensors."""
        p0 = self.rec["params0"]
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                v.copy_(p0[k])
            for st in self.optimizer.state.values():
                for v in st.values():
                    if torch.is_tensor(v):
                        v.zero_()

    def epoch_once(self) -> tuple:
        """One epoch as ``Trainer.train`` runs it: (ms to the loss on the
        host, host ms before ``run_epoch`` returned, loss)."""
        a = time.perf_counter()
        with record_function("portbench.epoch"):
            loss = self.t.run_epoch(self.model, self.optimizer, self.epoch)
            ret = time.perf_counter()
            loss = float(loss)
        b = time.perf_counter()
        self.epoch += 1
        return (b - a) * 1e3, (ret - a) * 1e3, loss

    def due(self) -> bool:
        """Whether ``Trainer.train`` validates after the epoch just run:
        after epochs 9, 19, ... of ``valid_epochs`` 10."""
        return self.epoch % self.model_cfg["valid_epochs"] == 0

    def validate(self) -> tuple:
        """One validation as ``Trainer.train`` runs it: (ms, all
        probabilities finite); the parameters it read and its fraud
        probabilities are kept for the check."""
        params = leaves(self.model)
        a = time.perf_counter()
        with record_function("portbench.validate"):
            res = self.t.evaluate(self.model, self.t.idx_valid,
                                  self.t.y_valid)
        ms = (time.perf_counter() - a) * 1e3
        self.rec["valid_params"] = params
        self.rec["valid_probs"] = np.array(res.anomaly_confidence)
        return ms, bool(np.isfinite(res.anomaly_confidence).all())

    def window(self, seconds: float) -> dict:
        """The closed loop for ``seconds``: epochs, a validation every
        ``valid_epochs``; the next starts when the last one's result is on
        the host."""
        epoch_ms, valid_ms, failed = [], [], 0
        start = time.perf_counter()
        while True:
            ms, _, loss = self.epoch_once()
            epoch_ms.append(ms)
            failed += not math.isfinite(loss)
            if self.due():
                ms, ok = self.validate()
                valid_ms.append(ms)
                failed += not ok
            if time.perf_counter() - start >= seconds:
                break
        n = len(epoch_ms)
        self.window_stats = {
            "epochs": n, "validations": len(valid_ms),
            "epoch_ms_median": stats.median(epoch_ms),
            "validate_ms_median": stats.median(valid_ms),
            # the median of each fifth of the epochs, in order: a slow
            # phase at the window's start shows in the first
            "epoch_ms_by_fifth": [
                stats.median(epoch_ms[i * n // 5: (i + 1) * n // 5])
                for i in range(5)]}
        return {"seconds": time.perf_counter() - start, "epoch_ms": epoch_ms,
                "validate_ms": valid_ms, "epochs": len(epoch_ms),
                "failed": failed}

    def traced(self, epochs: int, tries: int = 3) -> dict:
        """``epochs`` epochs with their validations under the profiler;
        the record the per-layer readers take.  Now and then the profiler
        records no kernel of a run on the card (seen with torch 2.11 on
        an H100): the slice is then traced again, up to ``tries`` times."""
        for _ in range(tries):
            tr = self._traced_once(epochs)
            if tr["device_ops"] or self.device.type != "cuda":
                break
        return tr

    def _traced_once(self, epochs: int) -> dict:
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        captures = self.runner.stats()["captures"]
        host_ms, n_valid, failed = [], 0, 0
        plans = []
        nb = self.t.num_batches
        with profile(activities=acts) as prof:
            for _ in range(epochs):
                self.tap.on = True
                _, hms, loss = self.epoch_once()
                self.tap.on = False
                host_ms.append(hms)
                failed += not math.isfinite(loss)
                b, _, w, _ = self.tap.last(nb)
                plans.append((b, w))
                if self.due():
                    failed += not self.validate()[1]
                    n_valid += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        ev = trace.events(prof)
        lo, hi = trace.wall(ev["spans"])
        rows = sum(int((w > 0).sum()) for _, w in plans)
        return {
            **ev, "wall": (lo, hi), "epoch_host_ms": host_ms,
            "epochs": epochs, "validations": n_valid, "failed": failed,
            "steps": epochs * nb,
            "captures": self.runner.stats()["captures"] - captures,
            "rows": rows, "plans": [(b.cpu(), w.cpu()) for b, w in plans],
            "reference": self.cfg.get("reference", "pcgnn"),
            "stores": self.stores, "feat_dim": self.raw.features.shape[1],
            "emb": self.model_cfg["emb_size"],
            "relations": len(self.raw.srcs),
            "params": sum(p.numel() for p in self.model.parameters()),
            "breakdown": trace.breakdown(ev, lo, hi)}

    def counted(self, tr: dict) -> None:
        """The traced slice's counts that rest on the reference's graph
        (``reference``), added to its record ``tr``: the degree sums of
        its batches' real rows, the fused records' width, the train
        positives."""
        self.reference()
        plans = tr.pop("plans")
        tr.update(
            hub_neighbors=self.degree_sum(plans, True),
            neighbors=self.degree_sum(plans),
            record_width=sum(min(int(deg.max()), cap)
                             for deg, cap in self.hub_cap) * tr["feat_dim"]
            if self.stores else 0,
            train_pos=int(self.ref.train_pos.shape[0]))

    def degree_sum(self, plans, hubs_only: bool = False) -> int:
        """Degree sum of the real rows of the traced batches ``plans``, over
        all relations; ``hubs_only``: of the rows above their relation's
        window cap."""
        total, dev = 0, self.hub_cap[0][0].device
        for b, w in plans:
            b, real = b.to(dev), w.to(dev) > 0
            for deg, cap in self.hub_cap:
                d = deg[b]
                keep = real & (d > cap) if hubs_only else real
                total += int(torch.where(keep, d, 0).sum())
        return total

    def close(self) -> None:
        """Free the program's state: the reference runs after it."""
        for k in ("t", "model", "optimizer", "runner", "tap"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple:
        self.reference()
        return check.compare(self.refmod, self.ref, self.rec,
                             self.model_cfg, self.traffic["limits"])


def card(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    kind = torch.cuda.get_device_name(device)
    out = {"platform": "gpu", "kind": kind, "count": 1}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i",
                            str(device.index or 0)], capture_output=True,
                           text=True, timeout=60)
        out["power_limit"] = q.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["power_limit"] = f"unread: {e}"
    return out


def run_cell(cfg: dict, traffic: dict, metrics: list, seed: int,
             seconds: float, traced: bool, device, t0: float) -> tuple:
    """(result line dict, [(name, value, limit)]) of one run of the cell
    of configuration ``cfg`` and traffic ``traffic``, reporting
    ``metrics`` (``cell_metrics``); raises RuntimeError when a forbidden
    module is loaded once the window has closed."""
    device = torch.device(device)
    run = Run(cfg, traffic, seed, device)
    run.setup()
    setup_s = time.perf_counter() - t0
    dev_info = card(device)
    if traced:
        tr = run.traced(traffic["traced_epochs"])
        attempted = tr["epochs"] + tr["validations"]
        failed = tr["failed"]
        rec = {"trace": tr}
    else:
        w = run.window(seconds)
        w["setup_s"] = setup_s
        attempted = w["epochs"] + len(w["validate_ms"])
        failed = w["failed"]
        rec = {"window": w}
    if device.type == "cuda":
        dev_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    # the reference after the window, on the card the program has freed
    run.close()
    run.reference()
    if traced:
        run.counted(tr)
    else:
        w["edges_per_epoch"] = run.edges_per_epoch
    rec["peaks"] = peaks_mod.peaks(dev_info["kind"])
    values = {}
    for m in metrics:
        v = reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    a = time.perf_counter()
    with no_tf32():
        ok, rows = run.check()
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded once the window closed: {bad}")
    line = {"correct": ok, "attempted": attempted, "failed": failed,
            "metrics": values, "device": dev_info}
    if traced:
        lo, hi = tr["wall"]
        busy = stats.covered(stats.clip(
            [(o[1], o[2]) for o in tr["device_ops"]], lo, hi))
        dev_info.update(busy_s=busy / 1e6, window_s=(hi - lo) / 1e6)
        line["breakdown"] = tr["breakdown"]
    line["setup_laps"] = run.laps
    line["reference_s"] = {"graph": run.reference_s,
                           "check": time.perf_counter() - a}
    if not traced:
        line["window_stats"] = run.window_stats
    line["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line, rows


@contextlib.contextmanager
def no_tf32():
    """Float32 products stay float32 (the reference's precision)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
