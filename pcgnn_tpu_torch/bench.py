"""Headline benchmark: PC-GNN training throughput on a YelpChi-scale graph
(counterpart of the repository's ``bench.py``).

    python -m pcgnn_tpu_torch.bench [--preset yelp-like] [--batch_size 1024]
        [--epochs 48] [--emb_size 64] [--graph_pickle PATH]
        [--baseline PATH] [--device cuda]

Prints the card's name and power limit and the host's CPU model, then, as
its last line, ONE JSON line with ``bench.py``'s keys:

  {"metric": "pcgnn_train_edges_per_s", "value": ..., "unit": "edges/s",
   "vs_baseline": ..., "epochs_per_hour": ..., "step_ms": ...,
   "hbm_bw_util": ..., "step_achieved_gbps": ..., "peak_gbps": ...,
   "roofline_step_ms": ..., "preset": ..., "batch_size": ...,
   "device": <torch.cuda.get_device_name()>}

``value``: candidate edges per second of the full training step (pick ->
choose -> aggregate forward and backward -> Adam), summed over relations
(``edges_per_epoch``), over a block of ``--epochs`` epochs run back to back
(``Trainer.epoch_block``: every step a replay of the captured training
step, the hub lane planned once an epoch) after a warm-up block of as many
(which holds the capture); the barrier is ``torch.cuda.synchronize()`` and
a read of the loss.  ``hbm_bw_util`` and
``roofline_step_ms``: ``Trainer.single_step`` at ``nscan`` 16 timed by
``utils.roofline.measure`` against ``pcgnn_step_streaming_bytes``.
``vs_baseline``: ``value`` over ``reference_edges_per_s`` of the file
``--baseline`` (default: the repository's ``BASELINE_MEASURED.json``,
measured on another host), 1.0 if the file is absent.
``python -m pcgnn_tpu_torch.benchmarks.measure_reference --out FILE``
measures the reference on this host; pass ``--baseline FILE``.

The host still picks, plans and launches one graph a step, so ``value``
can move with the host: compare two lines only from one call.  The bench times the card: on a CPU device it
raises before any work, as ``utils.roofline.measure`` does.

``--graph_pickle``: a pickle of the port's own graph (``save_graph``:
numpy leaves, no stores; the trainer builds its stores on the card).  A
pickle of the JAX package's graph cannot be unpickled without the JAX
classes, so it is not taken.  Make one on the host with
``bench.save_graph(synthetic_fraud_graph('stress-1m', seed=2), path)``
(``data.synthetic``; the bench's seed is 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

from pcgnn_tpu_torch.utils import roofline

BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "BASELINE_MEASURED.json")
# steps per call of the roofline's single_step
NSCAN = 16


def bench_config(preset: str, batch_size: int, epochs: int,
                 emb_size: int) -> dict:
    """``bench.py``'s configuration (no evaluation, no early stop)."""
    return dict(seed=2, data_name=f"synthetic:{preset}", model="PCGNN",
                train_ratio=0.4, test_ratio=0.67, emb_size=emb_size,
                lr=0.01, weight_decay=0.001, alpha=2.0, rho=0.5,
                epochs=epochs, valid_epochs=10 ** 9, batch_size=batch_size,
                patience=10 ** 9, exp_num=0)


def edges_per_epoch(t) -> float:
    """Expected candidate edges per epoch of trainer ``t`` (``bench.py``'s
    definition): each of the epoch's picked nodes contributes deg_r(v)
    slots per relation.  A baseline's epoch takes every training node
    once, over the homo graph."""
    if not t.is_pcgnn:
        return float(t.graph.homo.deg.double().cpu().numpy()[t.idx_train]
                     .sum())
    p = t.pick_weights.double().cpu().numpy()
    p = p / p.sum()
    per_sample = sum(float((p * rel.deg.double().cpu().numpy()[t.idx_train])
                           .sum()) for rel in t.graph.relations)
    return per_sample * t.sample_size


def reference_edges_per_s(path: str):
    """``reference_edges_per_s`` of the JSON file ``path``; None when the
    file is absent or holds none."""
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("reference_edges_per_s") or None


def _map_leaves(obj, fn):
    """``obj`` (a graph dataclass, tuple or array) with every tensor or
    ndarray leaf replaced by ``fn(leaf)``."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_map_leaves(o, fn) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_leaves(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    return obj


def save_graph(graph, path: str) -> None:
    """Pickle ``graph`` (``graph.csr.MultiRelGraph``) with numpy leaves and
    without its stores, for ``--graph_pickle``."""
    with open(path, "wb") as f:
        pickle.dump(_map_leaves(graph.without_stores(),
                                lambda a: a.cpu().numpy()), f)


def load_graph(path: str):
    """The graph ``save_graph`` wrote, with tensor leaves on the host."""
    with open(path, "rb") as f:
        return _map_leaves(pickle.load(f), torch.from_numpy)


def run(preset: str = "yelp-like", batch_size: int = 1024, epochs: int = 48,
        emb_size: int = 64, graph_pickle: str | None = None,
        baseline: str | None = BASELINE_PATH, device="cuda",
        graph=None) -> dict:
    """The bench's line.  ``graph``: the preset's graph already built (a
    graph with stores keeps them).  Raises on a CPU device."""
    from pcgnn_tpu_torch.train.trainer import Trainer
    dev = roofline._card(device)
    if graph is None and graph_pickle:
        graph = load_graph(graph_pickle)
    t = Trainer(bench_config(preset, batch_size, epochs, emb_size),
                graph=graph, device=dev)
    model = t.new_model()
    optimizer = t.new_optimizer(model)
    edges = edges_per_epoch(t)

    def block(first_epoch: int) -> float:
        loss = t.epoch_block(model, optimizer, first_epoch, epochs)
        torch.cuda.synchronize(dev)
        return float(loss)

    block(0)                                    # warm-up
    t0 = time.perf_counter()
    block(epochs)
    dt = (time.perf_counter() - t0) / epochs
    edges_per_s = edges / dt

    # the roofline: NSCAN back-to-back steps on a fixed batch against the
    # least bytes a step must move
    rng = np.random.default_rng(0)
    rb = rng.choice(np.asarray(t.idx_train), batch_size)
    ry = t.graph.labels.cpu().numpy()[rb]
    rw = np.ones((batch_size,), np.float32)
    fn, fargs = t.single_step(model, optimizer, rb, ry, rw, nscan=NSCAN)
    m_max = model.minor_window(int(t.train_pos_dev.shape[0]),
                               t.graph.relations)
    step_bytes = roofline.pcgnn_step_streaming_bytes(
        t.graph, batch_size, m_max, emb_size)
    roof = roofline.measure(fn, *fargs, analytic_bytes=step_bytes * NSCAN,
                            device=dev)
    roof["wall_ms"] /= NSCAN

    ref = reference_edges_per_s(baseline)
    return {
        "metric": "pcgnn_train_edges_per_s",
        "value": round(edges_per_s, 1),
        "unit": "edges/s",
        "vs_baseline": round(edges_per_s / ref, 3) if ref else 1.0,
        "epochs_per_hour": round(3600.0 / dt, 1),
        "step_ms": round(dt / t.num_batches * 1e3, 2),
        "hbm_bw_util": (round(roof["sol_frac"], 4)
                        if roof.get("sol_frac") is not None else None),
        "step_achieved_gbps": round(roof["achieved_gbps"], 1),
        "peak_gbps": roof["peak_gbps"],
        "roofline_step_ms": round(roof["wall_ms"], 3),
        "preset": preset,
        "batch_size": batch_size,
        "device": roof["device"],
    }


def main(argv=None) -> int:
    from pcgnn_tpu_torch.benchmarks import card_line
    from pcgnn_tpu_torch.benchmarks.measure_reference import cpu_model
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="yelp-like")
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=48)
    ap.add_argument("--emb_size", type=int, default=64)
    ap.add_argument("--graph_pickle", default=None,
                    help="a graph written by save_graph for this preset "
                    "(skips the in-process graph build)")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="JSON with reference_edges_per_s (measure_reference "
                    "--out); vs_baseline is 1.0 without it")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    roofline._card(args.device)
    print(f"card: {card_line(args.device)}")
    print(f"host: {cpu_model()}, {os.cpu_count()} cores")
    line = run(args.preset, args.batch_size, args.epochs, args.emb_size,
               args.graph_pickle, args.baseline, args.device)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
