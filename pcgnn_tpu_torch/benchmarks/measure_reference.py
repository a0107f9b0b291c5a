"""Measure the throughput of the reference implementation's algorithmic hot
path on this host (counterpart of ``benchmarks/measure_reference.py``), the
yardstick of the bench's ``vs_baseline``.

    python -m pcgnn_tpu_torch.benchmarks.measure_reference \\
        [--preset yelp-like] [--batch_size 1024] [--emb 64] \\
        [--max_batches 4] [--out FILE]

The reference trains via per-batch Python-set neighbor unions, per-node
``torch.sort`` choose filtering, and host-built dense masks.  This script
re-executes that algorithm (torch tensors for the GEMMs, Python loops for
selection: the same structure) on the same synthetic YelpChi-scale graph,
built by the port's ``data/synthetic.py`` with the port's splits
(``data/prep.py``) and pick weights (``sampling/pick.py``), times up to
``max_batches`` batches of forward and backward, and reports candidate
edges per second.  It runs on the host CPU by definition (the reference is
CPU code): ``"host"`` says so and names the CPU model.  Prints its JSON;
writes ``--out`` only if given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import platform
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from pcgnn_tpu_torch.benchmarks import card_line
from pcgnn_tpu_torch.data.prep import pos_neg_split, stratified_splits
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.sampling.pick import pick_probs


def cpu_model() -> str:
    """The host CPU's model name (``/proc/cpuinfo``, else the platform's
    processor string)."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def adjacency_lists(rel):
    indptr = rel.indptr.cpu().numpy()
    col = rel.col.cpu().numpy()
    return [col[indptr[v]:indptr[v + 1]].tolist()
            for v in range(rel.num_nodes)]


def reference_style_batch(x, adj_lists, params, batch, labels, train_pos,
                          rho=0.5):
    """One training batch in the reference's algorithmic style; returns the
    loss (after backward) and the number of candidate edges examined."""
    feat = torch.from_numpy(x)
    clf_w, clf_b = params["clf_w"], params["clf_b"]
    scores = feat @ clf_w + clf_b
    s0 = scores[:, 0]
    edges = 0

    rel_embs = []
    for r, adj in enumerate(adj_lists):
        samp_neighs = []
        for i, v in enumerate(batch):
            neighs = adj[v]
            edges += len(neighs)
            num_sample = math.ceil(0.5 * len(neighs))
            d = torch.abs(s0[v] - s0[torch.tensor(neighs)])
            _, order = torch.sort(d)
            if len(neighs) > num_sample + 1:
                selected = [neighs[j] for j in order[:num_sample].tolist()]
            else:
                selected = list(neighs)
            if labels[i] == 1 and len(train_pos):
                m = int(num_sample * rho)
                dp = torch.abs(s0[v] - s0[torch.tensor(train_pos)])
                _, orderp = torch.sort(dp)
                selected.extend(train_pos[j] for j in orderp[:m].tolist())
            samp_neighs.append(set(selected))

        unique_nodes_list = list(set.union(*samp_neighs))
        unique_nodes = {n: i for i, n in enumerate(unique_nodes_list)}
        mask = torch.zeros(len(samp_neighs), len(unique_nodes))
        cols = [unique_nodes[n] for sn in samp_neighs for n in sn]
        rows = [i for i in range(len(samp_neighs)) for _ in samp_neighs[i]]
        mask[rows, cols] = 1
        mask = mask / mask.sum(1, keepdim=True)
        agg = mask @ feat[torch.tensor(unique_nodes_list)]
        cat = torch.cat([feat[torch.tensor(batch)], agg], dim=1)
        rel_embs.append(F.relu(cat @ params["intra"][r]))

    cat_all = torch.cat([feat[torch.tensor(batch)]] + rel_embs, dim=1)
    combined = F.relu(cat_all @ params["inter"])
    logits = combined @ params["head"]
    y = torch.tensor(labels, dtype=torch.long)
    loss = (F.cross_entropy(logits, y)
            + 2.0 * F.cross_entropy(scores[torch.tensor(batch)], y))
    loss.backward()
    return float(loss), edges


def run(preset="yelp-like", batch_size=1024, emb=64, max_batches=4):
    """(the JSON record, [(loss, candidate edges)] of each timed batch)."""
    g = synthetic_fraud_graph(preset, seed=2)
    x = g.features.cpu().numpy()
    labels = g.labels.cpu().numpy()
    idx_train, _, _ = stratified_splits(labels, 0.4, 0.67, seed=2)
    y_train = labels[idx_train]
    train_pos, _ = pos_neg_split(idx_train, y_train)
    adj_lists = [adjacency_lists(rel) for rel in g.relations]
    deg_train = g.homo.deg.cpu()[torch.as_tensor(idx_train)]
    w = pick_probs(deg_train, torch.as_tensor(y_train)).numpy()

    torch.manual_seed(0)
    f = x.shape[1]
    params = {
        "clf_w": torch.randn(f, 2, requires_grad=True),
        "clf_b": torch.zeros(2, requires_grad=True),
        "intra": [torch.randn(2 * f, emb, requires_grad=True)
                  for _ in range(3)],
        "inter": torch.randn(f + 3 * emb, emb, requires_grad=True),
        "head": torch.randn(emb, 2, requires_grad=True),
    }

    rng = np.random.default_rng(0)
    sample_size = 2 * len(train_pos)
    sampled = rng.choice(idx_train, size=sample_size, p=w / w.sum())
    num_batches = min(max_batches, -(-sample_size // batch_size))

    batches, t0 = [], time.perf_counter()
    for b in range(num_batches):
        batch = sampled[b * batch_size:(b + 1) * batch_size].tolist()
        batches.append(reference_style_batch(
            x, adj_lists, params, batch, labels[batch], train_pos.tolist()))
    dt = time.perf_counter() - t0
    total_edges = sum(e for _, e in batches)
    out = {
        "reference_edges_per_s": total_edges / dt,
        "reference_sec_per_epoch": dt / num_batches * (
            -(-sample_size // batch_size)),
        "preset": preset,
        "batch_size": batch_size,
        "num_batches_timed": num_batches,
        "candidate_edges": total_edges,
        "host": "cpu (torch)",
        "cpu_model": cpu_model(),
        "cpu_count": os.cpu_count(),
        "torch_threads": torch.get_num_threads(),
        "card": card_line("cuda") if torch.cuda.is_available() else None,
        "note": "reference algorithm re-execution; see module docstring",
    }
    return out, batches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="yelp-like")
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--emb", type=int, default=64)
    ap.add_argument("--max_batches", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out, _ = run(args.preset, args.batch_size, args.emb, args.max_batches)
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
