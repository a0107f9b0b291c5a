"""Real-data readiness checks: a go / no-go gate for a dataset directory.

Counterpart of ``pcgnn_tpu/data/verify.py``, with the same checks and
report lines.  Pointed at a data directory, it checks file presence,
shapes, label counts and relation symmetry against the reference datasets'
documented statistics, so that a wrong download fails before training.
It loads on the CPU and touches no device.

CLI:  python -m pcgnn_tpu_torch.data.verify --data_name yelp --data_prefix data/
Exit code 0 = go, 1 = no-go.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from pcgnn_tpu_torch.data.loaders import _PICKLED, NUM_UNLABELED, load_data

# documented dataset statistics: nodes, allowed feature dims, (min, max)
# fraud count over the labeled nodes
_EXPECTED = {
    # yelp 45,954 review nodes; 32-d (new .pt) or 100-d (old) features
    "yelp": dict(nodes=45954, feat_dims=(32, 100), fraud=(5000, 8000)),
    # amazon 11,944 users x 25-d; ids < 3305 unlabeled
    "amazon": dict(nodes=11944, feat_dims=(25,), fraud=(500, 1500)),
    # amazon_new: duplicate-feature rows dropped -> 9,840 x 25-d
    "amazon_new": dict(nodes=9840, feat_dims=(25,), fraud=(500, 1500)),
}


def expected_files(name: str, prefix: str) -> list:
    """The on-disk files the loader will open for ``name``."""
    subdir, fpref, rel_sufs, pt_name = _PICKLED[name]
    base = os.path.join(prefix, subdir)
    sufs = ("homo",) + tuple(s for s in rel_sufs if s != "homo")
    return [os.path.join(base, pt_name)] + [
        os.path.join(base, f"{fpref}_{s}_adjlists.pickle") for s in sufs]


def _check_relation(rel, name: str, checks: list) -> None:
    """Invariants every reference adjacency file holds: ids in range,
    symmetric, a self-loop on every connected node."""
    n = rel.num_nodes
    indptr = rel.indptr.cpu().numpy()
    col = rel.col.cpu().numpy()[: rel.num_edges]
    rows = np.repeat(np.arange(n), np.diff(indptr))

    checks.append((f"{name}: neighbor ids in [0, {n})",
                   bool(len(col) == 0 or (0 <= col.min() and col.max() < n))))
    # symmetry: the (u, v) set equals the (v, u) set (adjacency sets have
    # no parallel edges, so sorted keys compare exactly)
    key_fwd = np.sort(rows.astype(np.int64) * n + col)
    key_bwd = np.sort(col.astype(np.int64) * n + rows)
    checks.append((f"{name}: symmetric adjacency",
                   bool(np.array_equal(key_fwd, key_bwd))))
    has_self = np.zeros(n, bool)
    has_self[col[rows == col]] = True
    deg = np.diff(indptr)
    checks.append((f"{name}: self-loops on all connected nodes",
                   bool(has_self[deg > 0].all())))


def verify_dataset(name: str, prefix: str = "data/"):
    """Returns (ok: bool, report_lines: list[str])."""
    lines, checks = [], []
    if name not in _PICKLED:
        return False, [f"unknown dataset {name!r} "
                       f"(verifiable: {sorted(_PICKLED)})"]

    missing = [p for p in expected_files(name, prefix)
               if not os.path.exists(p)]
    for p in expected_files(name, prefix):
        lines.append(f"  {'MISSING ' if p in missing else 'found   '}{p}")
    if missing:
        lines.append(f"NO-GO: {len(missing)} expected file(s) missing")
        return False, lines

    try:
        g = load_data(name, prefix)
    except Exception as e:  # the report names any loader failure
        lines.append(f"NO-GO: loader raised {type(e).__name__}: {e}")
        return False, lines

    labels = g.labels.cpu().numpy()
    labeled = labels[NUM_UNLABELED.get(name, 0):]
    exp = _EXPECTED.get(name)
    if exp is not None:
        checks.append((f"node count == {exp['nodes']} (got {g.num_nodes})",
                       g.num_nodes == exp["nodes"]))
        checks.append((f"feature dim in {exp['feat_dims']} "
                       f"(got {g.feat_dim})", g.feat_dim in exp["feat_dims"]))
        fraud = int((labeled == 1).sum())
        lo, hi = exp["fraud"]
        checks.append((f"labeled fraud count in [{lo}, {hi}] (got {fraud})",
                       lo <= fraud <= hi))
    checks.append(("labels are binary on the labeled range "
                   f"(classes: {sorted(np.unique(labeled).tolist())})",
                   set(np.unique(labeled).tolist()) <= {0, 1}))
    checks.append(("features are finite",
                   bool(np.isfinite(g.features.cpu().numpy()).all())))

    _check_relation(g.homo, "homo", checks)
    for r, rel in enumerate(g.relations):
        _check_relation(rel, f"relation[{r}]", checks)
        deg = rel.deg.cpu().numpy()
        lines.append(f"  relation[{r}]: {rel.num_edges} edges, "
                     f"deg mean {deg.mean():.1f} max {deg.max()}")

    ok = all(passed for _, passed in checks)
    for desc, passed in checks:
        lines.append(f"  {'ok     ' if passed else 'FAILED '}{desc}")
    lines.append(("GO: dataset verified" if ok
                  else "NO-GO: one or more checks failed"))
    return ok, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_name", required=True)
    ap.add_argument("--data_prefix", default="data/")
    args = ap.parse_args(argv)
    ok, lines = verify_dataset(args.data_name, args.data_prefix)
    print(f"verify {args.data_name} @ {args.data_prefix}")
    print("\n".join(lines))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
