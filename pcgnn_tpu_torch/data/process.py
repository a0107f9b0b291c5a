"""Offline data preparation: a raw ``Amazon.mat`` / ``YelpChi.mat`` (scipy
``.mat`` with ``features``, ``label`` and the per-relation ``net_*`` sparse
matrices) to the native ``.npz`` graph file.

Counterpart of ``pcgnn_tpu/data/process.py``, writing the same file.
``--dedup`` builds ``amazon_new``: the first ``num_unlabeled`` ids are
marked unlabeled (label 2), duplicate feature rows are dropped, the
relations re-indexed, and labels clipped to 0..2.

Usage:
  python -m pcgnn_tpu_torch.data.process --mat data/Amazon.mat --out data/amazon.npz
  python -m pcgnn_tpu_torch.data.process --mat data/Amazon.mat --dedup \\
      --out data/amazon_new.npz
"""

from __future__ import annotations

import argparse

import numpy as np

from pcgnn_tpu_torch.data.loaders import save_native
from pcgnn_tpu_torch.graph.csr import build_multirel, csr_from_scipy

RELATION_KEYS = {
    "amazon": ["net_upu", "net_usu", "net_uvu"],
    "yelp": ["net_rur", "net_rtr", "net_rsr"],
}


def convert_mat(mat_path: str, out_path: str, *, dataset: str = "amazon",
                dedup: bool = False, num_unlabeled: int = 3305) -> None:
    from scipy.io import loadmat

    m = loadmat(mat_path)
    feats = np.asarray(m["features"].todense()
                       if hasattr(m["features"], "todense")
                       else m["features"], dtype=np.float32)
    labels = np.asarray(m["label"]).flatten().astype(np.int64)
    rels_sp = [m[k] for k in RELATION_KEYS[dataset]]
    homo_sp = m["homo"] if "homo" in m else sum(rels_sp)

    if dedup:
        labels = labels.copy()
        labels[:num_unlabeled] = 2
        _, first_idx = np.unique(feats, axis=0, return_index=True)
        keep = np.zeros(len(feats), dtype=bool)
        keep[first_idx] = True
        feats, labels = feats[keep], labels[keep]
        rels_sp = [r.tocsr()[keep][:, keep] for r in rels_sp]
        homo_sp = homo_sp.tocsr()[keep][:, keep]

    rels = [csr_from_scipy(r) for r in rels_sp]
    homo = csr_from_scipy(homo_sp)
    graph = build_multirel(rels, homo, feats, np.clip(labels, 0, 2))
    save_native(out_path, graph)
    print(f"wrote {out_path}: {graph.num_nodes} nodes, "
          f"{[r.num_edges for r in graph.relations]} relation edges")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mat", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", default="amazon", choices=list(RELATION_KEYS))
    ap.add_argument("--dedup", action="store_true",
                    help="amazon_new-style duplicate-feature-row removal")
    ap.add_argument("--num_unlabeled", type=int, default=3305)
    args = ap.parse_args(argv)
    convert_mat(args.mat, args.out, dataset=args.dataset, dedup=args.dedup,
                num_unlabeled=args.num_unlabeled)


if __name__ == "__main__":
    main()
