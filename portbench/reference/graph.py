"""The reference's graph: every relation's CSR, worked out again from the
raw edge lists, and the splits and pick weights of the PC-GNN protocol.

Semantics stated by the configuration and followed here:

* a relation is the set of its edges made symmetric, with a self-loop on
  every node; a row lists its neighbors in ascending id.  Where the
  configuration states ``directed`` (under ``graph``), the edges are kept
  as drawn, source to target, with the self-loops, each edge once;
* ``k = ceil(threshold * deg)``; the choose step keeps ``keff = deg`` when
  ``deg <= k + 1``, else ``k``; the oversample takes ``floor(k * rho)``;
* the homo graph is the union of the relations, by the same rule
  (``homo``); PC-GNN reads only its degrees (the pick's weights), the GCN
  reference reads it whole (``reference/gcn.py``);
* where the configuration holds bfloat16 stores (``edge_windows`` true,
  ``ewin_dtype`` bfloat16), the selection scores and the window rows'
  sums read the features rounded to bfloat16 (``stored``), except rows
  whose degree exceeds the relation's window cap (about the 99.5th degree
  percentile, ``window_cap``), which read their neighbors exactly; with a
  float32 store or none, everything reads exact float32;
* the splits are scikit-learn's stratified ``train_test_split`` twice
  (train, then the rest into valid and test), with the configuration's
  leading unlabeled ids left out;
* the pick draws ``2 |train positives|`` training nodes with replacement,
  with probability proportional to homo degree over ``|train|`` for a
  benign node and over ``|train positives|`` for a fraud one.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Relation:
    indptr: torch.Tensor      # [N+1] int64
    col: torch.Tensor         # [E] int64, rows ascending
    deg: torch.Tensor         # [N] int64
    keff: torch.Tensor        # [N] int64
    ksample: torch.Tensor     # [N] int64
    dcap: int                 # rows above it read exact features

    def to(self, device) -> "Relation":
        return dataclasses.replace(
            self, indptr=self.indptr.to(device), col=self.col.to(device),
            deg=self.deg.to(device), keff=self.keff.to(device),
            ksample=self.ksample.to(device))


def csr(src: np.ndarray, dst: np.ndarray, n: int, threshold: float,
        device, directed: bool = False) -> Relation:
    """The relation of an edge list: symmetric (or, ``directed``, as
    drawn), self-loops, each edge once, rows ascending; its keep counts
    and window cap."""
    s = torch.as_tensor(np.asarray(src, np.int64), device=device)
    d = torch.as_tensor(np.asarray(dst, np.int64), device=device)
    loops = torch.arange(n, device=device)
    pairs = [s * n + d] if directed else [s * n + d, d * n + s]
    del s, d
    key = torch.unique(torch.cat(pairs + [loops * n + loops]))
    del pairs
    col = key % n
    deg = torch.bincount(key // n, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(deg, 0)
    k = torch.ceil(threshold * deg.double()).long()
    keff = torch.where(deg <= k + 1, deg, k)
    return Relation(indptr=indptr, col=col, deg=deg, keff=keff, ksample=k,
                    dcap=window_cap(deg.cpu().numpy()))


def window_cap(deg: np.ndarray) -> int:
    """The window cap of a degree sequence: the largest degree when it is
    at most 128 or at most twice the 99.5th percentile rounded up to 16
    (at least 16); else that rounded percentile."""
    dmax = int(deg.max()) if deg.size else 0
    if dmax <= 128:
        return dmax
    cap = -(-max(int(np.percentile(deg, 99.5)), 16) // 16) * 16
    return dmax if dmax <= 2 * cap else cap


def normalize_rows(feats: np.ndarray) -> np.ndarray:
    """Row normalization with +0.01 smoothing, in float64, to float32."""
    feats = np.asarray(feats, dtype=np.float64)
    r_inv = np.power(feats.sum(axis=1) + 0.01, -1.0)
    r_inv[np.isinf(r_inv)] = 0.0
    return (feats * r_inv[:, None]).astype(np.float32)


def _approximate_mode(class_counts, n_draws, rng):
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need = int(n_draws - floored.sum())
    if need > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add = min(len(inds), need)
            inds = rng.choice(inds, size=add, replace=False)
            floored[inds] += 1
            need -= add
            if need == 0:
                break
    return floored.astype(int)


def _stratified(index, y, n_train, n_test, seed):
    _, y_idx, counts = np.unique(y, return_inverse=True, return_counts=True)
    by_class = np.split(np.argsort(y_idx, kind="stable"),
                        np.cumsum(counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(counts, n_train, rng)
    t_i = _approximate_mode(counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(counts)):
        perm = by_class[i].take(rng.permutation(counts[i]), mode="clip")
        train.append(perm[: n_i[i]])
        test.append(perm[n_i[i]: n_i[i] + t_i[i]])
    return (index[rng.permutation(np.concatenate(train))],
            index[rng.permutation(np.concatenate(test))])


def splits(labels: np.ndarray, train_ratio: float, test_ratio: float,
           seed: int, num_unlabeled: int = 0):
    """(train, valid, test) int64 node ids."""
    index = np.arange(num_unlabeled, len(labels))
    n = len(index)
    n_train = math.floor(train_ratio * n)
    train, rest = _stratified(index, labels[num_unlabeled:], n_train,
                              n - n_train, seed)
    m = len(rest)
    n_test = math.ceil(test_ratio * m)
    valid, test = _stratified(rest, labels[rest], m - n_test, n_test, seed)
    return (train.astype(np.int64), valid.astype(np.int64),
            test.astype(np.int64))


@dataclasses.dataclass
class Graph:
    features: torch.Tensor    # [N, F] float32, as the model reads them
    stored: torch.Tensor      # [N, F] what the choose step reads: the
                              # features rounded to bfloat16, or themselves
    labels: torch.Tensor      # [N] int64
    relations: list
    homo_deg: torch.Tensor    # [N] int64
    idx_train: np.ndarray
    idx_valid: np.ndarray
    train_pos: torch.Tensor   # [P] int64, in the train split's order
    # the plan is a permutation of the training nodes (every one once an
    # epoch), not the pick's draws
    permutation = False

    def to(self, device) -> "Graph":
        feats = self.features.to(device)
        stored = (feats if self.stored is self.features
                  else self.stored.to(device))
        return dataclasses.replace(
            self, features=feats, stored=stored,
            labels=self.labels.to(device),
            relations=[r.to(device) for r in self.relations],
            homo_deg=self.homo_deg.to(device),
            train_pos=self.train_pos.to(device))

    def pick_probs(self) -> np.ndarray:
        """[T] float64 pick probabilities of the training nodes."""
        y = self.labels.cpu().numpy()[self.idx_train]
        lf = np.where(y == 1, max(int(y.sum()), 1), len(y))
        w = self.homo_deg.cpu().numpy()[self.idx_train] / lf
        return w / w.sum()

    @property
    def sample_size(self) -> int:
        return max(2 * int(self.train_pos.shape[0]), 1)


def bf16_stores(model_cfg: dict) -> bool:
    """Whether the configuration holds bfloat16 edge-window stores (the
    trainer's defaults: stores on, in bfloat16)."""
    return (bool(model_cfg.get("edge_windows", True))
            and model_cfg.get("ewin_dtype", "bfloat16") == "bfloat16")


def nodes(raw, model_cfg: dict, seed: int, device) -> dict:
    """The node data of the generator's ``raw`` arrays under the
    configuration's model section (``train_ratio``, ``test_ratio``,
    ``num_unlabeled``, ``normalize_features``, ``edge_windows``,
    ``ewin_dtype``): ``Graph``'s fields other than the relations and the
    homo degrees."""
    feats = raw.features
    if model_cfg.get("normalize_features"):
        feats = normalize_rows(feats)
    x = torch.as_tensor(feats, device=device)
    labels = raw.labels
    tr, va, _ = splits(labels, model_cfg["train_ratio"],
                       model_cfg["test_ratio"], seed,
                       int(model_cfg.get("num_unlabeled", 0)))
    stored = (x.to(torch.bfloat16).to(torch.float32)
              if bf16_stores(model_cfg) else x)
    return dict(features=x, stored=stored,
                labels=torch.as_tensor(labels, device=device),
                idx_train=tr, idx_valid=va,
                train_pos=torch.as_tensor(tr[labels[tr] == 1],
                                          device=device))


def homo(raw, device, directed: bool = False) -> Relation:
    """The homo graph: the union of the relations, by the same rule."""
    return csr(np.concatenate(raw.srcs), np.concatenate(raw.dsts),
               raw.num_nodes, 0.5, device, directed)


def build(raw, model_cfg: dict, seed: int, device, *,
          directed: bool = False) -> Graph:
    """The reference graph of the generator's ``raw`` arrays under the
    configuration's model section (``threshold`` and what ``nodes``
    reads), its relations ``directed`` or not."""
    n = raw.num_nodes
    thr = model_cfg.get("threshold", 0.5)
    thr = thr if isinstance(thr, list) else [thr] * len(raw.srcs)
    rels = [csr(s, d, n, float(t), device, directed)
            for s, d, t in zip(raw.srcs, raw.dsts, thr)]
    homo_deg = homo(raw, device, directed).deg
    return Graph(relations=rels, homo_deg=homo_deg,
                 **nodes(raw, model_cfg, seed, device))


def edges_per_epoch(g: Graph) -> float:
    """Expected candidate edges an epoch: each picked node brings its
    degree in every relation."""
    p = g.pick_probs()
    per_pick = sum(float((p * r.deg.cpu().numpy()[g.idx_train]).sum())
                   for r in g.relations)
    return per_pick * g.sample_size
