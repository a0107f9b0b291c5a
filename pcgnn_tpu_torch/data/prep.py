"""Dataset preparation: splits, normalization, class partitioning.

Counterpart of ``pcgnn_tpu/data/prep.py`` in numpy alone.  The JAX package
splits with scikit-learn's ``train_test_split(stratify=...)``;
``stratified_splits`` reproduces that computation call by call (class counts
through the approximate multivariate-hypergeometric mode, then per-class
``RandomState`` permutations), so a seed gives the same split without
scikit-learn.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def normalize_features(feats: np.ndarray) -> np.ndarray:
    """Row-normalize with the reference's +0.01 smoothing."""
    feats = np.asarray(feats, dtype=np.float64)
    rowsum = feats.sum(axis=1) + 0.01
    r_inv = np.power(rowsum, -1.0)
    r_inv[np.isinf(r_inv)] = 0.0
    return (feats * r_inv[:, None]).astype(np.float32)


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Per-class draw counts summing to ``n_draws``: the floored
    proportional share, plus one for the largest remainders (ties broken
    by ``rng``)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_split(index: np.ndarray, y: np.ndarray, n_train: int,
                      n_test: int, seed: int):
    """One stratified shuffle split of ``index`` into (train, test)."""
    _, y_indices, class_counts = np.unique(y, return_inverse=True,
                                           return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("stratified split: the least populated class has "
                         "fewer than 2 members")
    if min(n_train, n_test) < len(class_counts):
        raise ValueError("stratified split: train and test must each hold "
                         "at least one member of every class")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(class_counts)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return index[rng.permutation(train)], index[rng.permutation(test)]


def stratified_splits(labels: np.ndarray, train_ratio: float,
                      test_ratio: float, seed: int, num_unlabeled: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stratified train/valid/test index split.

    The ``num_unlabeled`` leading node ids are left out of every split.
    ``test_ratio`` is the share of the rest (after the train split) that
    becomes test, as the reference composes two splits.

    Returns (idx_train, idx_valid, idx_test) as int64 arrays.
    """
    labels = np.asarray(labels)
    index = np.arange(num_unlabeled, len(labels))
    y = labels[num_unlabeled:]
    n = len(index)
    n_train = math.floor(train_ratio * n)
    idx_train, idx_rest = _stratified_split(index, y, n_train, n - n_train,
                                            seed)
    y_rest = labels[idx_rest]
    m = len(idx_rest)
    n_test = math.ceil(test_ratio * m)
    idx_valid, idx_test = _stratified_split(idx_rest, y_rest, m - n_test,
                                            n_test, seed)
    return (idx_train.astype(np.int64), idx_valid.astype(np.int64),
            idx_test.astype(np.int64))


def pos_neg_split(idx: np.ndarray, y: np.ndarray):
    """Split node ids by label."""
    idx = np.asarray(idx)
    y = np.asarray(y)
    return idx[y == 1], idx[y == 0]
