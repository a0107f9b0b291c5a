"""Evaluation metrics, in numpy.

Counterpart of ``pcgnn_tpu/train/metrics.py``, which takes the metric
definitions from scikit-learn; here they are written out (binary labels
{0, 1}, positive class 1, zero_division 0; macro averages over the classes
present in labels or predictions; ROC AUC as the trapezoid under the ROC
curve, NaN when one class is absent).  The model forward runs batched on the
trainer's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class EvalResult:
    accuracy: float
    f1: float
    f1_macro: float
    precision: float
    precision_macro: float
    recall: float
    recall_macro: float
    auc: float
    gmean: float
    predictions: np.ndarray        # argmax class per node
    anomaly_confidence: np.ndarray  # prob of class 1
    # decision threshold chosen by the validation F1 sweep; None otherwise
    thresh: Optional[float] = None

    @property
    def line(self) -> str:
        return (f"- F1: {self.f1:.4f}\t- Recall: {self.recall:.4f}"
                f"\t- Precision: {self.precision:.4f}"
                f"\t- Accuracy: {self.accuracy:.4f}\t- AUC-ROC: {self.auc:.4f}"
                f"\t- F1-macro: {self.f1_macro:.4f}"
                f"\t- Recall-macro: {self.recall_macro:.4f}"
                f"\t- AP: {self.precision_macro:.4f}"
                f"\t- GMean: {self.gmean:.4f}\t\n")


def _div(num: float, den: float) -> float:
    return float(num / den) if den else 0.0


def _counts(labels: np.ndarray, preds: np.ndarray, cls: int):
    """(tp, fp, fn) of class ``cls``."""
    t, p = labels == cls, preds == cls
    return (int(np.sum(t & p)), int(np.sum(~t & p)), int(np.sum(t & ~p)))


def precision_recall_f1(labels, preds, cls: int = 1):
    tp, fp, fn = _counts(np.asarray(labels), np.asarray(preds), cls)
    return _div(tp, tp + fp), _div(tp, tp + fn), _div(2 * tp, 2 * tp + fp + fn)


def f1_score(labels, preds, average: str = "binary") -> float:
    if average == "binary":
        return precision_recall_f1(labels, preds)[2]
    return _macro(labels, preds)[2]


def _macro(labels, preds):
    classes = np.union1d(np.unique(labels), np.unique(preds))
    per = np.array([precision_recall_f1(labels, preds, int(c))
                    for c in classes])
    return tuple(float(v) for v in per.mean(axis=0))


def roc_auc_score(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve; NaN when ``labels`` hold one class."""
    y = np.asarray(labels) == 1
    if len(np.unique(y)) != 2:
        return float("nan")
    order = np.argsort(np.asarray(scores), kind="mergesort")[::-1]
    s, y = np.asarray(scores)[order], y[order].astype(np.float64)
    distinct = np.where(np.diff(s))[0]
    thr = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y)[thr]
    fps = 1 + thr - tps
    # drop collinear points, as the reference curve does
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0, fps] / fps[-1]
    tpr = np.r_[0, tps] / tps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def conf_gmean(labels: np.ndarray, preds: np.ndarray) -> float:
    """Geometric mean of the true-positive and true-negative rates."""
    tp, fp, fn = _counts(labels, preds, 1)
    tn = int(np.sum((labels != 1) & (preds != 1)))
    denom = (tp + fn) * (tn + fp)
    return float((tp * tn / denom) ** 0.5) if denom else 0.0


def compute_metrics(labels: np.ndarray, probs: np.ndarray) -> EvalResult:
    """Metrics from class probabilities [M, 2]."""
    labels = np.asarray(labels)
    preds = probs.argmax(axis=1)
    anomaly = probs[:, 1]
    precision, recall, f1 = precision_recall_f1(labels, preds)
    precision_m, recall_m, f1_m = _macro(labels, preds)
    return EvalResult(
        accuracy=float(np.mean(labels == preds)), f1=f1, f1_macro=f1_m,
        precision=precision, precision_macro=precision_m, recall=recall,
        recall_macro=recall_m, auc=roc_auc_score(labels, anomaly),
        gmean=conf_gmean(labels, preds), predictions=preds,
        anomaly_confidence=anomaly)


def get_best_f1(labels: np.ndarray, probs: np.ndarray) -> Tuple[float, float]:
    """Sweep 100 thresholds on the anomaly probability for the best F1."""
    labels = np.asarray(labels)
    best_f1, best_thresh = 0.0, 0.0
    for thresh in np.linspace(0.01, 0.99, 100):
        f1 = f1_score(labels, (probs > thresh).astype(np.int64))
        if f1 > best_f1:
            best_f1, best_thresh = f1, thresh
    return best_f1, best_thresh


def evaluate(predict_fn, nodes: np.ndarray, labels: np.ndarray,
             batch_size: int, *, result=None, epoch: Optional[int] = None,
             epoch_best: Optional[int] = None, flag: Optional[str] = None,
             print_line: bool = True, valid_thresh: Optional[float] = None,
             sweep_thresh: bool = False) -> EvalResult:
    """Batched evaluation.

    ``predict_fn(batch_ids int64 tensor [B]) -> probs [B, 2]`` (on any
    device); the last batch is padded with node 0 and trimmed.
    ``valid_thresh`` recomputes F1 and F1-macro at that threshold;
    ``sweep_thresh`` takes the best of a 100-threshold F1 sweep instead and
    records the winning threshold in ``thresh``.
    """
    nodes = np.asarray(nodes)
    m = len(nodes)
    probs = np.empty((m, 2), dtype=np.float32)
    for start in range(0, m, batch_size):
        end = min(start + batch_size, m)
        batch = np.zeros(batch_size, np.int64)
        batch[: end - start] = nodes[start:end]
        out = predict_fn(torch.from_numpy(batch))
        probs[start:end] = out[: end - start].detach().cpu().numpy()

    res = compute_metrics(labels, probs)
    if sweep_thresh:
        res.f1, res.thresh = get_best_f1(labels, probs[:, 1])
        preds = (probs[:, 1] > res.thresh).astype(np.int64)
        res.f1_macro = f1_score(labels, preds, average="macro")
        res.predictions = preds
    elif valid_thresh is not None:
        preds = (probs[:, 1] > valid_thresh).astype(np.int64)
        res.f1 = f1_score(labels, preds)
        res.f1_macro = f1_score(labels, preds, average="macro")
        res.predictions = preds

    if result is not None:
        if flag == "val":
            result.write_val_log(epoch, epoch_best, res, print_line)
        elif flag == "test":
            result.write_test_log(epoch_best, res, print_line)
    return res
