"""Evaluation metrics shared by the XGBoost and zero-shot-eval CLIs.

Counterpart of ``plantcaduceus_tpu.downstream.metrics``, numpy only: the
JAX package calls ``sklearn.metrics`` and ``scipy.stats``, which the GPU
hosts do not carry, so their definitions are computed here in the same
order of operations:

* the reference's metric sets: classification accuracy/F1/AUROC/AP
  (src/lora_fine_tune.py:517-530), regression MSE/RMSE/MAE/R2/Pearson/
  Spearman (:533-551), micro-averaged multilabel (:554-563), and the ROC
  and PR curves of src/train_XGBoost.py:126-132;
* ``roc_curve`` keeps only the corners of the curve (sklearn's
  ``drop_intermediate=True``) and starts at (0, 0) with threshold ``inf``;
  ``precision_recall_curve`` keeps every threshold and ends at precision 1,
  recall 0; a tie of scores is one threshold;
* one class absent: the ROC curve's rate of the missing class is nan and
  its area nan, with an ``UndefinedMetricWarning``, as sklearn 1.9 gives
  (its ``roc_auc_score`` too); without positives recall is one at every
  threshold and the average precision 0. Labels other than sklearn's
  binary sets raise ``ValueError`` where sklearn does;
* F1 is 0 where nothing is predicted or labelled positive (sklearn's
  ``zero_division``); the micro averages ravel labels and scores;
* Pearson's r as ``scipy.stats.pearsonr`` forms it, Spearman's as Pearson's
  correlation of average-of-ties ranks (``scipy.stats.rankdata``'s
  default); nan, with a warning, for a constant input.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np


class UndefinedMetricWarning(UserWarning):
    """A metric is undefined for these labels (sklearn's warning of that name)."""


class ConstantInputWarning(RuntimeWarning):
    """A correlation of a constant input (scipy's warning of that name)."""


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    z = x - x.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


# ---------------------------------------------------------------------------
# binary ranking curves
# ---------------------------------------------------------------------------


def _binary_clf_curve(y_true: np.ndarray, scores: np.ndarray):
    """False and true positive counts at each distinct score, from the
    highest down (a tie is one threshold), and those scores: sklearn's
    ``_binary_clf_curve`` with the positive label 1."""
    y = np.asarray(y_true).ravel()
    classes = set(np.unique(y).tolist())
    if not (classes <= {0, 1} or classes <= {-1, 1}):
        raise ValueError(f"y_true takes value in {sorted(classes)} and pos_label is not "
                         "specified: labels must be {0, 1} or {-1, 1}")
    s = np.asarray(scores).ravel()
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order] == 1
    last = np.r_[np.flatnonzero(np.diff(s)), y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[last]
    return 1.0 + last - tps, tps, s[last]


def roc_curve(y_true: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) at the curve's corners, from (0, 0)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, scores)
    if len(fps) > 2:
        keep = np.flatnonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                                    True])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    fps, tps = np.r_[0, fps], np.r_[0, tps]
    thresholds = np.r_[np.inf, thresholds]
    rates = []
    for counts, what in ((fps, "negative"), (tps, "positive")):
        if counts[-1] <= 0:
            warnings.warn(f"No {what} samples in y_true, the {what} rate is undefined",
                          UndefinedMetricWarning, stacklevel=2)
            rates.append(np.repeat(np.nan, counts.shape))
        else:
            rates.append(counts / counts[-1])
    return rates[0], rates[1], thresholds


def precision_recall_curve(y_true: np.ndarray, scores: np.ndarray):
    """(precision, recall, thresholds), recall decreasing, ending at (1, 0)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, scores)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to one for all "
                      "thresholds", UserWarning, stacklevel=2)
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    return np.hstack((precision[::-1], 1)), np.hstack((recall[::-1], 0)), thresholds[::-1]


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoid area under y(x), x monotonic either way (sklearn ``auc``)."""
    dx = np.diff(x)
    direction = 1
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1
    return float(direction * np.sum(dx * (y[1:] + y[:-1]) / 2.0))


def roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Area under ``roc_curve``; nan, with a warning, when a class is absent."""
    fpr, tpr, _ = roc_curve(y_true, scores)
    return auc(fpr, tpr)


def roc_auc_score(y_true: np.ndarray, scores: np.ndarray) -> float:
    """sklearn's binary ``roc_auc_score``: the larger of two labels is the
    positive one; nan, with a warning, for one class; more raise."""
    y = np.asarray(y_true).ravel()
    labels = np.unique(y)
    if len(labels) > 2:
        raise ValueError(f"multiclass labels {labels.tolist()} need a score per class")
    if len(labels) < 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not defined "
                      "in that case.", UndefinedMetricWarning, stacklevel=2)
        return float("nan")
    return roc_auc((y == labels[-1]).astype(np.int64), scores)


def average_precision(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Σ (R_k − R_{k−1}) P_k over the thresholds (sklearn
    ``average_precision_score``, positive label 1; 0 without positives)."""
    labels = np.unique(np.asarray(y_true))
    if len(labels) > 2 or (len(labels) == 2 and 1 not in labels):
        raise ValueError(f"labels {labels.tolist()}: average precision needs binary "
                         "labels with the positive label 1")
    precision, recall, _ = precision_recall_curve(np.asarray(y_true) == 1, scores)
    return float(-np.sum(np.diff(recall) * precision[:-1]))


# ---------------------------------------------------------------------------
# label metrics
# ---------------------------------------------------------------------------


def accuracy(labels: np.ndarray, preds: np.ndarray) -> float:
    """Share of rows predicted exactly (every label of a row, if 2-D)."""
    eq = np.asarray(labels) == np.asarray(preds)
    return float(np.mean(eq if eq.ndim == 1 else eq.all(axis=1)))


def _f1(tp: float, fp: float, fn: float) -> float:
    den = 2 * tp + fp + fn
    return float(2 * tp / den) if den else 0.0


def binary_f1(labels: np.ndarray, preds: np.ndarray) -> float:
    """F1 of the positive label 1 (sklearn ``f1_score``, average='binary')."""
    labels, preds = np.asarray(labels).ravel(), np.asarray(preds).ravel()
    present = np.unique(np.r_[labels, preds])
    if len(present) > 2:
        raise ValueError(f"Target is multiclass ({present.tolist()}) but average='binary'")
    if len(present) == 2 and 1 not in present:
        raise ValueError(f"pos_label=1 is not a valid label. It should be one of "
                         f"{present.tolist()}")
    y, p = labels == 1, preds == 1
    return _f1(np.sum(y & p), np.sum(~y & p), np.sum(y & ~p))


def micro_f1(labels: np.ndarray, preds: np.ndarray) -> float:
    y, p = np.asarray(labels).ravel() == 1, np.asarray(preds).ravel() == 1
    return _f1(np.sum(y & p), np.sum(~y & p), np.sum(y & ~p))


# ---------------------------------------------------------------------------
# correlations
# ---------------------------------------------------------------------------


def _constant(x: np.ndarray) -> bool:
    return bool(np.all(x == x[0]))


def pearson_r(x: np.ndarray, y: np.ndarray) -> float:
    """``scipy.stats.pearsonr(x, y)[0]``: centred, scaled, normalised, dotted."""
    x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
    if x.size != y.size or x.size < 2:
        raise ValueError("x and y must have the same length, at least 2")
    if _constant(x) or _constant(y):
        warnings.warn("An input array is constant; the correlation coefficient is not "
                      "defined.", ConstantInputWarning, stacklevel=2)
        return float("nan")
    xm, ym = x - x.mean(), y - y.mean()
    xmax, ymax = np.abs(xm).max(), np.abs(ym).max()
    normx = xmax * np.linalg.norm(xm / xmax)
    normy = ymax * np.linalg.norm(ym / ymax)
    r = float(np.clip(np.dot(xm / normx, ym / normy), -1.0, 1.0))
    return float(np.round(r)) if x.size == 2 else r


def rank_average(a: np.ndarray) -> np.ndarray:
    """1-based ranks, ties given their mean rank (``scipy.stats.rankdata``)."""
    a = np.asarray(a).ravel()
    sorter = np.argsort(a, kind="mergesort")
    inv = np.empty(sorter.size, np.intp)
    inv[sorter] = np.arange(sorter.size, dtype=np.intp)
    a = a[sorter]
    first = np.r_[True, a[1:] != a[:-1]]
    dense = first.cumsum()[inv]
    count = np.r_[np.flatnonzero(first), len(first)]
    return 0.5 * (count[dense] + count[dense - 1] + 1)


def spearman_r(x: np.ndarray, y: np.ndarray) -> float:
    """``scipy.stats.spearmanr(x, y)[0]``: the correlation of the ranks."""
    x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
    if _constant(x) or _constant(y):
        warnings.warn("An input array is constant; the correlation coefficient is not "
                      "defined.", ConstantInputWarning, stacklevel=2)
        return float("nan")
    return float(np.corrcoef(rank_average(x), rank_average(y))[1, 0])


# ---------------------------------------------------------------------------
# the metric sets
# ---------------------------------------------------------------------------


def classification_metrics(logits: np.ndarray, labels: np.ndarray) -> Dict:
    probs = softmax(logits, axis=1)
    preds = logits.argmax(axis=1)
    scores = probs[:, 1]
    return {
        "accuracy": accuracy(labels, preds),
        "f1": binary_f1(labels, preds),
        "roc_auc": roc_auc_score(labels, scores),
        "average_precision": average_precision(labels, scores),
        "balance": float(np.sum(labels) / len(labels)),
    }


def regression_metrics(predictions: np.ndarray, labels: np.ndarray) -> Dict:
    predictions = np.asarray(predictions).squeeze()
    labels = np.asarray(labels, np.float64)
    mse = float(((predictions - labels) ** 2).mean())
    ss_tot = float(((labels - labels.mean()) ** 2).sum())
    ss_res = float(((labels - predictions) ** 2).sum())
    return {
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mae": float(np.abs(predictions - labels).mean()),
        "r2": float(1 - ss_res / (ss_tot + 1e-8)),
        "pearson_r": pearson_r(predictions, labels),
        "spearman_r": spearman_r(predictions, labels),
    }


def multilabel_metrics(logits: np.ndarray, labels: np.ndarray) -> Dict:
    probs = sigmoid(logits)
    preds = (probs > 0.5).astype(int)
    return {
        "accuracy": accuracy(labels, preds),
        "f1": micro_f1(labels, preds),
        "roc_auc": roc_auc_score(np.asarray(labels).ravel(), probs.ravel()),
        "average_precision": average_precision(np.asarray(labels).ravel(), probs.ravel()),
    }


def binary_curve_metrics(scores: np.ndarray, labels: np.ndarray) -> Dict:
    """ROC/PR curves + AUCs (the XGBoost evaluate_model contract)."""
    fpr, tpr, _ = roc_curve(labels, scores)
    precision, recall, _ = precision_recall_curve(labels, scores)
    return {
        "fpr": fpr, "tpr": tpr,
        "precision": precision, "recall": recall,
        "roc_auc": auc(fpr, tpr),
        "prauc": average_precision(labels, scores),
    }
