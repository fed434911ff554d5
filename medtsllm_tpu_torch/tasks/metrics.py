"""Classification metrics in numpy and scipy, as ``sklearn.metrics``
computes them for the tasks (``accuracy_score``, ``precision_score``,
``recall_score``, ``f1_score`` and ``jaccard_score`` with the ``binary``
and ``macro`` averages and ``zero_division=0``, ``roc_auc_score`` on
binary labels), so the port's tasks run where scikit-learn is absent.

Each per-class score is a ratio of confusion counts (tp, predicted
positives, true positives), 0 where its denominator is 0. ``binary``
scores class 1; ``macro`` averages over every label present in either
array. ``roc_auc`` is the Mann-Whitney statistic on ranks with ties
averaged, which equals the area under the ROC curve.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import rankdata


def accuracy(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def _counts(y_true, y_pred, average: str):
    """(tp, predicted, true) per scored label, int64 arrays."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    if average == "binary":
        present = np.union1d(y_true, y_pred)
        if len(present) > 2 or not np.isin(present, (0, 1)).all():
            raise ValueError(f"average='binary' needs labels in {{0, 1}}; got {present}")
        labels = np.array([1])
    elif average == "macro":
        labels = np.union1d(y_true, y_pred)
    else:
        raise ValueError(f"average must be 'binary' or 'macro'; got {average!r}")
    t = y_true[None, :] == labels[:, None]
    p = y_pred[None, :] == labels[:, None]
    return (t & p).sum(axis=1), p.sum(axis=1), t.sum(axis=1)


def _divide(num, den) -> np.ndarray:
    num, den = np.asarray(num, dtype=np.float64), np.asarray(den, dtype=np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def precision(y_true, y_pred, average: str = "binary") -> float:
    tp, pred, _ = _counts(y_true, y_pred, average)
    return float(np.mean(_divide(tp, pred)))


def recall(y_true, y_pred, average: str = "binary") -> float:
    tp, _, true = _counts(y_true, y_pred, average)
    return float(np.mean(_divide(tp, true)))


def f1(y_true, y_pred, average: str = "binary") -> float:
    tp, pred, true = _counts(y_true, y_pred, average)
    return float(np.mean(_divide(2.0 * tp, true + pred)))


def jaccard(y_true, y_pred, average: str = "binary") -> float:
    tp, pred, true = _counts(y_true, y_pred, average)
    return float(np.mean(_divide(tp, true + pred - tp)))


def roc_auc(y_true, scores) -> float:
    """Binary labels, continuous scores; both classes must be present."""
    y = np.asarray(y_true).ravel() == 1
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes in y_true")
    ranks = rankdata(np.asarray(scores, dtype=np.float64).ravel())
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))
