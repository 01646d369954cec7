"""Classification metrics (copy of ``endoscopy_tpu/eval/metrics.py``).

Micro and macro precision, recall and F1 and a per-class sensitivity /
specificity table, with sklearn's semantics at ``zero_division=0``, from
the full validation prediction dump on the host.

One difference: pandas is not a dependency of the port, so
``calculate_metrics(...)["sen/spec"]`` is a dict of the JAX package's
DataFrame's three columns, ``{"class", "sensitivity", "specificity"}``,
each a numpy array, not a DataFrame (``pandas.DataFrame(d)`` gives the
same table back).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def confusion_matrix(target: np.ndarray, pred: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """num_classes x num_classes matrix, rows = actual, cols = predicted."""
    target = np.asarray(target, dtype=np.int64)
    pred = np.asarray(pred, dtype=np.int64)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (target, pred), 1)
    return cm


def _per_class_counts(cm: np.ndarray):
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0).astype(np.float64) - tp
    fn = cm.sum(axis=1).astype(np.float64) - tp
    tn = cm.sum().astype(np.float64) - tp - fp - fn
    return tp, fp, fn, tn


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    out = np.zeros_like(num, dtype=np.float64)
    nz = den > 0
    out[nz] = num[nz] / den[nz]
    return out


def precision_score(target, pred, num_classes: int,
                    average: str = "macro") -> float:
    cm = confusion_matrix(target, pred, num_classes)
    tp, fp, fn, _ = _per_class_counts(cm)
    if average == "micro":
        return float(_safe_div(tp.sum(keepdims=True),
                               (tp + fp).sum(keepdims=True))[0])
    return float(_safe_div(tp, tp + fp).mean())


def recall_score(target, pred, num_classes: int,
                 average: str = "macro") -> float:
    cm = confusion_matrix(target, pred, num_classes)
    tp, _, fn, _ = _per_class_counts(cm)
    if average == "micro":
        return float(_safe_div(tp.sum(keepdims=True),
                               (tp + fn).sum(keepdims=True))[0])
    return float(_safe_div(tp, tp + fn).mean())


def f1_score(target, pred, num_classes: int, average: str = "macro") -> float:
    cm = confusion_matrix(target, pred, num_classes)
    tp, fp, fn, _ = _per_class_counts(cm)
    if average == "micro":
        p = _safe_div(tp.sum(keepdims=True), (tp + fp).sum(keepdims=True))
        r = _safe_div(tp.sum(keepdims=True), (tp + fn).sum(keepdims=True))
        return float(_safe_div(2 * p * r, p + r)[0])
    p = _safe_div(tp, tp + fp)
    r = _safe_div(tp, tp + fn)
    return float(_safe_div(2 * p * r, p + r).mean())


def sensitivity_specificity(target, pred, num_classes: int
                            ) -> Dict[str, np.ndarray]:
    """Per-class sensitivity (recall of the one-vs-rest positive class) and
    specificity (recall of the negative class), as columns."""
    cm = confusion_matrix(target, pred, num_classes)
    tp, fp, fn, tn = _per_class_counts(cm)
    return {"class": np.arange(num_classes),
            "sensitivity": _safe_div(tp, tp + fn),
            "specificity": _safe_div(tn, tn + fp)}


def calculate_metrics(pred, target, config=None,
                      num_classes: Optional[int] = None) -> Dict:
    """The metric dict, with the JAX package's keys."""
    if num_classes is None:
        num_classes = int(config.MODEL.NUM_CLASSES)
    kw = dict(num_classes=num_classes)
    return {
        "micro/precision": precision_score(target, pred, average="micro", **kw),
        "micro/recall": recall_score(target, pred, average="micro", **kw),
        "micro/f1": f1_score(target, pred, average="micro", **kw),
        "macro/precision": precision_score(target, pred, average="macro", **kw),
        "macro/recall": recall_score(target, pred, average="macro", **kw),
        "macro/f1": f1_score(target, pred, average="macro", **kw),
        "sen/spec": sensitivity_specificity(target, pred, num_classes),
    }
