"""ROC / AUC, thresholded accumulation.

Reference: `eval/ROC.java` (296 LoC, thresholded counts at K steps) and
`ROCMultiClass.java` — same thresholded design so streaming batches
accumulate O(K) state rather than storing every score.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import to_host


def _dedup_trapezoid(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under (x, y) points after collapsing duplicate x
    values to their max y (best operating point at that x)."""
    best: dict = {}
    for xi, yi in zip(x, y):
        best[float(xi)] = max(best.get(float(xi), 0.0), float(yi))
    xs = np.array(sorted(best))
    ys = np.array([best[xi] for xi in xs])
    return float(abs(np.trapezoid(ys, xs)))


class ROC:
    """Binary ROC. Labels: (N,) {0,1} or (N,2) one-hot; probs likewise."""

    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self.thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
        self._tp = np.zeros(threshold_steps + 1, np.int64)
        self._fp = np.zeros(threshold_steps + 1, np.int64)
        self._pos = 0
        self._neg = 0

    def eval(self, labels: np.ndarray, probs: np.ndarray) -> None:
        labels = np.asarray(to_host(labels))
        probs = np.asarray(to_host(probs))
        if labels.ndim == 2 and labels.shape[1] == 2:
            labels = labels[:, 1]
            probs = probs[:, 1]
        labels = labels.reshape(-1).astype(bool)
        probs = probs.reshape(-1)
        for i, t in enumerate(self.thresholds):
            pred = probs >= t
            self._tp[i] += int(np.sum(pred & labels))
            self._fp[i] += int(np.sum(pred & ~labels))
        self._pos += int(labels.sum())
        self._neg += int((~labels).sum())

    def get_roc_curve(self):
        tpr = self._tp / max(self._pos, 1)
        fpr = self._fp / max(self._neg, 1)
        return fpr, tpr

    def get_precision_recall_curve(self):
        """(thresholds, precision, recall) at each threshold step
        (reference `ROC.getPrecisionRecallCurve` — the repo exposes the
        same thresholded counts as a PR curve alongside the ROC curve).
        Precision at thresholds with zero predicted positives is defined
        as 1.0 (nothing claimed, nothing wrong)."""
        predicted_pos = self._tp + self._fp
        precision = np.where(predicted_pos > 0,
                             self._tp / np.maximum(predicted_pos, 1), 1.0)
        recall = self._tp / max(self._pos, 1)
        return self.thresholds, precision, recall

    def calculate_auc(self) -> float:
        """Trapezoidal AUC keeping the best TPR at each distinct FPR —
        several thresholds can share an FPR (coarse threshold grids on
        well-separated scores), and the curve's value there is the best
        operating point, not whichever threshold sorted last."""
        fpr, tpr = self.get_roc_curve()
        return _dedup_trapezoid(fpr, tpr)

    def calculate_auprc(self) -> float:
        """Area under the precision-recall curve: trapezoidal over the
        thresholded points, recall-ordered, keeping the BEST precision at
        each distinct recall level (several thresholds can share a recall;
        the curve's value there is the best operating point)."""
        _, precision, recall = self.get_precision_recall_curve()
        return _dedup_trapezoid(recall, precision)


class ROCMultiClass:
    """One-vs-all ROC per class (reference `eval/ROCMultiClass.java`)."""

    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self._rocs = {}

    def eval(self, labels: np.ndarray, probs: np.ndarray) -> None:
        labels = np.asarray(to_host(labels))
        probs = np.asarray(to_host(probs))
        for c in range(labels.shape[-1]):
            self._rocs.setdefault(c, ROC(self.steps)).eval(labels[:, c], probs[:, c])

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs.values()]))
