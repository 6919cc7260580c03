"""Regression evaluation (reference `eval/RegressionEvaluation.java`):
per-column MSE / MAE / RMSE / RSE / correlation / R2."""
from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import to_host


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self.n_columns = n_columns
        self._sum_sq_err = None
        self._sum_abs_err = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_pred_sq = None
        self._sum_label_pred = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None) -> None:
        labels = np.asarray(to_host(labels), np.float64)
        predictions = np.asarray(to_host(predictions), np.float64)
        mask = to_host(mask)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                keep = np.asarray(mask).astype(bool).reshape(-1)
                labels, predictions = labels[keep], predictions[keep]
        if self._sum_sq_err is None:
            self.n_columns = labels.shape[-1]
            z = lambda: np.zeros(self.n_columns)
            self._sum_sq_err, self._sum_abs_err = z(), z()
            self._sum_label, self._sum_label_sq = z(), z()
            self._sum_pred, self._sum_pred_sq, self._sum_label_pred = z(), z(), z()
        err = predictions - labels
        self._sum_sq_err += (err**2).sum(0)
        self._sum_abs_err += np.abs(err).sum(0)
        self._sum_label += labels.sum(0)
        self._sum_label_sq += (labels**2).sum(0)
        self._sum_pred += predictions.sum(0)
        self._sum_pred_sq += (predictions**2).sum(0)
        self._sum_label_pred += (labels * predictions).sum(0)
        self.n += labels.shape[0]

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_sq_err[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs_err[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self._sum_sq_err[col] / self.n))

    def relative_squared_error(self, col: int = 0) -> float:
        """RSE = Σ(pred - label)² / Σ(label - mean_label)² (reference
        `RegressionEvaluation.relativeSquaredError`)."""
        n = self.n
        denom = self._sum_label_sq[col] - self._sum_label[col] ** 2 / n
        return float(self._sum_sq_err[col] / max(denom, 1e-12))

    def correlation_r2(self, col: int = 0) -> float:
        n = self.n
        sx, sy = self._sum_label[col], self._sum_pred[col]
        sxx, syy = self._sum_label_sq[col], self._sum_pred_sq[col]
        sxy = self._sum_label_pred[col]
        num = n * sxy - sx * sy
        den = np.sqrt(max(n * sxx - sx**2, 1e-12)) * np.sqrt(max(n * syy - sy**2, 1e-12))
        r = num / den
        return float(r * r)

    def stats(self) -> str:
        cols = range(self.n_columns or 0)
        lines = ["Column    MSE            MAE            RMSE           R^2"]
        for c in cols:
            lines.append(f"{c:<9} {self.mean_squared_error(c):<14.6f} "
                         f"{self.mean_absolute_error(c):<14.6f} "
                         f"{self.root_mean_squared_error(c):<14.6f} "
                         f"{self.correlation_r2(c):<14.6f}")
        return "\n".join(lines)
