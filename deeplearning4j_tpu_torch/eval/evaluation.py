"""Classification evaluation: accuracy/precision/recall/F1/confusion matrix,
top-N accuracy, FPR/FNR/false-alarm rate, label-named stats report.

Counterpart of `deeplearning4j_tpu/eval/evaluation.py` (reference
`deeplearning4j-nn/.../eval/Evaluation.java:46`), a copy with the same
numbers: accumulation is host numpy; labels, predictions and masks may
also be torch tensors (on the card they are read back once per call), and
the model forward that makes the predictions runs on the network's
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


def to_host(a):
    """A numpy view of `a`: torch tensors are read back to the host
    (detached, bf16 widened to f32, which numpy lacks)."""
    if a is None or not hasattr(a, "detach"):
        return a
    a = a.detach()
    if a.dtype.is_floating_point and a.element_size() < 4:
        a = a.float()
    return a.cpu().numpy()


@dataclass
class Prediction:
    """One example's (actual, predicted) record for error analysis
    (reference `eval/meta/Prediction.java` — used by
    `Evaluation.getPredictionErrors()` etc.)."""

    actual: int
    predicted: int
    example_index: int


class Evaluation:
    """`top_n > 1` additionally tracks top-N accuracy (reference
    `Evaluation(int topN)` constructor + `topNAccuracy():674`)."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None,
                 record_meta: bool = False,
                 top_n: int = 1):
        self.num_classes = num_classes or (len(labels) if labels else None)
        self.label_names = labels
        self.record_meta = record_meta
        self.top_n = int(top_n)
        self._top_n_correct = 0
        self._top_n_total = 0
        self._predictions: List[Prediction] = []
        self._examples_seen = 0
        self._confusion: Optional[np.ndarray] = None  # [actual, predicted]

    # ------------------------------------------------------------------ acc
    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None, network=None) -> None:
        """Accumulate a batch. labels/predictions: (N, C) one-hot/probs, or
        (B, T, C) time series (flattened with mask), or (N, 1)/(N,) binary
        probabilities (thresholded at 0.5, two-class confusion — reference
        `eval`'s single-output branch).

        With `network=`, the second argument is the network INPUT and the
        predictions are computed by the network's test-mode forward
        (reference `eval(labels, input, network)` conveniences :160-176)."""
        if network is not None:
            out = network.output(predictions, train=False)
            # ComputationGraph returns one array per network output
            predictions = out[0] if isinstance(out, (list, tuple)) else out
        labels = np.asarray(to_host(labels))
        predictions = np.asarray(to_host(predictions))
        mask = to_host(mask)
        # binary single-output-column case: p(class 1) thresholded at 0.5;
        # expansion keeps leading dims so (B, T, 1) sequences flow into the
        # ndim==3 flatten-with-mask path below
        if predictions.ndim == 1:
            predictions = predictions.reshape(-1, 1)
        if predictions.shape[-1] == 1:
            p1 = predictions.astype(np.float64)
            predictions = np.concatenate([1.0 - p1, p1], axis=-1)
            if labels.ndim == predictions.ndim - 1:
                labels = labels[..., None]
            if labels.shape[-1] == 1:
                l1 = labels > 0.5
                labels = np.concatenate([~l1, l1], axis=-1).astype(np.float64)
            if self.num_classes is None:
                self.num_classes = 2
        # sparse labels: integer class ids shaped predictions.shape[:-1]
        sparse = (labels.ndim == predictions.ndim - 1
                  and np.issubdtype(labels.dtype, np.integer))
        if predictions.ndim == 3:
            B, T, C = predictions.shape
            labels = (labels.reshape(B * T) if sparse
                      else labels.reshape(B * T, C))
            predictions = predictions.reshape(B * T, C)
            if mask is not None:
                mask = np.asarray(mask).reshape(B * T)
        if self.num_classes is None:
            self.num_classes = predictions.shape[-1]
        if self._confusion is None:
            self._confusion = np.zeros((self.num_classes, self.num_classes), np.int64)
        actual = labels if sparse else np.argmax(labels, axis=-1)
        pred = np.argmax(predictions, axis=-1)
        total = actual.shape[0]  # PRE-mask flattened positions
        if mask is not None:
            keep_idx = np.where(np.asarray(mask).astype(bool).reshape(-1))[0]
            actual, pred = actual[keep_idx], pred[keep_idx]
        else:
            keep_idx = np.arange(total)
        # sparse id range check AFTER mask filtering (sentinel ids on
        # masked-out positions are fine); without it, np.add.at would
        # silently wrap negatives into the last confusion row
        if sparse:
            from deeplearning4j_tpu_torch.ops.losses import check_sparse_label_range

            check_sparse_label_range(actual, self.num_classes,
                                     where="evaluation")
        np.add.at(self._confusion, (actual, pred), 1)
        if self.top_n > 1 and predictions.shape[-1] > 1:
            kept_probs = predictions[keep_idx]
            true_prob = kept_probs[np.arange(len(actual)), actual]
            # correct iff fewer than top_n entries are STRICTLY greater
            # than the true class's probability (reference `eval:295-305`)
            n_greater = (kept_probs > true_prob[:, None]).sum(axis=-1)
            self._top_n_correct += int((n_greater < self.top_n).sum())
            self._top_n_total += len(actual)
        if self.record_meta:
            # example_index counts pre-mask flattened positions (row, or
            # b*T + t for sequences), so it maps back to the evaluated data
            # even when masked timesteps were skipped
            base = self._examples_seen
            self._predictions.extend(
                Prediction(int(a), int(p), base + int(k))
                for a, p, k in zip(actual, pred, keep_idx))
        self._examples_seen += total

    def merge(self, other: "Evaluation") -> None:
        """Accumulate another Evaluation's state into this one (reference
        `Evaluation.merge` — how distributed evaluation combines
        per-worker results)."""
        if other._confusion is None:
            return
        untouched = self._confusion is None and self._top_n_total == 0
        if other.top_n != self.top_n:
            if untouched and self.top_n == 1:
                self.top_n = other.top_n  # fresh aggregator adopts source's
            else:
                raise ValueError(f"cannot merge: top_n {self.top_n} vs "
                                 f"{other.top_n}")
        if self.label_names is None:
            self.label_names = other.label_names
        if self._confusion is None:
            self.num_classes = other.num_classes
            self._confusion = other._confusion.copy()
        else:
            if self.num_classes != other.num_classes:
                raise ValueError(
                    f"cannot merge: {self.num_classes} vs "
                    f"{other.num_classes} classes")
            self._confusion += other._confusion
        self._top_n_correct += other._top_n_correct
        self._top_n_total += other._top_n_total
        if self.record_meta and other.record_meta:
            base = self._examples_seen
            self._predictions.extend(
                Prediction(p.actual, p.predicted, base + p.example_index)
                for p in other._predictions)
        self._examples_seen += other._examples_seen

    # ----------------------------------------------------- prediction meta
    def _require_meta(self) -> None:
        if not self.record_meta:
            raise ValueError("construct Evaluation(record_meta=True) to "
                             "record per-example predictions")

    def get_prediction_errors(self) -> List[Prediction]:
        """Misclassified examples (reference
        `Evaluation.getPredictionErrors()`)."""
        self._require_meta()
        return [p for p in self._predictions if p.actual != p.predicted]

    def get_predictions_by_actual_class(self, cls: int) -> List[Prediction]:
        self._require_meta()
        return [p for p in self._predictions if p.actual == cls]

    def get_predictions_by_predicted_class(self, cls: int) -> List[Prediction]:
        self._require_meta()
        return [p for p in self._predictions if p.predicted == cls]

    # -------------------------------------------------------------- counts
    @property
    def confusion_matrix(self) -> np.ndarray:
        return self._confusion if self._confusion is not None else np.zeros((0, 0))

    def true_positives(self, cls: int) -> int:
        return int(self._confusion[cls, cls])

    def false_positives(self, cls: int) -> int:
        return int(self._confusion[:, cls].sum() - self._confusion[cls, cls])

    def false_negatives(self, cls: int) -> int:
        return int(self._confusion[cls, :].sum() - self._confusion[cls, cls])

    def true_negatives(self, cls: int) -> int:
        """Examples neither labeled nor predicted as `cls` (reference
        `trueNegatives` counter semantics)."""
        c = self._confusion
        return int(c.sum() - c[cls, :].sum() - c[:, cls].sum() + c[cls, cls])

    def class_label(self, cls: int) -> str:
        if self.label_names is not None and cls < len(self.label_names):
            return self.label_names[cls]
        return str(cls)

    # -------------------------------------------------------------- metrics
    def accuracy(self) -> float:
        if self._confusion is None:
            return 0.0
        c = self._confusion
        total = c.sum()
        return float(np.trace(c)) / total if total else 0.0

    def top_n_accuracy(self) -> float:
        """Fraction of examples whose true class was among the top-N
        predicted probabilities (reference `topNAccuracy():674`; equals
        `accuracy()` for top_n=1)."""
        if self.top_n <= 1:
            return self.accuracy()
        if self._top_n_total == 0:
            return 0.0
        return self._top_n_correct / self._top_n_total

    def _avg_excluding_edge(self, per_class) -> float:
        """Macro-average of a per-class metric, excluding classes whose
        metric is undefined (0/0 — reference's `-1` edge-case sentinel
        exclusion in `precision()`/`recall()`/`falsePositiveRate()`)."""
        vals = [per_class(i) for i in range(self.num_classes)]
        vals = [v for v in vals if v is not None]
        return float(np.mean(vals)) if vals else 0.0

    def precision(self, cls: Optional[int] = None, edge: float = 0.0) -> float:
        if self._confusion is None:
            return 0.0
        if cls is not None:
            tp, fp = self.true_positives(cls), self.false_positives(cls)
            return tp / (tp + fp) if (tp + fp) else edge
        return self._avg_excluding_edge(
            lambda i: self.precision(i) if (self.true_positives(i)
                                            + self.false_positives(i)) else None)

    def recall(self, cls: Optional[int] = None, edge: float = 0.0) -> float:
        if self._confusion is None:
            return 0.0
        if cls is not None:
            tp, fn = self.true_positives(cls), self.false_negatives(cls)
            return tp / (tp + fn) if (tp + fn) else edge
        return self._avg_excluding_edge(
            lambda i: self.recall(i) if (self.true_positives(i)
                                         + self.false_negatives(i)) else None)

    def false_positive_rate(self, cls: Optional[int] = None,
                            edge: float = 0.0) -> float:
        """FP / (FP + TN); class average excludes undefined classes
        (reference `falsePositiveRate:522`)."""
        if self._confusion is None:
            return 0.0
        if cls is not None:
            fp, tn = self.false_positives(cls), self.true_negatives(cls)
            return fp / (fp + tn) if (fp + tn) else edge
        return self._avg_excluding_edge(
            lambda i: self.false_positive_rate(i)
            if (self.false_positives(i) + self.true_negatives(i)) else None)

    def false_negative_rate(self, cls: Optional[int] = None,
                            edge: float = 0.0) -> float:
        """FN / (FN + TP) (reference `falseNegativeRate:560`)."""
        if self._confusion is None:
            return 0.0
        if cls is not None:
            fn, tp = self.false_negatives(cls), self.true_positives(cls)
            return fn / (fn + tp) if (fn + tp) else edge
        return self._avg_excluding_edge(
            lambda i: self.false_negative_rate(i)
            if (self.false_negatives(i) + self.true_positives(i)) else None)

    def false_alarm_rate(self) -> float:
        """(FPR + FNR) / 2 (reference `falseAlarmRate():619`)."""
        return (self.false_positive_rate() + self.false_negative_rate()) / 2.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    # --------------------------------------------------------------- report
    def stats(self, suppress_warnings: bool = False) -> str:
        """Multi-line classification report: label-named confusion lines,
        excluded-class warnings, and the scores block (reference
        `stats():352-408`)."""
        if self._confusion is None:
            return "Evaluation: no examples seen"
        lines: List[str] = []
        warnings: List[str] = []
        for a in range(self.num_classes):
            for p in range(self.num_classes):
                count = int(self._confusion[a, p])
                if count:
                    lines.append(
                        f"Examples labeled as {self.class_label(a)} "
                        f"classified by model as {self.class_label(p)}: "
                        f"{count} times")
            if not suppress_warnings and self.true_positives(a) == 0:
                if self.false_positives(a) == 0:
                    warnings.append(
                        f"Warning: class {self.class_label(a)} was never "
                        "predicted by the model. This class was excluded "
                        "from the average precision")
                if self.false_negatives(a) == 0:
                    warnings.append(
                        f"Warning: class {self.class_label(a)} has never "
                        "appeared as a true label. This class was excluded "
                        "from the average recall")
        lines.append("")
        lines.extend(warnings)
        lines += [
            "==========================Scores========================================",
            f" Accuracy:  {self.accuracy():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top {self.top_n} Accuracy:  "
                         f"{self.top_n_accuracy():.4f}")
        lines += [
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "========================================================================",
        ]
        return "\n".join(lines)
