"""Classification evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/classification.py``
(``Evaluation`` :25-147 and the binary and ROC classes :148-275),
copied as host numpy: metrics accumulate across
``eval(labels, predictions)`` calls in a confusion matrix on the host
(finalizing metrics is not a device workload). Labels and predictions
may be numpy arrays or tensors on any device (one copy to the host a
call). As in the JAX package, ``eval`` takes predictions of shape
(N, C) only: a sequence model's (B, T, C) outputs are flattened by the
caller.

``EvaluationBinary``, ``ROC``, ``ROCBinary`` and ``ROCMultiClass`` (JAX
:148-275) are copied the same way: per-output counts at a threshold, and
exact-threshold ROC curves, AUC and AUPRC over every score seen.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _to_np(a):
    """A host numpy copy of an array or a tensor."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        return (a.float() if a.dtype.is_floating_point and a.itemsize < 4
                else a).numpy()
    return np.asarray(a)


class Evaluation:
    """Multi-class evaluation (JAX ``evaluation/classification.py:25-147``;
    reference: classification/Evaluation.java:57)."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = labels
        self.top_n = top_n
        self._conf: Optional[np.ndarray] = None   # [actual, predicted]
        self._top_n_correct = 0
        self._count = 0

    # ------------------------------------------------------------------
    def eval(self, labels, predictions) -> None:
        """Accumulate a batch. labels: one-hot or class indices;
        predictions: probabilities/scores (N, C)."""
        y = _to_np(labels)
        p = _to_np(predictions)
        if p.ndim != 2:
            raise ValueError(f"predictions must be (N, C), got {p.shape}")
        n_classes = p.shape[1]
        if self.num_classes is None:
            self.num_classes = n_classes
        if self._conf is None:
            self._conf = np.zeros((self.num_classes, self.num_classes),
                                  np.int64)
        y_idx = y.argmax(-1) if y.ndim == 2 else y.astype(int)
        p_idx = p.argmax(-1)
        np.add.at(self._conf, (y_idx, p_idx), 1)
        self._count += len(y_idx)
        if self.top_n > 1:
            top = np.argsort(-p, axis=-1)[:, :self.top_n]
            self._top_n_correct += int((top == y_idx[:, None]).any(-1).sum())
        else:
            self._top_n_correct += int((p_idx == y_idx).sum())

    # ------------------------------------------------------------------
    def _require(self):
        if self._conf is None:
            raise ValueError("no data evaluated yet")

    def confusion_matrix(self) -> np.ndarray:
        self._require()
        return self._conf.copy()

    def accuracy(self) -> float:
        self._require()
        return float(np.trace(self._conf)) / max(self._count, 1)

    def top_n_accuracy(self) -> float:
        self._require()
        return self._top_n_correct / max(self._count, 1)

    def true_positives(self, c: int) -> int:
        return int(self._conf[c, c])

    def false_positives(self, c: int) -> int:
        return int(self._conf[:, c].sum() - self._conf[c, c])

    def false_negatives(self, c: int) -> int:
        return int(self._conf[c, :].sum() - self._conf[c, c])

    def precision(self, c: Optional[int] = None) -> float:
        """Per-class, or macro-average over classes seen (reference
        default: macro, excluding classes with 0 predictions+labels)."""
        self._require()
        if c is not None:
            denom = self._conf[:, c].sum()
            return float(self._conf[c, c] / denom) if denom else 0.0
        vals = [self.precision(i) for i in range(self.num_classes)
                if self._conf[:, i].sum() + self._conf[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, c: Optional[int] = None) -> float:
        self._require()
        if c is not None:
            denom = self._conf[c, :].sum()
            return float(self._conf[c, c] / denom) if denom else 0.0
        vals = [self.recall(i) for i in range(self.num_classes)
                if self._conf[:, i].sum() + self._conf[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, c: Optional[int] = None) -> float:
        if c is not None:
            p, r = self.precision(c), self.recall(c)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        vals = [self.f1(i) for i in range(self.num_classes)
                if self._conf[:, i].sum() + self._conf[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def matthews_correlation(self) -> float:
        """Multi-class MCC (reference: Evaluation.matthewsCorrelation)."""
        self._require()
        c = self._conf.astype(np.float64)
        t = c.sum(1)          # actual counts
        p = c.sum(0)          # predicted counts
        n = c.sum()
        cov_tp = np.trace(c) * n - t @ p
        denom = np.sqrt(n * n - p @ p) * np.sqrt(n * n - t @ t)
        return float(cov_tp / denom) if denom else 0.0

    def stats(self) -> str:
        self._require()
        names = self.label_names or [str(i) for i in range(self.num_classes)]
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.num_classes}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: "
                         f"{self.top_n_accuracy():.4f}")
        lines.append("\n=========================Confusion Matrix=========================")
        header = "     " + " ".join(f"{n:>5}" for n in names)
        lines.append(header)
        for i, row in enumerate(self._conf):
            lines.append(f"{names[i]:>4} " + " ".join(f"{v:>5}" for v in row))
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output binary metrics at threshold 0.5 (reference:
    classification/EvaluationBinary.java)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._tp = self._fp = self._tn = self._fn = None

    def eval(self, labels, predictions) -> None:
        y = _to_np(labels)
        p = (_to_np(predictions) >= self.threshold)
        y = y.reshape(y.shape[0], -1).astype(bool)
        p = p.reshape(p.shape[0], -1)
        if self._tp is None:
            n_out = y.shape[1]
            self._tp = np.zeros(n_out, np.int64)
            self._fp = np.zeros(n_out, np.int64)
            self._tn = np.zeros(n_out, np.int64)
            self._fn = np.zeros(n_out, np.int64)
        self._tp += (p & y).sum(0)
        self._fp += (p & ~y).sum(0)
        self._tn += (~p & ~y).sum(0)
        self._fn += (~p & y).sum(0)

    def accuracy(self, i: int = 0) -> float:
        tot = self._tp[i] + self._fp[i] + self._tn[i] + self._fn[i]
        return float((self._tp[i] + self._tn[i]) / tot) if tot else 0.0

    def precision(self, i: int = 0) -> float:
        d = self._tp[i] + self._fp[i]
        return float(self._tp[i] / d) if d else 0.0

    def recall(self, i: int = 0) -> float:
        d = self._tp[i] + self._fn[i]
        return float(self._tp[i] / d) if d else 0.0

    def f1(self, i: int = 0) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0


class ROC:
    """Binary ROC/AUC with exact thresholding (reference:
    classification/ROC.java; thresholdSteps=0 → exact mode)."""

    def __init__(self):
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions) -> None:
        y = _to_np(labels)
        p = _to_np(predictions)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
            y = y[:, 1] if y.ndim == 2 else y
        self._scores.append(p.reshape(-1))
        self._labels.append(y.reshape(-1))

    def _collect(self):
        if not self._scores:
            raise ValueError("no data evaluated yet")
        return np.concatenate(self._scores), np.concatenate(self._labels)

    def roc_curve(self):
        """(fpr, tpr, thresholds) sorted by descending threshold."""
        s, y = self._collect()
        order = np.argsort(-s)
        y = y[order].astype(bool)
        tps = np.cumsum(y)
        fps = np.cumsum(~y)
        tpr = tps / max(y.sum(), 1)
        fpr = fps / max((~y).sum(), 1)
        return (np.concatenate([[0.0], fpr]), np.concatenate([[0.0], tpr]),
                np.concatenate([[np.inf], s[order]]))

    def auc(self) -> float:
        fpr, tpr, _ = self.roc_curve()
        return float(np.trapezoid(tpr, fpr))

    def auprc(self) -> float:
        s, y = self._collect()
        order = np.argsort(-s)
        y = y[order].astype(bool)
        tps = np.cumsum(y)
        precision = tps / np.arange(1, len(y) + 1)
        recall = tps / max(y.sum(), 1)
        return float(np.trapezoid(precision, recall))


class ROCBinary:
    """Per-output ROC (reference: ROCBinary.java)."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions) -> None:
        y = _to_np(labels).reshape(len(_to_np(labels)), -1)
        p = _to_np(predictions).reshape(y.shape)
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(y.shape[1])]
        for i, roc in enumerate(self._rocs):
            roc.eval(y[:, i], p[:, i])

    def auc(self, i: int = 0) -> float:
        return self._rocs[i].auc()


class ROCMultiClass:
    """One-vs-all ROC per class (reference: ROCMultiClass.java)."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions) -> None:
        y = _to_np(labels)
        p = _to_np(predictions)
        if y.ndim != 2:
            y = np.eye(p.shape[1])[y.astype(int)]
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(p.shape[1])]
        for c, roc in enumerate(self._rocs):
            roc.eval(y[:, c], p[:, c])

    def auc(self, c: int = 0) -> float:
        return self._rocs[c].auc()

    def average_auc(self) -> float:
        return float(np.mean([r.auc() for r in self._rocs]))
