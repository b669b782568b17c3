"""Classification evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/classification.py``
(``Evaluation`` :25-147), copied as host numpy: metrics accumulate across
``eval(labels, predictions)`` calls in a confusion matrix on the host
(finalizing metrics is not a device workload). Labels and predictions
may be numpy arrays or tensors on any device (one copy to the host a
call). As in the JAX package, ``eval`` takes predictions of shape
(N, C) only: a sequence model's (B, T, C) outputs are flattened by the
caller.

Not ported yet, each refused by name when made: ``EvaluationBinary``,
``ROC``, ``ROCBinary`` and ``ROCMultiClass`` (ROADMAP queue 1 item 10:
evaluation/).
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


class _Refused:
    """A JAX evaluation class the port has not ported: refused when
    made."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet (ROADMAP queue 1 item "
            f"10: evaluation/)")


class EvaluationBinary(_Refused):
    pass


class ROC(_Refused):
    pass


class ROCBinary(_Refused):
    pass


class ROCMultiClass(_Refused):
    pass
