"""Regression evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/regression.py``, copied as
host numpy: per-column MSE, MAE, RMSE, R^2 and Pearson correlation,
accumulated across ``eval(labels, predictions)`` calls. Labels and
predictions may be numpy arrays or tensors on any device; each is
flattened to (N, columns).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.evaluation.classification import _to_np


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None):
        self.n_columns = n_columns
        self._n = 0
        self._sum_err2 = None
        self._sum_abs = None
        self._sum_y = None
        self._sum_y2 = None
        self._sum_p = None
        self._sum_p2 = None
        self._sum_yp = None

    def eval(self, labels, predictions) -> None:
        y = _to_np(labels)
        p = _to_np(predictions)
        y = y.reshape(len(y), -1).astype(np.float64)
        p = p.reshape(y.shape).astype(np.float64)
        if self._sum_err2 is None:
            c = y.shape[1]
            self.n_columns = c
            self._sum_err2 = np.zeros(c)
            self._sum_abs = np.zeros(c)
            self._sum_y = np.zeros(c)
            self._sum_y2 = np.zeros(c)
            self._sum_p = np.zeros(c)
            self._sum_p2 = np.zeros(c)
            self._sum_yp = np.zeros(c)
        e = p - y
        self._n += len(y)
        self._sum_err2 += (e ** 2).sum(0)
        self._sum_abs += np.abs(e).sum(0)
        self._sum_y += y.sum(0)
        self._sum_y2 += (y ** 2).sum(0)
        self._sum_p += p.sum(0)
        self._sum_p2 += (p ** 2).sum(0)
        self._sum_yp += (y * p).sum(0)

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_err2[col] / self._n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs[col] / self._n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self._sum_y2[col] - self._sum_y[col] ** 2 / self._n
        ss_res = self._sum_err2[col]
        return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0

    def pearson_correlation(self, col: int = 0) -> float:
        n = self._n
        cov = self._sum_yp[col] - self._sum_y[col] * self._sum_p[col] / n
        vy = self._sum_y2[col] - self._sum_y[col] ** 2 / n
        vp = self._sum_p2[col] - self._sum_p[col] ** 2 / n
        d = np.sqrt(vy * vp)
        return float(cov / d) if d else 0.0

    def stats(self) -> str:
        cols = range(self.n_columns)
        lines = ["Column    MSE        MAE        RMSE       R^2        PC"]
        for c in cols:
            lines.append(
                f"{c:<8} {self.mean_squared_error(c):<10.5f} "
                f"{self.mean_absolute_error(c):<10.5f} "
                f"{self.root_mean_squared_error(c):<10.5f} "
                f"{self.r_squared(c):<10.5f} "
                f"{self.pearson_correlation(c):<10.5f}")
        return "\n".join(lines)
