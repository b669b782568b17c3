"""Calibration: per-channel int8 scales and the classifier calibration
evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/calibration.py``:
``channel_scales`` (:87) and the binned quantile it calls
(``_quantile_from_counts`` :57), copied as host numpy, and
``absmax_scales``, the same absmax scales computed on a tensor where it
lies (the card, for a model's weights), bit for bit the host's.
``quantize_symmetric`` is the payload both packages make from a scale:
``clip(round(x / s), -127, 127)`` as int8, ``round`` half to even.
``Histogram`` and ``histogram_quantile`` (:38-82), ``ReliabilityDiagram``
and ``EvaluationCalibration`` (:142-358) are copied as host numpy too:
counts accumulated with one ``bincount`` a batch; labels and predictions
may be arrays or tensors on any device (one copy to the host a call).
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.evaluation.classification import \
    _to_np as _host

DEFAULT_RELIABILITY_BINS = 10
DEFAULT_HISTOGRAM_BINS = 50


def _to_np(a) -> np.ndarray:
    return np.asarray(_host(a), dtype=np.float64)


def _as_one_hot(labels: np.ndarray, num_classes: int,
                n_rows: int) -> np.ndarray:
    """labels as [rows, C] one-hot: accepts class indices of any shape
    with n_rows entries ([N], [N,1], [N,T]...) or one-hot/probabilities
    with a trailing class dim."""
    if labels.size == n_rows and (labels.ndim == 1 or
                                  labels.shape[-1] != num_classes
                                  or num_classes == 1):
        idx = labels.reshape(-1).astype(np.int64)
        return np.eye(num_classes, dtype=np.float64)[idx]
    return labels.reshape(-1, num_classes)


class Histogram:
    """A fixed-range histogram (reference: curves/Histogram.java)."""

    def __init__(self, title: str, lower: float, upper: float,
                 counts: np.ndarray):
        self.title = title
        self.lower = float(lower)
        self.upper = float(upper)
        self.bin_counts = np.asarray(counts, dtype=np.int64)

    @property
    def num_bins(self) -> int:
        return int(self.bin_counts.shape[0])

    def bin_edges(self) -> np.ndarray:
        return np.linspace(self.lower, self.upper, self.num_bins + 1)

    def __repr__(self):
        return (f"Histogram({self.title!r}, [{self.lower}, {self.upper}], "
                f"n={int(self.bin_counts.sum())})")


def _quantile_from_counts(counts: np.ndarray, lowers: np.ndarray,
                          uppers: np.ndarray, q: float) -> np.ndarray:
    """Value at quantile ``q`` for each row of binned ``counts``:
    right-edge convention, the smallest bin upper edge below which at
    least ``q`` of the mass lies."""
    counts = np.asarray(counts, np.float64)
    nb = counts.shape[1]
    total = counts.sum(axis=1)
    cum = np.cumsum(counts, axis=1)
    target = max(float(q), 0.0) * total[:, None]
    b = np.argmax(cum >= target, axis=1)        # first bin reaching q
    lowers = np.asarray(lowers, np.float64)
    uppers = np.asarray(uppers, np.float64)
    return lowers + (b + 1) / nb * (uppers - lowers)


def histogram_quantile(hist: Histogram, q: float) -> float:
    """Value at quantile ``q`` of a :class:`Histogram`'s binned mass
    (right-edge convention). The binned analogue of ``np.quantile`` for
    data only available as fixed-range counts."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile must be in (0, 1], got {q}")
    return float(_quantile_from_counts(
        hist.bin_counts[None], [hist.lower], [hist.upper], q)[0])


def channel_scales(samples, method: str = "absmax", quantile: float = 0.999,
                   num_bins: int = 512, qmax: float = 127.0) -> np.ndarray:
    """NaN-safe per-channel symmetric-int quantization scales.

    ``samples``: an array whose LAST axis is the channel axis (leading
    axes are flattened into observations). Returns ``scales`` of shape
    ``[channels]`` (float32) such that ``round(x / scale)`` clipped to
    ``[-qmax, qmax]`` is the int payload and ``payload * scale`` the
    dequantized value.

    - ``method="absmax"``: scale = max |x| / qmax, every value
      representable (weights).
    - ``method="quantile"``: per-channel |x| binned into ``num_bins``
      fixed-range bins, the scale the value at ``quantile`` (right-edge
      convention): clips activation or KV outliers.

    NaN/Inf observations are ignored; a channel with no positive finite
    mass (all-zero, all-NaN) gets scale 1.0, so its payload quantizes to
    0 and dequantizes to 0, never NaN/Inf.
    """
    if method not in ("absmax", "quantile"):
        raise ValueError(f"method must be 'absmax' or 'quantile', "
                         f"got {method!r}")
    if not 0.0 < quantile <= 1.0:
        raise ValueError(f"quantile must be in (0, 1], got {quantile}")
    if int(num_bins) <= 0:
        raise ValueError("num_bins must be positive")
    x = np.asarray(samples, np.float64)
    if x.ndim == 0:
        raise ValueError("samples must have a channel axis")
    c = x.shape[-1]
    a = np.abs(x.reshape(-1, c))
    finite = np.isfinite(a)
    a = np.where(finite, a, 0.0)
    amax = a.max(axis=0) if a.shape[0] else np.zeros(c)
    if method == "absmax":
        peak = amax
    else:
        nb = int(num_bins)
        # normalise to the per-channel range, clip into nb bins, one
        # bincount in all
        safe = np.where(amax > 0, amax, 1.0)
        bins = np.clip((a / safe * nb).astype(np.int64), 0, nb - 1)
        flat = (np.broadcast_to(np.arange(c), a.shape) * nb + bins)
        counts = np.bincount(flat.reshape(-1),
                             weights=finite.reshape(-1).astype(np.float64),
                             minlength=c * nb).reshape(c, nb)
        peak = _quantile_from_counts(counts, np.zeros(c), amax, quantile)
    peak = np.where(np.isfinite(peak) & (peak > 0), peak, float(qmax))
    return (peak / float(qmax)).astype(np.float32)


def absmax_scales(t: torch.Tensor, qmax: float = 127.0) -> torch.Tensor:
    """``channel_scales(t, method="absmax")`` of a float32 tensor, computed
    where it lies: the largest finite |x| of each channel (last axis; the
    exact float32 value the host's float64 reduction finds), divided by
    ``qmax`` in float64 and rounded to float32; 1.0 for a channel with no
    positive finite value."""
    c = t.shape[-1]
    a = t.reshape(-1, c).abs()
    a = torch.where(torch.isfinite(a), a, torch.zeros((), dtype=a.dtype,
                                                      device=a.device))
    amax = a.amax(dim=0).double() if a.shape[0] else torch.zeros(
        c, dtype=torch.float64, device=t.device)
    peak = torch.where(amax > 0, amax, torch.full_like(amax, float(qmax)))
    return (peak / float(qmax)).to(torch.float32)


def quantize_symmetric(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 payload of float32 ``t`` at per-channel (last axis)
    ``scale``: ``clip(round(t / scale), -127, 127)``, the quotient in
    float32 and ``round`` half to even, as numpy's."""
    return torch.round(t / scale).clamp_(-127, 127).to(torch.int8)


class ReliabilityDiagram:
    """Mean predicted probability vs observed frequency per confidence bin
    (reference: curves/ReliabilityDiagram.java)."""

    def __init__(self, title: str, mean_predicted: np.ndarray,
                 frac_positives: np.ndarray, counts: np.ndarray):
        self.title = title
        self.mean_predicted_value = mean_predicted
        self.frac_positives = frac_positives
        self.bin_counts = counts

    def __repr__(self):
        return f"ReliabilityDiagram({self.title!r}, bins={len(self.bin_counts)})"


class EvaluationCalibration:
    """Accumulating calibration evaluation.

    Reference parity: EvaluationCalibration.java:106-467. `eval()` may be
    called repeatedly with batches; reports are computed on demand.
    """

    def __init__(self, reliability_bins: int = DEFAULT_RELIABILITY_BINS,
                 histogram_bins: int = DEFAULT_HISTOGRAM_BINS,
                 exclude_empty_bins: bool = True):
        if reliability_bins <= 0 or histogram_bins <= 0:
            raise ValueError("bin counts must be positive")
        self.reliability_bins = reliability_bins
        self.histogram_bins = histogram_bins
        self.exclude_empty_bins = exclude_empty_bins
        self._num_classes: Optional[int] = None
        self.reset()

    # -- accumulation ------------------------------------------------------

    def reset(self) -> None:
        self._num_classes = None
        self._rdiag_pos = None          # [C, RB] positives per bin
        self._rdiag_total = None        # [C, RB] examples per bin
        self._rdiag_sum_pred = None     # [C, RB] sum of predicted prob
        self._label_counts = None       # [C]
        self._pred_counts = None        # [C]
        self._residual_all = None       # [HB] |label - p| over all entries
        self._residual_by_label = None  # [C, HB] for rows whose label == c
        self._prob_all = None           # [HB] predicted prob, all entries
        self._prob_by_label = None      # [C, HB]

    def _init_state(self, num_classes: int) -> None:
        self._num_classes = num_classes
        rb, hb, c = self.reliability_bins, self.histogram_bins, num_classes
        self._rdiag_pos = np.zeros((c, rb), dtype=np.int64)
        self._rdiag_total = np.zeros((c, rb), dtype=np.int64)
        self._rdiag_sum_pred = np.zeros((c, rb), dtype=np.float64)
        self._label_counts = np.zeros(c, dtype=np.int64)
        self._pred_counts = np.zeros(c, dtype=np.int64)
        self._residual_all = np.zeros(hb, dtype=np.int64)
        self._residual_by_label = np.zeros((c, hb), dtype=np.int64)
        self._prob_all = np.zeros(hb, dtype=np.int64)
        self._prob_by_label = np.zeros((c, hb), dtype=np.int64)

    def eval(self, labels, predictions, mask=None) -> None:
        """Accumulate a batch. labels: one-hot [N,C] or indices [N];
        predictions: probabilities [N,C]. Rows with mask==0 are dropped."""
        p = _to_np(predictions)
        if p.ndim != 2:
            p = p.reshape(-1, p.shape[-1])
        n, c = p.shape
        y = _as_one_hot(_to_np(labels), c, n)
        if mask is not None:
            keep = _to_np(mask).reshape(-1) != 0
            p, y = p[keep], y[keep]
            n = p.shape[0]
        if self._num_classes is None:
            self._init_state(c)
        elif c != self._num_classes:
            raise ValueError(
                f"num_classes changed: {self._num_classes} -> {c}")
        if n == 0:
            return

        rb, hb = self.reliability_bins, self.histogram_bins
        # Reliability diagram: bin each (example, class) prob into rb bins.
        bins = np.clip((p * rb).astype(np.int64), 0, rb - 1)  # [N, C]
        cls = np.broadcast_to(np.arange(c), (n, c))
        flat = (cls * rb + bins).reshape(-1)
        self._rdiag_total += np.bincount(
            flat, minlength=c * rb).reshape(c, rb)
        self._rdiag_pos += np.bincount(
            flat, weights=y.reshape(-1),
            minlength=c * rb).reshape(c, rb).astype(np.int64)
        self._rdiag_sum_pred += np.bincount(
            flat, weights=p.reshape(-1), minlength=c * rb).reshape(c, rb)

        # Label / argmax-prediction counts.
        lab_idx = y.argmax(axis=1)
        self._label_counts += np.bincount(lab_idx, minlength=c)
        self._pred_counts += np.bincount(p.argmax(axis=1), minlength=c)

        # Residual plot: |label - p| over every (example, class) entry,
        # range [0, 1] (EvaluationCalibration.java:268-305).
        resid = np.abs(y - p)
        rbins = np.clip((resid * hb).astype(np.int64), 0, hb - 1)
        self._residual_all += np.bincount(
            rbins.reshape(-1), minlength=hb)
        pbins = np.clip((p * hb).astype(np.int64), 0, hb - 1)
        self._prob_all += np.bincount(pbins.reshape(-1), minlength=hb)
        # Per-label-class versions: for rows labeled class c, bin ONLY
        # column c — the positive-label entry (i, c) — matching the
        # reference residualPlotByLabelClass / probHistogramByLabelClass
        # (l.mul(currBinBitMask).sum(0): the label one-hot masks out the
        # other classes' columns). One entry per row, not C.
        rbin_lab = rbins[np.arange(n), lab_idx]
        self._residual_by_label += np.bincount(
            lab_idx * hb + rbin_lab, minlength=c * hb).reshape(c, hb)
        pbin_lab = pbins[np.arange(n), lab_idx]
        self._prob_by_label += np.bincount(
            lab_idx * hb + pbin_lab, minlength=c * hb).reshape(c, hb)

    def merge(self, other: "EvaluationCalibration") -> None:
        if other._num_classes is None:
            return
        if self._num_classes is None:
            self._init_state(other._num_classes)
        for name in ("_rdiag_pos", "_rdiag_total", "_rdiag_sum_pred",
                     "_label_counts", "_pred_counts", "_residual_all",
                     "_residual_by_label", "_prob_all", "_prob_by_label"):
            setattr(self, name, getattr(self, name) + getattr(other, name))

    # -- reports -----------------------------------------------------------

    def _require(self):
        if self._num_classes is None:
            raise RuntimeError("eval() has not been called")

    def num_classes(self) -> int:
        self._require()
        return self._num_classes

    def reliability_diagram(self, class_idx: int) -> ReliabilityDiagram:
        """(reference: getReliabilityDiagram, EvaluationCalibration.java:365)"""
        self._require()
        total = self._rdiag_total[class_idx]
        pos = self._rdiag_pos[class_idx]
        sum_pred = self._rdiag_sum_pred[class_idx]
        if self.exclude_empty_bins:
            keep = total > 0
            total, pos, sum_pred = total[keep], pos[keep], sum_pred[keep]
        with np.errstate(invalid="ignore", divide="ignore"):
            mean_pred = np.where(total > 0, sum_pred / total, 0.0)
            frac_pos = np.where(total > 0, pos / np.maximum(total, 1), 0.0)
        return ReliabilityDiagram(
            f"Reliability diagram: class {class_idx}",
            mean_pred, frac_pos, total.copy())

    def expected_calibration_error(self, class_idx: Optional[int] = None
                                   ) -> float:
        """ECE = sum_b (n_b / N) * |acc_b - conf_b| (not in the reference;
        the standard scalar summary of its reliability diagram)."""
        self._require()
        if class_idx is None:
            total = self._rdiag_total.sum(axis=0)
            pos = self._rdiag_pos.sum(axis=0)
            sum_pred = self._rdiag_sum_pred.sum(axis=0)
        else:
            total = self._rdiag_total[class_idx]
            pos = self._rdiag_pos[class_idx]
            sum_pred = self._rdiag_sum_pred[class_idx]
        n = total.sum()
        if n == 0:
            return 0.0
        keep = total > 0
        conf = sum_pred[keep] / total[keep]
        acc = pos[keep] / total[keep]
        return float(np.sum(total[keep] / n * np.abs(acc - conf)))

    def label_counts_each_class(self) -> np.ndarray:
        self._require()
        return self._label_counts.copy()

    def prediction_counts_each_class(self) -> np.ndarray:
        self._require()
        return self._pred_counts.copy()

    def residual_plot_all_classes(self) -> Histogram:
        self._require()
        return Histogram("Residual plot - all predictions and labels",
                         0.0, 1.0, self._residual_all)

    def residual_plot(self, label_class_idx: int) -> Histogram:
        self._require()
        return Histogram(
            f"Residual plot - predictions for label class {label_class_idx}",
            0.0, 1.0, self._residual_by_label[label_class_idx])

    def probability_histogram_all_classes(self) -> Histogram:
        self._require()
        return Histogram("Network probabilities", 0.0, 1.0, self._prob_all)

    def probability_histogram(self, label_class_idx: int) -> Histogram:
        self._require()
        return Histogram(
            f"Network probabilities: label class {label_class_idx}",
            0.0, 1.0, self._prob_by_label[label_class_idx])

    def stats(self) -> str:
        self._require()
        c = self._num_classes
        lines = [f"EvaluationCalibration: {c} classes, "
                 f"{int(self._label_counts.sum())} examples",
                 f"  ECE (all classes): "
                 f"{self.expected_calibration_error():.4f}"]
        for i in range(c):
            lines.append(
                f"  class {i}: labels={int(self._label_counts[i])} "
                f"predicted={int(self._pred_counts[i])} "
                f"ECE={self.expected_calibration_error(i):.4f}")
        return "\n".join(lines)
