"""Per-channel symmetric int8 quantization scales.

Counterpart of ``deeplearning4j_tpu/evaluation/calibration.py``:
``channel_scales`` (:87) and the binned quantile it calls
(``_quantile_from_counts`` :57), copied as host numpy, and
``absmax_scales``, the same absmax scales computed on a tensor where it
lies (the card, for a model's weights), bit for bit the host's.
``quantize_symmetric`` is the payload both packages make from a scale:
``clip(round(x / s), -127, 127)`` as int8, ``round`` half to even.
"""
from __future__ import annotations

import numpy as np
import torch


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
