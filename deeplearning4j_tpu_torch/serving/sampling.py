"""Seeded host-side token sampling for the generative serving tier.

Counterpart of ``deeplearning4j_tpu/serving/sampling.py`` (``sample_token``
:27), copied as it is: host numpy over one slot's logits row, the draw
keyed by ``(seed, index)`` -- the request's seed folded with the ABSOLUTE
token index (prompt length + tokens generated so far). The fold carries
no server state, so a request's sampled continuation is the same whatever
shares its batch, and a seeded sample equals the JAX package's whenever
the logits agree. The greedy path (temperature 0) keeps the device
argmax.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["sample_token"]


def sample_token(logits, temperature: float = 1.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 seed: int = 0, index: int = 0) -> int:
    """Draw one token id from a [vocab] logits row.

    - ``temperature <= 0`` is exact greedy (argmax, no rng consumed).
    - ``top_k`` keeps the k highest logits before the softmax.
    - ``top_p`` keeps the smallest descending-probability prefix whose
      mass reaches p (the boundary token included), renormalized.
    - ``(seed, index)`` seeds a fresh ``np.random.default_rng`` per
      draw — a pure function of its arguments, so the same request
      replays identically whatever else shares the batch.

    NaN-safe: non-finite logits can never be drawn; if every logit is
    non-finite the argmax fallback still returns a valid id.
    """
    z = np.asarray(logits, np.float64).reshape(-1)
    if z.size < 1:
        raise ValueError("sample_token needs a non-empty logits row")
    if temperature is None or float(temperature) <= 0.0:
        return int(np.argmax(z))
    z = np.where(np.isfinite(z), z, -np.inf)
    z = z / float(temperature)
    if top_k is not None and 0 < int(top_k) < z.size:
        kth = np.partition(z, -int(top_k))[-int(top_k)]
        z = np.where(z >= kth, z, -np.inf)
    m = z.max()
    if not np.isfinite(m):
        # every logit masked/non-finite: degenerate row, greedy fallback
        return int(np.argmax(np.asarray(logits, np.float64).reshape(-1)))
    p = np.exp(z - m)
    p /= p.sum()
    if top_p is not None and 0.0 < float(top_p) < 1.0:
        order = np.argsort(-p, kind="stable")
        csum = np.cumsum(p[order])
        cut = int(np.searchsorted(csum, float(top_p)) + 1)
        keep = np.zeros(p.size, bool)
        keep[order[:cut]] = True
        p = np.where(keep, p, 0.0)
        p /= p.sum()
    # SeedSequence rejects negative entries; fold to the nonneg range
    rng = np.random.default_rng((int(seed) & 0xFFFFFFFFFFFFFFFF,
                                 int(index) & 0xFFFFFFFFFFFFFFFF))
    r = rng.random()
    tok = int(np.searchsorted(np.cumsum(p), r, side="right"))
    return min(tok, p.size - 1)
