"""Weight initialization (counterpart of ``deeplearning4j_tpu/nn/weights.py``
``init_weights`` :26): the same variance formulas and the same draws from a
numpy ``Generator``, so a port network built from the same seed starts
from the same weights as the JAX one. Shapes are given in the JAX
package's layout (HWIO for convolutions)."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels HWIO: receptive field * channels
    rf = int(np.prod(shape[:-2]))
    return shape[-2] * rf, shape[-1] * rf


def init_weights(scheme: str, shape: Tuple[int, ...],
                 rng: np.random.Generator) -> np.ndarray:
    scheme = scheme.upper()
    fan_in, fan_out = _fans(tuple(shape))
    if scheme == "XAVIER":
        return rng.normal(0.0, math.sqrt(2.0 / (fan_in + fan_out)), shape)
    if scheme == "RELU":
        return rng.normal(0.0, math.sqrt(2.0 / fan_in), shape)
    raise NotImplementedError(
        f"weight init scheme {scheme!r} is not ported yet (XAVIER, RELU; "
        f"ROADMAP queue 1 item 1.2)")
