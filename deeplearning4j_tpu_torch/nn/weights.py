"""Weight initialization (counterpart of ``deeplearning4j_tpu/nn/weights.py``
``init_weights`` :26-63 and ``ALL_SCHEMES`` :66): the same schemes,
variance formulas and bounds, and the same draws from a numpy
``Generator``, so a port network built from the same seed starts from the
same weights as the JAX one. Shapes are given in the JAX package's layout
(HWIO for convolutions)."""
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
    if scheme == "ZERO":
        return np.zeros(shape)
    if scheme == "ONES":
        return np.ones(shape)
    if scheme == "IDENTITY":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY needs a square 2d shape")
        return np.eye(shape[0])
    normal = {"NORMAL": 1.0 / math.sqrt(fan_in),
              "XAVIER": math.sqrt(2.0 / (fan_in + fan_out)),
              "RELU": math.sqrt(2.0 / fan_in),
              "LECUN_NORMAL": math.sqrt(1.0 / fan_in),
              "VAR_SCALING_NORMAL_FAN_AVG": math.sqrt(2.0 / (fan_in
                                                              + fan_out))}
    if scheme in normal:
        return rng.normal(0.0, normal[scheme], shape)
    uniform = {"XAVIER_UNIFORM": math.sqrt(6.0 / (fan_in + fan_out)),
               "RELU_UNIFORM": math.sqrt(6.0 / fan_in),
               "LECUN_UNIFORM": math.sqrt(3.0 / fan_in),
               "UNIFORM": 1.0 / math.sqrt(fan_in),
               "SIGMOID_UNIFORM": 4.0 * math.sqrt(6.0 / (fan_in + fan_out))}
    if scheme in uniform:
        a = uniform[scheme]
        return rng.uniform(-a, a, shape)
    raise ValueError(f"unknown weight init scheme: {scheme}")


ALL_SCHEMES = ["ZERO", "ONES", "IDENTITY", "NORMAL", "XAVIER",
               "XAVIER_UNIFORM", "RELU", "RELU_UNIFORM", "LECUN_NORMAL",
               "LECUN_UNIFORM", "UNIFORM", "SIGMOID_UNIFORM"]
