"""Pairwise (broadcasting binary) ops.

Counterpart of ``deeplearning4j_tpu/ops/pairwise.py``: ``add`` :21,
``subtract`` :22, ``multiply`` :23, ``divide`` :24, ``squaredsubtract``
:35 and ``greater`` :40, with their aliases. Broadcasting is numpy's; the
result dtype is JAX's (``ops/dtypes.py``): a 0-d float32 constant times a
bfloat16 tensor is float32, as in the JAX package.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.dtypes import inexact, promote, result_type
from deeplearning4j_tpu_torch.ops.registry import op

_P = "pairwise"


@op("add", _P, n_inputs=2)
def add(a, b):
    return torch.add(*promote(a, b))


@op("subtract", _P, n_inputs=2, aliases=("sub",))
def subtract(a, b):
    return torch.sub(*promote(a, b))


@op("multiply", _P, n_inputs=2, aliases=("mul",))
def multiply(a, b):
    return torch.mul(*promote(a, b))


@op("divide", _P, n_inputs=2, aliases=("div",))
def divide(a, b):
    """True division; integers divide as floats (JAX's ``true_divide``)."""
    dt = inexact(result_type(a, b))
    return torch.div(*(t.to(dt) if isinstance(t, torch.Tensor) else t
                       for t in (a, b)))


@op("squaredsubtract", _P, n_inputs=2, aliases=("squareddifference",))
def squaredsubtract(a, b):
    return torch.square(torch.sub(*promote(a, b)))


@op("greater", _P, n_inputs=2, aliases=("gt",))
def greater(a, b):
    return torch.gt(*promote(a, b))
