"""Elementwise ops of the slices (counterpart of
``deeplearning4j_tpu/ops/elementwise.py``: ``rsqrt`` :33, ``neg`` :37,
``tanh`` :53, ``erf`` :58, ``relu`` :96, ``gelu`` :126, ``cast`` :222,
``softmax`` :233)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.dtypes import torch_dtype
from deeplearning4j_tpu_torch.ops.registry import op

_E = "elementwise"


@op("relu", _E, n_inputs=1)
def relu(x):
    return torch.relu(x)


@op("gelu", _E, n_inputs=1)
def gelu(x, precise: bool = False):
    """The tanh approximation unless ``precise`` (the JAX op's
    ``approximate=not precise``)."""
    return F.gelu(x, approximate="none" if precise else "tanh")


@op("softmax", _E, n_inputs=1)
def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


@op("rsqrt", _E, n_inputs=1)
def rsqrt(x):
    return torch.rsqrt(x)


@op("neg", _E, n_inputs=1, aliases=("negative",))
def neg(x):
    return torch.neg(x)


@op("tanh", _E, n_inputs=1)
def tanh(x):
    return torch.tanh(x)


@op("erf", _E, n_inputs=1)
def erf(x):
    return torch.erf(x)


@op("cast", _E, n_inputs=1)
def cast(x, dtype: str):
    """``x`` in ``dtype`` (a name such as ``"float32"``; a float cast to an
    integer truncates toward zero, as numpy's)."""
    return x.to(torch_dtype(dtype))
