"""Elementwise ops of the slice (counterpart of
``deeplearning4j_tpu/ops/elementwise.py``: ``relu`` :96, ``gelu`` :126,
``softmax`` :233; and ``add`` of ``ops/pairwise.py`` :21)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.registry import op

_E = "elementwise"


@op("add", "pairwise", n_inputs=2)
def add(a, b):
    return torch.add(a, b)


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
