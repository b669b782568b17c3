"""Shape ops of the slice (counterpart of
``deeplearning4j_tpu/ops/shape_ops.py``: ``reshape`` :22, ``permute`` :27,
``split`` :70, ``pad`` :111, ``slice`` :124). They return views where
torch allows."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.registry import op

_S = "shape"


@op("reshape", _S, n_inputs=1)
def reshape(x, shape):
    return torch.reshape(x, tuple(shape))


@op("permute", _S, n_inputs=1)
def permute(x, axes=None):
    if axes is None:
        axes = tuple(reversed(range(x.dim())))
    return x.permute(*axes)


@op("split", _S, n_inputs=1)
def split(x, num_split: int, axis: int = 0):
    n = x.shape[axis]
    if n % num_split:
        raise ValueError(f"axis {axis} of length {n} does not split into "
                         f"{num_split} equal parts")
    return tuple(torch.split(x, n // num_split, dim=axis))


def pad(x, paddings, constant: float = 0.0):
    """Constant padding; ``paddings`` is numpy-style, one (before, after)
    pair per axis."""
    flat = []
    for before, after in reversed([tuple(p) for p in paddings]):
        flat += [before, after]
    return F.pad(x, flat, value=constant)


@op("slice", _S, n_inputs=1)
def slice_(x, begin, size):
    """``size[i] == -1`` takes the rest of axis i."""
    idx = tuple(slice(b, x.shape[i] if s == -1 else b + s)
                for i, (b, s) in enumerate(zip(begin, size)))
    return x[idx]
