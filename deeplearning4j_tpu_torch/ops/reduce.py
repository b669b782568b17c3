"""Reductions of the slice (counterpart of
``deeplearning4j_tpu/ops/reduce.py``: ``reduce_mean``)."""
from __future__ import annotations


def reduce_mean(x, axis=None, keep_dims: bool = False):
    if axis is None:
        return x.mean()
    return x.mean(dim=axis, keepdim=keep_dims)
