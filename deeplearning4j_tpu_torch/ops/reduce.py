"""Reductions (counterpart of ``deeplearning4j_tpu/ops/reduce.py``:
``reduce_sum`` :33, ``reduce_mean`` :34, ``reduce_max`` :36 and ``argmax``
:78, with their
aliases). ``axis=None`` (or an empty list) reduces every axis;
``keep_dims`` keeps the reduced axes as length 1. Result dtypes are the
JAX ops' (``ops/dtypes.py``'s defaults): the mean of integers is a float,
the sum of bools or integers other than int64 the default integer, an argmax the
default integer."""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.dtypes import DEFAULT_INT, inexact
from deeplearning4j_tpu_torch.ops.registry import op

_R = "reduce"


def _reduce(fn, x, axis, keep_dims, **kw):
    """``fn`` (``Tensor.mean``, ``Tensor.sum``) over ``axis``: every axis
    for None or an empty list."""
    if isinstance(axis, int):
        axis = (axis,)
    dims = tuple(int(a) for a in axis or ()) or tuple(range(x.dim()))
    if not dims:                                  # a 0-d tensor
        return fn(x, **kw)
    return fn(x, dim=dims, keepdim=keep_dims, **kw)


@op("reduce_mean", _R, n_inputs=1, aliases=("mean",))
def reduce_mean(x, axis=None, keep_dims: bool = False):
    if not x.is_floating_point():
        x = x.to(inexact(x.dtype))
    return _reduce(torch.Tensor.mean, x, axis, keep_dims)


@op("reduce_sum", _R, n_inputs=1, aliases=("sum",))
def reduce_sum(x, axis=None, keep_dims: bool = False):
    dt = None if x.is_floating_point() or x.dtype == torch.int64 \
        else DEFAULT_INT
    return _reduce(torch.Tensor.sum, x, axis, keep_dims, dtype=dt)


@op("reduce_max", _R, n_inputs=1, aliases=("amax_reduce",))
def reduce_max(x, axis=None, keep_dims: bool = False):
    if isinstance(axis, int):
        axis = (axis,)
    dims = tuple(int(a) for a in axis or ()) or tuple(range(x.dim()))
    return torch.amax(x, dim=dims, keepdim=keep_dims) if dims else x


@op("argmax", _R, n_inputs=1, aliases=("imax",))
def argmax(x, axis=None, keep_dims: bool = False):
    """The first index of the largest value along ``axis`` (an int), or in
    the flattened tensor for any other ``axis``."""
    if isinstance(axis, int):
        r = torch.argmax(x, dim=axis, keepdim=keep_dims)
    else:
        r = torch.argmax(x)
    return r.to(DEFAULT_INT)
