"""Shape ops (counterpart of ``deeplearning4j_tpu/ops/shape_ops.py``:
``reshape`` :22, ``permute`` :27, ``reverse`` :95, ``concat`` :55, ``stack`` :60, ``split``
:70, ``pad`` :111, ``slice`` :124, ``strided_slice`` :132, ``gather`` :139, ``where_op`` :260,
``one_hot`` :275, ``space_to_depth`` :307, ``depth_to_space`` :319). They
return views where torch allows.

``gather`` and ``one_hot`` keep the JAX ops' answers for any index, with no
host sync and no device assert, so that a captured train step can hold
them: ``jnp.take`` wraps an index in [-n, 0) and fills an output row whose
index is out of range (NaN for floats, the least value for signed
integers) and sends it no gradient; ``jax.nn.one_hot`` gives such an index
a row of zeros. ``gather``'s backward is a sorted scatter
(``index_put_(accumulate=True)``, whose CUDA kernel sorts the indices and
sums each row's gradients in index order), so its bits do not depend on
the order of atomics, as ``index_select``'s backward (``index_add_``) does
on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.dtypes import promote, torch_dtype
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


@op("reverse", _S, n_inputs=1, aliases=("flip",))
def reverse(x, axis):
    """``x`` reversed along ``axis`` (an int or a sequence of ints; JAX
    ``reverse`` :95, ``jnp.flip``)."""
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return torch.flip(x, dims)


@op("split", _S, n_inputs=1)
def split(x, num_split: int, axis: int = 0):
    n = x.shape[axis]
    if n % num_split:
        raise ValueError(f"axis {axis} of length {n} does not split into "
                         f"{num_split} equal parts")
    return tuple(torch.split(x, n // num_split, dim=axis))


@op("pad", _S, n_inputs=1)
def pad(x, paddings, mode: str = "constant", constant: float = 0.0):
    """Constant padding; ``paddings`` is numpy-style, one (before, after)
    pair per axis. The JAX op's other modes are refused by name."""
    if mode.lower() != "constant":
        raise NotImplementedError(
            f"pad mode {mode!r} is not ported yet (ROADMAP queue 1 item 5)")
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


@op("strided_slice", _S, n_inputs=1)
def strided_slice(x, begin, end, strides=None):
    """``x[b0:e0:s0, b1:e1:s1, ...]`` (Python slice rules: ends past the
    axis clamp)."""
    return x[tuple(slice(b, e, s) for b, e, s in zip(
        begin, end, strides or [1] * len(begin)))]


@op("concat", _S)
def concat(*xs, axis: int = 0):
    return torch.cat(promote(*xs), dim=axis)


@op("stack", _S, aliases=("parallel_stack",))
def stack(*xs, axis: int = 0):
    return torch.stack(promote(*xs), dim=axis)


@op("where_op", _S, aliases=("select",))
def where_op(cond, x=None, y=None):
    """``x`` where ``cond`` else ``y`` (the JAX op's 3-input form; its
    1-input form, the coordinates of the true elements, has a
    data-dependent shape and waits with the rest of the registry, ROADMAP
    queue 1 item 5)."""
    if x is None or y is None:
        raise NotImplementedError(
            "where_op(cond) (coordinates, a data-dependent shape) is not "
            "ported yet (ROADMAP queue 1 item 5); pass cond, x and y")
    return torch.where(cond.bool(), *promote(x, y))


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for an out-of-range index."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


class _Gather(torch.autograd.Function):
    """``jnp.take(x, indices, axis)`` with JAX's index rule, and a backward
    that scatters in index order (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, indices, axis: int):
        n = x.shape[axis]
        idx = indices.long()
        idx = torch.where(idx < 0, idx + n, idx)
        valid = (idx >= 0) & (idx < n)
        safe = torch.where(valid, idx, torch.zeros_like(idx))
        out_shape = x.shape[:axis] + indices.shape + x.shape[axis + 1:]
        out = x.index_select(axis, safe.reshape(-1)).reshape(out_shape)
        mask = valid.reshape((1,) * axis + tuple(indices.shape)
                             + (1,) * (x.dim() - axis - 1))
        out = torch.where(mask, out, torch.full((), _fill_value(x.dtype),
                                                dtype=x.dtype,
                                                device=x.device))
        ctx.save_for_backward(safe, mask)
        ctx.axis, ctx.x_shape = axis, x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        safe, mask = ctx.saved_tensors
        axis, shape = ctx.axis, ctx.x_shape
        g = torch.where(mask, g, torch.zeros((), dtype=g.dtype,
                                             device=g.device))
        pre = math.prod(shape[:axis])
        post = math.prod(shape[axis + 1:])
        rows = g.reshape(pre, safe.numel(), post).transpose(0, 1)
        gx = torch.zeros((shape[axis], pre, post), dtype=g.dtype,
                         device=g.device)
        gx.index_put_((safe.reshape(-1),), rows, accumulate=True)
        gx = gx.transpose(0, 1).reshape(
            shape[:axis] + (shape[axis],) + shape[axis + 1:])
        return gx, None, None


@op("gather", _S, n_inputs=2)
def gather(x, indices, axis: int = 0):
    """``x``'s slices along ``axis`` at ``indices`` (any integer dtype and
    shape): the result's shape is ``x.shape[:axis] + indices.shape +
    x.shape[axis + 1:]``."""
    return _Gather.apply(x, indices, axis % x.dim())


@op("one_hot", _S, n_inputs=1, aliases=("onehot",))
def one_hot(indices, depth: int, on_value: float = 1.0,
            off_value: float = 0.0, axis: int = -1, dtype: str = "float32"):
    """A new axis ``axis`` of length ``depth``: ``on_value`` where it equals
    the index, else ``off_value`` (a row of ``off_value`` for an index
    outside [0, depth))."""
    nd = indices.dim() + 1
    ax = axis % nd
    classes = torch.arange(depth, device=indices.device).reshape(
        (depth,) + (1,) * (nd - 1 - ax))
    oh = (indices.long().unsqueeze(ax) == classes).to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


def _to_nhwc(x, data_format: str):
    return x.permute(0, 2, 3, 1) if data_format == "NCHW" else x


def _from_nhwc(x, data_format: str):
    return x.permute(0, 3, 1, 2) if data_format == "NCHW" else x


@op("space_to_depth", _S, n_inputs=1)
def space_to_depth(x, block_size: int, data_format: str = "NHWC"):
    """Each ``block_size`` x ``block_size`` patch to channels, ordered
    (block row, block column, channel) with the channel fastest, as the
    JAX op (``pixel_unshuffle`` puts the channel slowest)."""
    x = _to_nhwc(x, data_format)
    b, h, w, c = x.shape
    bs = block_size
    x = x.reshape(b, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
    return _from_nhwc(x.reshape(b, h // bs, w // bs, bs * bs * c),
                      data_format)


@op("depth_to_space", _S, n_inputs=1)
def depth_to_space(x, block_size: int, data_format: str = "NHWC"):
    """The inverse of :func:`space_to_depth`."""
    x = _to_nhwc(x, data_format)
    b, h, w, c = x.shape
    bs = block_size
    x = x.reshape(b, h, w, bs, bs, c // (bs * bs)).permute(0, 1, 3, 2, 4, 5)
    return _from_nhwc(x.reshape(b, h * bs, w * bs, c // (bs * bs)),
                      data_format)
