"""TF-compat ops (counterpart of ``deeplearning4j_tpu/ops/tf_compat.py``:
``_strided_slice_index`` :112, ``strided_slice_masked`` :140 and
``tf_fused_batch_norm`` :243). The TF importer folds a ``StridedSlice``'s
begin, end and strides into static attributes and emits
``strided_slice_masked``; a ``FusedBatchNorm`` becomes
``tf_fused_batch_norm``."""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.registry import op

_C = "compat"


def _strided_slice_index(begin, end, strides, begin_mask, end_mask,
                         ellipsis_mask, new_axis_mask, shrink_axis_mask):
    """A copy of the JAX helper: TF's masks as a numpy-style index."""
    idx = []
    for i in range(len(begin)):
        if ellipsis_mask & (1 << i):
            idx.append(Ellipsis)
        elif new_axis_mask & (1 << i):
            idx.append(None)
        elif shrink_axis_mask & (1 << i):
            idx.append(begin[i])
        else:
            b = None if (begin_mask & (1 << i)) else begin[i]
            e = None if (end_mask & (1 << i)) else end[i]
            idx.append(slice(b, e, strides[i]))
    return tuple(idx)


def _flip_negative_steps(x, idx):
    """``x`` and ``idx`` with every slice of negative step turned into a
    flip of its axis and a slice of positive step, which torch indexing
    takes (numpy's and JAX's take both)."""
    n_real = sum(1 for i in idx if i is not None and i is not Ellipsis)
    dim, out, flips = 0, [], []
    for i in idx:
        if i is Ellipsis:
            dim += x.dim() - n_real
        elif isinstance(i, slice) and i.step is not None and i.step < 0:
            n = x.shape[dim]
            start, stop, step = i.indices(n)
            count = len(range(start, stop, step))
            first = n - 1 - start
            out.append(slice(first, first + count * -step if count else
                             first, -step))
            flips.append(dim)
            dim += 1
            continue
        elif i is not None:
            dim += 1
        out.append(i)
    return (x.flip(flips) if flips else x), tuple(out)


@op("strided_slice_masked", _C, n_inputs=1)
def strided_slice_masked(x, begin=(), end=(), strides=(), begin_mask: int = 0,
                         end_mask: int = 0, ellipsis_mask: int = 0,
                         new_axis_mask: int = 0, shrink_axis_mask: int = 0):
    """TF's ``StridedSlice`` with begin, end and strides as static
    attributes (a view where every step is positive)."""
    idx = _strided_slice_index(tuple(begin), tuple(end),
                               tuple(strides) or (1,) * len(tuple(begin)),
                               begin_mask, end_mask, ellipsis_mask,
                               new_axis_mask, shrink_axis_mask)
    x, idx = _flip_negative_steps(x, idx)
    return x[idx]


@op("tf_fused_batch_norm", _C, n_inputs=5)
def tf_fused_batch_norm(x, scale, offset, mean, variance,
                        epsilon: float = 1e-3, data_format: str = "NHWC",
                        is_training: bool = False):
    """``FusedBatchNormV3``: (y, batch mean, batch variance) with the
    batch's float32 statistics (biased variance) when ``is_training``,
    else the given ones; the per-channel scale and shift are computed in
    their dtype and applied in x's."""
    caxis = 3 if data_format == "NHWC" else 1
    axes = tuple(i for i in range(x.dim()) if i != caxis)
    if is_training:
        xf = x.float()
        m = xf.mean(dim=axes)
        v = xf.var(dim=axes, unbiased=False)
    else:
        m, v = mean, variance
    sh = [1] * x.dim()
    sh[caxis] = -1
    inv = torch.rsqrt(v + epsilon)
    scale_ = (scale * inv).reshape(sh).to(x.dtype)
    shift_ = (offset - scale * m * inv).reshape(sh).to(x.dtype)
    return x * scale_ + shift_, m, v
