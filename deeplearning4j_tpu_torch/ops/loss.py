"""Loss ops of the slice (counterpart of ``deeplearning4j_tpu/ops/loss.py``:
``softmax_dtype_scope`` :32, ``_f32``/``_tail``/``_reduce_loss`` :49-75,
``softmax_cross_entropy`` :109, ``sparse_softmax_cross_entropy`` :127).

The log-softmax tail runs in float32 whatever the input dtype, unless a
:func:`softmax_dtype_scope` names another dtype; the per-example losses
are always reduced to the scalar loss in float32."""
from __future__ import annotations

import contextlib
import contextvars

import torch

from deeplearning4j_tpu_torch.ops.dtypes import promote, torch_dtype
from deeplearning4j_tpu_torch.ops.registry import op

_L = "loss"
_LOWP = (torch.bfloat16, torch.float16)

#: The softmax/CE tail dtype (None: float32). Set with
#: :func:`softmax_dtype_scope`; read when a loss op runs.
_SOFTMAX_DTYPE: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_torch_softmax_dtype", default=None)


@contextlib.contextmanager
def softmax_dtype_scope(dtype):
    """While active, the softmax-CE losses keep their log-softmax tail in
    ``dtype`` (a torch dtype or its name) instead of float32. Routed from
    ``MixedPrecision.softmax_dtype``."""
    token = _SOFTMAX_DTYPE.set(None if dtype is None else torch_dtype(dtype))
    try:
        yield
    finally:
        _SOFTMAX_DTYPE.reset(token)


def softmax_dtype():
    """The active scope's dtype (None: the float32 tail)."""
    return _SOFTMAX_DTYPE.get()


def _f32(x):
    return x.float() if x.dtype in _LOWP else x


def _tail(x):
    dt = _SOFTMAX_DTYPE.get()
    return _f32(x) if dt is None else x.to(dt)


def _reduce_loss(per_ex, weights, reduction: str):
    if weights is None:
        weights = torch.ones_like(per_ex)
    w = torch.broadcast_to(weights, per_ex.shape)
    weighted = per_ex * w
    r = reduction.lower()
    if r == "none":
        return weighted
    acc = torch.float32 if weighted.dtype in _LOWP else weighted.dtype
    if r == "sum":
        return weighted.sum(dtype=acc)
    if r in ("mean_by_nonzero_weight", "mean"):
        nz = (w != 0).sum(dtype=torch.float32)
        return weighted.sum(dtype=acc) / torch.clamp_min(nz, 1.0).to(acc)
    raise ValueError(f"unknown reduction {reduction}")


@op("softmax_cross_entropy", _L)
def softmax_cross_entropy(logits, labels, weights=None,
                          reduction: str = "mean"):
    """Cross-entropy of pre-activation ``logits`` against one-hot or
    probability ``labels``; the sum over classes accumulates in float32."""
    logits, labels = (_tail(t) for t in promote(logits, labels))
    logp = torch.log_softmax(logits, dim=-1)
    # float32 accumulation whatever the dtype, float64 included (the JAX op)
    per = -(labels * logp).sum(dim=-1, dtype=torch.float32)
    return _reduce_loss(per, weights, reduction)


@op("sparse_softmax_cross_entropy", _L)
def sparse_softmax_cross_entropy(logits, labels, weights=None,
                                 reduction: str = "mean"):
    """Cross-entropy against integer class ids ``labels``: no one-hot is
    built; the gathered per-token losses are reduced in float32."""
    logp = torch.log_softmax(_tail(logits), dim=-1)
    per = _f32(-torch.gather(logp, -1, labels.long().unsqueeze(-1))
               .squeeze(-1))
    return _reduce_loss(per, weights, reduction)
