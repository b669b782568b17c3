"""Loss ops of the slice (counterpart of ``deeplearning4j_tpu/ops/loss.py``:
``softmax_dtype_scope`` :32, ``_f32``/``_tail``/``_reduce_loss`` :49-93,
``mean_sqerr_loss`` :96, ``absolute_difference_loss`` :103,
``softmax_cross_entropy`` :109, ``sparse_softmax_cross_entropy`` :127,
``sigm_cross_entropy`` :141, ``hinge_loss`` :153, ``squared_hinge_loss``
:162, ``poisson_loss`` :189, ``kl_divergence_loss`` :201,
``cosine_distance_loss`` :209), and the loss functions of the layer
configurations (JAX ``nn/layers.py`` ``_LOSS_OPS`` :510-521 and
``_FUSED_LOGIT_LOSSES`` :524): :data:`LOSS_OPS`,
:data:`FUSED_LOGIT_LOSSES`.

Each loss takes (predictions or logits, labels) with the class or
feature axis last; the per-example losses are reduced over it.

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


@op("mean_sqerr_loss", _L, aliases=("mse_loss", "l2_loss_full"))
def mean_sqerr_loss(predictions, labels, weights=None,
                    reduction: str = "mean"):
    predictions, labels = _f32(predictions), _f32(labels)
    per = torch.square(predictions - labels).mean(dim=-1)
    return _reduce_loss(per, weights, reduction)


@op("absolute_difference_loss", _L, aliases=("mae_loss", "l1_loss"))
def absolute_difference_loss(predictions, labels, weights=None,
                             reduction: str = "mean"):
    """``mean |p - l|``; where p equals l the gradient is JAX's
    ``abs``'s, 1 (``torch.abs`` gives 0)."""
    d = predictions - labels
    per = torch.where(d >= 0, d, -d).mean(dim=-1)
    return _reduce_loss(per, weights, reduction)


@op("sigm_cross_entropy", _L, aliases=("sigmoid_cross_entropy",))
def sigm_cross_entropy(logits, labels, weights=None,
                       reduction: str = "mean",
                       label_smoothing: float = 0.0):
    """Binary cross-entropy of ``logits``, in the stable form
    ``max(x, 0) - x * z + log1p(exp(-|x|))``, with JAX's gradients where
    a logit is exactly 0 (a ReLU's zero through a zero bias): ``max``
    splits the tie (1/2) and ``abs`` takes 1, so the gradient there is
    ``-z``, where ``clamp_min`` and ``abs`` would give ``1 - z``."""
    logits, labels = _f32(logits), _f32(labels)
    if label_smoothing > 0.0:
        labels = labels * (1.0 - label_smoothing) + 0.5 * label_smoothing
    relu = 0.5 * (logits + torch.abs(logits))     # exact; 1/2 at 0
    mag = torch.where(logits >= 0, logits, -logits)   # |x|; 1 at 0
    per_el = relu - logits * labels + torch.log1p(torch.exp(-mag))
    return _reduce_loss(per_el.mean(dim=-1), weights, reduction)


@op("hinge_loss", _L)
def hinge_loss(predictions, labels, weights=None, reduction: str = "mean"):
    """Labels in {0, 1} taken as {-1, 1}."""
    lab = 2.0 * labels - torch.ones_like(labels)
    per = torch.clamp_min(1.0 - lab * predictions, 0.0).mean(dim=-1)
    return _reduce_loss(per, weights, reduction)


@op("squared_hinge_loss", _L)
def squared_hinge_loss(predictions, labels, weights=None,
                       reduction: str = "mean"):
    lab = 2.0 * labels - 1.0
    per = torch.square(torch.clamp_min(1.0 - lab * predictions, 0.0)
                       ).mean(dim=-1)
    return _reduce_loss(per, weights, reduction)


@op("poisson_loss", _L)
def poisson_loss(predictions, labels, weights=None, reduction: str = "mean",
                 log_input: bool = False):
    predictions, labels = _f32(predictions), _f32(labels)
    if log_input:
        per_el = torch.exp(predictions) - labels * predictions
    else:
        per_el = predictions - labels * torch.log(
            torch.clamp_min(predictions, 1e-12))
    return _reduce_loss(per_el.mean(dim=-1), weights, reduction)


@op("kl_divergence_loss", _L, aliases=("kld_loss",))
def kl_divergence_loss(predictions, labels, weights=None,
                       reduction: str = "mean"):
    predictions, labels = _f32(predictions), _f32(labels)
    per = (labels * (torch.log(torch.clamp_min(labels, 1e-12))
                     - torch.log(torch.clamp_min(predictions, 1e-12)))
           ).sum(dim=-1)
    return _reduce_loss(per, weights, reduction)


@op("cosine_distance_loss", _L)
def cosine_distance_loss(predictions, labels, weights=None, axis: int = -1,
                         reduction: str = "mean"):
    per = 1.0 - (predictions * labels).sum(dim=axis)
    return _reduce_loss(per, weights, reduction)


#: a layer's ``loss_function`` -> its registry op (JAX ``_LOSS_OPS``)
LOSS_OPS = {
    "MCXENT": "softmax_cross_entropy",
    "NEGATIVELOGLIKELIHOOD": "softmax_cross_entropy",
    "MSE": "mean_sqerr_loss",
    "L1": "absolute_difference_loss",
    "XENT": "sigm_cross_entropy",
    "HINGE": "hinge_loss",
    "SQUARED_HINGE": "squared_hinge_loss",
    "POISSON": "poisson_loss",
    "KL_DIVERGENCE": "kl_divergence_loss",
    "COSINE_PROXIMITY": "cosine_distance_loss",
}

#: the losses that take pre-activation logits (they fuse the activation)
FUSED_LOGIT_LOSSES = ("softmax_cross_entropy", "sigm_cross_entropy")


def loss_op(loss_function: str) -> str:
    """A layer's loss function by name -> its registry op; an unknown name
    raises ``KeyError``, as the JAX package's lookup does."""
    return LOSS_OPS[loss_function.upper()]
