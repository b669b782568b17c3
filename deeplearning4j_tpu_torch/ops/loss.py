"""Loss ops of the slice (counterpart of ``deeplearning4j_tpu/ops/loss.py``:
``softmax_cross_entropy`` :110 and ``_reduce_loss``). The loss math runs in
float32 whatever the input dtype."""
from __future__ import annotations

import torch


def _f32(x):
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _reduce_loss(per_ex, weights, reduction: str):
    if weights is None:
        weights = torch.ones_like(per_ex)
    w = torch.broadcast_to(weights, per_ex.shape)
    weighted = per_ex * w
    r = reduction.lower()
    if r == "none":
        return weighted
    if r == "sum":
        return weighted.sum(dtype=torch.float32)
    if r in ("mean_by_nonzero_weight", "mean"):
        nz = (w != 0).sum(dtype=torch.float32)
        return weighted.sum(dtype=torch.float32) / torch.clamp_min(nz, 1.0)
    raise ValueError(f"unknown reduction {reduction}")


def softmax_cross_entropy(logits, labels, weights=None,
                          reduction: str = "mean"):
    """Cross-entropy of pre-activation ``logits`` against one-hot or
    probability ``labels``, with a float32 per-example sum."""
    logits, labels = _f32(logits), _f32(labels)
    logp = torch.log_softmax(logits, dim=-1)
    per = -(labels * logp).sum(dim=-1, dtype=torch.float32)
    return _reduce_loss(per, weights, reduction)
