"""Neural-network ops of the ResNet-50 slice: convolution, pooling, batch
norm.

Counterpart of ``deeplearning4j_tpu/ops/nn_ops.py`` (``conv2d`` :55,
``max_pool2d`` :219, ``batchnorm`` :302, ``batchnorm_train`` :323).
Tensors are logically NCHW, as PyTorch's convolutions take them, in any
memory format (the network body runs ``torch.channels_last``, so a
channel is the fastest axis, as in the JAX package's NHWC body).
Convolution weights are OIHW; the JAX package's are HWIO.

"SAME" padding is JAX's: the extra row or column, when the total is odd,
goes on the bottom/right. PyTorch's ``padding="same"`` refuses strides
above 1 and pads the other way, so SAME is an explicit pad here.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.kernels.bn_relu import BatchNormTrain


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pad(in_size: int, stride: int, k_eff: int) -> Tuple[int, int]:
    out = -(-in_size // stride)
    total = max(0, (out - 1) * stride + k_eff - in_size)
    return total // 2, total - total // 2


def _conv_padding(pad, in_sizes: Sequence[int], strides, k_effs
                  ) -> List[Tuple[int, int]]:
    if isinstance(pad, str):
        p = pad.upper()
        if p == "SAME":
            return [_same_pad(i, s, k)
                    for i, s, k in zip(in_sizes, strides, k_effs)]
        if p == "VALID":
            return [(0, 0)] * len(in_sizes)
        raise ValueError(f"unknown padding {pad}")
    if isinstance(pad, (list, tuple)):
        return [_pair(p) for p in pad]
    return [_pair(pad)] * len(in_sizes)


def _pad_spatial(x, pads, value: float):
    """Returns (x, symmetric padding for the op): an asymmetric pad is
    applied here, a symmetric one is left to the op."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def conv2d(x, w, bias=None, strides=(1, 1), padding="SAME",
           dilation=(1, 1)):
    """2D convolution; ``w`` is OIHW (outC, inC, kH, kW)."""
    strides, dilation = _pair(strides), _pair(dilation)
    k_effs = [(w.shape[2 + i] - 1) * dilation[i] + 1 for i in range(2)]
    pads = _conv_padding(padding, x.shape[2:], strides, k_effs)
    x, sym = _pad_spatial(x, pads, 0.0)
    return F.conv2d(x, w, bias, strides, sym, dilation)


def max_pool2d(x, kernel=(2, 2), strides=None, padding="VALID"):
    kernel = _pair(kernel)
    strides = _pair(strides if strides is not None else kernel)
    pads = _conv_padding(padding, x.shape[2:], strides, kernel)
    x, sym = _pad_spatial(x, pads, float("-inf"))
    return F.max_pool2d(x, kernel, strides, sym)


def batchnorm(x, mean, variance, gamma=None, beta=None,
              epsilon: float = 1e-5):
    """Inference batch norm over channel axis 1, in x's dtype: the
    per-channel ``a``/``b`` are computed in float32 and cast to x's dtype,
    then one ``x * a + b`` pass."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(variance.float() + epsilon)
    a = inv if gamma is None else gamma.float() * inv
    b = -mean.float() * a
    if beta is not None:
        b = b + beta.float()
    return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


def batchnorm_train(x, gamma, beta, running_mean, running_var,
                    momentum: float = 0.9, epsilon: float = 1e-5,
                    relu: bool = False):
    """Training batch norm over channel axis 1 with batch statistics:
    returns (out, new_running_mean, new_running_var), where
    ``new = momentum * old + (1 - momentum) * batch`` and the batch
    variance is the unbiased one. ``relu=True`` returns ``relu(out)``.
    The backward of ``out`` is the BN(+ReLU) kernel pair
    (``kernels/bn_relu.py``)."""
    out, mean, var = BatchNormTrain.apply(x, gamma, beta, epsilon, relu)
    n = x.numel() // x.shape[1]
    unbiased = var * n / max(n - 1, 1)
    new_mean = momentum * running_mean + \
        (1 - momentum) * mean.to(running_mean.dtype)
    new_var = momentum * running_var + \
        (1 - momentum) * unbiased.to(running_var.dtype)
    return out, new_mean, new_var
