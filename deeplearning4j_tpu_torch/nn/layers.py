"""Layer configurations and the modules they build.

Counterpart of ``deeplearning4j_tpu/nn/layers.py`` (``InputType`` :35,
``BaseLayer`` :123, ``BuildContext`` :162, ``DenseLayer`` :237,
``ConvolutionLayer`` :300, ``SubsamplingLayer`` :346,
``BatchNormalization`` :378, ``ActivationLayer`` :420,
``GlobalPoolingLayer`` :486, ``OutputLayer`` :541). A configuration's
``build`` draws its parameters from the build context's numpy generator in
the JAX package's order and returns an ``nn.Module``. Parameter names are
the JAX package's suffixes (``W``, ``b``, ``gamma``, ``beta``; state
``mean``, ``var``), so ``{node}.{suffix}`` in a state dict is
``{node}_{suffix}`` in the JAX network.

Parameters are stored in the configuration's dtype (float32 masters by
default). Each module casts them to the dtype of its input, which is the
compute dtype of the step (the mixed-precision cast policy); batch-norm
running statistics stay in the configuration's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.nn.activations import (activation_fn,
                                                     resolve_activation)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops import nn_ops
from deeplearning4j_tpu_torch.ops.loss import softmax_cross_entropy
from deeplearning4j_tpu_torch.ops.reduce import reduce_mean


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str                      # "ff" | "cnn"
    dims: Tuple[int, ...]          # ff: (n,); cnn: (c, h, w)

    @staticmethod
    def feed_forward(n: int) -> "InputType":
        return InputType("ff", (int(n),))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", (int(channels), int(height), int(width)))

    @property
    def flat_size(self) -> int:
        return int(np.prod(self.dims))


def _as_pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_out(size: int, k: int, s: int, mode: str, d: int = 1) -> int:
    if mode.upper() == "SAME":
        out = -(-size // s)
    else:
        out = (size - ((k - 1) * d + 1)) // s + 1
    if out < 1:
        raise ValueError(
            f"layer output spatial size {out} < 1 (input {size}, kernel "
            f"{k}, stride {s}, dilation {d}, mode {mode}): the network is "
            f"deeper/stride-ier than the input size supports")
    return out


def _pad_mode(mode: str) -> str:
    m = mode.upper()
    if m == "SAME":
        return "SAME"
    if m in ("VALID", "TRUNCATE", "STRICT"):
        return "VALID"
    raise ValueError(f"unsupported convolution_mode {mode!r} "
                     f"(use Same/Truncate/Strict/Valid)")


@dataclasses.dataclass
class BuildContext:
    """Carries the init generator and the target device through builds."""
    rng: np.random.Generator
    device: torch.device
    dtype: torch.dtype = torch.float32

    def param(self, shape, scheme: str) -> np.ndarray:
        return init_weights(scheme, tuple(shape), self.rng)

    def tensor(self, value, memory_format=torch.contiguous_format):
        t = torch.as_tensor(np.asarray(value), dtype=self.dtype,
                            device=self.device)
        return t.contiguous(memory_format=memory_format)


class BaseLayer:
    """``output_type(itype)``; ``build(ctx, itype) -> nn.Module``."""

    def output_type(self, itype: InputType) -> InputType:
        raise NotImplementedError

    def build(self, ctx: BuildContext, itype: InputType) -> nn.Module:
        raise NotImplementedError


def _require_ff(layer, itype: InputType) -> None:
    if itype.kind != "ff":
        raise NotImplementedError(
            f"{type(layer).__name__} on {itype.kind} input is not ported "
            f"yet (the cnn -> ff flatten); put a GlobalPoolingLayer first")


# ----------------------------------------------------------------------
class Affine(nn.Module):
    """``x @ W + b`` (Dense and Output layers; W is (n_in, n_out))."""

    def __init__(self, ctx, w, b, activation: str):
        super().__init__()
        self.W = nn.Parameter(ctx.tensor(w))
        self.b = None if b is None else nn.Parameter(ctx.tensor(b))
        self.activation = activation

    def logits(self, x):
        z = x @ self.W.to(x.dtype)
        return z if self.b is None else z + self.b.to(x.dtype)

    def forward(self, x):
        return activation_fn(self.activation)(self.logits(x))


@dataclasses.dataclass
class DenseLayer(BaseLayer):
    n_out: int = 0
    activation: str = "relu"
    weight_init: str = "XAVIER"
    bias_init: float = 0.0
    has_bias: bool = True

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def build(self, ctx, itype):
        _require_ff(self, itype)
        resolve_activation(self.activation)
        w = ctx.param((itype.flat_size, self.n_out), self.weight_init)
        b = np.full((self.n_out,), self.bias_init) if self.has_bias else None
        return Affine(ctx, w, b, self.activation)


class Head(Affine):
    """Output layer: ``forward`` returns the pre-activation logits, which
    the loss takes; ``activation`` maps them to the network's output."""

    def __init__(self, ctx, w, b, activation):
        super().__init__(ctx, w, b, activation)

    def forward(self, x):
        return self.logits(x)

    def loss(self, z, labels):
        return softmax_cross_entropy(z, labels)


@dataclasses.dataclass
class OutputLayer(BaseLayer):
    """Dense + loss head; MCXENT takes the pre-softmax logits."""
    n_out: int = 0
    loss_function: str = "MCXENT"
    activation: str = "softmax"
    weight_init: str = "XAVIER"
    bias_init: float = 0.0
    has_bias: bool = True

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def build(self, ctx, itype):
        if self.loss_function.upper() not in ("MCXENT",
                                              "NEGATIVELOGLIKELIHOOD"):
            raise NotImplementedError(
                f"loss {self.loss_function!r} is not ported yet (MCXENT)")
        _require_ff(self, itype)
        resolve_activation(self.activation)
        w = ctx.param((itype.flat_size, self.n_out), self.weight_init)
        b = np.full((self.n_out,), self.bias_init) if self.has_bias else None
        return Head(ctx, w, b, self.activation)


# ----------------------------------------------------------------------
class Conv2d(nn.Module):
    def __init__(self, ctx, w_hwio, b, stride, padding, dilation,
                 activation):
        super().__init__()
        self.W = nn.Parameter(ctx.tensor(w_hwio.transpose(3, 2, 0, 1),
                                         torch.channels_last))
        self.b = None if b is None else nn.Parameter(ctx.tensor(b))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.activation = activation

    def forward(self, x):
        b = None if self.b is None else self.b.to(x.dtype)
        z = nn_ops.conv2d(x, self.W.to(x.dtype), b, self.stride,
                          self.padding, self.dilation)
        return activation_fn(self.activation)(z)


@dataclasses.dataclass
class ConvolutionLayer(BaseLayer):
    """2D convolution; the JAX package's weights are HWIO, the module's
    OIHW."""
    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    convolution_mode: str = "SAME"
    dilation: Tuple[int, int] = (1, 1)
    activation: str = "identity"
    weight_init: str = "RELU"
    bias_init: float = 0.0
    has_bias: bool = True

    def output_type(self, itype):
        c, h, w = itype.dims
        kh, kw = _as_pair(self.kernel_size)
        sh, sw = _as_pair(self.stride)
        dh, dw = _as_pair(self.dilation)
        return InputType("cnn", (
            self.n_out, _conv_out(h, kh, sh, self.convolution_mode, dh),
            _conv_out(w, kw, sw, self.convolution_mode, dw)))

    def build(self, ctx, itype):
        resolve_activation(self.activation)
        kh, kw = _as_pair(self.kernel_size)
        w = ctx.param((kh, kw, itype.dims[0], self.n_out), self.weight_init)
        b = np.full((self.n_out,), self.bias_init) if self.has_bias else None
        return Conv2d(ctx, w, b, _as_pair(self.stride),
                      _pad_mode(self.convolution_mode),
                      _as_pair(self.dilation), self.activation)


class Pool2d(nn.Module):
    def __init__(self, kernel, stride, padding):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x):
        return nn_ops.max_pool2d(x, self.kernel, self.stride, self.padding)


@dataclasses.dataclass
class SubsamplingLayer(BaseLayer):
    pooling_type: str = "MAX"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Optional[Tuple[int, int]] = None
    convolution_mode: str = "VALID"

    def output_type(self, itype):
        c, h, w = itype.dims
        kh, kw = _as_pair(self.kernel_size)
        sh, sw = _as_pair(self.stride or self.kernel_size)
        return InputType("cnn", (c,
                                 _conv_out(h, kh, sh, self.convolution_mode),
                                 _conv_out(w, kw, sw, self.convolution_mode)))

    def build(self, ctx, itype):
        if self.pooling_type.upper() != "MAX":
            raise NotImplementedError(
                f"pooling {self.pooling_type!r} is not ported yet (MAX)")
        return Pool2d(_as_pair(self.kernel_size),
                      _as_pair(self.stride or self.kernel_size),
                      _pad_mode(self.convolution_mode))


# ----------------------------------------------------------------------
class BatchNorm(nn.Module):
    """Batch norm over channel axis 1. In training mode it normalizes with
    the batch statistics and updates the running ones in place; ``relu``
    (set by the graph when the only consumer is a ReLU activation) fuses
    that ReLU, so that the backward is one kernel pair with the mask."""

    def __init__(self, ctx, n, decay, eps):
        super().__init__()
        self.gamma = nn.Parameter(ctx.tensor(np.ones((n,))))
        self.beta = nn.Parameter(ctx.tensor(np.zeros((n,))))
        self.register_buffer("mean", ctx.tensor(np.zeros((n,))))
        self.register_buffer("var", ctx.tensor(np.ones((n,))))
        self.decay, self.eps = decay, eps
        self.relu = False

    def forward(self, x):
        gamma, beta = self.gamma.to(x.dtype), self.beta.to(x.dtype)
        if not self.training:
            out = nn_ops.batchnorm(x, self.mean, self.var, gamma, beta,
                                   self.eps)
            return torch.relu(out) if self.relu else out
        out, new_mean, new_var = nn_ops.batchnorm_train(
            x, gamma, beta, self.mean, self.var, self.decay, self.eps,
            relu=self.relu)
        with torch.no_grad():
            self.mean.copy_(new_mean)
            self.var.copy_(new_var)
        return out


@dataclasses.dataclass
class BatchNormalization(BaseLayer):
    """'decay' is the running-average momentum:
    new = decay * old + (1 - decay) * batch."""
    decay: float = 0.9
    eps: float = 1e-5

    def output_type(self, itype):
        return itype

    def build(self, ctx, itype):
        return BatchNorm(ctx, itype.dims[0], self.decay, self.eps)


class Activation(nn.Module):
    def __init__(self, activation: str):
        super().__init__()
        self.activation = activation

    def forward(self, x):
        return activation_fn(self.activation)(x)


@dataclasses.dataclass
class ActivationLayer(BaseLayer):
    activation: str = "relu"

    def output_type(self, itype):
        return itype

    def build(self, ctx, itype):
        resolve_activation(self.activation)
        return Activation(self.activation)


class GlobalAvgPool(nn.Module):
    def forward(self, x):
        return reduce_mean(x, axis=(2, 3))


@dataclasses.dataclass
class GlobalPoolingLayer(BaseLayer):
    pooling_type: str = "AVG"

    def output_type(self, itype):
        if itype.kind != "cnn":
            raise ValueError("GlobalPoolingLayer needs cnn input")
        return InputType.feed_forward(itype.dims[0])

    def build(self, ctx, itype):
        self.output_type(itype)
        if self.pooling_type.upper() != "AVG":
            raise NotImplementedError(
                f"global pooling {self.pooling_type!r} is not ported yet "
                f"(AVG)")
        return GlobalAvgPool()
