"""Convolution-family layers beyond ``layers.py`` (counterpart of
``deeplearning4j_tpu/nn/conv_layers.py``: ``Deconvolution2DLayer`` :153,
``DepthwiseConvolution2DLayer`` :200, ``SeparableConvolution2DLayer``
:247, ``LocalResponseNormalization`` :296, ``Upsampling2DLayer`` :324,
``ZeroPaddingLayer`` :343, ``Cropping2DLayer`` :365). Each has both
builders: ``build_sd`` records the JAX layer's op (``MultiLayerNetwork``)
and ``build`` makes a module of ``ComputationGraph``, whose 4-d weights are
the JAX layouts permuted (3, 2, 0, 1), as ``convert.params_from_jax``
moves them. The 1d and 3d layers (``Convolution1DLayer``,
``Convolution3DLayer``, ``Subsampling3DLayer``) are refused by name
(ROADMAP queue 1 item 10)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.nn.activations import resolve_activation
from deeplearning4j_tpu_torch.nn.layers import (LAYER_TYPES, BaseLayer,
                                                Conv2d, InputType, _as_pair,
                                                _conv_out, _pad_mode,
                                                _sd_activation,
                                                apply_cnn_activation)
from deeplearning4j_tpu_torch.ops import nn_ops
from deeplearning4j_tpu_torch.ops.shape_ops import pad


def _sd_bias(ctx, lname: str, n: int, value: float, inputs: list) -> None:
    inputs.append(ctx.sd.var(f"{lname}_b", value=np.full((n,), value),
                             dtype=ctx.dtype))


def _sd_conv(ctx, op: str, lname: str, inputs, attrs, activation: str):
    z = ctx.sd.invoke(op, inputs, {**attrs, "data_format": ctx.cnn_format},
                      name=f"{lname}_z")
    return _sd_activation(ctx.sd, z, activation, lname)


@dataclasses.dataclass
class Deconvolution2DLayer(BaseLayer):
    """Transposed convolution; the weight is (kH, kW, outC, inC), stored
    like the forward convolution it transposes."""
    n_out: int = 0
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    convolution_mode: str = "SAME"
    activation: str = "identity"
    weight_init: str = "RELU"
    bias_init: float = 0.0
    has_bias: bool = True

    def output_type(self, itype):
        c, h, w = itype.dims
        kh, kw = _as_pair(self.kernel_size)
        sh, sw = _as_pair(self.stride)
        if self.convolution_mode.upper() == "SAME":
            oh, ow = h * sh, w * sw
        else:                       # lax.conv_transpose VALID
            oh, ow = (h - 1) * sh + max(kh, sh), (w - 1) * sw + max(kw, sw)
        return InputType("cnn", (self.n_out, oh, ow))

    def _weight(self, ctx, itype, lname=None):
        kh, kw = _as_pair(self.kernel_size)
        shape = (kh, kw, self.n_out, itype.dims[0])
        return ctx.param(f"{lname}_W", shape, self.weight_init) \
            if lname else ctx.param(shape, self.weight_init)

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("deconv")
        inputs = [x, self._weight(ctx, itype, lname)]
        if self.has_bias:
            _sd_bias(ctx, lname, self.n_out, self.bias_init, inputs)
        return _sd_conv(ctx, "deconv2d", lname, inputs, {
            "strides": _as_pair(self.stride),
            "padding": _pad_mode(self.convolution_mode)},
            self.activation), self.output_type(itype)

    def build(self, ctx, itype):
        resolve_activation(self.activation)
        w = self._weight(ctx, itype)
        b = np.full((self.n_out,), self.bias_init) if self.has_bias else None
        return Conv2d(ctx, w, b, _as_pair(self.stride),
                      _pad_mode(self.convolution_mode), (1, 1),
                      self.activation, op=nn_ops.deconv2d)


@dataclasses.dataclass
class DepthwiseConvolution2DLayer(BaseLayer):
    """Depthwise convolution; the weight is (kH, kW, C, depth_multiplier),
    output channel ``c * depth_multiplier + m``."""
    depth_multiplier: int = 1
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
            c * self.depth_multiplier,
            _conv_out(h, kh, sh, self.convolution_mode, dh),
            _conv_out(w, kw, sw, self.convolution_mode, dw)))

    def _shape(self, itype):
        kh, kw = _as_pair(self.kernel_size)
        return (kh, kw, itype.dims[0], self.depth_multiplier)

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("dwconv")
        inputs = [x, ctx.param(f"{lname}_W", self._shape(itype),
                               self.weight_init)]
        if self.has_bias:
            _sd_bias(ctx, lname, itype.dims[0] * self.depth_multiplier,
                     self.bias_init, inputs)
        return _sd_conv(ctx, "depthwise_conv2d", lname, inputs, {
            "strides": _as_pair(self.stride),
            "padding": _pad_mode(self.convolution_mode),
            "dilation": _as_pair(self.dilation)},
            self.activation), self.output_type(itype)

    def build(self, ctx, itype):
        resolve_activation(self.activation)
        w = ctx.param(self._shape(itype), self.weight_init)
        n = itype.dims[0] * self.depth_multiplier
        b = np.full((n,), self.bias_init) if self.has_bias else None
        return Conv2d(ctx, w, b, _as_pair(self.stride),
                      _pad_mode(self.convolution_mode),
                      _as_pair(self.dilation), self.activation,
                      op=nn_ops.depthwise_conv2d)


class SeparableConv2d(nn.Module):
    """The depthwise convolution (``dW``), then the 1x1 pointwise one
    (``pW``) with the bias; both weights the JAX layouts permuted (3, 2,
    0, 1)."""

    def __init__(self, ctx, dw, pw, b, stride, padding, dilation,
                 activation):
        super().__init__()
        self.dW = nn.Parameter(ctx.tensor(dw.transpose(3, 2, 0, 1)))
        self.pW = nn.Parameter(ctx.tensor(pw.transpose(3, 2, 0, 1),
                                          torch.channels_last))
        self.b = None if b is None else nn.Parameter(ctx.tensor(b))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.activation = activation

    def forward(self, x):
        y = nn_ops.depthwise_conv2d(x, self.dW.to(x.dtype), None,
                                    self.stride, self.padding, self.dilation)
        b = None if self.b is None else self.b.to(x.dtype)
        z = nn_ops.conv2d(y, self.pW.to(x.dtype), b, (1, 1), "VALID")
        return apply_cnn_activation(
            z.contiguous(memory_format=torch.channels_last), self.activation)


@dataclasses.dataclass
class SeparableConvolution2DLayer(BaseLayer):
    """Depthwise-separable convolution: ``dW`` (kH, kW, C, multiplier),
    then ``pW`` (1, 1, C * multiplier, n_out)."""
    n_out: int = 0
    depth_multiplier: int = 1
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

    def _shapes(self, itype):
        kh, kw = _as_pair(self.kernel_size)
        c, m = itype.dims[0], self.depth_multiplier
        return (kh, kw, c, m), (1, 1, c * m, self.n_out)

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("sepconv")
        ds, ps = self._shapes(itype)
        inputs = [x, ctx.param(f"{lname}_dW", ds, self.weight_init),
                  ctx.param(f"{lname}_pW", ps, self.weight_init)]
        if self.has_bias:
            _sd_bias(ctx, lname, self.n_out, self.bias_init, inputs)
        return _sd_conv(ctx, "separable_conv2d", lname, inputs, {
            "strides": _as_pair(self.stride),
            "padding": _pad_mode(self.convolution_mode),
            "dilation": _as_pair(self.dilation)},
            self.activation), self.output_type(itype)

    def build(self, ctx, itype):
        resolve_activation(self.activation)
        ds, ps = self._shapes(itype)
        dw = ctx.param(ds, self.weight_init)
        pw = ctx.param(ps, self.weight_init)
        b = np.full((self.n_out,), self.bias_init) if self.has_bias else None
        return SeparableConv2d(ctx, dw, pw, b, _as_pair(self.stride),
                               _pad_mode(self.convolution_mode),
                               _as_pair(self.dilation), self.activation)


class LRN(nn.Module):
    def __init__(self, depth: int, bias: float, alpha: float, beta: float):
        super().__init__()
        self.depth, self.bias, self.alpha, self.beta = depth, bias, alpha, \
            beta

    def forward(self, x):
        return nn_ops.lrn(x, self.depth, self.bias, self.alpha, self.beta)


@dataclasses.dataclass
class LocalResponseNormalization(BaseLayer):
    """LRN across channels: ``x / (k + alpha * sum x^2)^beta`` over a
    window of ``n`` channels (odd), the op's ``depth`` being ``n // 2``."""
    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75

    def output_type(self, itype):
        return itype

    def _depth(self) -> int:
        if int(self.n) % 2 == 0:
            raise ValueError(
                f"LRN window n={self.n} must be odd (symmetric window "
                f"2*(n//2)+1); even n would silently widen the window")
        return int(self.n) // 2

    def build_sd(self, ctx, x, itype):
        out = ctx.sd.invoke("lrn", [x], {
            "depth": self._depth(), "bias": self.k, "alpha": self.alpha,
            "beta": self.beta, "data_format": ctx.cnn_format},
            name=ctx.lname("lrn"))
        return out, itype

    def build(self, ctx, itype):
        return LRN(self._depth(), self.k, self.alpha, self.beta)


class Upsample2d(nn.Module):
    def __init__(self, factor):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return nn_ops.upsampling2d(x, self.factor).contiguous(
            memory_format=torch.channels_last)


@dataclasses.dataclass
class Upsampling2DLayer(BaseLayer):
    """Nearest-neighbour upsampling by ``size``."""
    size: Tuple[int, int] = (2, 2)

    def output_type(self, itype):
        c, h, w = itype.dims
        fh, fw = _as_pair(self.size)
        return InputType("cnn", (c, h * fh, w * fw))

    def build_sd(self, ctx, x, itype):
        out = ctx.sd.invoke("upsampling2d", [x], {
            "factor": _as_pair(self.size), "data_format": ctx.cnn_format},
            name=ctx.lname("upsample"))
        return out, self.output_type(itype)

    def build(self, ctx, itype):
        return Upsample2d(_as_pair(self.size))


class ZeroPad2d(nn.Module):
    def __init__(self, padding):
        super().__init__()
        self.padding = tuple(padding)

    def forward(self, x):
        t, b, l, r = self.padding
        out = pad(x, ((0, 0), (0, 0), (t, b), (l, r)))
        return out.contiguous(memory_format=torch.channels_last)


def _spatial_pads(ctx, t, b, l, r):
    if ctx.cnn_format == "NHWC":
        return ((0, 0), (t, b), (l, r), (0, 0))
    return ((0, 0), (0, 0), (t, b), (l, r))


@dataclasses.dataclass
class ZeroPaddingLayer(BaseLayer):
    """padding = (top, bottom, left, right)."""
    padding: Tuple[int, int, int, int] = (1, 1, 1, 1)

    def output_type(self, itype):
        c, h, w = itype.dims
        t, b, l, r = self.padding
        return InputType("cnn", (c, h + t + b, w + l + r))

    def build_sd(self, ctx, x, itype):
        out = ctx.sd.invoke("pad", [x], {
            "paddings": _spatial_pads(ctx, *self.padding)},
            name=ctx.lname("zeropad"))
        return out, self.output_type(itype)

    def build(self, ctx, itype):
        return ZeroPad2d(self.padding)


class Crop2d(nn.Module):
    def __init__(self, cropping):
        super().__init__()
        self.cropping = tuple(cropping)

    def forward(self, x):
        t, b, l, r = self.cropping
        h, w = x.shape[2], x.shape[3]
        return x[:, :, t:h - b, l:w - r]


@dataclasses.dataclass
class Cropping2DLayer(BaseLayer):
    """cropping = (top, bottom, left, right)."""
    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def output_type(self, itype):
        c, h, w = itype.dims
        t, b, l, r = self.cropping
        return InputType("cnn", (c, h - t - b, w - l - r))

    def build_sd(self, ctx, x, itype):
        c, h, w = itype.dims
        t, b, l, r = self.cropping
        big = 2 ** 31 - 1
        if ctx.cnn_format == "NHWC":
            begin, end = (0, t, l, 0), (big, h - b, w - r, big)
        else:
            begin, end = (0, 0, t, l), (big, big, h - b, w - r)
        out = ctx.sd.invoke("strided_slice", [x], {
            "begin": begin, "end": end, "strides": (1, 1, 1, 1)},
            name=ctx.lname("crop"))
        return out, self.output_type(itype)

    def build(self, ctx, itype):
        return Crop2d(self.cropping)


for _cls in [Deconvolution2DLayer, DepthwiseConvolution2DLayer,
             SeparableConvolution2DLayer, LocalResponseNormalization,
             Upsampling2DLayer, ZeroPaddingLayer, Cropping2DLayer]:
    LAYER_TYPES[_cls.__name__] = _cls
