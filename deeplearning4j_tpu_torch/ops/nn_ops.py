"""Neural-network ops: convolution, pooling and batch norm (the ResNet-50
and LeNet slices); layer norm, embedding lookup, bias add and attention
(the GPT slice).

Counterpart of ``deeplearning4j_tpu/ops/nn_ops.py`` (``conv2d`` :55,
``depthwise_conv2d`` :113, ``separable_conv2d`` :141, ``deconv2d`` :149,
``upsampling2d`` :187, ``max_pool2d`` :219, ``avg_pool2d`` :227,
``batchnorm`` :302, ``batchnorm_train`` :323, ``layer_norm`` :365,
``lrn`` :396, ``embedding_lookup`` :417,
``bias_add`` :424 with its ``data_format``,
``scaled_dot_product_attention`` :462; the recurrent ops ``lstm_cell``
:520, ``lstm_layer`` :539 and ``rnn_init_state`` :560, whose cell runs in
the kernels of ``kernels/lstm.py``; ``gru_cell`` / ``gru_layer`` :569-592,
``simple_rnn_cell`` / ``simple_rnn_layer`` and ``_rnn_activation``
:595-624, whose recurrences run in the kernels of
``kernels/recurrence.py``).
Tensors are logically NCHW, as PyTorch's convolutions take them, in any
memory format (the network body runs ``torch.channels_last``, so a
channel is the fastest axis, as in the JAX package's NHWC body).
``conv2d`` and ``max_pool2d`` take OIHW weights and NCHW tensors
(``ComputationGraph``); the ops registered under those names take the
JAX package's layouts, HWIO weights and an NCHW or NHWC ``data_format``
(``MultiLayerNetwork`` records NHWC).

Operands of two dtypes are promoted by JAX's rule (``ops/dtypes.py``).

"SAME" padding is JAX's: the extra row or column, when the total is odd,
goes on the bottom/right. PyTorch's ``padding="same"`` refuses strides
above 1 and pads the other way, so SAME is an explicit pad here.

``deconv2d`` is ``lax.conv_transpose(..., transpose_kernel=True)``: the
transposed convolution's full output (``conv_transpose2d`` with no
padding) cropped, or padded with zeros, to the window ``lax`` pads to.
Its weight is HWIO with I the deconvolution's *output* channels; as an
OIHW-ordered tensor (``w.permute(3, 2, 0, 1)``) it is PyTorch's
``(in, out, kH, kW)`` transposed-convolution weight as it stands.
``depthwise_conv2d``'s weight is (kH, kW, C, multiplier); the output
channel of input c and multiplier m is ``c * multiplier + m``. ``lrn``
divides by ``(bias + alpha * sum of x^2 over 2 * depth + 1 channels)^beta``
with no division of alpha by the window (``F.local_response_norm``
divides it).

The module-side functions (``conv2d``, ``deconv2d``, ``depthwise_conv2d``,
``lrn`` on NCHW tensors) take the weights as the ``ComputationGraph``'s
modules hold them: the JAX layout permuted (3, 2, 0, 1).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.kernels import attention, lstm, recurrence
from deeplearning4j_tpu_torch.kernels.bn_relu import BatchNormTrain
from deeplearning4j_tpu_torch.ops.dtypes import promote
from deeplearning4j_tpu_torch.ops.registry import op

_N = "nn"


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
           dilation=(1, 1), groups: int = 1):
    """2D convolution; ``w`` is OIHW (outC, inC / groups, kH, kW)."""
    strides, dilation = _pair(strides), _pair(dilation)
    k_effs = [(w.shape[2 + i] - 1) * dilation[i] + 1 for i in range(2)]
    pads = _conv_padding(padding, x.shape[2:], strides, k_effs)
    x, sym = _pad_spatial(x, pads, 0.0)
    return F.conv2d(x, w, bias, strides, sym, dilation, groups)


def max_pool2d(x, kernel=(2, 2), strides=None, padding="VALID"):
    kernel = _pair(kernel)
    strides = _pair(strides if strides is not None else kernel)
    pads = _conv_padding(padding, x.shape[2:], strides, kernel)
    x, sym = _pad_spatial(x, pads, float("-inf"))
    return F.max_pool2d(x, kernel, strides, sym)


def avg_pool2d(x, kernel=(2, 2), strides=None, padding="VALID"):
    """Average pooling; a padded position counts as a zero in the window
    (the JAX op's ``count_include_pad=True``)."""
    kernel = _pair(kernel)
    strides = _pair(strides if strides is not None else kernel)
    pads = _conv_padding(padding, x.shape[2:], strides, kernel)
    x, sym = _pad_spatial(x, pads, 0.0)
    return F.avg_pool2d(x, kernel, strides, sym, count_include_pad=True)


def _transpose_pads(k: int, s: int, padding) -> Tuple[int, int]:
    """``lax.conv_transpose``'s (before, after) padding of the dilated
    input for an effective kernel ``k`` and stride ``s``."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            pad_len = k + s - 2
            pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        elif padding.upper() == "VALID":
            pad_len = k + s - 2 + max(k - s, 0)
            pad_a = k - 1
        else:
            raise ValueError(f"unknown padding {padding}")
        return pad_a, pad_len - pad_a
    return _pair(padding)


def deconv2d(x, w, bias=None, strides=(1, 1), padding="SAME",
             dilation=(1, 1)):
    """Transposed convolution; ``w`` is (inC, outC, kH, kW)."""
    strides, dilation = _pair(strides), _pair(dilation)
    pads = []
    for i in range(2):
        k = (w.shape[2 + i] - 1) * dilation[i] + 1
        a, b = _transpose_pads(k, strides[i], padding if isinstance(
            padding, str) else padding[i])
        # the full output is the window padded by (k - 1, k - 1)
        pads += [a - (k - 1), b - (k - 1)]
    full = F.conv_transpose2d(x, w, None, strides, 0, 0, 1, dilation)
    out = F.pad(full, (pads[2], pads[3], pads[0], pads[1]))
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def depthwise_weight(w):
    """(mult, C, kH, kW), the JAX (kH, kW, C, mult) permuted (3, 2, 0, 1),
    as the grouped convolution's (C * mult, 1, kH, kW) weight."""
    m, c, kh, kw = w.shape
    return w.permute(1, 0, 2, 3).reshape(c * m, 1, kh, kw)


def depthwise_conv2d(x, w, bias=None, strides=(1, 1), padding="SAME",
                     dilation=(1, 1)):
    """Depthwise convolution; ``w`` is (mult, C, kH, kW)."""
    return conv2d(x, depthwise_weight(w), bias, strides, padding, dilation,
                  groups=x.shape[1])


def lrn(x, depth: int = 5, bias: float = 1.0, alpha: float = 1.0,
        beta: float = 0.5):
    """Local response normalization across channel axis 1."""
    sq = x * x
    padded = F.pad(sq, (0, 0, 0, 0, depth, depth)) if x.dim() == 4 \
        else F.pad(sq, (depth, depth))
    c = x.shape[1]
    acc = torch.zeros_like(sq)
    for i in range(2 * depth + 1):
        acc = acc + padded[:, i:i + c]
    return x / torch.pow(bias + alpha * acc, beta)


def upsampling2d(x, factor=(2, 2)):
    """Nearest-neighbour upsampling of an NCHW tensor."""
    fh, fw = _pair(factor)
    return torch.repeat_interleave(torch.repeat_interleave(x, fh, dim=2),
                                   fw, dim=3)


# ----------------------------------------------------------------------
# the registered ops, in the JAX package's layouts (MultiLayerNetwork)
def _to_nchw(x, data_format: str):
    """An NHWC tensor as the NCHW view PyTorch's ops take: for NHWC
    memory, a channels_last view, so cuDNN gets its layout with no copy."""
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(y, data_format: str):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


@op("conv2d", _N, n_inputs=2)
def conv2d_op(x, w, bias=None, strides=(1, 1), padding="SAME",
              dilation=(1, 1), data_format: str = "NCHW"):
    """2D convolution with the JAX op's layouts: ``w`` is HWIO (kH, kW,
    inC, outC); ``x`` and the result are NCHW or NHWC. The weight goes to
    OIHW in channels_last memory (one small copy), so the convolution's
    output is channels_last and its NHWC view is contiguous."""
    if bias is None:
        x, w = promote(x, w)
    else:
        x, w, bias = promote(x, w, bias)
    w = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return _from_nchw(conv2d(_to_nchw(x, data_format), w, bias, strides,
                             padding, dilation), data_format)


@op("max_pool2d", _N, n_inputs=1, aliases=("maxpool2d",))
def max_pool2d_op(x, kernel=(2, 2), strides=None, padding="VALID",
                  data_format: str = "NCHW"):
    return _from_nchw(max_pool2d(_to_nchw(x, data_format), kernel, strides,
                                 padding), data_format)


@op("avg_pool2d", _N, n_inputs=1, aliases=("avgpool2d",))
def avg_pool2d_op(x, kernel=(2, 2), strides=None, padding="VALID",
                  data_format: str = "NCHW"):
    return _from_nchw(avg_pool2d(_to_nchw(x, data_format), kernel, strides,
                                 padding), data_format)


def _oihw(w):
    """A JAX-layout 4-D weight as the module-side one: (3, 2, 0, 1)."""
    return w.permute(3, 2, 0, 1)


def _bias_promoted(x, ws, bias):
    """``x``, the weights and ``bias`` promoted to one dtype."""
    out = promote(x, *ws, *(() if bias is None else (bias,)))
    return out[0], list(out[1:1 + len(ws)]), \
        None if bias is None else out[-1]


@op("deconv2d", _N, n_inputs=2, aliases=("conv2d_transpose",))
def deconv2d_op(x, w, bias=None, strides=(1, 1), padding="SAME",
                dilation=(1, 1), data_format: str = "NCHW"):
    """Transposed convolution with the JAX op's layouts: ``w`` is (kH,
    kW, outC, inC)."""
    x, (w,), bias = _bias_promoted(x, [w], bias)
    return _from_nchw(deconv2d(_to_nchw(x, data_format), _oihw(w), bias,
                               strides, padding, dilation), data_format)


@op("depthwise_conv2d", _N, n_inputs=2)
def depthwise_conv2d_op(x, w, bias=None, strides=(1, 1), padding="SAME",
                        dilation=(1, 1), data_format: str = "NCHW"):
    """Depthwise convolution; ``w`` is (kH, kW, C, multiplier)."""
    x, (w,), bias = _bias_promoted(x, [w], bias)
    return _from_nchw(depthwise_conv2d(_to_nchw(x, data_format), _oihw(w),
                                       bias, strides, padding, dilation),
                      data_format)


@op("separable_conv2d", _N, n_inputs=3)
def separable_conv2d_op(x, depth_w, point_w, bias=None, strides=(1, 1),
                        padding="SAME", dilation=(1, 1),
                        data_format: str = "NCHW"):
    """The depthwise convolution, then the 1x1 pointwise one with the
    bias."""
    x, (dw, pw), bias = _bias_promoted(x, [depth_w, point_w], bias)
    y = depthwise_conv2d(_to_nchw(x, data_format), _oihw(dw), None, strides,
                         padding, dilation)
    return _from_nchw(conv2d(y, _oihw(pw), bias, (1, 1), "VALID"),
                      data_format)


@op("upsampling2d", _N, n_inputs=1)
def upsampling2d_op(x, factor=(2, 2), data_format: str = "NCHW"):
    return _from_nchw(upsampling2d(_to_nchw(x, data_format), factor),
                      data_format)


@op("lrn", _N, n_inputs=1)
def lrn_op(x, depth: int = 5, bias: float = 1.0, alpha: float = 1.0,
           beta: float = 0.5, data_format: str = "NCHW"):
    """``depth`` is the half-window (the JAX op's convention)."""
    return _from_nchw(lrn(_to_nchw(x, data_format), depth, bias, alpha,
                          beta), data_format)


def _channel_first(x, axis: int):
    """``x`` with its feature ``axis`` as axis 1, and the inverse: NHWC to
    the NCHW view of channels-last memory, (B, T, C) to (B * T, C)."""
    axis = axis % x.dim()
    if axis == 1:
        return x, lambda y: y
    if x.dim() == 4 and axis == 3:
        return x.permute(0, 3, 1, 2), lambda y: y.permute(0, 2, 3, 1)
    if x.dim() == 3 and axis == 2:
        shape = x.shape
        return x.reshape(-1, shape[2]), lambda y: y.reshape(shape)
    raise ValueError(f"batch norm over axis {axis} of a {x.dim()}-d tensor "
                     f"is not supported")


@op("batchnorm", _N, aliases=("batch_norm",))
def batchnorm_op(x, mean, variance, gamma=None, beta=None,
                 epsilon: float = 1e-5, axis: int = 1):
    """The inference batch norm of the JAX op's signature, over ``axis``."""
    xc, back = _channel_first(x, axis)
    return back(batchnorm(xc, mean, variance, gamma, beta, epsilon))


@op("batchnorm_train", _N)
def batchnorm_train_op(x, gamma, beta, running_mean, running_var,
                       momentum: float = 0.9, epsilon: float = 1e-5,
                       axis: int = 1):
    """The training batch norm of the JAX op's signature: ``(out,
    new_running_mean, new_running_var)``, per-channel statistics over
    every axis but ``axis`` (the JAX op given ``axis=-1`` on a 4-d tensor
    reduces the channels too: ROADMAP queue 3, facts); the backward is the
    BN kernel pair."""
    xc, back = _channel_first(x, axis)
    gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    out, new_mean, new_var = batchnorm_train(xc, gamma, beta, running_mean,
                                             running_var, momentum, epsilon)
    return back(out), new_mean, new_var


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


@op("layer_norm", _N)
def layer_norm(x, gamma, beta=None, axis=-1, epsilon: float = 1e-5):
    """Layer norm with the JAX op's numerics: one-pass moments in float32
    for bf16/f16 input (``var = max(E[x^2] - mean^2, 0)``), then
    ``(x - mean) * rsqrt(var + eps) * gamma + beta`` in x's dtype."""
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean = xf.mean(dim=ax, keepdim=True)
    m2 = (xf * xf).mean(dim=ax, keepdim=True)
    var = torch.clamp_min(m2 - mean * mean, 0.0)
    inv = torch.rsqrt(var + epsilon)
    out = torch.mul(*promote((x - mean.to(x.dtype)) * inv.to(x.dtype), gamma))
    if beta is not None:
        out = torch.add(*promote(out, beta))
    return out


@op("embedding_lookup", _N, n_inputs=2)
def embedding_lookup(table, ids):
    """Rows of ``table`` at integer ``ids`` (int32 or int64)."""
    return F.embedding(ids, table)


@op("bias_add", _N, n_inputs=2)
def bias_add(x, bias, data_format: str = "NHWC"):
    """``x + bias`` over the last axis, or over axis 1 for ``"NCHW"`` and
    ``x`` of rank 3 or more."""
    if data_format == "NCHW" and x.dim() > 2:
        bias = bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.add(*promote(x, bias))


@op("scaled_dot_product_attention", _N)
def scaled_dot_product_attention(q, k, v, mask=None, causal: bool = False,
                                 scale: float = None):
    """Multi-head attention core: q, k, v are (batch, heads, seq,
    head_dim); float32 scores and softmax, probabilities cast to v's dtype
    for the product with v. On the card, the kernels of
    ``kernels/attention.py``."""
    q, k, v = promote(q, k, v)
    return attention.scaled_dot_product_attention(q, k, v, mask, causal,
                                                  scale)


# ----------------------------------------------------------------------
# recurrent ops (the JAX ``lstm_cell`` :520, ``lstm_layer`` :539 and
# ``rnn_init_state`` :560)
@op("lstm_layer", _N, aliases=("lstmLayer",))
def lstm_layer(x, h0, c0, w_ih, w_hh, b, time_major: bool = False,
               return_sequences: bool = True):
    """An LSTM over a sequence, gate order ``[i, f, g, o]``: ``(out, hT,
    cT)``, ``out`` the hidden states of every timestep (``(B, T, U)``, or
    ``(T, B, U)`` with ``time_major``) or, without ``return_sequences``,
    ``hT``. x: (B, T, in), h0/c0: (B, U), w_ih: (in, 4U), w_hh: (U, 4U),
    b: (4U,). The recurrence is ``kernels/lstm.py``'s ``lstm_sequence``."""
    x, h0, c0, w_ih, w_hh, b = promote(x, h0, c0, w_ih, w_hh, b)
    hs, h_t, c_t = lstm.lstm_sequence(x.transpose(0, 1) if time_major
                                      else x, h0, c0, w_ih, w_hh, b)
    if not return_sequences:
        return h_t, h_t, c_t
    return (hs.transpose(0, 1) if time_major else hs), h_t, c_t


@op("lstm_cell", _N)
def lstm_cell(x, h_prev, c_prev, w_ih, w_hh, b):
    """One LSTM step: ``(h, c)``. x: (B, in), h/c: (B, U), w_ih: (in,
    4U), w_hh: (U, 4U), b: (4U,): the sequence op over one timestep."""
    _, h, c = lstm_layer(x.unsqueeze(1), h_prev, c_prev, w_ih, w_hh, b)
    return h, c


@op("rnn_init_state", _N, n_inputs=1)
def rnn_init_state(x, units: int, time_major: bool = False):
    """Zero initial state (batch, units) in x's dtype, the batch taken
    from the sequence input (axis 1 with ``time_major``)."""
    return torch.zeros((x.shape[1] if time_major else x.shape[0], units),
                       dtype=x.dtype, device=x.device)


# ----------------------------------------------------------------------
# the GRU and the simple RNN (the JAX ``gru_cell`` :569, ``gru_layer`` :583,
# ``_rnn_activation`` :595, ``simple_rnn_cell`` :607, ``simple_rnn_layer``
# :613)
def _time_major_out(hs, time_major: bool):
    return hs.transpose(0, 1) if time_major else hs


@op("gru_layer", _N, aliases=("gru",))
def gru_layer(x, h0, w_ih, w_hh, b_ih, b_hh, time_major: bool = False):
    """A GRU over a sequence, gate order ``[r, u, c]``: ``(out, hT)``,
    ``out`` every timestep's hidden state ((B, T, U), or (T, B, U) with
    ``time_major``). ``h' = u h + (1 - u) c`` with ``c = tanh(x W_c + b_c +
    r (h W_hc + b_hc))``. x: (B, T, in), h0: (B, U), w_ih: (in, 3U), w_hh:
    (U, 3U), b_ih, b_hh: (3U,). The recurrence is ``kernels/recurrence.py``'s
    ``recurrence_sequence``."""
    x, h0, w_ih, w_hh, b_ih, b_hh = promote(x, h0, w_ih, w_hh, b_ih, b_hh)
    hs, h_t = recurrence.recurrence_sequence(
        "gru", x.transpose(0, 1) if time_major else x, h0, w_ih, w_hh, b_ih,
        b_hh=b_hh)
    return _time_major_out(hs, time_major), h_t


@op("gru_cell", _N)
def gru_cell(x, h_prev, w_ih, w_hh, b_ih, b_hh):
    """One GRU step: the sequence op over one timestep."""
    return gru_layer(x.unsqueeze(1), h_prev, w_ih, w_hh, b_ih, b_hh)[1]


def _rnn_activation(name: str) -> str:
    """An activation's registry name as the simple RNN's kernel takes it
    (``identity``/``linear`` or a registry op); an unknown name raises
    ``ValueError`` as the JAX package's does."""
    key = name.lower()
    if key in ("identity", "linear"):
        return "identity"
    from deeplearning4j_tpu_torch.ops import registry
    if not registry.has_op(key):
        raise ValueError(f"unknown rnn activation {name!r}")
    return registry.get_op(key).name


@op("simple_rnn_layer", _N)
def simple_rnn_layer(x, h0, w_ih, w_hh, b, time_major: bool = False,
                     activation: str = "tanh"):
    """``h_t = act(x_t W + h_{t-1} U + b)`` over a sequence: ``(out, hT)``.
    The recurrence is ``kernels/recurrence.py``'s ``recurrence_sequence``,
    whose kernel takes the activations of ``recurrence.ACTIVATIONS``."""
    x, h0, w_ih, w_hh, b = promote(x, h0, w_ih, w_hh, b)
    hs, h_t = recurrence.recurrence_sequence(
        "simple", x.transpose(0, 1) if time_major else x, h0, w_ih, w_hh, b,
        activation=_rnn_activation(activation))
    return _time_major_out(hs, time_major), h_t


@op("simple_rnn_cell", _N, aliases=("sru_cell_simple",))
def simple_rnn_cell(x, h_prev, w_ih, w_hh, b, activation: str = "tanh"):
    """One simple RNN step: the sequence op over one timestep."""
    return simple_rnn_layer(x.unsqueeze(1), h_prev, w_ih, w_hh, b,
                            activation=activation)[1]
