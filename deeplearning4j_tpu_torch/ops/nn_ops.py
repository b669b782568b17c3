"""Neural-network ops: convolution, pooling and batch norm (the ResNet-50
and LeNet slices); layer norm, embedding lookup, bias add and attention
(the GPT slice).

Counterpart of ``deeplearning4j_tpu/ops/nn_ops.py`` (``conv2d`` :55,
``max_pool2d`` :219, ``avg_pool2d`` :227, ``batchnorm`` :302,
``batchnorm_train`` :323, ``layer_norm`` :365, ``embedding_lookup`` :417,
``bias_add`` :424 with its ``data_format``,
``scaled_dot_product_attention`` :462; the recurrent ops ``lstm_cell``
:520, ``lstm_layer`` :539 and ``rnn_init_state`` :560, whose cell runs in
the kernels of ``kernels/lstm.py``).
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
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.kernels import attention, lstm
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
    """Average pooling; a padded position counts as a zero in the window
    (the JAX op's ``count_include_pad=True``)."""
    kernel = _pair(kernel)
    strides = _pair(strides if strides is not None else kernel)
    x = _to_nchw(x, data_format)
    pads = _conv_padding(padding, x.shape[2:], strides, kernel)
    x, sym = _pad_spatial(x, pads, 0.0)
    return _from_nchw(F.avg_pool2d(x, kernel, strides, sym,
                                   count_include_pad=True), data_format)


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
    b: (4U,). The recurrence is ``kernels/lstm.py``'s ``LSTMSequence``."""
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
