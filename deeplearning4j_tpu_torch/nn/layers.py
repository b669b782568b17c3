"""Layer configurations and the modules they build.

Counterpart of ``deeplearning4j_tpu/nn/layers.py`` (``InputType`` :35,
``BaseLayer`` :123, ``BuildContext`` :162, ``DenseLayer`` :237,
``ConvolutionLayer`` :300, ``SubsamplingLayer`` :346,
``BatchNormalization`` :378, ``ActivationLayer`` :420, ``DropoutLayer``
:433, ``LSTMLayer`` :449, ``GlobalPoolingLayer`` :486, ``_LOSS_OPS`` :510,
``_attach_loss_head`` :527, ``OutputLayer`` :541, ``LossLayer`` :572,
``_maybe_dropout`` :228, the JSON form ``to_json`` :134 /
``from_json`` :147 and ``LAYER_TYPES`` :586; ``_rnn_initial_states``
:202 and ``_rnn_carry_states`` :220). A configuration has two builders:

- ``build`` (``ComputationGraph``) draws its parameters from the build
  context's numpy generator in the JAX package's order and returns an
  ``nn.Module``. Parameter names are the JAX package's suffixes (``W``,
  ``b``, ``gamma``, ``beta``; state ``mean``, ``var``), so
  ``{node}.{suffix}`` in a state dict is ``{node}_{suffix}`` in the JAX
  network.
- ``build_sd`` (``MultiLayerNetwork``) records the JAX ``build`` methods'
  ops into a SameDiff graph under the same variable names
  (``layer{i}_{kind}_W``, ``_b``, ...), with the same draws, into a
  training graph or an inference graph (``SDBuildContext.training``: a
  batch norm records ``batchnorm_train`` and updates its running
  statistics, state variables, in one and ``batchnorm`` in the other;
  dropout is recorded in the training graph only, as in the JAX package).
  A layer class without one is refused in a ``MultiLayerNetwork``.

Dropout (``dropout`` of a layer, ``DropoutLayer``) drops a layer's
*input*, keeping each element with probability ``p`` (the JAX package's
convention): the ``dropout`` op of ``ops/random.py``, whose mask the
card draws from the fit's base seed, the step's iteration and the node's
index (``kernels/dropout.py``). A ``ComputationGraph`` node's index is
its position in the configuration; a ``SameDiff`` op's its position in
the graph.

A loss head (``OutputLayer``, ``LossLayer`` and those of
``nn/layers_ext.py``) takes any loss function of ``ops/loss.py``
``LOSS_OPS``; the fused ones (MCXENT, XENT) take the pre-activation
logits, the others the activation's output. In a ``ComputationGraph`` a
head module has ``is_loss_head``, ``output(z)`` (what ``output()``
returns) and ``loss(z, labels, x)`` (``x`` the head's input).

Sequences are (batch, time, features), as in the JAX package. In a
TBPTT graph (``SDBuildContext.tbptt_batch``) a recurrent layer's initial
states are state variables of shape (tbptt_batch, units), which the
train step carries from chunk to chunk.

Parameters are stored in the configuration's dtype (float32 masters by
default). Each module casts them to the dtype of its input, which is the
compute dtype of the step (the mixed-precision cast policy); batch-norm
running statistics stay in the configuration's dtype.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.nn.activations import (activation_fn,
                                                     resolve_activation)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops import nn_ops
from deeplearning4j_tpu_torch.ops import random as random_ops
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.ops.loss import FUSED_LOGIT_LOSSES, loss_op


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputType:
    """ff: (n,); cnn: (c, h, w); rnn: (features, timesteps), fed as
    (batch, timesteps, features); no ``ComputationGraph`` vertex takes it
    yet (ROADMAP queue 1 item 10)."""
    kind: str                      # "ff" | "cnn" | "rnn"
    dims: Tuple[int, ...]

    @staticmethod
    def feed_forward(n: int) -> "InputType":
        return InputType("ff", (int(n),))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", (int(channels), int(height), int(width)))

    @staticmethod
    def recurrent(size: int, timesteps: int = -1) -> "InputType":
        return InputType("rnn", (int(size), int(timesteps)))

    @property
    def flat_size(self) -> int:
        if self.kind == "rnn":
            raise ValueError(f"cannot flatten {self}")
        return int(np.prod(self.dims))

    def placeholder_shape(self) -> Tuple[int, ...]:
        if self.kind == "rnn":
            return (-1, self.dims[1], self.dims[0])     # (B, T, C)
        return (-1,) + self.dims

    def to_json(self) -> dict:
        return {"kind": self.kind, "dims": list(self.dims)}

    @staticmethod
    def from_json(d) -> "InputType":
        return InputType(d["kind"], tuple(d["dims"]))


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
    #: the node being built: its index keys its dropout draws
    node: int = 0

    def param(self, shape, scheme: str) -> np.ndarray:
        return init_weights(scheme, tuple(shape), self.rng)

    def tensor(self, value, memory_format=torch.contiguous_format):
        t = torch.as_tensor(np.asarray(value), dtype=self.dtype,
                            device=self.device)
        return t.contiguous(memory_format=memory_format)


@dataclasses.dataclass
class SDBuildContext:
    """Carries the SameDiff graph, the init generator and the layer index
    through a ``MultiLayerNetwork`` build (the JAX ``BuildContext``)."""
    sd: object                      # SameDiff
    rng: np.random.Generator
    dtype: str = "float32"
    idx: int = 0
    #: the training graph (batch statistics, dropout) or the inference one
    training: bool = True
    labels_var: object = None       # labels placeholder, for the loss head
    output_var: object = None       # set by the output layer
    cnn_format: str = "NHWC"
    #: TBPTT: the batch of the recurrent layers' state variables, and
    #: their names as they are made
    tbptt_batch: Optional[int] = None
    rnn_state_vars: list = dataclasses.field(default_factory=list)
    #: a wrapper's name for its inner layer's variables (``Bidirectional``'s
    #: ``{lname}_fwd`` / ``_bwd``), as the JAX context's ``prefix``
    prefix: Optional[str] = None

    def lname(self, kind: str) -> str:
        return self.prefix if self.prefix else f"layer{self.idx}_{kind}"

    def state(self, name: str, value):
        return self.sd.state_var(name, np.asarray(value), dtype=self.dtype)

    def param(self, name: str, shape, scheme: str):
        return self.sd.var(name, value=init_weights(scheme, tuple(shape),
                                                    self.rng),
                           dtype=self.dtype)

    def bias(self, name: str, n: int, value: float):
        return self.sd.var(name, value=np.full((n,), value),
                           dtype=self.dtype)


def _rnn_initial_states(ctx: SDBuildContext, lname: str, x, units: int,
                        names=("h0",)):
    """A recurrent layer's initial states: zeros made in the graph from the
    sequence's batch, or in a TBPTT graph zero state variables of
    (tbptt_batch, units), reset by ``fit_tbptt`` for every minibatch and
    carried by the train step across its chunks."""
    outs = []
    for nm in names:
        if ctx.tbptt_batch:
            sv = ctx.state(f"{lname}_{nm}_state",
                           np.zeros((ctx.tbptt_batch, units)))
            ctx.rnn_state_vars.append(sv.name)
            outs.append(sv)
        else:
            outs.append(ctx.sd.invoke("rnn_init_state", [x],
                                      {"units": units}, name=f"{lname}_{nm}"))
    return outs


def _rnn_carry_states(ctx: SDBuildContext, pairs) -> None:
    """In a TBPTT graph, each (state variable, final state) pair: the state
    takes the final state after every step."""
    if ctx.tbptt_batch:
        for sv, fv in pairs:
            ctx.sd.update_state(sv, fv)


def _sd_activation(sd, x, activation: str, lname: str):
    op = resolve_activation(activation)
    return x if op == "identity" else sd.invoke(op, [x], {},
                                                name=f"{lname}_act")


def _maybe_dropout(ctx: SDBuildContext, x, p: float, lname: str):
    """Input dropout in the training graph (JAX ``_maybe_dropout``)."""
    if p and 0 < p < 1 and ctx.training:
        return ctx.sd.invoke("dropout", [x], {"p": p}, name=f"{lname}_drop")
    return x


def _attach_loss_head(ctx: SDBuildContext, z, out, loss_function: str):
    """The loss op of ``loss_function`` on the logits ``z`` (fused losses)
    or the activation ``out``, named ``loss`` and marked; ``out`` is the
    network's output (JAX ``_attach_loss_head``)."""
    ctx.output_var = out
    name = loss_op(loss_function)
    loss = ctx.sd.invoke(name, [z if name in FUSED_LOGIT_LOSSES else out,
                                ctx.labels_var], {}, name="loss")
    loss.mark_as_loss()
    return loss


class Dropout(nn.Module):
    """Inverted dropout in training mode (the node's ``p`` is the retain
    probability), the identity in inference mode."""

    def __init__(self, p: float, node: int):
        super().__init__()
        self.p, self.node = float(p), int(node)

    def forward(self, x):
        if not self.training or not 0 < self.p < 1:
            return x
        return random_ops.dropout(x, self.p, node=self.node)


def _input_dropout(ctx: BuildContext, p: float) -> Optional[Dropout]:
    return Dropout(p, ctx.node) if p and 0 < p < 1 else None


class BaseLayer:
    """``output_type(itype)``; ``build(ctx, itype) -> nn.Module``;
    ``build_sd(ctx, x, itype) -> (output variable, output type)``;
    ``to_json``/``from_json``, the JAX package's form: ``{"@class": the
    class name, field: value, ...}``, tuples as lists."""

    def to_json(self) -> dict:
        d = {"@class": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = list(v) if isinstance(v, tuple) else v
        return d

    @staticmethod
    def from_json(d: dict) -> "BaseLayer":
        """A layer from its JSON form; a JAX layer class the port has not
        ported is refused by name."""
        d = dict(d)
        name = d.pop("@class")
        cls = LAYER_TYPES.get(name)
        if cls is None:
            raise NotImplementedError(
                f"layer {name!r} is not ported yet (ROADMAP queue 1 item 10: "
                f"nn/ layers); the port's: {sorted(LAYER_TYPES)}")
        if hasattr(cls, "_from_json_fields"):
            return cls._from_json_fields(d)
        kw = {f.name: tuple(d[f.name]) if isinstance(d[f.name], list)
              else d[f.name]
              for f in dataclasses.fields(cls) if f.name in d}
        return cls(**kw)

    def output_type(self, itype: InputType) -> InputType:
        raise NotImplementedError

    def build(self, ctx: BuildContext, itype: InputType) -> nn.Module:
        raise NotImplementedError

    def build_sd(self, ctx: SDBuildContext, x, itype: InputType):
        raise NotImplementedError(
            f"{type(self).__name__} in a MultiLayerNetwork is not ported "
            f"yet (ROADMAP queue 1 item 10: nn/ layers)")


def _require_ff(layer, itype: InputType) -> None:
    if itype.kind == "rnn":
        raise ValueError(
            f"{type(layer).__name__} wants flat input but got a sequence; "
            f"use LSTMLayer(return_sequences=False) or GlobalPoolingLayer "
            f"before it")
    if itype.kind != "ff":
        # a ComputationGraph flattens a cnn input before a layer that
        # wants ff (``multilayer._adapt_itype``), as the JAX graph does
        raise ValueError(
            f"{type(layer).__name__} wants flat input but got "
            f"{itype.kind} input")


# ----------------------------------------------------------------------
class Affine(nn.Module):
    """``x @ W + b`` (Dense and Output layers; W is (n_in, n_out))."""

    def __init__(self, ctx, w, b, activation: str,
                 drop: Optional[Dropout] = None):
        super().__init__()
        self.W = nn.Parameter(ctx.tensor(w))
        self.b = None if b is None else nn.Parameter(ctx.tensor(b))
        self.activation = activation
        self.drop = drop

    def logits(self, x):
        if self.drop is not None:
            x = self.drop(x)
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
    dropout: float = 0.0
    has_bias: bool = True

    def output_type(self, itype):
        if itype.kind == "rnn":          # per timestep
            return InputType.recurrent(self.n_out, itype.dims[1])
        return InputType.feed_forward(self.n_out)

    def build_sd(self, ctx, x, itype):
        """On rnn input the product broadcasts over (batch, time)."""
        if itype.kind != "rnn":
            _require_ff(self, itype)
        lname = ctx.lname("dense")
        n_in = itype.dims[0] if itype.kind == "rnn" else itype.flat_size
        x = _maybe_dropout(ctx, x, self.dropout, lname)
        w = ctx.param(f"{lname}_W", (n_in, self.n_out), self.weight_init)
        z = x.mmul(w, name=f"{lname}_mm")
        if self.has_bias:
            z = z.add(ctx.bias(f"{lname}_b", self.n_out, self.bias_init),
                      name=f"{lname}_z")
        return (_sd_activation(ctx.sd, z, self.activation, lname),
                self.output_type(itype))

    def build(self, ctx, itype):
        _require_ff(self, itype)
        resolve_activation(self.activation)
        w = ctx.param((itype.flat_size, self.n_out), self.weight_init)
        b = np.full((self.n_out,), self.bias_init) if self.has_bias else None
        return Affine(ctx, w, b, self.activation,
                      _input_dropout(ctx, self.dropout))


def to_nhwc(t: torch.Tensor) -> torch.Tensor:
    """A logical NCHW tensor as NHWC (a loss reduces its last axis), any
    other as it is."""
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def head_loss(name: str, z, out, labels):
    """The loss op ``name`` on the logits ``z`` (fused losses) or the
    activation ``out``, each and ``labels`` channels-last."""
    return registry.get_op(name).fn(
        to_nhwc(z if name in FUSED_LOGIT_LOSSES else out),
        to_nhwc(labels))


class Head(Affine):
    """Output layer: ``forward`` returns the pre-activation logits;
    ``output`` maps them through ``activation`` to the network's output;
    ``loss`` is the loss function's op."""
    is_loss_head = True

    def __init__(self, ctx, w, b, activation, loss_function: str = "MCXENT"):
        super().__init__(ctx, w, b, activation)
        self.loss_op = loss_op(loss_function)

    def forward(self, x):
        return self.logits(x)

    def output(self, z):
        return activation_fn(self.activation)(z)

    def loss(self, z, labels, x=None):
        return head_loss(self.loss_op, z, self.output(z), labels)


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

    def build_sd(self, ctx, x, itype):
        """Dense + loss head: the loss function's op, named ``loss`` (the
        JAX ``_attach_loss_head``)."""
        loss_op(self.loss_function)
        _require_ff(self, itype)
        lname = ctx.lname("out")
        w = ctx.param(f"{lname}_W", (itype.flat_size, self.n_out),
                      self.weight_init)
        z = x.mmul(w, name=f"{lname}_mm")
        if self.has_bias:
            z = z.add(ctx.bias(f"{lname}_b", self.n_out, self.bias_init),
                      name=f"{lname}_z")
        out = _sd_activation(ctx.sd, z, self.activation, lname)
        _attach_loss_head(ctx, z, out, self.loss_function)
        return out, self.output_type(itype)

    def build(self, ctx, itype):
        loss_op(self.loss_function)
        _require_ff(self, itype)
        resolve_activation(self.activation)
        w = ctx.param((itype.flat_size, self.n_out), self.weight_init)
        b = np.full((self.n_out,), self.bias_init) if self.has_bias else None
        return Head(ctx, w, b, self.activation, self.loss_function)


class LossHead(nn.Module):
    """A loss head without parameters: ``forward`` passes its input (the
    logits) through."""
    is_loss_head = True

    def __init__(self, activation: str, loss_function: str):
        super().__init__()
        self.activation = activation
        self.loss_op = loss_op(loss_function)

    def forward(self, x):
        return x

    def output(self, z):
        return apply_cnn_activation(z, self.activation)

    def loss(self, z, labels, x=None):
        return head_loss(self.loss_op, z, self.output(z), labels)


@dataclasses.dataclass
class LossLayer(BaseLayer):
    """A loss without parameters (JAX ``LossLayer`` :572)."""
    loss_function: str = "MSE"
    activation: str = "identity"

    def output_type(self, itype):
        return itype

    def build_sd(self, ctx, x, itype):
        out = _sd_activation(ctx.sd, x, self.activation, ctx.lname("act"))
        _attach_loss_head(ctx, x, out, self.loss_function)
        return out, itype

    def build(self, ctx, itype):
        resolve_activation(self.activation)
        return LossHead(self.activation, self.loss_function)


# ----------------------------------------------------------------------
def apply_cnn_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """An activation of a module's output; softmax takes the feature
    axis, 1 (the body is logical NCHW)."""
    if resolve_activation(name) == "softmax":
        return torch.softmax(x, dim=1)
    return activation_fn(name)(x)


class Conv2d(nn.Module):
    """A convolution-family module: its weights as the JAX layout permuted
    (3, 2, 0, 1) (``convert.params_from_jax``), its bias, input dropout and
    activation; ``op`` the ``ops/nn_ops.py`` function (``conv2d``,
    ``deconv2d``, ``depthwise_conv2d``)."""

    def __init__(self, ctx, w_hwio, b, stride, padding, dilation,
                 activation, drop: Optional[Dropout] = None,
                 op=nn_ops.conv2d):
        super().__init__()
        self.W = nn.Parameter(ctx.tensor(w_hwio.transpose(3, 2, 0, 1),
                                         torch.channels_last))
        self.b = None if b is None else nn.Parameter(ctx.tensor(b))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.activation = activation
        self.drop = drop
        self.op = op

    def forward(self, x):
        if self.drop is not None:
            x = self.drop(x)
        b = None if self.b is None else self.b.to(x.dtype)
        z = self.op(x, self.W.to(x.dtype), b, self.stride, self.padding,
                    self.dilation)
        return apply_cnn_activation(
            z.contiguous(memory_format=torch.channels_last), self.activation)


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
    dropout: float = 0.0

    def output_type(self, itype):
        c, h, w = itype.dims
        kh, kw = _as_pair(self.kernel_size)
        sh, sw = _as_pair(self.stride)
        dh, dw = _as_pair(self.dilation)
        return InputType("cnn", (
            self.n_out, _conv_out(h, kh, sh, self.convolution_mode, dh),
            _conv_out(w, kw, sw, self.convolution_mode, dw)))

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("conv")
        kh, kw = _as_pair(self.kernel_size)
        x = _maybe_dropout(ctx, x, self.dropout, lname)
        w = ctx.param(f"{lname}_W", (kh, kw, itype.dims[0], self.n_out),
                      self.weight_init)
        inputs = [x, w]
        if self.has_bias:
            inputs.append(ctx.bias(f"{lname}_b", self.n_out,
                                   self.bias_init))
        z = ctx.sd.invoke("conv2d", inputs, {
            "strides": _as_pair(self.stride),
            "padding": _pad_mode(self.convolution_mode),
            "dilation": _as_pair(self.dilation),
            "data_format": ctx.cnn_format}, name=f"{lname}_z")
        return (_sd_activation(ctx.sd, z, self.activation, lname),
                self.output_type(itype))

    def build(self, ctx, itype):
        resolve_activation(self.activation)
        kh, kw = _as_pair(self.kernel_size)
        w = ctx.param((kh, kw, itype.dims[0], self.n_out), self.weight_init)
        b = np.full((self.n_out,), self.bias_init) if self.has_bias else None
        return Conv2d(ctx, w, b, _as_pair(self.stride),
                      _pad_mode(self.convolution_mode),
                      _as_pair(self.dilation), self.activation,
                      _input_dropout(ctx, self.dropout))


class Pool2d(nn.Module):
    def __init__(self, kernel, stride, padding, op=nn_ops.max_pool2d):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.op = op

    def forward(self, x):
        return self.op(x, self.kernel, self.stride, self.padding)


@dataclasses.dataclass
class SubsamplingLayer(BaseLayer):
    pooling_type: str = "MAX"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Optional[Tuple[int, int]] = None
    convolution_mode: str = "VALID"
    pnorm: int = 2          # PNORM pooling's p (refused yet; JSON field)

    def output_type(self, itype):
        c, h, w = itype.dims
        kh, kw = _as_pair(self.kernel_size)
        sh, sw = _as_pair(self.stride or self.kernel_size)
        return InputType("cnn", (c,
                                 _conv_out(h, kh, sh, self.convolution_mode),
                                 _conv_out(w, kw, sw, self.convolution_mode)))

    def _op(self) -> str:
        op = {"MAX": "max_pool2d", "AVG": "avg_pool2d"}.get(
            self.pooling_type.upper())
        if op is None:
            raise NotImplementedError(
                f"pooling {self.pooling_type!r} is not ported yet (MAX, "
                f"AVG; ROADMAP queue 1 item 5: pnorm_pool2d)")
        return op

    def build_sd(self, ctx, x, itype):
        op = self._op()
        out = ctx.sd.invoke(op, [x], {
            "kernel": _as_pair(self.kernel_size),
            "strides": _as_pair(self.stride or self.kernel_size),
            "padding": _pad_mode(self.convolution_mode),
            "data_format": ctx.cnn_format}, name=ctx.lname("pool"))
        return out, self.output_type(itype)

    def build(self, ctx, itype):
        op = {"max_pool2d": nn_ops.max_pool2d,
              "avg_pool2d": nn_ops.avg_pool2d}[self._op()]
        return Pool2d(_as_pair(self.kernel_size),
                      _as_pair(self.stride or self.kernel_size),
                      _pad_mode(self.convolution_mode), op)


# ----------------------------------------------------------------------
class BatchNorm(nn.Module):
    """Batch norm over channel axis 1. In training mode it normalizes with
    the batch statistics and updates the running ones in place, unless
    ``update_stats`` is off (:func:`running_stats_frozen`); ``relu`` (set
    by the graph when the only consumer is a ReLU activation) fuses that
    ReLU, so that the backward is one kernel pair with the mask. A call
    may pass ``relu`` to override it (the graph's unfused forward)."""

    def __init__(self, ctx, n, decay, eps):
        super().__init__()
        self.gamma = nn.Parameter(ctx.tensor(np.ones((n,))))
        self.beta = nn.Parameter(ctx.tensor(np.zeros((n,))))
        self.register_buffer("mean", ctx.tensor(np.zeros((n,))))
        self.register_buffer("var", ctx.tensor(np.ones((n,))))
        self.decay, self.eps = decay, eps
        self.relu = False
        self.update_stats = True

    def forward(self, x, relu: Optional[bool] = None):
        relu = self.relu if relu is None else relu
        gamma, beta = self.gamma.to(x.dtype), self.beta.to(x.dtype)
        if not self.training:
            out = nn_ops.batchnorm(x, self.mean, self.var, gamma, beta,
                                   self.eps)
            return torch.relu(out) if relu else out
        out, new_mean, new_var = nn_ops.batchnorm_train(
            x, gamma, beta, self.mean, self.var, self.decay, self.eps,
            relu=relu)
        if self.update_stats:
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.var.copy_(new_var)
        return out


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """While active, a training-mode forward of ``module``'s batch norms
    normalizes with the batch statistics and leaves the running ones as
    they are (the JAX package's training forward is functional: it
    returns the new statistics and ``output`` drops them)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


@dataclasses.dataclass
class BatchNormalization(BaseLayer):
    """'decay' is the running-average momentum:
    new = decay * old + (1 - decay) * batch."""
    decay: float = 0.9
    eps: float = 1e-5

    def output_type(self, itype):
        return itype

    def build_sd(self, ctx, x, itype):
        """``batchnorm_train`` (training graph: the running statistics,
        state variables, take its new values after each step) or
        ``batchnorm`` over the feature axis: 2 for sequences, -1 for NHWC
        cnn tensors, else 1 (JAX ``BatchNormalization.build``)."""
        lname = ctx.lname("bn")
        n = itype.dims[0]
        gamma = ctx.sd.var(f"{lname}_gamma", value=np.ones((n,)),
                           dtype=ctx.dtype)
        beta = ctx.sd.var(f"{lname}_beta", value=np.zeros((n,)),
                          dtype=ctx.dtype)
        mean = ctx.state(f"{lname}_mean", np.zeros((n,)))
        var = ctx.state(f"{lname}_var", np.ones((n,)))
        if itype.kind == "rnn":
            axis = 2
        elif itype.kind == "cnn" and ctx.cnn_format == "NHWC":
            axis = -1
        else:
            axis = 1
        if ctx.training:
            out, new_mean, new_var = ctx.sd.invoke(
                "batchnorm_train", [x, gamma, beta, mean, var],
                {"momentum": self.decay, "epsilon": self.eps, "axis": axis},
                name=lname, n_outputs=3)
            ctx.sd.update_state(mean, new_mean)
            ctx.sd.update_state(var, new_var)
        else:
            out = ctx.sd.invoke("batchnorm", [x, mean, var, gamma, beta],
                                {"epsilon": self.eps, "axis": axis},
                                name=lname)
        return out, itype

    def build(self, ctx, itype):
        return BatchNorm(ctx, itype.dims[0], self.decay, self.eps)


class Activation(nn.Module):
    def __init__(self, activation: str):
        super().__init__()
        self.activation = activation

    def forward(self, x):
        return apply_cnn_activation(x, self.activation)


@dataclasses.dataclass
class ActivationLayer(BaseLayer):
    activation: str = "relu"

    def output_type(self, itype):
        return itype

    def build_sd(self, ctx, x, itype):
        return (_sd_activation(ctx.sd, x, self.activation,
                               ctx.lname("act")), itype)

    def build(self, ctx, itype):
        resolve_activation(self.activation)
        return Activation(self.activation)


@dataclasses.dataclass
class DropoutLayer(BaseLayer):
    """Dropout of its input, ``dropout`` the retain probability (JAX
    ``DropoutLayer`` :433); the identity at inference."""
    dropout: float = 0.5

    def output_type(self, itype):
        return itype

    def build_sd(self, ctx, x, itype):
        if ctx.training and 0 < self.dropout < 1:
            x = ctx.sd.invoke("dropout", [x], {"p": self.dropout},
                              name=ctx.lname("dropout"))
        return x, itype

    def build(self, ctx, itype):
        return Dropout(self.dropout, ctx.node)


class GlobalPool(nn.Module):
    """AVG, MAX or SUM over the spatial axes."""

    def __init__(self, op: str):
        super().__init__()
        self.op = op

    def forward(self, x):
        return registry.get_op(self.op).fn(x, axis=(2, 3))


@dataclasses.dataclass
class GlobalPoolingLayer(BaseLayer):
    """AVG, MAX or SUM over the spatial axes of cnn input or the time axis
    of rnn input (``MultiLayerNetwork``); a ``ComputationGraph`` takes
    them over cnn input."""
    pooling_type: str = "AVG"

    def output_type(self, itype):
        if itype.kind not in ("cnn", "rnn"):
            raise ValueError("GlobalPoolingLayer needs cnn or rnn input")
        return InputType.feed_forward(itype.dims[0])

    def build_sd(self, ctx, x, itype):
        self.output_type(itype)
        op = self._op()
        if itype.kind == "rnn":
            axis = (1,)
        else:
            axis = (1, 2) if ctx.cnn_format == "NHWC" else (2, 3)
        out = ctx.sd.invoke(op, [x], {"axis": axis}, name=ctx.lname("gpool"))
        return out, self.output_type(itype)

    def _op(self) -> str:
        op = {"AVG": "reduce_mean", "MAX": "reduce_max",
              "SUM": "reduce_sum"}.get(self.pooling_type.upper())
        if op is None:
            raise NotImplementedError(
                f"global pooling {self.pooling_type!r} is not ported yet "
                f"(AVG, MAX, SUM; ROADMAP queue 1 item 5: pnorm)")
        return op

    def build(self, ctx, itype):
        if itype.kind != "cnn":
            raise ValueError("GlobalPoolingLayer in a ComputationGraph needs "
                             "cnn input")
        return GlobalPool(self._op())


# ----------------------------------------------------------------------
@dataclasses.dataclass
class LSTMLayer(BaseLayer):
    """LSTM over (B, T, C) sequences (JAX ``nn/layers.py:449-483``): the
    ``lstm_layer`` op, gate order ``[i, f, g, o]``. Parameters
    ``{lname}_Wih`` (in, 4u) and ``{lname}_Whh`` (u, 4u) are drawn in that
    order; ``{lname}_b`` is zero but for the forget gate's slice, set to
    ``forget_gate_bias_init``. ``dropout`` drops the input sequence. In a
    ``ComputationGraph`` the node is a :class:`Recurrent` module."""
    n_out: int = 0
    weight_init: str = "XAVIER"
    forget_gate_bias_init: float = 1.0
    return_sequences: bool = True
    dropout: float = 0.0

    def output_type(self, itype):
        if self.return_sequences:
            return InputType.recurrent(self.n_out, itype.dims[1])
        return InputType.feed_forward(self.n_out)

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("lstm")
        n_in, u = itype.dims[0], self.n_out
        x = _maybe_dropout(ctx, x, self.dropout, lname)
        w_ih = ctx.param(f"{lname}_Wih", (n_in, 4 * u), self.weight_init)
        w_hh = ctx.param(f"{lname}_Whh", (u, 4 * u), self.weight_init)
        b0 = np.zeros((4 * u,))
        b0[u:2 * u] = self.forget_gate_bias_init
        b = ctx.sd.var(f"{lname}_b", value=b0, dtype=ctx.dtype)
        h0, c0 = _rnn_initial_states(ctx, lname, x, u, ("h0", "c0"))
        out, h_t, c_t = ctx.sd.invoke(
            "lstm_layer", [x, h0, c0, w_ih, w_hh, b],
            {"time_major": False, "return_sequences": self.return_sequences},
            name=lname, n_outputs=3)
        _rnn_carry_states(ctx, [(h0, h_t), (c0, c_t)])
        return (out if self.return_sequences else h_t,
                self.output_type(itype))

    def build(self, ctx, itype):
        n_in, u = itype.dims[0], self.n_out
        w_ih = ctx.param((n_in, 4 * u), self.weight_init)
        w_hh = ctx.param((u, 4 * u), self.weight_init)
        b = np.zeros((4 * u,))
        b[u:2 * u] = self.forget_gate_bias_init
        return Recurrent(ctx, "lstm_layer", {"Wih": w_ih, "Whh": w_hh,
                                             "b": b},
                         ("x", "h0", "c0", "Wih", "Whh", "b"), u,
                         self.return_sequences,
                         _input_dropout(ctx, self.dropout))


class Recurrent(nn.Module):
    """A recurrent layer of a ``ComputationGraph``: ``op`` (a registry
    recurrence) over its (B, T, C) input from zero states, its parameters
    under the JAX package's suffixes (``params``, in ``order`` among the
    op's inputs ``x``, ``h0``, ``c0``); the sequence of hidden states, or
    the last one without ``return_sequences``."""

    def __init__(self, ctx, op: str, params: Dict[str, np.ndarray],
                 order: Tuple[str, ...], units: int, return_sequences: bool,
                 drop: Optional[Dropout] = None, **attrs):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(ctx.tensor(value)))
        self.op, self.order, self.units = op, order, units
        self.return_sequences, self.drop, self.attrs = (return_sequences,
                                                        drop, attrs)

    def forward(self, x):
        if self.drop is not None:
            x = self.drop(x)
        zero = x.new_zeros(x.shape[0], self.units)
        args = [x if n == "x" else zero if n in ("h0", "c0")
                else getattr(self, n).to(x.dtype) for n in self.order]
        out = registry.get_op(self.op).fn(*args, **self.attrs)
        return out[0] if self.return_sequences else out[1]


#: the JSON ``@class`` names the port reads (``BaseLayer.from_json``);
#: ``nn/conv_layers.py`` and ``nn/recurrent_layers.py`` add theirs
LAYER_TYPES: Dict[str, type] = {c.__name__: c for c in [
    DenseLayer, ConvolutionLayer, SubsamplingLayer, BatchNormalization,
    ActivationLayer, DropoutLayer, LSTMLayer, GlobalPoolingLayer,
    OutputLayer, LossLayer]}
