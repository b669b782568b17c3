"""Recurrent layers beyond ``LSTMLayer`` (counterpart of
``deeplearning4j_tpu/nn/recurrent_layers.py``: ``SimpleRnnLayer`` :25-58,
``Bidirectional`` :61-121, ``LastTimeStepLayer`` :124-142 and
``RnnOutputLayer`` :145-175). Sequences are (batch, time, features).

``SimpleRnnLayer`` is the ``simple_rnn_layer`` op (its recurrence in
``kernels/recurrence.py``). ``Bidirectional`` runs its layer on the
sequence and, under a second namespace (``{lname}_fwd`` / ``_bwd``, as
the JAX wrapper's), on the sequence reversed in time (``reverse``), turns
the second's output back and merges the two: CONCAT (features), ADD, MUL
or AVERAGE. In a TBPTT graph only the forward direction carries its
state (the backward one's last state belongs to the chunk's first
timestep). In a ``ComputationGraph`` the node is a
:class:`BidirectionalModule` of two modules, ``fwd`` and ``bwd``, whose
parameters the JAX package names ``{node}_fwd_{suffix}`` /
``{node}_bwd_{suffix}``.

``RnnOutputLayer`` is a dense layer a timestep with a loss over every
timestep: its loss function's op (``softmax_cross_entropy`` on the (B,
T, C) logits for MCXENT), whose mean runs over batch and time, as the
JAX op's does.

Not ported yet, refused by name when it is made (and so when a
configuration's JSON names it): ``ConvLSTM2DLayer`` (ROADMAP queue 1 item
10: recurrent_layers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.nn.activations import resolve_activation
from deeplearning4j_tpu_torch.nn.layers import (
    LAYER_TYPES, BaseLayer, InputType, Recurrent, _attach_loss_head,
    _input_dropout, _maybe_dropout, _rnn_carry_states, _rnn_initial_states,
    _sd_activation)
from deeplearning4j_tpu_torch.ops.loss import loss_op

_NOT_PORTED = "ROADMAP queue 1 item 10: recurrent_layers"


@dataclasses.dataclass
class SimpleRnnLayer(BaseLayer):
    """``h_t = act(x_t W + h_{t-1} U + b)`` (JAX :25-58): ``{lname}_W``
    (in, u) and ``{lname}_U`` (u, u) drawn in that order, ``{lname}_b``
    zero; ``dropout`` drops the input sequence."""
    n_out: int = 0
    activation: str = "tanh"
    weight_init: str = "XAVIER"
    return_sequences: bool = True
    dropout: float = 0.0

    def output_type(self, itype):
        if self.return_sequences:
            return InputType.recurrent(self.n_out, itype.dims[1])
        return InputType.feed_forward(self.n_out)

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("rnn")
        n_in, u = itype.dims[0], self.n_out
        x = _maybe_dropout(ctx, x, self.dropout, lname)
        w = ctx.param(f"{lname}_W", (n_in, u), self.weight_init)
        r = ctx.param(f"{lname}_U", (u, u), self.weight_init)
        b = ctx.sd.var(f"{lname}_b", value=np.zeros((u,)), dtype=ctx.dtype)
        h0, = _rnn_initial_states(ctx, lname, x, u)
        out, h_t = ctx.sd.invoke(
            "simple_rnn_layer", [x, h0, w, r, b],
            {"activation": resolve_activation(self.activation)},
            name=lname, n_outputs=2)
        _rnn_carry_states(ctx, [(h0, h_t)])
        return (out if self.return_sequences else h_t,
                self.output_type(itype))

    def build(self, ctx, itype):
        n_in, u = itype.dims[0], self.n_out
        w = ctx.param((n_in, u), self.weight_init)
        r = ctx.param((u, u), self.weight_init)
        return Recurrent(ctx, "simple_rnn_layer",
                         {"W": w, "U": r, "b": np.zeros((u,))},
                         ("x", "h0", "W", "U", "b"), u,
                         self.return_sequences,
                         _input_dropout(ctx, self.dropout),
                         activation=resolve_activation(self.activation))


_MODES = ("CONCAT", "ADD", "MUL", "AVERAGE")
#: added to a graph node's index to key its backward direction's draws
BACKWARD_NODE = 1 << 20


class BidirectionalModule(nn.Module):
    """``fwd`` on the sequence, ``bwd`` on it reversed in time (its
    sequence output turned back), merged by ``mode``."""

    def __init__(self, fwd: nn.Module, bwd: nn.Module, mode: str,
                 sequences: bool):
        super().__init__()
        self.fwd, self.bwd = fwd, bwd
        self.mode, self.sequences = mode, sequences

    def forward(self, x):
        f = self.fwd(x)
        b = self.bwd(torch.flip(x, (1,)))
        if self.sequences:
            b = torch.flip(b, (1,))
        if self.mode == "CONCAT":
            return torch.cat([f, b], dim=-1)
        if self.mode == "ADD":
            return f + b
        if self.mode == "MUL":
            return f * b
        return (f + b) * 0.5


@dataclasses.dataclass
class Bidirectional(BaseLayer):
    """A recurrent layer run both ways in time and merged (JAX :61-121):
    ``mode`` CONCAT, ADD, MUL or AVERAGE."""
    layer: Optional[BaseLayer] = None
    mode: str = "CONCAT"

    def _mode(self) -> str:
        mode = self.mode.upper()
        if mode not in _MODES:
            raise ValueError(f"unknown Bidirectional mode {self.mode}")
        return mode

    def output_type(self, itype):
        inner = self.layer.output_type(itype)
        if self.mode.upper() == "CONCAT":
            if inner.kind == "rnn":
                return InputType.recurrent(2 * inner.dims[0], inner.dims[1])
            return InputType.feed_forward(2 * inner.dims[0])
        return inner

    def build_sd(self, ctx, x, itype):
        mode = self._mode()
        lname = ctx.lname("bidir")
        saved_prefix = ctx.prefix
        ctx.prefix = f"{lname}_fwd"
        fwd, inner_t = self.layer.build_sd(ctx, x, itype)
        x_rev = ctx.sd.invoke("reverse", [x], {"axis": (1,)},
                              name=f"{lname}_xrev")
        ctx.prefix = f"{lname}_bwd"
        # the backward direction carries no TBPTT state: its final state
        # belongs to the chunk's first timestep
        saved_tbptt = ctx.tbptt_batch
        ctx.tbptt_batch = None
        try:
            bwd, _ = self.layer.build_sd(ctx, x_rev, itype)
        finally:
            ctx.tbptt_batch = saved_tbptt
            ctx.prefix = saved_prefix
        if inner_t.kind == "rnn":
            bwd = ctx.sd.invoke("reverse", [bwd], {"axis": (1,)},
                                name=f"{lname}_orev")
        if mode == "CONCAT":
            axis = 2 if inner_t.kind == "rnn" else 1
            out = ctx.sd.invoke("concat", [fwd, bwd], {"axis": axis},
                                name=f"{lname}_out")
        elif mode == "ADD":
            out = fwd.add(bwd, name=f"{lname}_out")
        elif mode == "MUL":
            out = fwd.mul(bwd, name=f"{lname}_out")
        else:
            half = ctx.sd.constant(0.5, f"{lname}_half", dtype=ctx.dtype)
            out = fwd.add(bwd).mul(half, name=f"{lname}_out")
        return out, self.output_type(itype)

    def build(self, ctx, itype):
        mode = self._mode()
        fwd = self.layer.build(ctx, itype)
        # the backward direction's input dropout draws under a key of its
        # own (the node's index is the forward's)
        node = ctx.node
        ctx.node = node + BACKWARD_NODE
        try:
            bwd = self.layer.build(ctx, itype)
        finally:
            ctx.node = node
        return BidirectionalModule(fwd, bwd, mode,
                                   self.layer.output_type(itype).kind
                                   == "rnn")

    def to_json(self) -> dict:
        return {"@class": "Bidirectional", "mode": self.mode,
                "layer": self.layer.to_json()}

    @staticmethod
    def _from_json_fields(d: dict) -> "Bidirectional":
        return Bidirectional(layer=BaseLayer.from_json(d["layer"]),
                             mode=d.get("mode", "CONCAT"))


@dataclasses.dataclass
class LastTimeStepLayer(BaseLayer):
    """The last timestep of a sequence, as ff: ``x[:, T - 1]`` at the
    configured (static) T, as the JAX layer slices it."""

    def output_type(self, itype):
        return InputType.feed_forward(itype.dims[0])

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("laststep")
        t = itype.dims[1]
        if t <= 0:
            raise ValueError("LastTimeStepLayer needs static timesteps")
        out = ctx.sd.invoke(
            "strided_slice", [x],
            {"begin": (0, t - 1, 0), "end": (2**31 - 1, t, 2**31 - 1),
             "strides": (1, 1, 1)}, name=f"{lname}_slice")
        out = ctx.sd.invoke("reshape", [out], {"shape": (-1, itype.dims[0])},
                            name=f"{lname}_reshape")
        return out, self.output_type(itype)

    def build(self, ctx, itype):
        t = itype.dims[1]
        if t <= 0:
            raise ValueError("LastTimeStepLayer needs static timesteps")
        return LastTimeStep(t - 1)


class LastTimeStep(nn.Module):
    """``x[:, t]`` of a (B, T, C) sequence."""

    def __init__(self, t: int):
        super().__init__()
        self.t = t

    def forward(self, x):
        return x[:, self.t]


@dataclasses.dataclass
class RnnOutputLayer(BaseLayer):
    """A dense layer a timestep and a loss over all timesteps (the mean
    over batch and time); MCXENT takes the pre-softmax logits."""
    n_out: int = 0
    loss_function: str = "MCXENT"
    activation: str = "softmax"
    weight_init: str = "XAVIER"
    bias_init: float = 0.0
    has_bias: bool = True

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.dims[1])

    def build_sd(self, ctx, x, itype):
        loss_op(self.loss_function)
        lname = ctx.lname("rnnout")
        w = ctx.param(f"{lname}_W", (itype.dims[0], self.n_out),
                      self.weight_init)
        z = x.mmul(w, name=f"{lname}_mm")     # (B, T, in) @ (in, out)
        if self.has_bias:
            z = z.add(ctx.bias(f"{lname}_b", self.n_out, self.bias_init),
                      name=f"{lname}_z")
        out = _sd_activation(ctx.sd, z, self.activation, lname)
        _attach_loss_head(ctx, z, out, self.loss_function)
        return out, self.output_type(itype)


class ConvLSTM2DLayer(BaseLayer):
    """The JAX convolutional LSTM: not ported yet, refused when made."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet ({_NOT_PORTED})")

    @classmethod
    def _from_json_fields(cls, d: dict):
        return cls()


for _cls in (LastTimeStepLayer, RnnOutputLayer, SimpleRnnLayer,
             Bidirectional, ConvLSTM2DLayer):
    LAYER_TYPES[_cls.__name__] = _cls
