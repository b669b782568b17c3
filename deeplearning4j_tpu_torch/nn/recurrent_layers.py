"""Recurrent layers beyond ``LSTMLayer`` (counterpart of
``deeplearning4j_tpu/nn/recurrent_layers.py``: ``LastTimeStepLayer``
:124-142 and ``RnnOutputLayer`` :145-175). Sequences are (batch, time,
features).

``RnnOutputLayer`` is a dense layer a timestep with a loss over every
timestep: its loss function's op (``softmax_cross_entropy`` on the (B,
T, C) logits for MCXENT), whose mean runs over batch and time, as the
JAX op's does.

Not ported yet, each refused by name when it is made (and so when a
configuration's JSON names it): ``SimpleRnnLayer``, ``Bidirectional``
and ``ConvLSTM2DLayer`` (ROADMAP queue 1 item 10: recurrent_layers).
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.layers import (LAYER_TYPES, BaseLayer,
                                                InputType, _attach_loss_head,
                                                _sd_activation)
from deeplearning4j_tpu_torch.ops.loss import loss_op

_NOT_PORTED = "ROADMAP queue 1 item 10: recurrent_layers"


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


class _Refused(BaseLayer):
    """A JAX recurrent layer the port has not ported: refused when made."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet ({_NOT_PORTED})")

    @classmethod
    def _from_json_fields(cls, d: dict):
        return cls()


class SimpleRnnLayer(_Refused):
    pass


class Bidirectional(_Refused):
    pass


class ConvLSTM2DLayer(_Refused):
    pass


for _cls in (LastTimeStepLayer, RnnOutputLayer, SimpleRnnLayer,
             Bidirectional, ConvLSTM2DLayer):
    LAYER_TYPES[_cls.__name__] = _cls
