"""Detection, loss and structural layers of the zoo's image models
(counterpart of ``deeplearning4j_tpu/nn/layers_ext.py``:
``Yolo2OutputLayer`` :119-175, ``SpaceToDepthLayer`` :594,
``DepthToSpaceLayer`` :612, ``CnnLossLayer`` :631 and
``CenterLossOutputLayer`` :689-735) and its recurrent layers
``GravesLSTMLayer`` and ``GRULayer`` (:330-396, the ops
``graves_lstm_layer`` and ``gru_layer``, whose recurrences run in
``kernels/recurrence.py``; a ``ComputationGraph`` node is a
``nn/layers.py`` ``Recurrent`` module). The module's other layers are
refused by name (ROADMAP queue 1 item 10).

The loss heads mark their loss (``MultiLayerNetwork``) or are loss-head
modules (``ComputationGraph``: ``is_loss_head``, ``output(z)``,
``loss(z, labels, x)``), whose losses the graph sums. Labels come in the
external NCHW layout where they are maps; the losses take them, and the
maps they compare them with, channels-last.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.nn.activations import resolve_activation
from deeplearning4j_tpu_torch.nn.layers import (
    LAYER_TYPES, Affine, BaseLayer, InputType, LossHead, Recurrent,
    _require_ff, _rnn_carry_states, _rnn_initial_states, _sd_activation,
    to_nhwc)
from deeplearning4j_tpu_torch.ops import nn_ext, shape_ops
from deeplearning4j_tpu_torch.ops.loss import (FUSED_LOGIT_LOSSES, loss_op,
                                               softmax_cross_entropy)


def _nhwc(ctx, x, name: str):
    return x if ctx.cnn_format == "NHWC" else ctx.sd.invoke(
        "permute", [x], {"axes": (0, 2, 3, 1)}, name=name)


class Yolo2Head(nn.Module):
    """Passes the raw grid through; its loss is ``yolo2_loss``."""
    is_loss_head = True

    def __init__(self, anchors, lambda_coord: float, lambda_noobj: float):
        super().__init__()
        self.anchors = tuple(anchors)
        self.lambda_coord, self.lambda_noobj = lambda_coord, lambda_noobj

    def forward(self, x):
        return x

    def output(self, z):
        return z

    def loss(self, z, labels, x=None):
        return nn_ext.yolo2_loss(to_nhwc(z), to_nhwc(labels),
                                 self.anchors, self.lambda_coord,
                                 self.lambda_noobj)


@dataclasses.dataclass
class Yolo2OutputLayer(BaseLayer):
    """YOLOv2 detection head. Input: a cnn map with A*(5+C) channels on an
    (H, W) grid; output: the same map. Labels: (B, 4+C, H, W), each cell's
    box corners in grid units and its class one-hot."""
    anchors: Tuple[float, ...] = (1.0, 1.0)    # flat (w, h) pairs
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5
    consumes_labels = True

    def output_type(self, itype):
        return itype

    def labels_placeholder_shape(self, otype):
        """(B, 4+C, H, W), not the prediction grid's A*(5+C) channels."""
        c, h, w = otype.dims
        n_anchors = max(1, len(self.anchors) // 2)
        return (-1, 4 + c // n_anchors - 5, h, w)

    def _check(self, itype):
        n_anchors = len(self.anchors) // 2
        if itype.dims[0] % n_anchors:
            raise ValueError(f"channels {itype.dims[0]} not divisible by "
                             f"{n_anchors} anchors")

    def build_sd(self, ctx, x, itype):
        self._check(itype)
        lname = ctx.lname("yolo2")
        if ctx.labels_var is not None and ctx.training:
            lab = ctx.sd.invoke("permute", [ctx.labels_var],
                                {"axes": (0, 2, 3, 1)},
                                name=f"{lname}_lab_nhwc")
            pred = _nhwc(ctx, x, f"{lname}_pred_nhwc")
            ctx.sd.invoke("yolo2_loss", [pred, lab], {
                "anchors": tuple(self.anchors),
                "lambda_coord": self.lambda_coord,
                "lambda_noobj": self.lambda_noobj},
                name=f"{lname}_loss").mark_as_loss()
        ctx.output_var = x
        return x, itype

    def build(self, ctx, itype):
        self._check(itype)
        return Yolo2Head(self.anchors, self.lambda_coord, self.lambda_noobj)


class SpaceToDepth(nn.Module):
    def __init__(self, block_size: int, inverse: bool = False):
        super().__init__()
        self.block_size, self.inverse = block_size, inverse

    def forward(self, x):
        fn = shape_ops.depth_to_space if self.inverse \
            else shape_ops.space_to_depth
        return fn(x, self.block_size, "NCHW").contiguous(
            memory_format=torch.channels_last)


@dataclasses.dataclass
class SpaceToDepthLayer(BaseLayer):
    """Each ``block_size`` x ``block_size`` patch to channels (YOLO2's
    "reorg")."""
    block_size: int = 2

    def output_type(self, itype):
        c, h, w = itype.dims
        b = self.block_size
        return InputType("cnn", (c * b * b, h // b, w // b))

    def build_sd(self, ctx, x, itype):
        out = ctx.sd.invoke("space_to_depth", [x], {
            "block_size": self.block_size, "data_format": ctx.cnn_format},
            name=ctx.lname("s2d"))
        return out, self.output_type(itype)

    def build(self, ctx, itype):
        return SpaceToDepth(self.block_size)


@dataclasses.dataclass
class DepthToSpaceLayer(BaseLayer):
    """The inverse of :class:`SpaceToDepthLayer`."""
    block_size: int = 2

    def output_type(self, itype):
        c, h, w = itype.dims
        b = self.block_size
        return InputType("cnn", (c // (b * b), h * b, w * b))

    def build_sd(self, ctx, x, itype):
        out = ctx.sd.invoke("depth_to_space", [x], {
            "block_size": self.block_size, "data_format": ctx.cnn_format},
            name=ctx.lname("d2s"))
        return out, self.output_type(itype)

    def build(self, ctx, itype):
        return SpaceToDepth(self.block_size, inverse=True)


@dataclasses.dataclass
class CnnLossLayer(BaseLayer):
    """A per-pixel loss on a cnn map; labels NCHW, like the output."""
    loss_function: str = "MSE"
    activation: str = "identity"

    def output_type(self, itype):
        return itype

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("cnnloss")
        out = _sd_activation(ctx.sd, x, self.activation, f"{lname}_act")
        if ctx.labels_var is not None:
            name = loss_op(self.loss_function)
            lab = ctx.labels_var
            if ctx.cnn_format == "NHWC":
                lab = ctx.sd.invoke("permute", [lab], {"axes": (0, 2, 3, 1)},
                                    name=f"{lname}_lab")
            ctx.sd.invoke(name, [x if name in FUSED_LOGIT_LOSSES else out,
                                 lab], {}, name=f"{lname}_loss").mark_as_loss()
        ctx.output_var = out
        return out, itype

    def build(self, ctx, itype):
        resolve_activation(self.activation)
        return LossHead(self.activation, self.loss_function)


class CenterLossHead(Affine):
    """Softmax head plus center loss: ``loss`` is MCXENT of the logits
    plus ``0.5 * lambda * mean((x - c_y)^2)``, ``x`` the head's input and
    ``c_y`` the centers of the batch's classes; in a training forward it
    then moves each class's center by ``alpha`` times the mean of its
    samples' ``x - c`` (the buffer ``centers``, a state written in place
    inside the step: a captured window replays the write)."""
    is_loss_head = True

    def __init__(self, ctx, w, b, n_in: int, alpha: float, lambda_: float):
        super().__init__(ctx, w, b, "softmax")
        self.register_buffer("centers", ctx.tensor(
            np.zeros((w.shape[1], n_in))))
        self.alpha, self.lambda_ = alpha, lambda_

    def forward(self, x):
        return self.logits(x)

    def output(self, z):
        return torch.softmax(z, dim=-1)

    def loss(self, z, labels, x=None):
        ce = softmax_cross_entropy(z, labels)
        centers = self.centers.to(x.dtype)
        diff = x - labels @ centers
        closs = (diff * diff).mean() * (0.5 * self.lambda_)
        if self.training:
            with torch.no_grad():
                upd = labels.transpose(0, 1) @ diff
                cnt = labels.sum(dim=0, keepdim=True)
                new = centers + upd / (cnt.transpose(0, 1) + 1e-8) * \
                    self.alpha
                self.centers.copy_(new)
        return ce.float() + closs.float()


@dataclasses.dataclass
class CenterLossOutputLayer(BaseLayer):
    """Softmax head + center loss; ``alpha`` the centers' update rate,
    ``lambda_`` the center loss's weight. In a ``ComputationGraph`` (the
    FaceNet path); a ``MultiLayerNetwork`` refuses it by name."""
    n_out: int = 0
    alpha: float = 0.05
    lambda_: float = 0.5
    weight_init: str = "XAVIER"
    consumes_labels = True

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def build_sd(self, ctx, x, itype):
        raise NotImplementedError(
            "CenterLossOutputLayer in a MultiLayerNetwork is not ported yet "
            "(ROADMAP queue 1 item 10: nn/ layers; a ComputationGraph "
            "takes it)")

    def build(self, ctx, itype):
        _require_ff(self, itype)
        n_in = itype.flat_size
        w = ctx.param((n_in, self.n_out), self.weight_init)
        return CenterLossHead(ctx, w, np.zeros(self.n_out), n_in, self.alpha,
                              self.lambda_)


# ----------------------------------------------------------------------
class _RecurrentBase(BaseLayer):
    def output_type(self, itype):
        if self.return_sequences:
            return InputType.recurrent(self.n_out, itype.dims[1])
        return InputType.feed_forward(self.n_out)


@dataclasses.dataclass
class GravesLSTMLayer(_RecurrentBase):
    """Peephole LSTM (JAX :330-361): the ``graves_lstm_layer`` op, gate
    order ``[i, f, g, o]``. ``{lname}_Wih`` (in, 4u) and ``{lname}_Whh``
    (u, 4u) drawn in that order; the peepholes ``{lname}_Wp`` (3, u) zero;
    ``{lname}_b`` zero but for the forget gate's slice,
    ``forget_gate_bias_init``. In a TBPTT graph h and c are carried."""
    n_out: int = 0
    weight_init: str = "XAVIER"
    forget_gate_bias_init: float = 1.0
    return_sequences: bool = True

    def _init(self, draw, n_in):
        u = self.n_out
        w_ih = draw("Wih", (n_in, 4 * u))
        w_hh = draw("Whh", (u, 4 * u))
        b = np.zeros((4 * u,))
        b[u:2 * u] = self.forget_gate_bias_init
        return w_ih, w_hh, np.zeros((3, u)), b

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("glstm")
        u = self.n_out
        w_ih, w_hh, w_p, b = self._init(
            lambda n, s: ctx.param(f"{lname}_{n}", s, self.weight_init),
            itype.dims[0])
        w_p = ctx.sd.var(f"{lname}_Wp", value=w_p, dtype=ctx.dtype)
        b = ctx.sd.var(f"{lname}_b", value=b, dtype=ctx.dtype)
        h0, c0 = _rnn_initial_states(ctx, lname, x, u, ("h0", "c0"))
        out, h_t, c_t = ctx.sd.invoke(
            "graves_lstm_layer", [x, h0, c0, w_ih, w_hh, w_p, b],
            {"return_sequences": self.return_sequences}, name=lname,
            n_outputs=3)
        _rnn_carry_states(ctx, [(h0, h_t), (c0, c_t)])
        return (out if self.return_sequences else h_t), \
            self.output_type(itype)

    def build(self, ctx, itype):
        w_ih, w_hh, w_p, b = self._init(
            lambda n, s: ctx.param(s, self.weight_init), itype.dims[0])
        return Recurrent(ctx, "graves_lstm_layer",
                         {"Wih": w_ih, "Whh": w_hh, "Wp": w_p, "b": b},
                         ("x", "h0", "c0", "Wih", "Whh", "Wp", "b"),
                         self.n_out, self.return_sequences)


@dataclasses.dataclass
class GRULayer(_RecurrentBase):
    """GRU (JAX :364-396): the ``gru_layer`` op, gate order ``[r, u,
    c]``. ``{lname}_Wih`` (in, 3u) and ``{lname}_Whh`` (u, 3u) drawn in
    that order; ``{lname}_bih`` and ``{lname}_bhh`` (3u,) zero. In a TBPTT
    graph h is carried."""
    n_out: int = 0
    weight_init: str = "XAVIER"
    return_sequences: bool = True

    def _init(self, draw, n_in):
        u = self.n_out
        return (draw("Wih", (n_in, 3 * u)), draw("Whh", (u, 3 * u)),
                np.zeros(3 * u), np.zeros(3 * u))

    def build_sd(self, ctx, x, itype):
        lname = ctx.lname("gru")
        w_ih, w_hh, b_ih, b_hh = self._init(
            lambda n, s: ctx.param(f"{lname}_{n}", s, self.weight_init),
            itype.dims[0])
        b_ih = ctx.sd.var(f"{lname}_bih", value=b_ih, dtype=ctx.dtype)
        b_hh = ctx.sd.var(f"{lname}_bhh", value=b_hh, dtype=ctx.dtype)
        h0, = _rnn_initial_states(ctx, lname, x, self.n_out)
        out, h_t = ctx.sd.invoke("gru_layer", [x, h0, w_ih, w_hh, b_ih, b_hh],
                                 {}, name=lname, n_outputs=2)
        _rnn_carry_states(ctx, [(h0, h_t)])
        return (out if self.return_sequences else h_t), \
            self.output_type(itype)

    def build(self, ctx, itype):
        w_ih, w_hh, b_ih, b_hh = self._init(
            lambda n, s: ctx.param(s, self.weight_init), itype.dims[0])
        return Recurrent(ctx, "gru_layer",
                         {"Wih": w_ih, "Whh": w_hh, "bih": b_ih,
                          "bhh": b_hh},
                         ("x", "h0", "Wih", "Whh", "bih", "bhh"),
                         self.n_out, self.return_sequences)


for _cls in [Yolo2OutputLayer, SpaceToDepthLayer, DepthToSpaceLayer,
             CnnLossLayer, CenterLossOutputLayer, GravesLSTMLayer,
             GRULayer]:
    LAYER_TYPES[_cls.__name__] = _cls
