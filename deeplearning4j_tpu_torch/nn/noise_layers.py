"""Noise layers (counterpart of ``deeplearning4j_tpu/nn/noise_layers.py``
:21-92): Gaussian noise, Gaussian dropout, alpha dropout and spatial
dropout, each its random op of ``ops/random.py`` in the training graph
only (the inference graph's layer is the identity). The ops draw on the
card from the fit's base seed, the step's iteration and the node's index
(``kernels/dropout.py``), so a replayed fit window draws new noise each
step. ``dropout`` is the *retain* probability, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

from torch import nn

from deeplearning4j_tpu_torch.nn.layers import LAYER_TYPES, BaseLayer
from deeplearning4j_tpu_torch.ops import random as random_ops


class Noise(nn.Module):
    """A random op of ``ops/random.py`` in training mode, the identity in
    inference mode; ``node`` keys its draws."""

    def __init__(self, op: str, node: int, **attrs):
        super().__init__()
        self.op, self.node, self.attrs = op, int(node), attrs

    def forward(self, x):
        if not self.training:
            return x
        return getattr(random_ops, self.op)(x, node=self.node, **self.attrs)


class _NoiseLayer(BaseLayer):
    def output_type(self, itype):
        return itype

    def _active(self) -> bool:
        raise NotImplementedError

    def _call(self, itype, cnn_format: str):
        """(op, attrs) of the layer's draw."""
        raise NotImplementedError

    def build_sd(self, ctx, x, itype):
        if not ctx.training or not self._active():
            return x, itype
        op, attrs = self._call(itype, ctx.cnn_format)
        return ctx.sd.invoke(op, [x], attrs,
                             name=ctx.lname(self._kind)), itype

    def build(self, ctx, itype):
        if not self._active():
            return nn.Identity()
        op, attrs = self._call(itype, "NCHW")
        return Noise(op, ctx.node, **attrs)


@dataclasses.dataclass
class GaussianNoiseLayer(_NoiseLayer):
    """Additive N(0, stddev) noise at train time (JAX :21-35)."""
    stddev: float = 0.1
    _kind = "gnoise"

    def _active(self):
        return self.stddev > 0

    def _call(self, itype, cnn_format):
        return "gaussian_noise", {"stddev": self.stddev}


@dataclasses.dataclass
class GaussianDropoutLayer(_NoiseLayer):
    """Multiplicative N(1, rate / (1 - rate)) noise (JAX :38-51)."""
    rate: float = 0.1
    _kind = "gdrop"

    def _active(self):
        return self.rate > 0

    def _call(self, itype, cnn_format):
        return "gaussian_dropout", {"rate": self.rate}


@dataclasses.dataclass
class AlphaDropoutLayer(_NoiseLayer):
    """SELU-compatible dropout (JAX :54-68)."""
    dropout: float = 0.95
    _kind = "adrop"

    def _active(self):
        return self.dropout < 1.0

    def _call(self, itype, cnn_format):
        return "alpha_dropout", {"p": self.dropout}


@dataclasses.dataclass
class SpatialDropoutLayer(_NoiseLayer):
    """Whole-channel dropout of cnn maps or (B, T, C) sequences (JAX
    :71-88): the channel axis is the layout's (1 for NCHW, -1 for NHWC
    and sequences)."""
    dropout: float = 0.9
    _kind = "sdrop"

    def _active(self):
        return self.dropout < 1.0

    def _call(self, itype, cnn_format):
        axis = -1
        if itype.kind == "cnn" and not cnn_format.endswith("C"):
            axis = 1
        return "spatial_dropout", {"p": self.dropout, "channel_axis": axis}


for _cls in [GaussianNoiseLayer, GaussianDropoutLayer, AlphaDropoutLayer,
             SpatialDropoutLayer]:
    LAYER_TYPES[_cls.__name__] = _cls
