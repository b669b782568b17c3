"""Convolution-family layers beyond ``layers.py`` (counterpart of
``deeplearning4j_tpu/nn/conv_layers.py``: ``ZeroPaddingLayer`` :343)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from deeplearning4j_tpu_torch.nn.layers import (LAYER_TYPES, BaseLayer,
                                                InputType)
from deeplearning4j_tpu_torch.ops.shape_ops import pad


class ZeroPad2d(nn.Module):
    def __init__(self, padding):
        super().__init__()
        self.padding = tuple(padding)

    def forward(self, x):
        t, b, l, r = self.padding
        out = pad(x, ((0, 0), (0, 0), (t, b), (l, r)))
        return out.contiguous(memory_format=torch.channels_last)


@dataclasses.dataclass
class ZeroPaddingLayer(BaseLayer):
    """padding = (top, bottom, left, right)."""
    padding: Tuple[int, int, int, int] = (1, 1, 1, 1)

    def output_type(self, itype):
        c, h, w = itype.dims
        t, b, l, r = self.padding
        return InputType("cnn", (c, h + t + b, w + l + r))

    def build(self, ctx, itype):
        return ZeroPad2d(self.padding)


LAYER_TYPES["ZeroPaddingLayer"] = ZeroPaddingLayer
