"""Elementwise ops of the slice (counterpart of
``deeplearning4j_tpu/ops/elementwise.py``: ``relu`` :97, ``softmax`` :233)."""
from __future__ import annotations

import torch


def relu(x):
    return torch.relu(x)


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)
