"""Shape ops of the slice (counterpart of
``deeplearning4j_tpu/ops/shape_ops.py``: ``pad`` :111)."""
from __future__ import annotations

import torch.nn.functional as F


def pad(x, paddings, constant: float = 0.0):
    """Constant padding; ``paddings`` is numpy-style, one (before, after)
    pair per axis."""
    flat = []
    for before, after in reversed([tuple(p) for p in paddings]):
        flat += [before, after]
    return F.pad(x, flat, value=constant)
