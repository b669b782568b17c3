"""Learning-rate resolution (counterpart of
``deeplearning4j_tpu/learning/schedules.py``). This slice of the port
takes constant learning rates only; schedules come later."""
from __future__ import annotations

import numpy as np


def resolve_lr(lr, iteration: int, epoch: int) -> float:
    if not isinstance(lr, (int, float)):
        raise NotImplementedError(
            f"learning-rate schedules are not ported yet; got {lr!r}")
    # the JAX package resolves the rate to a float32 scalar
    return float(np.float32(lr))
