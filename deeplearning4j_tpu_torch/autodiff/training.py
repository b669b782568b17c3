"""Training configuration and history.

Counterpart of ``deeplearning4j_tpu/autodiff/training.py``
(``MixedPrecision`` :33, ``TrainingConfig`` :94, ``History``). The cast
policy is that of the JAX train step (``samediff.py`` ``_build_step_parts``):
under ``MixedPrecision`` the parameters (``gamma``/``beta`` included), the
inputs and the labels are cast to the compute dtype at the top of the
forward, while batch-norm running statistics stay float32; the loss is
summed in float32 and the gradients flow back through the casts into the
float32 masters.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from deeplearning4j_tpu_torch.learning.updaters import IUpdater

_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


@dataclasses.dataclass
class MixedPrecision:
    """Compute in ``compute_dtype`` with float32 master parameters."""
    compute_dtype: str = "bfloat16"

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)


@dataclasses.dataclass
class TrainingConfig:
    updater: IUpdater
    iteration_count: int = 0


class History:
    """Per-epoch mean losses of one ``fit`` (reference:
    listeners.records.History)."""

    def __init__(self):
        self.epoch_losses: List[float] = []

    def add_epoch(self, epoch: int, mean_loss: float) -> None:
        self.epoch_losses.append(float(mean_loss))

    def final_loss(self) -> float:
        return self.epoch_losses[-1] if self.epoch_losses else float("nan")
