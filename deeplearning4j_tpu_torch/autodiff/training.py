"""Training configuration and history.

Counterpart of ``deeplearning4j_tpu/autodiff/training.py``
(``MixedPrecision`` :33, ``TrainingConfig`` :94 with its ``builder()``
:350, ``History``, ``Listener`` :385, ``ScoreIterationListener`` :419). The cast policy is that of the JAX train step
(``samediff.py`` ``_build_step_parts``): under ``MixedPrecision`` the
float parameters, constants and inputs are cast to the compute dtype at
the top of the forward (integer ids stay as they are; batch-norm running
statistics stay float32); the loss is summed in float32 and the
gradients flow back through the casts into the float32 masters.

A field of the JAX package's ``TrainingConfig`` that this port does not
honour yet is not accepted: the constructor and the builder have no such
argument (``accum_steps``, ``sentinel``, ...).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.learning.updaters import IUpdater
from deeplearning4j_tpu_torch.ops.dtypes import torch_dtype


@dataclasses.dataclass
class MixedPrecision:
    """Compute in ``compute_dtype`` with float32 master parameters.

    ``loss_scale``: optional static loss scaling (the loss is multiplied
    before the backward and the gradients divided after it).
    ``softmax_dtype`` (alias ``ce_tail_dtype``): the dtype of the
    softmax-CE losses' log-softmax tail; None keeps it float32.
    """
    compute_dtype: str = "bfloat16"
    loss_scale: Optional[float] = None
    softmax_dtype: Optional[str] = None
    ce_tail_dtype: dataclasses.InitVar[Optional[str]] = None

    def __post_init__(self, ce_tail_dtype: Optional[str]) -> None:
        if ce_tail_dtype is not None:
            if (self.softmax_dtype is not None
                    and self.softmax_dtype != ce_tail_dtype):
                raise ValueError(
                    f"softmax_dtype={self.softmax_dtype!r} and its alias "
                    f"ce_tail_dtype={ce_tail_dtype!r} disagree; pass one")
            self.softmax_dtype = ce_tail_dtype

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)


# ce_tail_dtype is both a constructor alias (the InitVar) and a read alias
# of softmax_dtype; attached after the class, since a property in the body
# would shadow the InitVar's default
MixedPrecision.ce_tail_dtype = property(lambda self: self.softmax_dtype)


@dataclasses.dataclass
class TrainingConfig:
    updater: IUpdater
    data_set_feature_mapping: Sequence[str] = ()
    data_set_label_mapping: Sequence[str] = ()
    iteration_count: int = 0
    epoch_count: int = 0
    mixed_precision: Optional[MixedPrecision] = None
    # K > 1: fit runs K steps a dispatch (autodiff/window.py)
    fused_steps: int = 1

    def __post_init__(self):
        self.fused_steps = int(self.fused_steps)
        self.data_set_feature_mapping = list(self.data_set_feature_mapping)
        self.data_set_label_mapping = list(self.data_set_label_mapping)

    class Builder:
        """Fluent builder (the reference's TrainingConfig.Builder), for the
        fields this port honours."""

        def __init__(self):
            self._kw: Dict[str, Any] = {}

        def updater(self, u):
            self._kw["updater"] = u
            return self

        def data_set_feature_mapping(self, *names):
            self._kw["data_set_feature_mapping"] = list(names)
            return self

        def data_set_label_mapping(self, *names):
            self._kw["data_set_label_mapping"] = list(names)
            return self

        def mixed_precision(self, mp):
            self._kw["mixed_precision"] = MixedPrecision() if mp is True \
                else mp
            return self

        def fused_steps(self, k: int):
            self._kw["fused_steps"] = int(k)
            return self

        def build(self) -> "TrainingConfig":
            return TrainingConfig(**self._kw)

    @staticmethod
    def builder() -> "TrainingConfig.Builder":
        return TrainingConfig.Builder()


class History:
    """Per-epoch mean losses of one ``fit``, and every step's loss
    (reference: listeners.records.History)."""

    def __init__(self):
        self.epoch_losses: List[float] = []
        self.step_losses: List[float] = []

    def add_epoch(self, epoch: int, mean_loss: float,
                  step_losses: Sequence[float] = ()) -> None:
        self.epoch_losses.append(float(mean_loss))
        self.step_losses.extend(float(v) for v in step_losses)

    def final_loss(self) -> float:
        return self.epoch_losses[-1] if self.epoch_losses else float("nan")


class Listener:
    """Training listener (reference: autodiff.listeners.Listener). Return
    False from ``on_epoch_end`` to stop.

    Losses stay on the device during a fit; ``fit`` fetches them once
    every ``frequency`` steps (the smallest of its listeners') and
    delivers the burst through ``iterations_done``, whose default replays
    ``iteration_done`` step by step."""

    #: how often (in iterations) this listener needs losses delivered
    frequency: int = 10

    def on_training_start(self, sd): ...
    def on_training_end(self, sd): ...
    def on_epoch_start(self, sd, epoch: int): ...
    def on_epoch_end(self, sd, epoch: int, mean_loss: float): ...
    def iteration_done(self, sd, epoch: int, iteration: int,
                       loss: float): ...

    def iterations_done(self, sd, epoch: int, iterations: Sequence[int],
                        losses: Sequence[float]):
        for it, lo in zip(iterations, losses):
            self.iteration_done(sd, epoch, it, lo)


class ScoreIterationListener(Listener):
    """Print the score every ``print_every`` iterations (reference:
    optimize/listeners/ScoreIterationListener)."""

    def __init__(self, print_every: int = 10, print_fn=print):
        self.print_every = print_every
        self.frequency = print_every
        self.print_fn = print_fn

    def iteration_done(self, sd, epoch, iteration, loss):
        if iteration % self.print_every == 0:
            self.print_fn(f"Score at iteration {iteration} is {loss}")
