"""Training configuration and history.

Counterpart of ``deeplearning4j_tpu/autodiff/training.py``
(``MixedPrecision`` :33, ``TrainingConfig`` :94 with ``clip_gradients``
:196, ``to_json`` :230, its ``builder()`` :350, ``History``, ``Listener``
:385, ``ScoreIterationListener`` :419). The cast policy is that of the
JAX train step (``samediff.py`` ``_build_step_parts``): under
``MixedPrecision`` the float parameters, constants and inputs are cast to
the compute dtype at the top of the forward (integer ids stay as they
are; batch-norm running statistics stay float32); the loss is summed in
float32 and the gradients flow back through the casts into the float32
masters.

The options of the step's apply half (``regularization``,
``grad_clip_value``, ``gradient_normalization``) and of the fit tiers
(``fused_steps``, ``accum_steps``, ``sentinel``) are the JAX fields, with
its JSON form. A field of the JAX package's ``TrainingConfig`` that this
port does not honour yet is not accepted: the constructor and the
builder have no such argument (``tensorstats``, ``fingerprints``,
``sharding``, ``nan_panic``, ``analyze``, ...; ROADMAP queue 1 items 3,
7 and 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.learning.regularization import Regularization
from deeplearning4j_tpu_torch.learning.updaters import IUpdater
from deeplearning4j_tpu_torch.ops.dtypes import torch_dtype

#: the gradient normalization modes of ``TrainingConfig.clip_gradients_``
#: (``clip_by_global_norm`` is an alias of ``clip_l2_global``)
GRADIENT_NORMALIZATIONS = ("clip_element_wise_absolute_value",
                           "clip_l2_per_layer", "clip_l2_global",
                           "clip_by_global_norm", "renormalize_l2_per_layer")


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

    def to_json(self) -> dict:
        return {"compute_dtype": self.compute_dtype,
                "loss_scale": self.loss_scale,
                "softmax_dtype": self.softmax_dtype}

    @staticmethod
    def from_json(d) -> "Optional[MixedPrecision]":
        if d is None:
            return None
        return MixedPrecision(compute_dtype=d.get("compute_dtype", "bfloat16"),
                              loss_scale=d.get("loss_scale"),
                              softmax_dtype=d.get("softmax_dtype",
                                                  d.get("ce_tail_dtype")))


# ce_tail_dtype is both a constructor alias (the InitVar) and a read alias
# of softmax_dtype; attached after the class, since a property in the body
# would shadow the InitVar's default
MixedPrecision.ce_tail_dtype = property(lambda self: self.softmax_dtype)


@dataclasses.dataclass
class TrainingConfig:
    updater: IUpdater
    data_set_feature_mapping: Sequence[str] = ()
    data_set_label_mapping: Sequence[str] = ()
    # L1/L2 change the gradient before the updater, WeightDecay the
    # update after it (autodiff/step.py)
    regularization: Sequence[Regularization] = ()
    grad_clip_value: Optional[float] = None
    iteration_count: int = 0
    epoch_count: int = 0
    mixed_precision: Optional[MixedPrecision] = None
    # None or one of GRADIENT_NORMALIZATIONS
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    # K > 1: fit runs K steps a dispatch (autodiff/window.py)
    fused_steps: int = 1
    # N > 1: the updater applies the mean of N micro-steps' gradients
    # every N-th step (an effective batch of N batches); forces the
    # fused-window tier
    accum_steps: int = 1
    # the device-side divergence sentinel: a TrainingDivergedError names
    # the first step whose loss or gradients went non-finite, read at the
    # flushes the fit already makes; the parameter math is unchanged
    sentinel: bool = False

    def __post_init__(self):
        self.fused_steps = int(self.fused_steps)
        self.accum_steps = int(self.accum_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got "
                             f"{self.accum_steps}")
        self.sentinel = bool(self.sentinel)
        self.regularization = list(self.regularization or ())
        mode = (self.gradient_normalization or "none").lower()
        if mode not in ("none", "") + GRADIENT_NORMALIZATIONS:
            raise ValueError(f"unknown gradient_normalization {mode!r}; "
                             f"known: {', '.join(GRADIENT_NORMALIZATIONS)}")
        self.data_set_feature_mapping = list(self.data_set_feature_mapping)
        self.data_set_label_mapping = list(self.data_set_label_mapping)

    @torch.no_grad()
    def clip_gradients_(self, grads: List[torch.Tensor]) -> None:
        """The elementwise clip, then the configured normalization mode,
        on ``grads`` in place (JAX ``clip_gradients``: the same modes,
        formulas and eps). A norm is a device tensor: no host sync."""
        if self.grad_clip_value is not None:
            c = float(self.grad_clip_value)
            torch._foreach_clamp_min_(grads, -c)
            torch._foreach_clamp_max_(grads, c)
        mode = (self.gradient_normalization or "none").lower()
        if mode in ("none", "") or not grads:
            return
        t = float(self.gradient_normalization_threshold)
        eps = 1e-8
        if mode == "clip_element_wise_absolute_value":
            torch._foreach_clamp_min_(grads, -t)
            torch._foreach_clamp_max_(grads, t)
            return
        sq = [torch.sum(torch.square(g)) for g in grads]
        if mode in ("clip_l2_global", "clip_by_global_norm"):
            total = sq[0]
            for s in sq[1:]:
                total = total + s
            # t / x, a division (Tensor.__rtruediv__ multiplies by 1/x)
            scale = torch.clamp_max(torch.full_like(total, t) / (
                torch.sqrt(total) + eps), 1.0)
            torch._foreach_mul_(grads, scale)
            return
        for g, s in zip(grads, sq):
            if mode == "clip_l2_per_layer":
                g.mul_(torch.clamp_max(torch.full_like(s, t) / (
                    torch.sqrt(s) + eps), 1.0))
            else:                               # renormalize_l2_per_layer
                g.div_(torch.sqrt(s) + eps)

    def to_json(self) -> dict:
        return {
            "updater": self.updater.to_json(),
            "data_set_feature_mapping": list(self.data_set_feature_mapping),
            "data_set_label_mapping": list(self.data_set_label_mapping),
            "regularization": [r.to_json() for r in self.regularization],
            "grad_clip_value": self.grad_clip_value,
            "iteration_count": self.iteration_count,
            "epoch_count": self.epoch_count,
            "mixed_precision": (self.mixed_precision.to_json()
                                if self.mixed_precision else None),
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "fused_steps": self.fused_steps,
            "accum_steps": self.accum_steps,
            "sentinel": self.sentinel,
        }

    @staticmethod
    def from_json(d: dict) -> "TrainingConfig":
        """The JAX package's JSON form. A field this port does not
        honour yet, set to something other than its default, is refused
        by name."""
        for key, item in (("sharding", "9: parallel/"),
                          ("tensorstats", "7: monitor/tensorstats"),
                          ("fingerprints", "7: integrity/")):
            if d.get(key):
                raise NotImplementedError(
                    f"TrainingConfig.{key} is not ported yet (ROADMAP "
                    f"queue 1 item {item})")
        return TrainingConfig(
            updater=IUpdater.from_json(d["updater"]),
            data_set_feature_mapping=d.get("data_set_feature_mapping", []),
            data_set_label_mapping=d.get("data_set_label_mapping", []),
            regularization=[Regularization.from_json(r)
                            for r in d.get("regularization", [])],
            grad_clip_value=d.get("grad_clip_value"),
            iteration_count=d.get("iteration_count", 0),
            epoch_count=d.get("epoch_count", 0),
            mixed_precision=MixedPrecision.from_json(
                d.get("mixed_precision")),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
            fused_steps=d.get("fused_steps", 1),
            accum_steps=d.get("accum_steps", 1),
            sentinel=d.get("sentinel", False))

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

        def regularization(self, *regs):
            self._kw["regularization"] = list(regs)
            return self

        def grad_clip_value(self, v):
            self._kw["grad_clip_value"] = v
            return self

        def mixed_precision(self, mp):
            self._kw["mixed_precision"] = MixedPrecision() if mp is True \
                else mp
            return self

        def gradient_normalization(self, mode, threshold: float = 1.0):
            self._kw["gradient_normalization"] = mode
            self._kw["gradient_normalization_threshold"] = threshold
            return self

        def fused_steps(self, k: int):
            self._kw["fused_steps"] = int(k)
            return self

        def accum_steps(self, n: int):
            self._kw["accum_steps"] = int(n)
            return self

        def sentinel(self, on: bool = True):
            self._kw["sentinel"] = bool(on)
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
