"""Learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/learning/schedules.py`` (``ISchedule``
:17, the nine schedules :45-181, ``resolve_lr`` :195): the same classes,
fields, formulas and JSON form (``{"@class": name, **fields}``). The JAX
package traces a schedule into its step as float32 ``jnp`` arithmetic on
the iteration; the port resolves it on the host, in numpy float32 with
every constant rounded to float32 first, as JAX's weak-typed scalars are,
and stages the value into the step (``learning/updaters.py``). So a
captured CUDA graph reads each step's rate from a buffer. ``exp`` and
``pow`` may differ from XLA's by an ulp.

As in the JAX fit, the fit tiers resolve every schedule at epoch 0
(``autodiff/samediff.py:875-882`` there): an ``EPOCH``-type schedule
does not advance inside ``fit``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

F = np.float32


class ISchedule:
    """``value_at(iteration, epoch)`` -> the float32 value."""

    schedule_type: str = "ITERATION"  # or "EPOCH"

    def value_at(self, iteration, epoch) -> np.float32:
        raise NotImplementedError

    def _t(self, iteration, epoch) -> np.float32:
        return F(epoch if self.schedule_type == "EPOCH" else iteration)

    def to_json(self) -> dict:
        d = {"@class": type(self).__name__}
        d.update(dataclasses.asdict(self))
        return d

    @staticmethod
    def from_json(d: Optional[dict]) -> Optional["ISchedule"]:
        if d is None:
            return None
        d = dict(d)
        return _SCHEDULES[d.pop("@class")](**d)


@dataclasses.dataclass
class FixedSchedule(ISchedule):
    value: float = 1e-3

    def value_at(self, iteration, epoch):
        return F(self.value)


@dataclasses.dataclass
class ExponentialSchedule(ISchedule):
    """lr = initial * gamma^t."""
    initial_value: float = 1e-3
    gamma: float = 0.99
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return F(self.initial_value) * np.power(F(self.gamma), t)


@dataclasses.dataclass
class InverseSchedule(ISchedule):
    """lr = initial / (1 + gamma*t)^power."""
    initial_value: float = 1e-3
    gamma: float = 0.1
    power: float = 1.0
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return F(self.initial_value) / np.power(F(1.0) + F(self.gamma) * t,
                                                F(self.power))


@dataclasses.dataclass
class PolySchedule(ISchedule):
    """lr = initial * (1 - t/maxIter)^power."""
    initial_value: float = 1e-3
    power: float = 1.0
    max_iter: int = 10000
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        frac = np.clip(t / F(self.max_iter), F(0.0), F(1.0))
        return F(self.initial_value) * np.power(F(1.0) - frac,
                                                F(self.power))


@dataclasses.dataclass
class SigmoidSchedule(ISchedule):
    """lr = initial / (1 + exp(-gamma*(t - stepSize)))."""
    initial_value: float = 1e-3
    gamma: float = 0.1
    step_size: int = 100
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return F(self.initial_value) / (F(1.0) + np.exp(
            F(-self.gamma) * (t - F(self.step_size))))


@dataclasses.dataclass
class StepSchedule(ISchedule):
    """lr = initial * decayRate^floor(t/step)."""
    initial_value: float = 1e-3
    decay_rate: float = 0.5
    step: float = 1000.0
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return F(self.initial_value) * np.power(
            F(self.decay_rate), np.floor(t / F(self.step)))


@dataclasses.dataclass
class MapSchedule(ISchedule):
    """Piecewise constant over an explicit ``{t: lr}`` map, which must
    hold position 0."""
    values: Dict[int, float] = None
    schedule_type: str = "ITERATION"

    def __post_init__(self):
        if not self.values:
            raise ValueError("MapSchedule requires a values map")
        self.values = {int(k): v for k, v in self.values.items()}
        if 0 not in self.values:
            raise ValueError(
                "MapSchedule values must contain a value for position 0")

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        keys = sorted(self.values)
        out = F(self.values[keys[0]])
        for k in keys[1:]:
            if t >= F(k):
                out = F(self.values[k])
        return out


@dataclasses.dataclass
class RampSchedule(ISchedule):
    """Linear warm-up of a base schedule over ``num_iter`` iterations:
    ``clip((iteration + 1) / num_iter, 0, 1) * base``. ``base`` is the
    base schedule's JSON form (or the schedule, turned into it)."""
    base: dict = None
    num_iter: int = 1000

    def __post_init__(self):
        if self.base is None:
            raise ValueError("RampSchedule requires a base schedule")
        self._base = ISchedule.from_json(self.base) \
            if isinstance(self.base, dict) else self.base
        if not isinstance(self.base, dict):
            self.base = self._base.to_json()

    def value_at(self, iteration, epoch):
        frac = np.clip((F(iteration) + F(1.0)) / F(self.num_iter), F(0.0),
                       F(1.0))
        return frac * self._base.value_at(iteration, epoch)


@dataclasses.dataclass
class CycleSchedule(ISchedule):
    """1-cycle: a linear ramp up over ``stepSize = (cycleLength -
    annealingLength) // 2``, a linear ramp down, then ``initial *
    decay^(annealingLength - (cycleLength - pos))``."""
    initial_lr: float = 1e-3
    max_lr: float = 1e-2
    cycle_length: int = 1000
    annealing_length: int = 100
    annealing_decay: float = 0.1
    schedule_type: str = "ITERATION"

    def value_at(self, iteration, epoch):
        pos = self._t(iteration, epoch) % F(self.cycle_length)
        step_size = (self.cycle_length - self.annealing_length) // 2
        # a Python float (double), rounded once where it meets pos
        increment = F((self.max_lr - self.initial_lr) / max(step_size, 1))
        if pos < F(step_size):
            return F(self.initial_lr) + increment * pos
        if pos < F(2 * step_size):
            return F(self.max_lr) - increment * (pos - F(step_size))
        return F(self.initial_lr) * np.power(
            F(self.annealing_decay),
            F(self.annealing_length) - (F(self.cycle_length) - pos))


_SCHEDULES = {c.__name__: c for c in [
    FixedSchedule, ExponentialSchedule, InverseSchedule, PolySchedule,
    SigmoidSchedule, StepSchedule, MapSchedule, RampSchedule, CycleSchedule,
]}


def resolve_lr(lr, iteration: int, epoch: int) -> float:
    """The rate at ``(iteration, epoch)``, rounded to float32: ``lr`` is
    a number or an :class:`ISchedule`."""
    if isinstance(lr, ISchedule):
        return float(F(lr.value_at(iteration, epoch)))
    if isinstance(lr, (int, float, np.floating, np.integer)):
        return float(F(lr))
    raise TypeError(f"a learning rate is a number or an ISchedule; got "
                    f"{lr!r}")
