"""Random ops (counterpart of ``deeplearning4j_tpu/ops/random.py``:
``dropout`` :104-114, ``alpha_dropout`` :117, ``gaussian_dropout`` :130,
``gaussian_noise`` :138 and ``spatial_dropout`` :145-157). Of the JAX
module's random ops the port has these five; the others are refused by
name (ROADMAP queue 1 item 5), and the fit tiers refuse a graph that holds
one (``autodiff/window.py`` ``refuse_random_ops``).

The JAX package keys a random op by ``fold_in(fold_in(key(base_seed),
iteration), node)`` inside the compiled step. The port's step draws on the
card from the same three things (``kernels/dropout.py``): the train step
runs its forward inside :func:`rng_scope`, which names two int64 device
tensors, the fit's base seed and the step's absolute iteration, that the
fit tiers stage before each step or replay; the op records its node index
when it is recorded (``SameDiff.invoke``) or built
(``ComputationGraph``). Outside a fit (``output(training=True)``,
``calculate_gradients``) the owner opens a scope of its own.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import dropout as dropout_kernel
from deeplearning4j_tpu_torch.ops.registry import op

_R = "random"

#: the random ops the port has; a graph tier refuses any other
PORTED_RANDOM_OPS = ("dropout", "alpha_dropout", "gaussian_dropout",
                     "gaussian_noise", "spatial_dropout")

_RNG: contextvars.ContextVar = contextvars.ContextVar("dl4j_torch_rng",
                                                      default=None)


@contextlib.contextmanager
def rng_scope(seed: torch.Tensor, iteration: torch.Tensor):
    """While active, a random op draws with the base seed ``seed`` at the
    step ``iteration`` (one int64 each, on the op's device)."""
    token = _RNG.set((seed, iteration))
    try:
        yield
    finally:
        _RNG.reset(token)


def current_rng() -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    return _RNG.get()


def host_rng(seed: int, iteration: int, device) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """A scope's tensors for a call outside a fit."""
    return (torch.tensor([int(seed)], dtype=torch.int64, device=device),
            torch.tensor([int(iteration)], dtype=torch.int64, device=device))


@op("dropout", _R, n_inputs=1)
def dropout(x, p: float, node: int = 0, training: bool = True):
    """Inverted dropout: ``p`` is the RETAIN probability (the JAX op's and
    the reference's convention), ``where(keep, x / p, 0)``. Draws with the
    active :func:`rng_scope`; with none active it raises, since a draw
    keyed by nothing would repeat."""
    if not training or p >= 1.0:
        return x
    rng = _RNG.get()
    if rng is None:
        raise RuntimeError("dropout outside a step's rng_scope: the mask "
                           "needs the fit's base seed and the iteration")
    seed, iteration = rng
    return dropout_kernel.dropout(x, p, seed, iteration, node)


def _scope(name: str):
    rng = _RNG.get()
    if rng is None:
        raise RuntimeError(f"{name} outside a step's rng_scope: the draw "
                           f"needs the fit's base seed and the iteration")
    return rng


@op("alpha_dropout", _R, n_inputs=1)
def alpha_dropout(x, p: float, node: int = 0, training: bool = True):
    """SELU-compatible dropout, ``p`` the retain probability: ``a *
    where(keep, x, alpha') + b`` with the JAX op's constants
    (``kernels/dropout.py`` ``alpha_constants``)."""
    if not training or p >= 1.0:
        return x
    return dropout_kernel.noise("alpha_dropout", x,
                                *_scope("alpha_dropout"), node, p=p)


@op("gaussian_dropout", _R, n_inputs=1)
def gaussian_dropout(x, rate: float, node: int = 0, training: bool = True):
    """``x * (1 + s n)``, ``n`` standard normal, ``s = sqrt(rate / (1 -
    rate))``."""
    if not training or rate <= 0.0:
        return x
    stddev = (rate / (1.0 - rate)) ** 0.5
    return dropout_kernel.noise("gaussian_dropout", x,
                                *_scope("gaussian_dropout"), node,
                                stddev=stddev)


@op("gaussian_noise", _R, n_inputs=1)
def gaussian_noise(x, stddev: float, node: int = 0, training: bool = True):
    """``x + stddev * n``, ``n`` standard normal."""
    if not training:
        return x
    return dropout_kernel.noise("gaussian_noise", x,
                                *_scope("gaussian_noise"), node,
                                stddev=stddev)


@op("spatial_dropout", _R, n_inputs=1)
def spatial_dropout(x, p: float, node: int = 0, training: bool = True,
                    channel_axis: int = -1):
    """Channel-wise inverted dropout: one keep a (batch, channel), the
    whole map or sequence of a channel kept or dropped together; ``p`` the
    retain probability."""
    if not training or p >= 1.0:
        return x
    return dropout_kernel.noise("spatial_dropout", x,
                                *_scope("spatial_dropout"), node, p=p,
                                channel_axis=channel_axis)
