"""Gradient updaters, applied in place on float32 master parameters.

Counterpart of ``deeplearning4j_tpu/learning/updaters.py`` (``IUpdater``,
``Sgd``, ``Nesterovs`` :95, ``Adam`` :112), with the same update rules:
the JAX package computes ``updates`` and returns ``params - updates``;
here each leaf is updated in place under ``torch.no_grad()``, which keeps
one copy of the weights and of the state.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.learning.schedules import resolve_lr


class IUpdater:
    """``init(params) -> state``; ``apply_(params, grads, state, iteration)``
    updates ``params`` and ``state`` in place (``p -= update``)."""

    def init(self, params: Sequence[torch.Tensor]) -> List[Tuple]:
        return [self._leaf_init(p) for p in params]

    @torch.no_grad()
    def apply_(self, params, grads, state, iteration: int,
               epoch: int = 0) -> None:
        lr = resolve_lr(getattr(self, "learning_rate", 0.0), iteration, epoch)
        for p, g, s in zip(params, grads, state):
            self._leaf_apply_(p, g, s, lr)

    def _leaf_init(self, p) -> Tuple:
        return ()

    def _leaf_apply_(self, p, g, s, lr: float) -> None:
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class Sgd(IUpdater):
    """update = lr * g"""
    learning_rate: float = 1e-3

    def _leaf_apply_(self, p, g, s, lr):
        p.sub_(g * lr)


@dataclasses.dataclass(eq=False)
class Nesterovs(IUpdater):
    """v' = mu*v - lr*g; update = mu*v - (1+mu)*v'"""
    learning_rate: float = 0.1
    momentum: float = 0.9

    def _leaf_init(self, p):
        return (torch.zeros_like(p),)

    def _leaf_apply_(self, p, g, s, lr):
        (v,) = s
        mu = self.momentum
        update = v * mu                      # mu * v, before v moves on
        v.mul_(mu).sub_(g * lr)              # v' = mu*v - lr*g
        update.sub_(v * (1.0 + mu))          # mu*v - (1+mu)*v'
        p.sub_(update)


@dataclasses.dataclass(eq=False)
class Adam(IUpdater):
    """m' = b1*m + (1-b1)*g; v' = b2*v + (1-b2)*g^2;
    update = alphat * m' / (sqrt(v') + eps) with the reference's
    ``alphat = lr * sqrt(1 - b2^t) / (1 - b1^t)``, t = iteration + 1.

    ``alphat`` is computed on the host in float32, as the JAX package
    computes it (``1 - b2^t`` in float32 is what it divides by). The
    leaves are updated together with PyTorch's multi-tensor (``_foreach``)
    ops, a few launches per step for all of them."""
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def _leaf_init(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p))

    def alphat(self, lr: float, iteration: int) -> float:
        f = np.float32
        t = f(iteration + 1)
        return float(f(lr) * np.sqrt(f(1.0) - f(self.beta2) ** t)
                     / (f(1.0) - f(self.beta1) ** t))

    @torch.no_grad()
    def apply_(self, params, grads, state, iteration: int,
               epoch: int = 0) -> None:
        params, grads = list(params), list(grads)
        if not params:
            return
        lr = resolve_lr(self.learning_rate, iteration, epoch)
        ms = [s[0] for s in state]
        vs = [s[1] for s in state]
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_addcdiv_(params, ms, denom,
                                value=-self.alphat(lr, iteration))
