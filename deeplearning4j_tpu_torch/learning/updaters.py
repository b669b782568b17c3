"""Gradient updaters, applied in place on float32 master parameters.

Counterpart of ``deeplearning4j_tpu/learning/updaters.py`` (``IUpdater``,
``Sgd``, ``Nesterovs`` :95), with the same update rules: the JAX package
computes ``updates`` and returns ``params - updates``; here each leaf is
updated in place under ``torch.no_grad()``, which keeps one copy of the
weights and of the state.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

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
