"""Regularization of the gradients (L1, L2) and of the update (weight
decay).

Counterpart of ``deeplearning4j_tpu/learning/regularization.py``
(``L2Regularization`` :33, ``L1Regularization`` :42, ``WeightDecay`` :51):
the same classes, fields, ``apply_step`` and JSON form. The JAX package
maps ``apply(param, grad_or_update, lr)`` over the leaves; the port's
:meth:`Regularization.apply_` updates a group of leaves in place with
multi-tensor (``_foreach``) ops, the JAX expression's operations in its
order (the product, then the sum), on the parameters before the step's
update. ``lr`` is the step's learning rate, a 0-d float32 tensor on the
device (``autodiff/step.py`` stages it), so a captured CUDA graph reads
each step's value.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch


class Regularization:
    apply_step: str = "BEFORE_UPDATER"  # or "POST_UPDATER"

    def apply_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               lr: torch.Tensor) -> None:
        """``grads`` (the gradients, or the updates after the updater)
        regularized in place."""
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {"@class": type(self).__name__}
        d.update(dataclasses.asdict(self))
        return d

    @staticmethod
    def from_json(d: dict) -> "Regularization":
        d = dict(d)
        return _REGS[d.pop("@class")](**d)


@dataclasses.dataclass
class L2Regularization(Regularization):
    """grad += l2 * param."""
    l2: float = 0.0

    def apply_(self, params, grads, lr):
        torch._foreach_add_(grads, torch._foreach_mul(params, self.l2))


@dataclasses.dataclass
class L1Regularization(Regularization):
    """grad += l1 * sign(param)."""
    l1: float = 0.0

    def apply_(self, params, grads, lr):
        s = torch._foreach_sign(params)
        torch._foreach_mul_(s, self.l1)
        torch._foreach_add_(grads, s)


@dataclasses.dataclass
class WeightDecay(Regularization):
    """update += coeff * lr * param (``apply_lr``; else coeff * param),
    after the updater, so that an adaptive updater does not rescale it."""
    coeff: float = 0.0
    apply_lr: bool = True
    apply_step: str = "POST_UPDATER"

    def apply_(self, params, grads, lr):
        # (coeff * lr) * param, as the JAX expression groups it
        c = lr * self.coeff if self.apply_lr else self.coeff
        torch._foreach_add_(grads, torch._foreach_mul(params, c))


_REGS: Dict[str, type] = {c.__name__: c for c in
                          [L1Regularization, L2Regularization, WeightDecay]}
