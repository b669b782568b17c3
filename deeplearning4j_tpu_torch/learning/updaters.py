"""Gradient updaters, applied in place on float32 master parameters.

Counterpart of ``deeplearning4j_tpu/learning/updaters.py`` (``IUpdater``,
``Sgd``, ``Nesterovs`` :95, ``Adam`` :112), with the same update rules:
the JAX package computes ``updates`` and returns ``params - updates``;
here the leaves are updated in place under ``torch.no_grad()``, which
keeps one copy of the weights and of the state, with PyTorch's
multi-tensor (``_foreach``) ops: a few launches a step for all the
leaves. ``IUpdater.update_plain_`` (one leaf at a time, ``Sgd`` and
``Nesterovs``) is the plain version the tests hold them to.

What changes from step to step (the learning rate, Adam's ``alphat``) is
one scalar a step, computed on the host in float32, as the JAX package
computes it, by ``step_scalars`` (the learning rate, a number or a
schedule, resolved by ``learning/schedules.py``); it reaches the update
as a 0-d tensor on the parameters' device (``update_``'s ``scal``),
which the caller fills before the step (``autodiff/window.py``
``stage_``). So an update captured once in a CUDA graph reads the value
a fit tier wrote into that tensor before each replay, instead of the
first step's value frozen into the graph. ``update_``'s ``post`` sees
each group's update before it is subtracted: the post-updater
regularization (``WeightDecay``) of the JAX apply half.

The JSON form is the JAX package's (``{"@class": name, **fields}``, a
schedule in its own JSON form); the JAX updaters this port does not have
yet are refused by name (:func:`IUpdater.from_json`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.learning.schedules import ISchedule, resolve_lr

#: ``post(lo, hi, update)``: the update of leaves ``lo:hi``, changed in
#: place before it is subtracted from them
Post = Optional[Callable[[int, int, List[torch.Tensor]], None]]

#: the JAX package's updaters that this port does not have yet
NOT_PORTED = ("NoOp", "AdaMax", "Nadam", "AMSGrad", "AdaBelief", "AdaDelta",
              "AdaGrad", "RmsProp")


def stage_(dst: torch.Tensor, src) -> None:
    """Copy ``src`` (a numpy array or a tensor) into ``dst`` in place; a
    host array goes through pinned memory, with a copy that does not
    wait for the device. How every caller hands the updater its step's
    scalars (:meth:`IUpdater.apply_`, the fit tiers, ``ComputationGraph``).
    """
    if isinstance(src, torch.Tensor) and src.device.type != "cpu":
        dst.copy_(src)
        return
    t = torch.from_numpy(np.ascontiguousarray(src)) \
        if isinstance(src, np.ndarray) else src
    t = t.to(dst.dtype)
    if dst.device.type == "cuda":
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)


class IUpdater:
    """``init(params) -> state``; ``update_(params, grads, state, scal)``
    updates ``params`` and ``state`` in place (``p -= update``), with
    ``scal`` the step's value of :meth:`step_scalars`, a 0-d tensor on
    the device; ``apply_(params, grads, state, iteration)`` does one step
    with the scalar staged into a new tensor."""

    def init(self, params: Sequence[torch.Tensor]) -> List[Tuple]:
        return [self._leaf_init(p) for p in params]

    def step_scalars(self, iterations: Sequence[int],
                     epoch: int = 0) -> np.ndarray:
        """(len(iterations),) float32: each step's scalar."""
        return np.array([self._scalar(it, epoch) for it in iterations],
                        np.float32)

    def learning_rates(self, iterations: Sequence[int],
                       epoch: int = 0) -> np.ndarray:
        """(len(iterations),) float32: each step's learning rate."""
        return np.array([resolve_lr(getattr(self, "learning_rate", 0.0),
                                    it, epoch) for it in iterations],
                        np.float32)

    def _scalar(self, iteration: int, epoch: int) -> float:
        """The learning rate, resolved as the JAX package resolves it."""
        return resolve_lr(getattr(self, "learning_rate", 0.0), iteration,
                          epoch)

    def apply_(self, params, grads, state, iteration: int,
               epoch: int = 0) -> None:
        params = list(params)
        if not params:
            return
        scal = torch.zeros(1, dtype=torch.float32, device=params[0].device)
        stage_(scal, self.step_scalars([iteration], epoch))
        self.update_(params, grads, state, scal[0])

    def update_(self, params, grads, state, scal: torch.Tensor,
                post: Post = None) -> None:
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {"@class": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = v.to_json() if isinstance(v, ISchedule) else v
        return d

    @staticmethod
    def from_json(d: dict) -> "IUpdater":
        d = dict(d)
        name = d.pop("@class")
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"the {name} updater is not ported yet (ROADMAP queue 1 "
                f"item 3: the other eight updaters)")
        kw = {k: ISchedule.from_json(v)
              if isinstance(v, dict) and "@class" in v else v
              for k, v in d.items()}
        return UPDATERS[name](**kw)

    @torch.no_grad()
    def update_plain_(self, params, grads, state, scal: torch.Tensor) -> None:
        """The update one leaf at a time (``_leaf_apply_``): the plain
        version the tests hold :meth:`update_` to. Nothing else calls
        it."""
        for p, g, s in zip(params, grads, state):
            self._leaf_apply_(p, g, s, scal)

    def _leaf_init(self, p) -> Tuple:
        return ()

    def _leaf_apply_(self, p, g, s, lr: torch.Tensor) -> None:
        raise NotImplementedError


#: elements a group of leaves holds at most where an update makes
#: parameter-sized temporaries (a leaf larger than this is a group of
#: its own), so a large model holds group-sized temporaries
GROUP = 1 << 26


def _groups(params: List[torch.Tensor]):
    """``(lo, hi)`` index ranges of consecutive leaves, each at most
    ``GROUP`` elements (or one leaf)."""
    lo = 0
    while lo < len(params):
        hi, n = lo + 1, params[lo].numel()
        while hi < len(params) and n + params[hi].numel() <= GROUP:
            n += params[hi].numel()
            hi += 1
        yield lo, hi
        lo = hi


@dataclasses.dataclass(eq=False)
class Sgd(IUpdater):
    """update = lr * g. :meth:`update_` runs the leaves together with
    multi-tensor (``_foreach``) ops, the per-leaf expression's operations
    in its order."""
    learning_rate: float = 1e-3

    def _leaf_apply_(self, p, g, s, lr):
        p.sub_(g * lr)

    @torch.no_grad()
    def update_(self, params, grads, state, scal, post=None) -> None:
        params, grads = list(params), list(grads)
        for lo, hi in _groups(params):
            update = torch._foreach_mul(grads[lo:hi], scal)
            if post is not None:
                post(lo, hi, update)
            torch._foreach_sub_(params[lo:hi], update)
            del update


@dataclasses.dataclass(eq=False)
class Nesterovs(IUpdater):
    """v' = mu*v - lr*g; update = mu*v - (1+mu)*v'. :meth:`update_` runs
    the leaves together with multi-tensor (``_foreach``) ops, in the JAX
    expression's order: ``update = mu*v``, ``v' = mu*v - lr*g``,
    ``update -= (1+mu)*v'``, ``p -= update``; each per-leaf operation of
    ``_leaf_apply_`` is one op over a group of leaves."""
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

    @torch.no_grad()
    def update_(self, params, grads, state, scal, post=None) -> None:
        params, grads = list(params), list(grads)
        vs = [s[0] for s in state]
        mu = self.momentum
        for lo, hi in _groups(params):
            v = vs[lo:hi]
            update = torch._foreach_mul(v, mu)
            torch._foreach_mul_(v, mu)
            tmp = torch._foreach_mul(grads[lo:hi], scal)
            torch._foreach_sub_(v, tmp)
            tmp = torch._foreach_mul(v, 1.0 + mu)
            torch._foreach_sub_(update, tmp)
            del tmp
            if post is not None:
                post(lo, hi, update)
            torch._foreach_sub_(params[lo:hi], update)
            del update


@dataclasses.dataclass(eq=False)
class Adam(IUpdater):
    """m' = b1*m + (1-b1)*g; v' = b2*v + (1-b2)*g^2;
    update = alphat * m' / (sqrt(v') + eps) with the reference's
    ``alphat = lr * sqrt(1 - b2^t) / (1 - b1^t)``, t = iteration + 1.

    ``alphat`` is the step's scalar, computed on the host in float32, as
    the JAX package computes it (``1 - b2^t`` in float32 is what it
    divides by). The leaves are updated together with PyTorch's
    multi-tensor (``_foreach``) ops, a few launches per step for all of
    them, in the JAX expression's order: ``alphat * m'``, divided by the
    denominator, subtracted from the parameter (one ``addcdiv`` with
    value -1, which negates exactly). The two temporaries of that last
    part (``alphat * m'`` and the denominator) are made for groups of
    leaves of at most ``GROUP`` elements, so a large model holds two
    group-sized temporaries, not two parameter-sized ones."""
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

    def _scalar(self, iteration, epoch):
        return self.alphat(resolve_lr(self.learning_rate, iteration, epoch),
                           iteration)

    @torch.no_grad()
    def update_(self, params, grads, state, scal, post=None) -> None:
        params, grads = list(params), list(grads)
        if not params:
            return
        ms = [s[0] for s in state]
        vs = [s[1] for s in state]
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
        for lo, hi in _groups(params):
            update = torch._foreach_mul(ms[lo:hi], scal)
            denom = torch._foreach_sqrt(vs[lo:hi])
            torch._foreach_add_(denom, self.epsilon)
            if post is None:
                torch._foreach_addcdiv_(params[lo:hi], update, denom,
                                        value=-1.0)
            else:
                torch._foreach_div_(update, denom)
                post(lo, hi, update)
                torch._foreach_sub_(params[lo:hi], update)
            del update, denom


UPDATERS = {c.__name__: c for c in (Sgd, Nesterovs, Adam)}
