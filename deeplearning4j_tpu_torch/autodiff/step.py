"""The train step that every fit tier runs, for any step owner.

Counterpart of the JAX package's ``SameDiff._build_step_parts``
(``autodiff/samediff.py:776-890``: ``grad_fn`` and ``apply_fn``), of its
sentinel verdict ``_sentinel_ok`` (:976-991) and of the accumulation
branch of ``make_train_window`` (:1146-1176). A step owner
(``autodiff/window.py`` ``StepOwner``: ``SameDiff``, ``ComputationGraph``)
supplies the gradient half, ``_grad_step``: the forward under the
mixed-precision policy and the backward into the float32 masters. This
module writes the rest once:

- chaos NaN injection (``faults/chaos.py`` ``nan_gradients``): every
  gradient times NaN where the step's iteration, a device input, is the
  armed one, else times 1 (exact);
- the sentinel verdict on the (micro-)step's gradients: the loss finite
  and every gradient leaf finite. The leaves are read by
  ``torch._foreach_norm(ord=inf)``: ``max |g|`` is finite exactly when
  every element is, and, unlike a sum of squares, cannot overflow on
  large finite gradients; a few launches for all the leaves;
- accumulation (``accum_steps`` A > 1): the micro-step's gradients are
  added into a device accumulator, and at an apply position their mean
  (the sum divided by A) goes through the apply half, after which the
  accumulator is zeroed;
- the apply half, in the JAX order: the pre-updater regularization (L1,
  L2) on the gradients, the clipping (``TrainingConfig.clip_gradients_``),
  the updater with the post-updater regularization (``WeightDecay``) on
  its update, all in place.

A step's per-step values are device tensors the tier fills before the
step (``StepInputs``): the updater's scalar and the learning rate (row
``scal``) and the absolute iteration ``it``, which with the owner's base
seed keys the step's random ops (``ops/random.py`` ``rng_scope``). A CUDA
graph captured once reads them at every replay. Nothing here syncs with
the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.ops import random as random_ops


@dataclasses.dataclass
class StepInputs:
    """One step's device inputs: ``scal``, a (2,) float32 row (the
    updater's scalar, the learning rate), ``it``, the absolute iteration
    (0-d int64), and, with accumulation, ``accum`` (the accumulator, one
    tensor a trainable) and ``apply`` (whether the updater applies at
    this step: fixed when the step is captured)."""
    scal: torch.Tensor
    it: torch.Tensor
    accum: Optional[List[torch.Tensor]] = None
    apply: bool = True


def chaos_at(tc) -> Optional[int]:
    """The iteration armed for NaN-gradient injection, or None."""
    spec = getattr(tc, "_chaos_spec", None)
    at = getattr(spec, "nan_grads_at", None) if spec is not None else None
    return None if at is None else int(at)


def step_key(tc) -> tuple:
    """What the captured step depends on beyond the updater and the
    mixed-precision policy: a window captured under one key is not
    replayed under another."""
    return (int(tc.accum_steps), bool(tc.sentinel), chaos_at(tc),
            tuple(repr(r.to_json()) for r in tc.regularization),
            tc.grad_clip_value, tc.gradient_normalization,
            float(tc.gradient_normalization_threshold))


@torch.no_grad()
def inject_nan_(grads: List[torch.Tensor], it: torch.Tensor,
                at: int) -> None:
    """Every gradient times NaN at iteration ``at``, times 1 elsewhere."""
    factor = torch.where(it == at, float("nan"), 1.0).to(grads[0].dtype)
    torch._foreach_mul_(grads, factor)


@torch.no_grad()
def sentinel_ok(loss: torch.Tensor,
                grads: List[torch.Tensor]) -> torch.Tensor:
    """0-d bool: the loss finite and every gradient element finite."""
    ok = torch.isfinite(loss)
    if grads:
        peaks = torch._foreach_norm(grads, float("inf"))
        ok = ok & torch.isfinite(torch.stack(peaks)).all()
    return ok


@torch.no_grad()
def apply_(tc, params: List[torch.Tensor], grads: List[torch.Tensor],
           state, scal: torch.Tensor) -> None:
    """The apply half on ``grads`` (changed in place): regularization
    before the updater, clipping, the updater (``scal[0]``, its scalar)
    with the regularization after it, all with the step's learning rate
    ``scal[1]``."""
    lr = scal[1]
    regs = list(tc.regularization)
    for r in regs:
        if r.apply_step == "BEFORE_UPDATER":
            r.apply_(params, grads, lr)
    tc.clip_gradients_(grads)
    after = [r for r in regs if r.apply_step == "POST_UPDATER"]

    def post(lo, hi, update):
        for r in after:
            r.apply_(params[lo:hi], update, lr)

    tc.updater.update_(params, grads, state, scal[0],
                       post=post if after else None)


def train_step(owner, names: List[str], ph, state,
               inp: StepInputs):
    """One step of ``owner`` on the batch ``ph``: ``(loss,
    ok)``, the (unscaled) loss and the sentinel's verdict (None with
    the sentinel off), both on the device."""
    tc = owner.training_config
    with random_ops.rng_scope(owner.rng_seed_tensor(), inp.it):
        loss, grads = owner._grad_step(names, ph)
    grads = list(grads)
    at = chaos_at(tc)
    if at is not None and grads:
        inject_nan_(grads, inp.it, at)
    ok = sentinel_ok(loss, grads) if tc.sentinel else None
    params = owner._masters(names)
    if inp.accum is None:
        apply_(tc, params, grads, state, inp.scal)
        return loss, ok
    with torch.no_grad():
        torch._foreach_add_(inp.accum, grads)
        del grads
        if inp.apply:
            torch._foreach_div_(inp.accum, float(tc.accum_steps))
            apply_(tc, params, inp.accum, state, inp.scal)
            torch._foreach_zero_(inp.accum)
    return loss, ok
