"""Deterministic, seed-driven fault injection for the training rails.

Counterpart of a subset of ``deeplearning4j_tpu/faults/chaos.py``:
``ChaosSpec`` :115, ``FlakyIterator`` :125, ``BatchPoisoner`` :153 and
``ChaosMonkey`` :465 with ``flaky_iterator``, ``poison_batches`` and
``nan_gradients`` (:611). Given the same seed and run, a fault fires at
the same place:

- ``nan_gradients(model, at_step)``: every gradient becomes NaN at the
  absolute iteration ``at_step``, inside the step (``autodiff/step.py``
  reads the iteration from a device buffer), so it fires inside a
  captured window too. The armed iteration is part of a window's key:
  arming captures new windows, disarming returns to the old ones;
- ``poison_batches(it, at_step)``: one-shot, the batch at that yield
  count gets NaN features (numpy arrays or tensors, on any device), so a
  rolled-back retry passes cleanly;
- ``flaky_iterator(it, fail_at_batch)``: the loader raises a transient
  ``IOError`` at a batch index, a limited number of times.

The JAX module's other injectors (torn shards and flaky or slow shard
reads, prefetch worker kills, torn checkpoint commits, stalled or
bit-flipped dispatches, rotten checkpoints, synthetic OOM, SIGTERM,
host loss and kills, serving faults) are refused by name (ROADMAP queue
1 item 7).
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

#: the JAX ChaosMonkey's injectors this port does not have yet
NOT_PORTED = ("torn_shard", "flaky_read", "slow_reader", "worker_killer",
              "transient_device_error", "bitflip_param", "stalled_dispatch",
              "rot_checkpoint", "resource_exhausted", "oom_serving",
              "failing_os_replace", "failing_fsync", "failing_exec",
              "poison_request", "sigterm_listener", "host_loss",
              "host_killer", "kill_mid_stream")


class ChaosSpec:
    """Device-side injection knobs read by the train step. Attached as
    ``TrainingConfig._chaos_spec``; None (the default) leaves the step
    as it is."""

    def __init__(self, nan_grads_at: Optional[int] = None):
        self.nan_grads_at = nan_grads_at


class FlakyIterator:
    """Raises a transient loader error at batch ``fail_at_batch`` (its
    index in the pass), ``times`` times in all across passes."""

    def __init__(self, wrapped, fail_at_batch: int, times: int = 1,
                 exc_factory=None, log: Optional[List] = None):
        self._wrapped = wrapped
        self.fail_at_batch = int(fail_at_batch)
        self.times_left = int(times)
        self._exc_factory = exc_factory or (
            lambda i: IOError(f"chaos: injected loader failure at "
                              f"batch {i}"))
        self._log = log if log is not None else []

    def reset(self):
        if hasattr(self._wrapped, "reset"):
            self._wrapped.reset()

    def __iter__(self):
        for i, batch in enumerate(self._wrapped):
            if i == self.fail_at_batch and self.times_left > 0:
                self.times_left -= 1
                self._log.append({"event": "loader_exception",
                                  "batch_index": i, "t": time.time()})
                raise self._exc_factory(i)
            yield batch


class BatchPoisoner:
    """Replaces the batch at yield count ``at_step`` with NaN features,
    ``times`` times in all (one-shot by default). The count is of the
    batches this wrapper yielded, across passes: the absolute training
    iteration only while nothing upstream replays batches."""

    def __init__(self, wrapped, at_step: int, times: int = 1,
                 log: Optional[List] = None):
        self._wrapped = wrapped
        self.at_step = int(at_step)
        self.times_left = int(times)
        self._step = 0
        self._log = log if log is not None else []

    def reset(self):
        if hasattr(self._wrapped, "reset"):
            self._wrapped.reset()

    @staticmethod
    def _poison(part):
        if isinstance(part, (tuple, list)):
            return type(part)(BatchPoisoner._poison(p) for p in part)
        if isinstance(part, torch.Tensor):
            return torch.full_like(part, float("nan")) \
                if part.is_floating_point() else part
        a = np.array(part, copy=True)
        if np.issubdtype(a.dtype, np.floating):
            a[...] = np.nan
        return a

    def __iter__(self):
        for batch in self._wrapped:
            if self._step == self.at_step and self.times_left > 0:
                self.times_left -= 1
                self._log.append({"event": "batch_poisoned",
                                  "step": self._step, "t": time.time()})
                if isinstance(batch, dict):
                    batch = {k: self._poison(v) for k, v in batch.items()}
                elif hasattr(batch, "features") and hasattr(batch, "labels"):
                    batch = (self._poison(batch.features), batch.labels)
                else:
                    f, l = batch
                    batch = (self._poison(f), l)
            self._step += 1
            yield batch


class ChaosMonkey:
    """The fault-injection front end. All randomness flows from the
    constructor's seed; every injection is appended to ``log``."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.log: List[dict] = []

    def __getattr__(self, name):
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"ChaosMonkey.{name} is not ported yet (ROADMAP queue 1 "
                f"item 7: the rest of faults/chaos.py)")
        raise AttributeError(name)

    def draw_step(self, lo: int, hi: int) -> int:
        """A seed-deterministic step or batch index in [lo, hi)."""
        return int(self.rng.integers(lo, hi))

    def flaky_iterator(self, wrapped, fail_at_batch: Optional[int] = None,
                       n_batches: Optional[int] = None,
                       times: int = 1) -> FlakyIterator:
        if fail_at_batch is None:
            if n_batches is None:
                raise ValueError("pass fail_at_batch= or n_batches= to "
                                 "draw one from the seed")
            fail_at_batch = self.draw_step(0, n_batches)
        return FlakyIterator(wrapped, fail_at_batch, times=times,
                             log=self.log)

    def poison_batches(self, wrapped, at_step: Optional[int] = None,
                       n_steps: Optional[int] = None,
                       times: int = 1) -> BatchPoisoner:
        if at_step is None:
            if n_steps is None:
                raise ValueError("pass at_step= or n_steps= to draw one "
                                 "from the seed")
            at_step = self.draw_step(0, n_steps)
        return BatchPoisoner(wrapped, at_step, times=times, log=self.log)

    @contextlib.contextmanager
    def nan_gradients(self, model, at_step: int) -> Iterator[None]:
        """Arm NaN-gradient injection at the absolute iteration
        ``at_step`` for the context's duration (``model``: a SameDiff,
        ``MultiLayerNetwork`` or ``ComputationGraph``)."""
        tc = getattr(model, "samediff", model).training_config
        if tc is None:
            raise ValueError("set the model's training_config first")
        prev = getattr(tc, "_chaos_spec", None)
        tc._chaos_spec = ChaosSpec(nan_grads_at=int(at_step))
        self.log.append({"event": "nan_gradients_armed",
                         "step": int(at_step), "t": time.time()})
        try:
            yield
        finally:
            tc._chaos_spec = prev
