"""FaultTolerantFit: the decide-and-recover half of the fault rail.

Counterpart of ``deeplearning4j_tpu/faults/recovery.py`` (``RetryPolicy``
:51, ``FaultTolerantFit`` :74). On a structured fault during ``fit``
(divergence, a data-pipeline failure, a transient device error, a
checkpoint-write error) it

1. waits out the checkpoint writer, collects torn staging directories
   and rolls the model back to the newest committed checkpoint
   (parameters, running statistics, updater state, iteration, epoch);
2. optionally rescales the learning rate (``RetryPolicy.lr_rescale``);
3. sleeps a bounded exponential backoff (``sleep`` is injectable) and
   retries the remaining epochs. The budget counts rollbacks in a row
   without checkpoint progress;
4. when the budget is spent, restores the last good state, commits it
   again as a pinned final checkpoint and raises
   :class:`FaultBudgetExhaustedError`, whose ``__cause__`` is the last
   fault.

The input iterator is wrapped in ``RetryingIterator`` unless it is a
device-cached source (``stacked_batches``) or already wrapped. Every
decision is kept in ``events`` (the JAX ``{"type": "faults"}`` records).

In the port a rollback copies the checkpoint into the live tensors and
the learning rate is a staged host scalar, so neither a rollback nor an
``lr_rescale`` captures a fit window again (the JAX package retraces
its step after a rescale). As in the JAX fit, a retry replays the
interrupted epoch from its first batch with the restored counters; a
source that keys its batches by ``iteration_count`` resumes where the
checkpoint stopped. Not ported yet, each refused by name (ROADMAP queue
1 item 7): ``stats_storage=`` (``ui/``) and a checkpoint written by
several processes (``checkpoint/reshard.py``). The streaming pipeline
whose seek resumes mid-epoch (``datapipe/``) waits with them.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.checkpoint.listener import CheckpointListener
from deeplearning4j_tpu_torch.checkpoint.manager import (CheckpointError,
                                                         CheckpointManager,
                                                         TopologyChangedError)
from deeplearning4j_tpu_torch.faults.errors import (FaultBudgetExhaustedError,
                                                    FaultError,
                                                    SilentCorruptionError,
                                                    retryable_errors)
from deeplearning4j_tpu_torch.faults.iterators import RetryingIterator
from deeplearning4j_tpu_torch.monitor.trace import TRACER as _tracer


@dataclasses.dataclass
class RetryPolicy:
    """``max_retries``: rollbacks in a row without checkpoint progress
    before aborting; ``backoff_base``/``backoff_max``: the bounded
    exponential backoff's seconds; ``lr_rescale``: the factor on the
    updater's (numeric) learning rate at every rollback (1.0 = off);
    ``data_max_retries``: the loader's retry budget a pass (0 = the
    iterator is not wrapped); ``quarantine_corrupt``: skip NaN/Inf
    batches instead of training on them."""
    max_retries: int = 3
    backoff_base: float = 0.5
    backoff_max: float = 30.0
    lr_rescale: float = 1.0
    data_max_retries: int = 3
    quarantine_corrupt: bool = True


class FaultTolerantFit:
    """``fit()`` that survives divergence, flaky loaders, torn
    checkpoints and transient device errors::

        mgr = CheckpointManager(ckpt_dir, keep_last_n=3)
        ftf = FaultTolerantFit(net, mgr, policy=RetryPolicy(max_retries=2),
                               checkpoint_every_n_iterations=50)
        history = ftf.fit(train_iter, epochs=20)

    ``sentinel=True`` (the default) arms the device-side divergence
    sentinel on the model's ``TrainingConfig``."""

    def __init__(self, model, manager: CheckpointManager,
                 policy: Optional[RetryPolicy] = None,
                 checkpoint_every_n_iterations: Optional[int] = None,
                 checkpoint_every_n_epochs: Optional[int] = None,
                 stats_storage=None, sentinel: bool = True,
                 sleep: Callable[[float], None] = time.sleep):
        if stats_storage is not None:
            raise NotImplementedError(
                "FaultTolerantFit(stats_storage=...) is not ported yet "
                "(ROADMAP queue 1 item 7: ui/); the records are in "
                "FaultTolerantFit.events")
        self.model = model
        self.sd = getattr(model, "samediff", model)
        self.manager = manager
        self.policy = policy or RetryPolicy()
        self._sleep = sleep
        if checkpoint_every_n_iterations is None and \
                checkpoint_every_n_epochs is None:
            checkpoint_every_n_epochs = 1
        self._ckpt_iters = checkpoint_every_n_iterations
        self._ckpt_epochs = checkpoint_every_n_epochs
        self.events: List[dict] = []
        self.recovery_seconds = 0.0
        self.rollbacks = 0
        if sentinel and self.sd.training_config is not None:
            self.sd.training_config.sentinel = True

    # ------------------------------------------------------------------
    def _publish(self, event: str, **fields) -> dict:
        rec = {"type": "faults", "event": event, "t": time.time(), **fields}
        self.events.append(rec)
        return rec

    def _tc(self):
        tc = self.sd.training_config
        if tc is None:
            raise ValueError("model has no TrainingConfig; set it (or "
                             "init() the network) before FaultTolerantFit")
        return tc

    def resume_latest(self):
        """Restore the newest committed checkpoint into the model (the
        restart of a relaunched job, before ``fit``). Returns ``(step,
        state)`` or None."""
        return self._restore_latest()

    def _restore_latest(self, verified_only: bool = False):
        try:
            return self.manager.restore_latest(model=self.model,
                                               verified_only=verified_only)
        except TopologyChangedError as e:
            raise NotImplementedError(
                f"restoring a checkpoint of another topology is not ported "
                f"yet (ROADMAP queue 1 item 7: checkpoint/reshard.py): "
                f"{e}") from e

    def _rollback(self, cause: BaseException) -> int:
        t0 = time.perf_counter()
        rb_span = _tracer.span("faults.rollback", cat="faults",
                               cause=type(cause).__name__)
        rb_span.__enter__()
        try:
            # a failed or stuck asynchronous write may be the fault itself
            try:
                self.manager.wait_until_finished(timeout=60.0)
            except CheckpointError:
                pass
            try:
                self.manager.check_error()
            except CheckpointError:
                pass
            removed = self.manager.gc_uncommitted()
            verified_only = isinstance(cause, SilentCorruptionError)
            res = self._restore_latest(verified_only=verified_only)
            if res is None:
                raise FaultBudgetExhaustedError(
                    "no committed checkpoint to roll back to",
                    cause="no_checkpoint") from cause
            step, _ = res
            rb_span.set(restored_step=int(step))
        finally:
            rb_span.__exit__(*sys.exc_info())
        if self.policy.lr_rescale != 1.0:
            upd = self._tc().updater
            lr = getattr(upd, "learning_rate", None)
            if isinstance(lr, (int, float)):
                # a staged scalar: no window is captured again
                upd.learning_rate = lr * self.policy.lr_rescale
        dt = time.perf_counter() - t0
        self.recovery_seconds += dt
        self.rollbacks += 1
        self._publish(
            "rollback", restored_step=int(step), gc_removed=len(removed),
            overhead_s=round(dt, 6), lr_rescale=self.policy.lr_rescale,
            verified_only=verified_only,
            **(cause.provenance() if isinstance(cause, FaultError)
               else {"error": type(cause).__name__, "cause": "exception"}))
        return step

    # ------------------------------------------------------------------
    def fit(self, dataset_iterator, epochs: int = 1,
            listeners: Sequence = ()):
        """Train ``epochs`` epochs (counted from the model's
        ``epoch_count``), surviving recoverable faults within the retry
        budget. Returns the History of the final attempt."""
        tc = self._tc()
        policy = self.policy
        if policy.data_max_retries > 0 and \
                not isinstance(dataset_iterator, RetryingIterator) and \
                not hasattr(dataset_iterator, "stacked_batches"):
            # a device-cached source keeps the attribute the graph tiers
            # route on; it has no transient loader failures, and the
            # sentinel covers its device arrays
            dataset_iterator = RetryingIterator(
                dataset_iterator, max_retries=policy.data_max_retries,
                quarantine_corrupt=policy.quarantine_corrupt,
                on_event=self.events.append)
        ckpt_iters = self._ckpt_iters
        accum = max(1, int(tc.accum_steps))
        if ckpt_iters is not None and accum > 1 and ckpt_iters % accum:
            # the accumulator is not in a checkpoint: a rollback target
            # must sit on an accumulation-cycle boundary
            ckpt_iters = ((ckpt_iters + accum - 1) // accum) * accum
        ckpt = CheckpointListener(
            self.manager, every_n_iterations=ckpt_iters,
            every_n_epochs=self._ckpt_epochs)
        all_listeners = list(listeners) + [ckpt]
        # a rollback target must exist before the first step can fail
        if self.manager.latest_step() is None:
            self.manager.save(int(tc.iteration_count), model=self.model,
                              epoch=int(tc.epoch_count), blocking=True)
        target = int(tc.epoch_count) + int(epochs)
        attempts = 0
        last_restore_step = -1
        history = None
        retryable = retryable_errors()
        while True:
            remaining = target - int(tc.epoch_count)
            if remaining <= 0:
                break
            try:
                history = self.model.fit(dataset_iterator,
                                         epochs=remaining,
                                         listeners=all_listeners)
                break          # done (or a listener chose to stop early)
            except retryable as e:
                self._publish(
                    "fault",
                    **(e.provenance() if isinstance(e, FaultError)
                       else {"error": type(e).__name__,
                             "cause": "exception"}))
                step = self._rollback(e)
                if step > last_restore_step:
                    attempts = 1          # progress since the last loop
                else:
                    attempts += 1
                last_restore_step = step
                if attempts > policy.max_retries:
                    try:
                        self.manager.save(int(step), model=self.model,
                                          epoch=int(tc.epoch_count),
                                          blocking=True, pin=True)
                    except Exception:
                        pass   # the restored step is already on disk
                    self._publish("retry_exhausted", attempts=attempts,
                                  restored_step=int(step))
                    raise FaultBudgetExhaustedError(
                        f"retry budget exhausted after {attempts - 1} "
                        f"rollbacks to step {step}: {e!r}",
                        step=int(step), cause="budget_exhausted") from e
                # stateful watchers judge the replayed steps fresh
                for l in listeners:
                    reset = getattr(l, "reset", None)
                    if callable(reset):
                        reset()
                backoff = min(policy.backoff_max,
                              policy.backoff_base * (2 ** (attempts - 1)))
                self._publish("retry", attempt=attempts,
                              backoff_s=round(backoff, 6),
                              resume_step=int(step))
                if backoff > 0:
                    with _tracer.span("faults.backoff", cat="faults",
                                      attempt=attempts,
                                      backoff_s=round(backoff, 6)):
                        self._sleep(backoff)
        self.manager.wait_until_finished()
        if self.rollbacks:
            self._publish("recovered", rollbacks=self.rollbacks,
                          overhead_s=round(self.recovery_seconds, 6))
        return history

    def report(self) -> dict:
        """The recovery summary of the run so far."""
        return {"rollbacks": self.rollbacks,
                "recovery_seconds": round(self.recovery_seconds, 6),
                "events": list(self.events)}
