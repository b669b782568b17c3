"""CheckpointListener: periodic checkpoints from any ``fit``.

Counterpart of ``deeplearning4j_tpu/checkpoint/listener.py``: the builder
cadences (every N epochs, iterations or seconds) over the atomic
asynchronous manager, for ``SameDiff.fit``, ``MultiLayerNetwork.fit``
and ``ComputationGraph.fit``. A snapshot is taken at a listener flush,
at a window boundary: the port's parameters are updated in place, so the
live tensors there are the state of the last completed step, and the
fit has already advanced ``iteration_count`` to it (the JAX fit syncs
its working copies at each flush for a listener with ``needs_params``).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

from deeplearning4j_tpu_torch.autodiff.training import Listener
from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager
from deeplearning4j_tpu_torch.checkpoint.state import capture_training_state


class CheckpointListener(Listener):
    """Periodic checkpoints on an iteration, epoch or wall-clock cadence.

    ``manager_or_dir``: a CheckpointManager, or a directory (a manager
    with ``keep_last_n=keep_last`` is made over it). At least one cadence
    must be set. A checkpoint's step is the count of iterations
    completed when it was taken (the restored ``state.iteration``)."""

    def __init__(self, manager_or_dir,
                 every_n_iterations: Optional[int] = None,
                 every_n_epochs: Optional[int] = None,
                 every_n_seconds: Optional[float] = None,
                 keep_last: int = 3, normalizer=None,
                 save_on_training_end: bool = False):
        if isinstance(manager_or_dir, CheckpointManager):
            self.manager = manager_or_dir
        else:
            self.manager = CheckpointManager(manager_or_dir,
                                             keep_last_n=keep_last)
        if not any((every_n_iterations, every_n_epochs, every_n_seconds)):
            raise ValueError("set at least one cadence: every_n_iterations, "
                             "every_n_epochs, every_n_seconds")
        if every_n_iterations is not None and every_n_iterations <= 0:
            raise ValueError("every_n_iterations must be positive")
        if every_n_epochs is not None and every_n_epochs <= 0:
            raise ValueError("every_n_epochs must be positive")
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.every_n_seconds = every_n_seconds
        self.normalizer = normalizer
        self.save_on_training_end = save_on_training_end
        # the delivery cadence asked of the fit: iteration checkpoints on
        # their own cadence, time-based ones every step, epoch-only ones
        # never inside an epoch
        if every_n_iterations is not None:
            self.frequency = every_n_iterations
        elif every_n_seconds is not None:
            self.frequency = 1
        else:
            self.frequency = 1_000_000_000
        self._epoch = 0
        self._last_time_save = None
        self._last_step: Optional[int] = None
        #: seconds each snapshot's device-to-host copy took
        self.capture_seconds = []

    class Builder:
        def __init__(self, directory):
            self._dir = directory
            self._kw = {}

        def keep_last(self, n: int):
            self._kw["keep_last"] = int(n)
            return self

        def save_every_n_epochs(self, n: int):
            self._kw["every_n_epochs"] = int(n)
            return self

        def save_every_n_iterations(self, n: int):
            self._kw["every_n_iterations"] = int(n)
            return self

        def save_every(self, seconds: float):
            self._kw["every_n_seconds"] = float(seconds)
            return self

        def build(self) -> "CheckpointListener":
            return CheckpointListener(self._dir, **self._kw)

    @staticmethod
    def builder(directory) -> "CheckpointListener.Builder":
        return CheckpointListener.Builder(directory)

    @staticmethod
    def _global_epoch(sd, fallback: int) -> int:
        """Epochs completed (``epoch_count``), not the fit's own index: a
        retried fit's index would roll the epoch budget back on
        restore."""
        tc = getattr(sd, "training_config", None)
        if tc is None:
            return int(fallback)
        return int(getattr(tc, "epoch_count", fallback))

    def _save(self, sd, step: int, blocking: bool = False) -> None:
        t0 = time.perf_counter()
        state = capture_training_state(sd, epoch=self._epoch,
                                       normalizer=self.normalizer)
        self.capture_seconds.append(time.perf_counter() - t0)
        self.manager.save(step, state, blocking=blocking)
        self._last_step = step

    def on_training_start(self, sd):
        if self._last_time_save is None:
            self._last_time_save = time.perf_counter()

    def on_epoch_start(self, sd, epoch: int):
        self._epoch = self._global_epoch(sd, epoch)

    def iterations_done(self, sd, epoch: int, iterations: Sequence[int],
                        losses: Sequence[float]):
        self._epoch = self._global_epoch(sd, epoch)
        fire = False
        # a burst is at most ``frequency`` long: at most one hit in it
        if self.every_n_iterations is not None and any(
                (i + 1) % self.every_n_iterations == 0 for i in iterations):
            fire = True
        if self.every_n_seconds is not None:
            now = time.perf_counter()
            if now - (self._last_time_save or 0) >= self.every_n_seconds:
                self._last_time_save = now
                fire = True
        step = iterations[-1] + 1
        if fire and step != self._last_step:
            self._save(sd, step)

    def on_epoch_end(self, sd, epoch: int, mean_loss: float):
        # epoch_count already counts this epoch: restoring an epoch-end
        # snapshot resumes at the next epoch
        self._epoch = self._global_epoch(sd, epoch + 1)
        if self.every_n_epochs is not None and \
                self._epoch % self.every_n_epochs == 0:
            tc = sd.training_config
            step = int(getattr(tc, "iteration_count", 0)) if tc else epoch
            if step != self._last_step:
                self._save(sd, step)

    def on_training_end(self, sd):
        if self.save_on_training_end:
            tc = sd.training_config
            step = int(getattr(tc, "iteration_count", 0)) if tc else 0
            if step != self._last_step:
                self._save(sd, step, blocking=True)
        # surface any asynchronous write error before fit returns
        self.manager.wait_until_finished()

    def last_checkpoint(self) -> Optional[int]:
        """Newest committed step (after wait_until_finished)."""
        return self.manager.latest_step()
