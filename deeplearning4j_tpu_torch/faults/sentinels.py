"""Divergence sentinels: the device rail's verdict and host-side
watchers.

Counterpart of ``deeplearning4j_tpu/faults/sentinels.py``. The device
sentinel (``TrainingConfig.sentinel``) is computed inside the step
(``autodiff/step.py`` ``sentinel_ok``) and folded into each window's
first-bad-step marker (``autodiff/window.py``); the fit tiers raise
through :func:`raise_diverged` where they read it. The host watchers
(:class:`LossSpikeWatcher`, :class:`PlateauWatcher`) are listeners that
inspect the losses ``fit`` already fetches: finite-but-wrong regimes the
device flag cannot see. They cost nothing extra: they ride the burst
flushes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.autodiff.training import Listener
from deeplearning4j_tpu_torch.faults.errors import TrainingDivergedError


class LossSpikeWatcher(Listener):
    """Raise :class:`TrainingDivergedError` when the loss jumps more
    than ``spike_factor`` times above its exponential moving average (or
    goes non-finite). ``warmup`` iterations are observed before spikes
    fire. ``frequency`` is the delivery cadence asked of the fit (the
    flush interval is the smallest among the listeners')."""

    def __init__(self, spike_factor: float = 10.0, warmup: int = 20,
                 ema_decay: float = 0.9, frequency: int = 10):
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1")
        self.spike_factor = float(spike_factor)
        self.warmup = int(warmup)
        self.ema_decay = float(ema_decay)
        self.frequency = max(1, int(frequency))
        self._ema: Optional[float] = None
        self._seen = 0

    def reset(self) -> None:
        """Forget the EMA and warm-up; ``FaultTolerantFit`` calls it on
        every rollback, so that the replayed steps are judged fresh."""
        self._ema = None
        self._seen = 0

    def iterations_done(self, sd, epoch: int, iterations: Sequence[int],
                        losses: Sequence[float]):
        for it, loss in zip(iterations, losses):
            loss = float(loss)
            if not np.isfinite(loss):
                raise TrainingDivergedError(
                    f"non-finite loss {loss} at iteration {it} "
                    f"(epoch {epoch})", step=int(it), epoch=int(epoch),
                    cause="non_finite_loss", value=loss)
            if self._ema is not None and self._seen >= self.warmup and \
                    loss > self.spike_factor * max(self._ema, 1e-12):
                raise TrainingDivergedError(
                    f"loss spike: {loss:.6g} > {self.spike_factor}x EMA "
                    f"{self._ema:.6g} at iteration {it} (epoch {epoch})",
                    step=int(it), epoch=int(epoch), cause="loss_spike",
                    value=loss)
            self._ema = loss if self._ema is None else \
                self.ema_decay * self._ema + (1 - self.ema_decay) * loss
            self._seen += 1


class PlateauWatcher(Listener):
    """Raise :class:`TrainingDivergedError` (cause ``"plateau"``) when
    the epoch mean loss has not improved by ``min_delta`` for
    ``patience`` epochs in a row. An epoch-only listener: its frequency
    asks for no flush inside an epoch."""

    frequency = 1_000_000_000

    def __init__(self, patience: int = 5, min_delta: float = 0.0):
        self.patience = int(patience)
        self.min_delta = float(min_delta)
        self.best = float("inf")
        self._stale = 0

    def reset(self) -> None:
        """Forget the best loss and the staleness (a rollback)."""
        self.best = float("inf")
        self._stale = 0

    def on_epoch_end(self, sd, epoch: int, mean_loss: float):
        if mean_loss is None:
            return
        if mean_loss < self.best - self.min_delta:
            self.best = float(mean_loss)
            self._stale = 0
            return
        self._stale += 1
        if self._stale >= self.patience:
            raise TrainingDivergedError(
                f"loss plateaued for {self._stale} epochs (best "
                f"{self.best:.6g}, epoch {epoch} mean {mean_loss:.6g})",
                epoch=int(epoch), cause="plateau", value=float(mean_loss))


def check_bad_steps(bads, epoch: int, epoch_start_iter: int) -> None:
    """Fetched first-bad-step markers of windows or steps (-1 = clean):
    the earliest marked step raises."""
    hit = [b for b in bads if b >= 0]
    if hit:
        raise_diverged(int(min(hit)), epoch, epoch_start_iter)


def raise_diverged(bad_step: int, epoch: int, epoch_start_iter: int,
                   loss: Optional[float] = None) -> None:
    """The device sentinel's raise site, shared by the fit tiers."""
    raise TrainingDivergedError(
        f"device sentinel: non-finite loss/gradient at iteration "
        f"{bad_step} (epoch {epoch}, batch {bad_step - epoch_start_iter} "
        f"of the epoch); roll back to the last committed checkpoint",
        step=int(bad_step), epoch=int(epoch),
        batch_index=int(bad_step - epoch_start_iter),
        cause="device_sentinel",
        value=None if loss is None else float(loss))
