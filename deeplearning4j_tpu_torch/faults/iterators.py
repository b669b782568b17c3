"""RetryingIterator: the data pipeline's recovery rail.

Counterpart of ``deeplearning4j_tpu/faults/iterators.py``, with the same
treatment of the three ways a loader fails:

- **transient loader exceptions**: the wrapped iterator is repositioned
  past the batches already delivered (``seek_batches(skip)`` where the
  source has it, else ``reset()`` and a fast-forward) and iteration
  goes on; a per-pass retry budget and an optional backoff bound it;
- **corrupt batches** (NaN/Inf in host-resident features): quarantined:
  the batch index is recorded and skipped on this and every later pass;
- **persistent failure**: a :class:`DataPipelineError` carrying the
  failing batch index escapes to the caller (``FaultTolerantFit``).

Host-resident means a numpy array or a tensor on the CPU; tensors on the
card are not pulled back to check (the device sentinel catches what
reaches the step), as the JAX scan skips device arrays. Exact recovery
by fast-forward needs a source that is deterministic per pass.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.faults.errors import DataPipelineError
from deeplearning4j_tpu_torch.monitor.trace import TRACER as _tracer


def _batch_arrays(batch) -> list:
    if isinstance(batch, dict):
        return list(batch.values())
    if hasattr(batch, "features") and hasattr(batch, "labels"):
        batch = (batch.features, batch.labels)
    if isinstance(batch, (tuple, list)):
        out = []
        for part in batch:
            out.extend(part if isinstance(part, (tuple, list)) else [part])
        return out
    return [batch]


def batch_is_corrupt(batch) -> bool:
    """True when a host-resident floating-point array of the batch holds
    NaN or Inf."""
    for a in _batch_arrays(batch):
        if isinstance(a, np.ndarray):
            if np.issubdtype(a.dtype, np.floating) and \
                    not np.isfinite(a).all():
                return True
        elif isinstance(a, torch.Tensor) and a.device.type == "cpu" and \
                a.is_floating_point() and not bool(torch.isfinite(a).all()):
            return True
    return False


class RetryingIterator:
    """Wrap an iterator of batches with retry and quarantine.

    ``max_retries``: transient-failure retries a pass;
    ``max_consecutive_failures``: failures at the same batch index
    before giving up on it; ``quarantine_corrupt``: skip (and remember)
    NaN/Inf batches; ``transient``: the exception classes eligible for a
    retry (anything else propagates); ``on_event``: a callback given one
    dict a retry or quarantine (also kept in ``events``)."""

    def __init__(self, wrapped, max_retries: int = 3,
                 max_consecutive_failures: int = 2,
                 quarantine_corrupt: bool = True,
                 backoff_base: float = 0.0, backoff_max: float = 5.0,
                 transient: Tuple[type, ...] = (Exception,),
                 on_event: Optional[Callable[[dict], None]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self._wrapped = wrapped
        self.max_retries = int(max_retries)
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.quarantine_corrupt = bool(quarantine_corrupt)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self._transient = tuple(transient)
        self._on_event = on_event
        self._sleep = sleep
        self.quarantined: set = set()
        self.events: List[dict] = []

    def reset(self):
        if hasattr(self._wrapped, "reset"):
            self._wrapped.reset()

    def _event(self, kind: str, index: int, error=None) -> None:
        ev = {"type": "faults", "event": kind, "batch_index": int(index),
              "t": time.time()}
        if error is not None:
            ev["error"] = repr(error)
        self.events.append(ev)
        if self._on_event is not None:
            self._on_event(ev)

    def _restarted(self, skip: int):
        """A fresh iterator at batch ``skip`` of the pass: seeked where
        the source can, else reset and fast-forwarded. A source that
        shrank below ``skip`` is a pipeline fault."""
        seek = getattr(self._wrapped, "seek_batches", None)
        if callable(seek):
            with _tracer.span("data.loader_seek", cat="data", skip=skip):
                return seek(skip)
        with _tracer.span("data.loader_retry", cat="data", skip=skip):
            self.reset()
            it = iter(self._wrapped)
            for i in range(skip):
                try:
                    next(it)
                except StopIteration:
                    raise DataPipelineError(
                        f"data source shrank during retry: expected at "
                        f"least {skip} batches, ended at {i}",
                        batch_index=i, cause="source_shrank") from None
            return it

    def _backoff(self, consecutive: int) -> None:
        if self.backoff_base > 0:
            self._sleep(min(self.backoff_max,
                            self.backoff_base * (2 ** (consecutive - 1))))

    def __iter__(self):
        self.reset()
        it = iter(self._wrapped)
        index = 0                       # the batch being fetched
        retries_left = self.max_retries
        consecutive = 0
        while True:
            try:
                batch = next(it)
            except StopIteration:
                return
            except self._transient as e:
                consecutive += 1
                retries_left -= 1
                if retries_left < 0 or \
                        consecutive > self.max_consecutive_failures:
                    self._event("loader_failed", index, e)
                    raise DataPipelineError(
                        f"data loader failed at batch {index} after "
                        f"{self.max_retries - max(retries_left, 0)} "
                        f"retries ({consecutive} consecutive): {e!r}",
                        batch_index=index, cause="loader_exhausted") from e
                self._event("loader_retry", index, e)
                self._backoff(consecutive)
                # restart until it works or the budget is spent; never
                # go on with the old iterator, whose generator is closed
                while True:
                    try:
                        it = self._restarted(index)
                        break
                    except DataPipelineError:
                        raise
                    except self._transient as e2:
                        consecutive += 1
                        retries_left -= 1
                        self._event("loader_retry", index, e2)
                        if retries_left < 0 or \
                                consecutive > self.max_consecutive_failures:
                            raise DataPipelineError(
                                f"data loader restart failed at batch "
                                f"{index}: {e2!r}", batch_index=index,
                                cause="loader_exhausted") from e2
                        self._backoff(consecutive)
                continue
            consecutive = 0
            if index in self.quarantined:
                self._event("quarantine_skip", index)
                index += 1
                continue
            if self.quarantine_corrupt and batch_is_corrupt(batch):
                self.quarantined.add(index)
                self._event("quarantine", index)
                index += 1
                continue
            index += 1
            yield batch
