"""Serving resilience: SLO admission and supervised workers.

Counterpart of ``deeplearning4j_tpu/serving/resilience.py``, cut to what
the generative servers use, copied and adapted (host code):

- the typed-failure contract: :class:`ServingError`,
  :class:`RetryableServingError` (``retry_after_s``; its wire format
  belongs to the fleet, not ported yet);
- :class:`ResilienceConfig`, with the fields the generative tier reads
  (admission and supervision; the circuit breaker and poisoned-batch
  bisection belong to ``ParallelInference``, not ported yet);
- :class:`AdmissionController`: a deadline-carrying request whose
  estimated wait (queue depth x a rolling percentile of the decode-step
  time, :class:`~deeplearning4j_tpu_torch.monitor.steptime.RollingPercentiles`)
  already exceeds its deadline is shed typed at ``submit()``;
- :class:`InflightSlot` and :class:`WorkerSupervisor`: a crashed worker
  is restarted with bounded exponential backoff and its in-flight
  requests are requeued exactly once.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.monitor.steptime import RollingPercentiles


class ServingError(RuntimeError):
    """Base class for typed serving failures (re-exported by
    ``serving.queue``)."""


class RetryableServingError(ServingError):
    """A typed, *retryable* shed: the request was rejected by a
    transient capacity condition (full queue, exhausted block pool, SLO
    admission), not by anything wrong with the request itself.
    ``retry_after_s`` — when set — is the structured backoff hint: how
    long the shedding condition is expected to persist."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclass
class ResilienceConfig:
    """Knobs for the serving resilience rail (``resilience=True`` means
    this default config).

    - ``admission``: shed deadline-carrying requests whose estimated
      wait (queued work ahead x rolling ``percentile`` exec time)
      already exceeds their deadline. Estimation starts after
      ``min_exec_samples`` observed execs; ``window`` bounds the rolling
      sample.
    - ``supervise``: run the worker under a :class:`WorkerSupervisor`,
      which restarts it with backoff between ``worker_backoff_base_s``
      and ``worker_backoff_max_s``.
    """

    admission: bool = True
    min_exec_samples: int = 8
    percentile: float = 95.0
    window: int = 256
    supervise: bool = True
    worker_backoff_base_s: float = 0.05
    worker_backoff_max_s: float = 2.0

    @staticmethod
    def normalize(value) -> Optional["ResilienceConfig"]:
        """None/False -> None (rail off); True -> defaults; a config
        passes through."""
        if value is None or value is False:
            return None
        if value is True:
            return ResilienceConfig()
        if isinstance(value, ResilienceConfig):
            return value
        raise TypeError(f"resilience= expects None/bool/ResilienceConfig, "
                        f"got {type(value).__name__}")


class AdmissionController:
    """SLO admission math: estimated queue wait from a rolling exec-time
    percentile.

    ``observe(exec_ms)`` feeds every dispatch's exec time;
    ``estimate_wait_ms(pending_rows, rows_per_dispatch)`` returns the
    expected wall wait for a request behind ``pending_rows`` queued rows
    (including its own) on a serially-executing device:
    ``ceil(pending_rows / rows_per_dispatch) × p<percentile>(exec_ms)``
    — or None while fewer than ``min_samples`` execs have been seen
    (no shedding on a cold estimator)."""

    def __init__(self, window: int = 256, percentile: float = 95.0,
                 min_samples: int = 8):
        self.percentile = float(percentile)
        self.min_samples = int(min_samples)
        self._pcts = RollingPercentiles(window=int(window))
        self._lock = threading.Lock()

    def observe(self, exec_ms: float) -> None:
        with self._lock:
            self._pcts.add(float(exec_ms))

    def estimate_wait_ms(self, pending_rows: int,
                         rows_per_dispatch: int) -> Optional[float]:
        with self._lock:
            if len(self._pcts) < self.min_samples:
                return None
            dispatches = math.ceil(max(0, int(pending_rows))
                                   / max(1, int(rows_per_dispatch)))
            return dispatches * self._pcts.percentile(self.percentile)

    def retry_hint_s(self, pending_rows: int = 1,
                     rows_per_dispatch: int = 1,
                     floor_s: float = 0.05) -> float:
        """Backoff hint (seconds) for a typed capacity shed — the
        ``retry_after_s`` a ``ServerOverloadedError`` (queue full, KV
        block pool exhausted) carries to the client. Derived from the
        rolling exec percentile when warm, clamped to ``floor_s`` so a
        cold estimator still tells clients to back off rather than
        hot-loop."""
        est = self.estimate_wait_ms(pending_rows, rows_per_dispatch)
        if est is None:
            return float(floor_s)
        return round(max(float(floor_s), est / 1000.0), 3)


class InflightSlot:
    """Per-worker visibility into popped-but-unresolved requests — what
    the supervisor requeues when the worker dies mid-dispatch. Plain
    attribute assignment (atomic under the GIL); the supervisor only
    reads it after the owning thread is dead."""

    def __init__(self):
        self.requests: Optional[List] = None
        self.exited = False             # clean loop return (don't restart)
        self.crashed: Optional[BaseException] = None
        self.progressed = False         # served at least one dispatch —
        #                                 the supervisor's evidence for
        #                                 resetting the crash-streak
        #                                 backoff (mere liveness is not)


class WorkerSupervisor:
    """Restarts crashed serving workers with bounded backoff and
    requeues their in-flight requests exactly once.

    ``spawn(index, slot)`` must create AND start a worker thread running
    the serving loop with ``slot`` as its in-flight window. The
    supervisor polls thread liveness; a dead thread whose slot is not
    ``exited`` is a crash: its in-flight requests are requeued (a
    request already requeued once fails its future — no infinite
    ping-pong), a ``{"type": "faults"}`` ``fault`` record is published,
    the worker is respawned after bounded exponential backoff, and a
    ``recovered`` record closes the episode (the /healthz 503 window).
    """

    def __init__(self, spawn: Callable[[int, InflightSlot], threading.Thread],
                 n_workers: int, queue, metrics,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 2.0,
                 poll_s: float = 0.02):
        self._spawn = spawn
        self._queue = queue
        self._metrics = metrics
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.poll_s = float(poll_s)
        self._stopping = False
        self._lock = threading.Lock()
        self._entries: List[dict] = []
        for i in range(max(1, int(n_workers))):
            slot = InflightSlot()
            self._entries.append({"index": i, "slot": slot,
                                  "thread": self._spawn(i, slot),
                                  "consecutive": 0})
        self._thread = threading.Thread(target=self._run,
                                        name="ServingSupervisor",
                                        daemon=True)
        self._thread.start()

    @property
    def threads(self) -> List[threading.Thread]:
        with self._lock:
            return [e["thread"] for e in self._entries]

    # ------------------------------------------------------------------
    def _requeue(self, reqs: List) -> None:
        _SE = ServingError
        # reversed: requeue() puts each at the FRONT, so walking newest-
        # first leaves the queue in the original FIFO order (oldest at
        # the head, keeping its deadline odds)
        for req in reversed(reqs or []):
            if req.future.done():
                continue
            if getattr(req, "requeues", 0) >= 1:
                # exactly-once: a request that already survived one
                # crash does not get a third dispatch
                err = _SE(f"request {req.id} lost to a crashed worker "
                          f"twice; giving up")
                req.fail(err)
                self._metrics.record_failure(err, cause="worker_crash")
                continue
            req.requeues = getattr(req, "requeues", 0) + 1
            try:
                self._queue.requeue(req)
                self._metrics.inc("requests_requeued")
            except Exception as e:        # closed non-drain queue
                req.fail(e)

    def _handle_crash(self, entry: dict) -> None:
        slot: InflightSlot = entry["slot"]
        inflight = list(slot.requests or [])
        self._metrics.inc("worker_restarts")
        entry["consecutive"] += 1
        self._requeue(inflight)
        backoff = min(self.backoff_max_s,
                      self.backoff_base_s * (2 ** (entry["consecutive"] - 1)))
        deadline = time.monotonic() + backoff
        while time.monotonic() < deadline and not self._stopping:
            time.sleep(min(self.poll_s, 0.01))
        if self._stopping:
            return
        new_slot = InflightSlot()
        entry["slot"] = new_slot
        entry["thread"] = self._spawn(entry["index"], new_slot)

    def _run(self) -> None:
        while not self._stopping:
            with self._lock:
                entries = list(self._entries)
            for entry in entries:
                t, slot = entry["thread"], entry["slot"]
                if t.is_alive():
                    if entry["consecutive"] and slot.progressed:
                        # the restarted worker actually SERVED work —
                        # its crash streak is over (mere liveness is
                        # not evidence: a crash-looping worker is alive
                        # for a few guard sleeps before re-dying, and
                        # resetting on that would pin the backoff at
                        # its base forever)
                        entry["consecutive"] = 0
                    continue
                if slot.exited or self._stopping:
                    continue
                self._handle_crash(entry)
            if self._queue.finished and all(
                    not e["thread"].is_alive() for e in entries):
                return
            time.sleep(self.poll_s)

    # ------------------------------------------------------------------
    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop restarting, join the supervisor and every worker. Call
        AFTER closing the queue (workers exit on drain completion)."""
        self._stopping = True
        self._thread.join(timeout=timeout if timeout is not None else 10.0)
        for t in self.threads:
            t.join(timeout=timeout)


__all__ = ["AdmissionController", "InflightSlot", "ResilienceConfig",
           "RetryableServingError", "ServingError", "WorkerSupervisor"]
