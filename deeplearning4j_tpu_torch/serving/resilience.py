"""Serving resilience: the detect -> decide -> recover rail for inference.

Counterpart of ``deeplearning4j_tpu/serving/resilience.py`` (host code,
copied and adapted), shared by ``ParallelInference`` and the generative
servers:

- the typed-failure contract: :class:`ServingError`,
  :class:`RetryableServingError` (``retry_after_s``, and
  ``to_wire``/``from_wire`` to carry a shed across a process boundary
  without losing its type), :class:`PoisonedRequestError` and
  :class:`ReloadFailedError`;
- :class:`AdmissionController`: a deadline-carrying request whose
  estimated wait (queued dispatches ahead x a rolling percentile of the
  exec time, :class:`~deeplearning4j_tpu_torch.monitor.steptime.RollingPercentiles`)
  already exceeds its deadline is shed typed at ``submit()``;
- :class:`CircuitBreaker`: closed / open / half-open on consecutive exec
  failures. Open sheds new submits (``retry_after_s`` = time until the
  next probe window) and pauses dispatch; after ``reset_timeout_s`` ONE
  probe batch goes through half-open: success closes the breaker,
  failure re-opens it;
- :class:`InflightSlot` and :class:`WorkerSupervisor`: a crashed worker
  is restarted with bounded exponential backoff and its in-flight
  requests are requeued exactly once (a request lost to two crashes
  fails its future);
- poisoned-batch isolation is driven from ``inference.py``: a failed
  batched exec (a raise, or a non-finite output row) is bisected down to
  the poisoned request, which fails with :class:`PoisonedRequestError`
  while its co-batched neighbours are served.

The JAX rail's ``{"type": "faults"}`` records wait for the stats storage
(ROADMAP queue 1 item 2.8).
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


#: wire-kind registry: class-name -> exception class, populated by
#: ``RetryableServingError.__init_subclass__`` so every typed shed in
#: the process round-trips through :meth:`RetryableServingError.from_wire`
#: to its concrete class. Unknown kinds (a newer replica's error type)
#: fall back to the base — the retry semantics survive even when the
#: specific subclass does not.
_WIRE_KINDS: dict = {}


class RetryableServingError(ServingError):
    """A typed, *retryable* shed: the request was rejected by a
    transient capacity condition (full queue, exhausted block pool,
    open breaker, SLO admission), not by anything wrong with the
    request itself. ``retry_after_s`` — when set — is the structured
    backoff hint: how long the shedding condition is expected to
    persist.

    This class is the routing contract the fleet tier keys on: a
    front door retries anything ``isinstance(e, RetryableServingError)``
    (honoring the hint) and never retries permanent ``ValueError``s.
    :meth:`to_wire`/:meth:`from_wire` round-trip the error as a plain
    dict so a router can transport a shed across a process boundary
    without losing its type or its ``retry_after_s``."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _WIRE_KINDS[cls.__name__] = cls

    def to_wire(self) -> dict:
        """Serialize to a plain dict: ``{"kind", "message",
        "retry_after_s"}`` — everything a remote caller needs to back
        off correctly."""
        return {"kind": type(self).__name__,
                "message": str(self),
                "retry_after_s": self.retry_after_s}

    @staticmethod
    def from_wire(d: dict) -> "RetryableServingError":
        """Reconstruct a typed shed from :meth:`to_wire` output. The
        concrete class is looked up by ``kind``; an unknown kind
        deserializes as the base class so cross-version fleets still
        agree on "retryable with this hint"."""
        cls = _WIRE_KINDS.get(str(d.get("kind", "")), RetryableServingError)
        hint = d.get("retry_after_s")
        return cls(str(d.get("message", "")),
                   retry_after_s=None if hint is None else float(hint))


class PoisonedRequestError(ServingError):
    """This request's input makes the model fail or produce non-finite
    outputs — it was quarantined by the bisecting dispatcher instead of
    failing its co-batched neighbours. ``request_id`` names the request;
    ``__cause__`` (when set) is the exec error the bisection isolated."""

    def __init__(self, message: str, request_id: Optional[int] = None):
        super().__init__(message)
        self.request_id = request_id


class ReloadFailedError(ServingError):
    """``reload_from()`` could not safely swap parameters. When
    ``rolled_back`` is True the previous parameters were restored and
    the server keeps serving exactly what it served before the attempt;
    ``report`` carries the machine-readable reload accounting."""

    def __init__(self, message: str, report: Optional[dict] = None,
                 rolled_back: bool = False):
        super().__init__(message)
        self.report = dict(report or {})
        self.rolled_back = rolled_back


@dataclass
class ResilienceConfig:
    """Knobs for the serving resilience rail (``ParallelInference
    (resilience=...)``; ``True`` means this default config).

    - ``admission``: shed deadline-carrying requests whose estimated
      wait (queued batches ahead × rolling ``percentile`` exec time)
      already exceeds their deadline. Estimation starts after
      ``min_exec_samples`` observed execs (cold servers never shed on
      garbage estimates); ``window`` bounds the rolling sample.
    - ``breaker_failure_threshold``: consecutive exec failures that
      open the circuit (0 disables the breaker);
      ``breaker_reset_s``: open → half-open probe delay.
    - ``supervise``: run workers under a :class:`WorkerSupervisor`.
      ``worker_max_consecutive_errors`` unexpected worker-loop errors
      kill the worker (the supervisor restarts it with backoff between
      ``worker_backoff_base_s`` and ``worker_backoff_max_s``).
    - ``isolate_poisoned``: bisect failed batched execs down to the
      poisoned request; ``check_finite_outputs`` extends "failed" to
      any non-finite output row (how a NaN input actually manifests —
      the device does not raise on it); ``single_retries``: extra attempts a
      lone *raising* request gets before it is declared poisoned
      (absorbs a transient exec fault landing on a singleton; a
      non-finite output is deterministic and is quarantined at once).
    """

    admission: bool = True
    min_exec_samples: int = 8
    percentile: float = 95.0
    window: int = 256
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 2.0
    supervise: bool = True
    worker_backoff_base_s: float = 0.05
    worker_backoff_max_s: float = 2.0
    worker_max_consecutive_errors: int = 3
    isolate_poisoned: bool = True
    check_finite_outputs: bool = True
    single_retries: int = 1

    @staticmethod
    def normalize(value) -> Optional["ResilienceConfig"]:
        """None/False → None (rail off); True → defaults; a config
        passes through."""
        if value is None or value is False:
            return None
        if value is True:
            return ResilienceConfig()
        if isinstance(value, ResilienceConfig):
            return value
        raise TypeError(f"resilience= expects None/bool/ResilienceConfig, "
                        f"got {type(value).__name__}")


class CircuitBreaker:
    """Closed / open / half-open breaker over consecutive exec failures.

    Thread-safe; transitions invoke ``on_transition(old, new)`` OUTSIDE
    the internal lock (the callback pokes metrics
    and must not deadlock against probes). ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 2.0,
                 on_transition: Optional[Callable[[str, str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold <= 0:
            raise ValueError("failure_threshold must be positive")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _set_locked(self, new: str) -> Optional[tuple]:
        old = self._state
        if old == new:
            return None
        self._state = new
        return (old, new)

    def _notify(self, transition: Optional[tuple]) -> None:
        if transition is not None and self.on_transition is not None:
            self.on_transition(*transition)

    # -- submit side ----------------------------------------------------
    def reject_for(self) -> Optional[float]:
        """Seconds a new submit should back off, or None to admit.
        Open rejects until the probe window; half-open admits (the
        queued request is what the probe will serve)."""
        with self._lock:
            if self._state != "open":
                return None
            remaining = self.reset_timeout_s - (self._clock()
                                                - self._opened_at)
            if remaining > 0:
                return remaining
            return None          # probe window reached: admit

    # -- dispatch side --------------------------------------------------
    def acquire(self):
        """Worker gate before popping a batch: returns
        ``(allowed, wait_s)``. Open → ``(False, seconds-until-probe)``;
        the FIRST caller after the reset timeout transitions to
        half-open and owns the probe (others keep waiting). A caller
        that acquired but dispatched nothing must :meth:`release`."""
        transition = None
        try:
            with self._lock:
                if self._state == "closed":
                    return True, 0.0
                now = self._clock()
                if self._state == "open":
                    remaining = self.reset_timeout_s - (now - self._opened_at)
                    if remaining > 0:
                        return False, remaining
                    transition = self._set_locked("half_open")
                    self._probe_inflight = True
                    return True, 0.0
                # half-open: exactly one probe at a time
                if not self._probe_inflight:
                    self._probe_inflight = True
                    return True, 0.0
                return False, 0.05
        finally:
            self._notify(transition)

    def release(self) -> None:
        """Give back an acquired probe that dispatched nothing."""
        with self._lock:
            if self._state == "half_open":
                self._probe_inflight = False

    # -- outcomes -------------------------------------------------------
    def on_success(self) -> None:
        transition = None
        with self._lock:
            self._consecutive = 0
            if self._state == "half_open":
                self._probe_inflight = False
                transition = self._set_locked("closed")
        self._notify(transition)

    def on_failure(self) -> None:
        transition = None
        with self._lock:
            self._consecutive += 1
            if self._state == "half_open":
                self._probe_inflight = False
                self._opened_at = self._clock()
                transition = self._set_locked("open")
            elif self._state == "closed" and \
                    self._consecutive >= self.failure_threshold:
                self._opened_at = self._clock()
                transition = self._set_locked("open")
        self._notify(transition)


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

    def exec_ms(self, p: Optional[float] = None) -> float:
        with self._lock:
            return self._pcts.percentile(self.percentile if p is None
                                         else p)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pcts)

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
    ping-pong), and the worker is respawned after bounded exponential
    backoff. ``on_crash`` runs first for each crash.
    """

    def __init__(self, spawn: Callable[[int, InflightSlot], threading.Thread],
                 n_workers: int, queue, metrics,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 2.0,
                 poll_s: float = 0.02,
                 on_crash: Optional[Callable[[], None]] = None):
        self._spawn = spawn
        self._queue = queue
        self._metrics = metrics
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.poll_s = float(poll_s)
        # run per crash BEFORE requeue — the server uses it to release
        # a half-open breaker probe the dead worker may have been
        # holding (a leaked probe would gate dispatch forever)
        self._on_crash = on_crash or (lambda: None)
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
        self._on_crash()
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


__all__ = ["AdmissionController", "CircuitBreaker",
           "InflightSlot", "PoisonedRequestError", "ReloadFailedError",
           "ResilienceConfig", "RetryableServingError", "ServingError",
           "WorkerSupervisor"]
