"""Bounded request queue with backpressure, deadlines and graceful drain.

Counterpart of ``deeplearning4j_tpu/serving/queue.py`` (host code, copied
and adapted): a hard ``max_queue_len`` past which ``put`` raises
:class:`ServerOverloadedError` (load shedding at admission), per-request
deadlines that expire AT DISPATCH (a request that already missed its
deadline is never sent to the device) and again at reply
(:meth:`InferenceRequest.complete`), crash-recovery ``requeue`` at the
front, and a two-phase ``close``: drain (stop intake, finish queued work)
or abort (fail pending futures with :class:`ServerClosedError`).

All coordination is one lock + one condition; consumers block in
:meth:`RequestQueue.take`, which is also where the coalescing row budget
lives, so every consumer (a ``ParallelInference`` worker, its dynamic
batcher, a generative server) shares the same expiry and shutdown
behavior.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

from deeplearning4j_tpu_torch.serving.resilience import (
    RetryableServingError, ServingError)


class ServerOverloadedError(RetryableServingError):
    """Admission rejected: the queue is at ``max_queue_len``, the SLO
    admission controller estimates the request cannot meet its deadline,
    or the circuit breaker is open (serving/resilience.py).

    A :class:`~deeplearning4j_tpu_torch.serving.resilience.RetryableServingError`:
    ``retry_after_s`` — when set — is the structured backoff hint (how
    long the shedding condition is expected to persist: estimated queue
    drain, or the breaker's time-to-probe), and the error round-trips
    across process boundaries via ``to_wire()``/``from_wire()``."""


class RequestTimeoutError(ServingError):
    """The request's deadline passed before it was dispatched."""


class ServingTimeoutError(RequestTimeoutError):
    """The request's deadline passed DURING execution: the result
    arrived, but past the SLO — surfaced as a timeout instead of a
    stale success (the reply-time deadline re-check)."""


class ServerClosedError(ServingError):
    """Submitted after ``shutdown()`` (or aborted by a non-drain close)."""


def _now() -> float:
    return time.monotonic()


def collapse_outputs(outputs, squeeze: bool):
    """Shape a request's per-output row arrays into its result: drop the
    row dim for single-example submits, collapse one-output models to a
    bare array. The ONE place defining the result contract for all
    modes (BATCHED scatter, SEQUENTIAL, INPLACE)."""
    sl = [o[0] for o in outputs] if squeeze else list(outputs)
    return sl if len(sl) > 1 else sl[0]


@dataclass
class InferenceRequest:
    """One queued unit of work: a (rows, ...) feature array + its future."""

    x: object                       # array or per-input list; leading
                                    # dim of each array = rows
    future: Future
    rows: int
    enqueue_t: float = field(default_factory=_now)
    deadline: Optional[float] = None    # absolute time.monotonic(), or None
    squeeze: bool = False               # single-example submit: drop row dim
    id: int = 0
    requeues: int = 0                   # crash-recovery requeues (max 1)

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else _now()) > self.deadline

    def time_out(self) -> None:
        if not self.future.done():
            self.future.set_exception(RequestTimeoutError(
                f"request {self.id} expired after "
                f"{(_now() - self.enqueue_t) * 1000:.1f} ms in queue"))

    def fail(self, exc: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(exc)

    def complete(self, outputs) -> bool:
        """Resolve with this request's row slices (see collapse_outputs)
        — unless the deadline passed while the batch executed: a request
        that expires DURING exec must not complete as a stale success,
        so its future gets :class:`ServingTimeoutError` instead and
        this returns False (the caller records the timeout)."""
        if self.expired():
            if not self.future.done():
                self.future.set_exception(ServingTimeoutError(
                    f"request {self.id} missed its deadline by "
                    f"{(_now() - self.deadline) * 1000:.1f} ms during "
                    f"execution"))
            return False
        if not self.future.done():
            self.future.set_result(collapse_outputs(outputs, self.squeeze))
        return True


class RequestQueue:
    """FIFO of :class:`InferenceRequest` with bounded depth.

    Producers call :meth:`put` (non-blocking; raises on overload/closed).
    Consumers call :meth:`take`, which blocks until live work, shutdown,
    or timeout, and pops greedily up to a row budget so a batcher can
    coalesce several requests in one call.
    """

    def __init__(self, max_queue_len: int = 256,
                 on_timeout=None):
        if max_queue_len <= 0:
            raise ValueError("max_queue_len must be positive")
        self.max_queue_len = int(max_queue_len)
        self._dq: deque = deque()
        self._rows = 0                  # queued rows (admission estimates)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._drain = True
        self._timed_out = 0             # expired-at-dispatch count
        self._on_timeout = on_timeout   # callback(req) per expiry

    # -- producer side --------------------------------------------------
    def put(self, req: InferenceRequest) -> None:
        with self._lock:
            if self._closed:
                raise ServerClosedError("request queue is closed")
            if len(self._dq) >= self.max_queue_len:
                raise ServerOverloadedError(
                    f"queue full ({self.max_queue_len} pending); retry "
                    f"with backoff")
            self._dq.append(req)
            self._rows += req.rows
            self._not_empty.notify()

    def requeue(self, req: InferenceRequest) -> None:
        """Put an already-admitted request back at the FRONT of the
        queue (crash recovery: it already waited its turn). Bypasses
        the capacity check — the request was admitted once and its
        future is outstanding; a bounds rejection here would drop it.
        Allowed while a drain is in progress (queued work is still
        being served); raises :class:`ServerClosedError` only after a
        non-drain close."""
        with self._lock:
            if self._closed and not self._drain:
                raise ServerClosedError(
                    "request queue is closed without drain")
            self._dq.appendleft(req)
            self._rows += req.rows
            self._not_empty.notify()

    # -- consumer side --------------------------------------------------
    def take(self, max_rows: int, timeout: Optional[float] = None,
             strict: bool = False) -> List[InferenceRequest]:
        """Pop live requests whose total rows fit ``max_rows``.

        Blocks up to ``timeout`` seconds (None = until work or close) for
        the FIRST request; never blocks for follow-ups — it greedily pops
        already-queued requests while they fit the row budget. Requests
        whose deadline has passed are completed with
        :class:`RequestTimeoutError` and skipped. Returns ``[]`` on
        timeout or when the queue is closed and empty.

        ``strict=False`` lets a single request larger than ``max_rows``
        through as the sole result (a sequential worker must serve any
        size); ``strict=True`` never exceeds the budget (a batcher
        topping up a partially full batch must not overshoot it).

        Expired futures are completed OUTSIDE the queue lock: a user
        done-callback may re-enter the queue (e.g. submit a retry), and
        completing under the non-reentrant lock would deadlock it.
        """
        end = None if timeout is None else _now() + timeout
        while True:
            expired: List[InferenceRequest] = []
            got: List[InferenceRequest] = []
            done = False
            with self._not_empty:
                got = self._pop_live_locked(max_rows, strict, expired)
                if got or self._closed:
                    done = True
                else:
                    remaining = None if end is None else end - _now()
                    if remaining is not None and remaining <= 0:
                        done = True
                    elif not expired:
                        # nothing to report yet: block for new work
                        self._not_empty.wait(remaining)
            for req in expired:          # lock released: safe to complete
                req.time_out()
                if self._on_timeout is not None:
                    self._on_timeout(req)
            if done:
                return got

    def _pop_live_locked(self, max_rows: int, strict: bool,
                         expired: List[InferenceRequest]
                         ) -> List[InferenceRequest]:
        out: List[InferenceRequest] = []
        rows = 0
        now = _now()
        while self._dq:
            head = self._dq[0]
            if head.expired(now):
                self._dq.popleft()
                self._rows -= head.rows
                self._timed_out += 1
                expired.append(head)     # completed by take(), post-lock
                continue
            if (out or strict) and rows + head.rows > max_rows:
                break
            self._dq.popleft()
            self._rows -= head.rows
            out.append(head)
            rows += head.rows
            if rows >= max_rows:
                break
        return out

    # -- lifecycle ------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Stop intake. ``drain=True`` lets consumers finish queued work;
        ``drain=False`` fails every pending future with
        :class:`ServerClosedError` immediately (outside the lock — see
        take())."""
        aborted: List[InferenceRequest] = []
        with self._lock:
            self._closed = True
            self._drain = drain
            if not drain:
                aborted = list(self._dq)
                self._dq.clear()
                self._rows = 0
            self._not_empty.notify_all()
        for req in aborted:
            req.fail(ServerClosedError(
                "server shut down before this request was served"))

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def finished(self) -> bool:
        """Closed and nothing left to serve — consumer exit condition."""
        with self._lock:
            return self._closed and not self._dq

    def pending(self) -> int:
        with self._lock:
            return len(self._dq)

    def pending_rows(self) -> int:
        """Total rows queued — the admission controller's backlog unit
        (dispatches drain up to ``max_batch_size`` rows at a time)."""
        with self._lock:
            return self._rows

    def timed_out_count(self) -> int:
        return self._timed_out

    def __len__(self) -> int:
        return self.pending()


__all__ = ["InferenceRequest", "RequestQueue", "RequestTimeoutError",
           "ServerClosedError", "ServerOverloadedError", "ServingError",
           "ServingTimeoutError", "collapse_outputs"]
