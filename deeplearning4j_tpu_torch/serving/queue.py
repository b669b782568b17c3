"""Bounded request queue with backpressure, deadlines and graceful drain.

Counterpart of ``deeplearning4j_tpu/serving/queue.py`` (host code, copied
and adapted): a hard ``max_queue_len`` past which ``put`` raises
:class:`ServerOverloadedError`, per-request deadlines that expire before
dispatch, crash-recovery ``requeue`` at the front, and a two-phase
``close`` (drain, or fail pending futures with
:class:`ServerClosedError`). ``InferenceRequest.complete`` and
``collapse_outputs`` belong to ``ParallelInference``'s reply path, which
is not ported yet.
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
    """Admission rejected: the queue is at ``max_queue_len``, or the SLO
    admission controller estimates the request cannot meet its deadline.

    A :class:`~deeplearning4j_tpu_torch.serving.resilience.RetryableServingError`:
    ``retry_after_s`` -- when set -- is the structured backoff hint (how
    long the shedding condition is expected to persist), and the error
    round-trips across process boundaries via ``to_wire()``/
    ``from_wire()``."""


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


@dataclass
class InferenceRequest:
    """One queued unit of work: a (rows, ...) feature array + its future."""

    x: object                       # array or per-input list; leading
                                    # dim of each array = rows
    future: Future
    rows: int
    enqueue_t: float = field(default_factory=_now)
    deadline: Optional[float] = None    # absolute time.monotonic(), or None
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


class RequestQueue:
    """FIFO of :class:`InferenceRequest` with bounded depth.

    Producers call :meth:`put` (non-blocking; raises on overload/closed).
    Consumers call :meth:`take`, which blocks until live work, shutdown,
    or timeout, and pops greedily up to a row budget.
    """

    def __init__(self, max_queue_len: int = 256,
                 on_timeout=None):
        if max_queue_len <= 0:
            raise ValueError("max_queue_len must be positive")
        self.max_queue_len = int(max_queue_len)
        self._dq: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._drain = True
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
            self._not_empty.notify()

    # -- consumer side --------------------------------------------------
    def take(self, max_rows: int, timeout: Optional[float] = None
             ) -> List[InferenceRequest]:
        """Pop live requests whose total rows fit ``max_rows``.

        Blocks up to ``timeout`` seconds (None = until work or close) for
        the FIRST request; never blocks for follow-ups — it greedily pops
        already-queued requests while they fit the row budget. Requests
        whose deadline has passed are completed with
        :class:`RequestTimeoutError` and skipped. Returns ``[]`` on
        timeout or when the queue is closed and empty.

        A single request larger than ``max_rows`` goes through as the
        sole result.

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
                got = self._pop_live_locked(max_rows, expired)
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

    def _pop_live_locked(self, max_rows: int,
                         expired: List[InferenceRequest]
                         ) -> List[InferenceRequest]:
        out: List[InferenceRequest] = []
        rows = 0
        now = _now()
        while self._dq:
            head = self._dq[0]
            if head.expired(now):
                self._dq.popleft()
                expired.append(head)     # completed by take(), post-lock
                continue
            if out and rows + head.rows > max_rows:
                break
            self._dq.popleft()
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
            self._not_empty.notify_all()
        for req in aborted:
            req.fail(ServerClosedError(
                "server shut down before this request was served"))

    @property
    def finished(self) -> bool:
        """Closed and nothing left to serve — consumer exit condition."""
        with self._lock:
            return self._closed and not self._dq

    def pending(self) -> int:
        with self._lock:
            return len(self._dq)


__all__ = ["InferenceRequest", "RequestQueue", "RequestTimeoutError",
           "ServerClosedError", "ServerOverloadedError", "ServingError",
           "ServingTimeoutError"]
