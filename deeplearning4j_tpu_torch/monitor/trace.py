"""Span tracer: host wall-time spans of the serving lifecycle.

Counterpart of ``deeplearning4j_tpu/monitor/trace.py``, cut to what the
port's serving tier uses: :data:`TRACER`, its ``span(name, cat, **args)``
context manager (with ``set`` and ``discard``) and its ``enabled``
switch. Disabled (the default), a
span is one attribute check returning a shared no-op object; enabled,
spans are recorded per thread, with their nesting, into a bounded ring
(:meth:`Tracer.spans`). The Chrome-trace export, incremental drains and
the ``traced`` decorator of the JAX module are not ported.

Spans time the HOST: a ``serving.decode`` span covers the host's enqueue
of the step and its wait for the step's tokens.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List


class _NullSpan:
    """The disabled path: a shared, stateless, no-op span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **args) -> "_NullSpan":
        return self

    def discard(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """One live (then completed) span. Create via :meth:`Tracer.span`."""

    __slots__ = ("tracer", "name", "cat", "args", "t0", "dur", "tid", "sid",
                 "parent", "_discarded")

    _ids = itertools.count(1)

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.dur = 0.0
        self.tid = 0
        self.sid = 0
        self.parent = 0        # sid of the enclosing span on this thread
        self._discarded = False

    def __enter__(self) -> "Span":
        self.tid = threading.get_ident()
        self.sid = next(Span._ids)
        stack = self.tracer._stack()
        if stack:
            self.parent = stack[-1].sid
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur = time.perf_counter() - self.t0
        stack = self.tracer._stack()
        if self in stack:
            stack.remove(self)
        if exc_type is not None:
            self.args = dict(self.args, error=exc_type.__name__)
        if not self._discarded:
            self.tracer._record(self)
        return False

    def set(self, **args) -> "Span":
        """Attach or overwrite span args."""
        self.args.update(args)
        return self

    def discard(self) -> None:
        """Drop this span on exit (an empty poll, say)."""
        self._discarded = True


class Tracer:
    """Thread-safe ring-buffered span tracer. ``enabled`` flips the call
    sites from no-op to recording in place."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._buf: "collections.deque[Span]" = collections.deque(
            maxlen=int(capacity))
        self._tls = threading.local()

    def span(self, name: str, cat: str = "", **args):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, cat, args)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, span: Span) -> None:
        with self._lock:
            self._buf.append(span)

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def reset(self) -> "Tracer":
        with self._lock:
            self._buf.clear()
        return self

    def spans(self) -> List[Span]:
        """The completed spans still in the ring, oldest first."""
        with self._lock:
            return list(self._buf)


#: the process-wide tracer every instrumented call site holds
TRACER = Tracer()
