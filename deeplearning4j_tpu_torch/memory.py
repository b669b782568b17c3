"""Device memory accounting.

Counterpart of ``deeplearning4j_tpu/memory.py``, cut to what the port's
serving tier needs: :class:`AllocationsTracker` (:226), the tagged byte
counts that the servers' KV slabs are booked under, and the two errors a
guarded allocation or an out-of-memory dispatch raise
(:class:`MemoryHeadroomError` :350, :class:`MemoryExhaustedError` :283,
here with the card's counters from ``torch.cuda`` in place of the PJRT
snapshot and live-array census).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional


class AllocationsTracker:
    """Counting tracker for explicit instrumentation points: what callers
    tag (the serving tier's ``kv_slab``). Thread-safe; ``release`` clamps
    at zero, so an unmatched release never drives a total negative."""

    _instance: Optional["AllocationsTracker"] = None

    def __init__(self):
        self._lock = threading.Lock()
        self._tracked: Dict[str, int] = {}
        self._counts: Dict[str, int] = {}

    @classmethod
    def get_instance(cls) -> "AllocationsTracker":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def allocate(self, tag: str, nbytes: int) -> None:
        with self._lock:
            self._tracked[tag] = self._tracked.get(tag, 0) + int(nbytes)
            self._counts[tag] = self._counts.get(tag, 0) + 1

    def release(self, tag: str, nbytes: int) -> None:
        with self._lock:
            self._tracked[tag] = max(
                0, self._tracked.get(tag, 0) - int(nbytes))

    def bytes_tracked(self, tag: str) -> int:
        with self._lock:
            return self._tracked.get(tag, 0)


class MemoryExhaustedError(RuntimeError):
    """A device allocation failed during a dispatch, with the card's
    memory counters at the time (``devices``) attached."""

    def __init__(self, message: str, *, program: Optional[str] = None,
                 devices: Optional[list] = None):
        super().__init__(message)
        self.program = program
        self.devices = list(devices or [])
        self.cause = "oom"


class MemoryHeadroomError(RuntimeError):
    """A guarded allocation (the serving tier's KV slabs) was refused
    because it needs more than the card has free, before the allocator
    fails."""

    def __init__(self, message: str, *, required_bytes: int = 0,
                 headroom_bytes: int = 0):
        super().__init__(message)
        self.required_bytes = int(required_bytes)
        self.headroom_bytes = int(headroom_bytes)
