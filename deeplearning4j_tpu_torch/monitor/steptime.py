"""Rolling order statistics of step times.

Counterpart of ``deeplearning4j_tpu/monitor/steptime.py``, cut to
``RollingPercentiles`` (:76), which the serving tier's admission
controller keeps its decode-step times in.
"""
from __future__ import annotations

import bisect
from typing import List


class RollingPercentiles:
    """Rolling-window order statistics over the last ``window`` values
    (bisect-maintained sorted list: O(log n) insert, O(1) percentile)."""

    def __init__(self, window: int = 512):
        self.window = int(window)
        self._ring: List[float] = []
        self._sorted: List[float] = []
        self._next = 0

    def add(self, value: float) -> None:
        v = float(value)
        if len(self._ring) < self.window:
            self._ring.append(v)
        else:
            old = self._ring[self._next]
            del self._sorted[bisect.bisect_left(self._sorted, old)]
            self._ring[self._next] = v
            self._next = (self._next + 1) % self.window
        bisect.insort(self._sorted, v)

    def __len__(self) -> int:
        return len(self._sorted)

    def percentile(self, p: float) -> float:
        if not self._sorted:
            return 0.0
        idx = min(len(self._sorted) - 1,
                  max(0, int(round(p / 100.0 * (len(self._sorted) - 1)))))
        return self._sorted[idx]
