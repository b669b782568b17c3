"""Serving metrics: counters and latency histograms.

Counterpart of ``deeplearning4j_tpu/serving/metrics.py`` (host code,
copied): :func:`safe_ratio`, :class:`LatencyHistogram` (fixed log-spaced
bins, O(1) recording, percentiles from the cumulative counts) and
:class:`ServingMetrics`: queue wait, end-to-end and exec latency, batch
occupancy and padding waste (:meth:`~ServingMetrics.observe_batch`),
compiled shapes, rejection / timeout / resilience counters and the
breaker state (:meth:`~ServingMetrics.set_resilience`). ``to_record()``
gives one ``{"type": "serving", ...}`` record and ``publish`` appends it
to any object with ``put(record)`` (the JAX package's ``StatsStorage``
is not ported yet, ROADMAP queue 1 item 2.8).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

# log-spaced bin edges (ms): 0.01 ms .. 60 s, ~12 bins per decade
_EDGES = np.geomspace(0.01, 60_000.0, 82)


def safe_ratio(num: float, den: float) -> float:
    """``num / den`` with 0.0 (not NaN/inf) on a zero denominator — the
    cold-start rule for every exported gauge ratio: a dashboard reading
    prefix-hit-rate or pool-occupancy before the first sample must see
    a number it can plot/alert on."""
    den = float(den)
    if den == 0.0 or not np.isfinite(den):
        return 0.0
    return float(num) / den


class LatencyHistogram:
    """Fixed-bin log-scale latency histogram with percentile readout."""

    def __init__(self, edges: Optional[np.ndarray] = None):
        self.edges = np.asarray(edges if edges is not None else _EDGES,
                                np.float64)
        # one underflow + one overflow bucket
        self.counts = np.zeros(len(self.edges) + 1, np.int64)
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0

    def record(self, ms: float) -> None:
        # NaN-free by construction: a non-finite sample (a clock glitch,
        # a 0-row dispatch timed as 0/0 upstream) records as 0.0 instead
        # of poisoning total_ms/max_ms and every later mean()
        ms = float(ms)
        if not np.isfinite(ms):
            ms = 0.0
        self.counts[int(np.searchsorted(self.edges, ms, side="left"))] += 1
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)

    def percentile(self, p: float) -> float:
        """p in [0, 100]; returns the upper edge of the bucket holding
        the p-th sample (a conservative estimate), 0.0 when empty —
        never NaN (the guard dashboards divide/alert on)."""
        if self.count == 0:
            return 0.0
        target = max(1, int(np.ceil(p / 100.0 * self.count)))
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, target))
        if idx >= len(self.edges):
            return float(self.max_ms)
        # upper edge of the bucket holding the target sample, clamped to
        # the exact observed max (an edge can overshoot it)
        return float(min(self.edges[idx], self.max_ms))

    def mean(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        """Stats dict; ``count`` rides along and ``low_sample`` flags a
        histogram whose tail percentiles are read from fewer than 32
        samples (a p99 of 3 requests is the max, not a p99 — consumers
        should render it with that caveat)."""
        return {"count": int(self.count),
                "low_sample": bool(self.count < 32),
                "mean": round(self.mean(), 4),
                "p50": round(self.percentile(50), 4),
                "p95": round(self.percentile(95), 4),
                "p99": round(self.percentile(99), 4),
                "max": round(self.max_ms, 4)}


_COUNTERS = ("requests_submitted", "requests_served", "requests_rejected",
             "requests_timed_out", "requests_failed", "batches_dispatched",
             "rows_served", "rows_padded", "compiles", "warmup_compiles",
             # the resilience rail: SLO sheds at admission, breaker trips,
             # crash-recovery requeues and worker restarts, transient exec
             # faults absorbed, bisection splits and quarantined poisoned
             # requests, hot reloads
             "requests_shed", "breaker_opens", "requests_requeued",
             "worker_restarts", "exec_faults", "bisect_splits",
             "poisoned_quarantined", "reloads", "reload_rollbacks")


class ServingMetrics:
    """Thread-safe accumulator for one server."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {c: 0 for c in _COUNTERS}
        self.queue_wait_ms = LatencyHistogram()
        self.e2e_ms = LatencyHistogram()
        self.exec_ms = LatencyHistogram()
        self.batch_sizes: Dict[int, int] = {}   # real rows -> dispatches
        # per-cause breakdowns + the most recent failure, so serving
        # degradation is attributable BEFORE it becomes an outage
        self.failure_causes: Dict[str, int] = {}
        self.timeout_causes: Dict[str, int] = {}
        self.last_error: Optional[dict] = None
        # resilience state snapshot (breaker state, ...), exported in
        # to_record()
        self.resilience: Dict[str, object] = {}
        self._start_t = time.time()

    # -- recording ------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def record_failure(self, error: BaseException,
                       cause: Optional[str] = None, n: int = 1) -> None:
        """One failed dispatch affecting ``n`` requests; ``cause``
        defaults to the exception class name."""
        cause = cause or type(error).__name__
        with self._lock:
            self.counters["requests_failed"] += n
            self.failure_causes[cause] = \
                self.failure_causes.get(cause, 0) + n
            self.last_error = {"kind": "failure", "cause": cause,
                              "error": repr(error), "t": time.time()}

    def record_timeout(self, cause: str = "deadline",
                       error: Optional[BaseException] = None,
                       n: int = 1) -> None:
        with self._lock:
            self.counters["requests_timed_out"] += n
            self.timeout_causes[cause] = \
                self.timeout_causes.get(cause, 0) + n
            self.last_error = {"kind": "timeout", "cause": cause,
                              "error": repr(error) if error else None,
                              "t": time.time()}

    def set_resilience(self, **fields) -> None:
        """Merge resilience-state fields (``breaker_state``, ...) into the
        exported snapshot."""
        with self._lock:
            self.resilience.update(fields)

    def observe_batch(self, rows: int, padding: int, exec_ms: float) -> None:
        """Negative/zero rows and non-finite exec times record as
        zeros (``LatencyHistogram.record`` guards the time): an
        empty/degenerate dispatch must not put NaN into the padding-
        waste or mean-size divisions downstream."""
        rows, padding = max(0, int(rows)), max(0, int(padding))
        with self._lock:
            self.counters["batches_dispatched"] += 1
            self.counters["rows_served"] += rows
            self.counters["rows_padded"] += padding
            self.batch_sizes[rows] = self.batch_sizes.get(rows, 0) + 1
            self.exec_ms.record(exec_ms)

    def observe_request(self, queue_wait_ms: float, e2e_ms: float) -> None:
        with self._lock:
            self.counters["requests_served"] += 1
            self.queue_wait_ms.record(queue_wait_ms)
            self.e2e_ms.record(e2e_ms)

    # -- readout --------------------------------------------------------
    def padding_waste(self) -> float:
        """Fraction of dispatched rows that were padding."""
        with self._lock:
            c = self.counters
            return safe_ratio(c["rows_padded"],
                              c["rows_served"] + c["rows_padded"])

    def mean_batch_size(self) -> float:
        with self._lock:
            return safe_ratio(self.counters["rows_served"],
                              self.counters["batches_dispatched"])

    def to_record(self) -> dict:
        """One ``{"type": "serving", ...}`` record."""
        with self._lock:
            c = self.counters
            dispatched, rows = c["batches_dispatched"], c["rows_served"]
            return {
                "type": "serving",
                "t": time.time(),
                "uptime_s": round(time.time() - self._start_t, 3),
                "counters": dict(c),
                "failure_causes": dict(self.failure_causes),
                "timeout_causes": dict(self.timeout_causes),
                "last_error": dict(self.last_error)
                if self.last_error else None,
                "resilience": dict(self.resilience)
                if self.resilience else None,
                "latency_ms": {"queue_wait": self.queue_wait_ms.summary(),
                               "e2e": self.e2e_ms.summary(),
                               "exec": self.exec_ms.summary()},
                "batch": {
                    "mean_size": round(safe_ratio(rows, dispatched), 3),
                    "padding_waste": round(safe_ratio(
                        c["rows_padded"], rows + c["rows_padded"]), 4),
                    "size_hist": {str(k): v for k, v in
                                  sorted(self.batch_sizes.items())}},
            }

    def publish(self, storage) -> dict:
        """Append the current snapshot to ``storage`` (``put(record)``)."""
        rec = self.to_record()
        storage.put(rec)
        return rec

    def stats(self) -> str:
        """Printable summary (the Evaluation.stats() convention)."""
        rec = self.to_record()
        c = rec["counters"]
        lines = [f"ServingMetrics: {c['requests_served']} served / "
                 f"{c['requests_submitted']} submitted "
                 f"({c['requests_rejected']} rejected, "
                 f"{c['requests_shed']} shed, "
                 f"{c['requests_timed_out']} timed out, "
                 f"{c['requests_failed']} failed)",
                 f"  batches: {c['batches_dispatched']} dispatched, "
                 f"mean size {rec['batch']['mean_size']}, padding waste "
                 f"{rec['batch']['padding_waste']:.1%}, "
                 f"{c['compiles']} compiled shapes "
                 f"({c['warmup_compiles']} prewarmed)"]
        for name in ("queue_wait", "e2e", "exec"):
            s = rec["latency_ms"][name]
            lines.append(f"  {name:<10} p50 {s['p50']:.3f} ms  "
                         f"p95 {s['p95']:.3f} ms  p99 {s['p99']:.3f} ms  "
                         f"max {s['max']:.3f} ms  (n={s['count']})")
        causes = {**rec["failure_causes"],
                  **{f"timeout:{k}": v
                     for k, v in rec["timeout_causes"].items()}}
        if causes:
            lines.append("  causes: " + ", ".join(
                f"{k}={v}" for k, v in sorted(causes.items())))
        if rec["last_error"]:
            le = rec["last_error"]
            lines.append(f"  last_error: [{le['cause']}] {le['error']}")
        res = rec.get("resilience")
        resil_counts = {k: c[k] for k in
                        ("requests_shed", "breaker_opens",
                         "worker_restarts", "requests_requeued",
                         "poisoned_quarantined", "reloads",
                         "reload_rollbacks") if c.get(k)}
        if res or resil_counts:
            bits = [f"{k}={v}" for k, v in sorted(resil_counts.items())]
            if res and res.get("breaker_state"):
                bits.insert(0, f"breaker={res['breaker_state']}")
            lines.append("  resilience: " + ", ".join(bits))
        return "\n".join(lines)


__all__ = ["LatencyHistogram", "ServingMetrics", "safe_ratio"]
