"""Dynamic batching with power-of-two shape buckets.

Counterpart of ``deeplearning4j_tpu/serving/batching.py`` (host code,
copied and adapted): ``ParallelInference``'s BATCHED mode coalesces
concurrent requests into one model invocation, padded up to a small
fixed set of power-of-two row counts (by default 4). The JAX package
buckets so that ``jax.jit`` compiles O(len(buckets)) programs; on the
card the buckets bound the shapes cuDNN and cuBLAS choose kernels for
(each met once at warmup), and they make the served rows of a request
a function of its bucket alone, whatever it was batched with. Padding
rows are zeros; they ride along through the forward and are sliced off
before futures resolve. Padding stays numpy on the host: a batch is one
host-to-device copy of the padded bucket and one read of its outputs.
The generative servers use :func:`pow2_buckets` and :class:`BucketSpec`
for their prefill ladder.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.monitor.trace import TRACER as _tracer
from deeplearning4j_tpu_torch.serving.queue import (InferenceRequest,
                                                    RequestQueue)


def pow2_buckets(max_batch_size: int, n_buckets: int = 4) -> Tuple[int, ...]:
    """Power-of-two row-count buckets ending at ``max_batch_size``.

    E.g. ``pow2_buckets(32) == (4, 8, 16, 32)``: halving down from the
    cap for ``n_buckets`` steps (stopping at 1). Once a dispatch fills
    the smallest bucket, padding waste is <50%; below it (a lone
    request under light load) waste can reach
    ``(smallest - 1) / smallest`` — include bucket 1 if that matters
    more than the extra compile. Total compilations are bounded by the
    bucket count regardless of request-size mix.
    """
    if max_batch_size <= 0:
        raise ValueError("max_batch_size must be positive")
    buckets = [int(max_batch_size)]
    while len(buckets) < n_buckets and buckets[0] > 1:
        buckets.insert(0, max(1, buckets[0] // 2))
    return tuple(dict.fromkeys(buckets))


class BucketSpec:
    """Sorted row-count buckets + lookup of the smallest fitting bucket."""

    def __init__(self, buckets: Sequence[int]):
        bs = sorted({int(b) for b in buckets})
        if not bs or bs[0] <= 0:
            raise ValueError(f"invalid buckets {buckets!r}")
        self.buckets = tuple(bs)

    @property
    def max_rows(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, rows: int) -> int:
        if rows > self.max_rows:
            raise ValueError(f"{rows} rows exceed largest bucket "
                             f"{self.max_rows}")
        for b in self.buckets:
            if rows <= b:
                return b
        raise AssertionError  # unreachable

    def __repr__(self):
        return f"BucketSpec{self.buckets}"


def scatter_rows(requests: Sequence[InferenceRequest],
                 outputs: Sequence[np.ndarray]) -> List[InferenceRequest]:
    """Scatter per-output row slices back to each request's future —
    THE one implementation of the reply contract (used by Batch.resolve
    and the resilient bisecting dispatcher). Each request's deadline is
    re-checked by ``complete()``; the returned list holds the requests
    whose deadline passed during exec (their futures got
    ServingTimeoutError, not the stale result — the caller records the
    timeouts)."""
    off = 0
    expired: List[InferenceRequest] = []
    for req in requests:
        if not req.complete([np.asarray(o[off:off + req.rows])
                             for o in outputs]):
            expired.append(req)
        off += req.rows
    return expired


@dataclass
class Batch:
    """One coalesced dispatch: padded features + the requests inside it."""

    requests: List[InferenceRequest]
    features: np.ndarray            # (bucket, *feat) — zero-padded
    rows: int                       # real rows (== sum of request rows)
    bucket: int                     # padded row count actually dispatched
    created_t: float = field(default_factory=time.monotonic)

    @property
    def padding(self) -> int:
        return self.bucket - self.rows

    def resolve(self, outputs: List[np.ndarray]) -> List[InferenceRequest]:
        """Scatter row slices to futures (see :func:`scatter_rows`)."""
        return scatter_rows(self.requests, outputs)

    def fail(self, exc: BaseException) -> None:
        for req in self.requests:
            req.fail(exc)


def pad_to_bucket(arrays: Sequence[np.ndarray], bucket: int) -> np.ndarray:
    """Stack request arrays along rows and zero-pad to ``bucket`` rows."""
    stacked = np.concatenate(arrays, axis=0) if len(arrays) > 1 \
        else np.asarray(arrays[0])
    pad = bucket - stacked.shape[0]
    if pad < 0:
        raise ValueError(f"{stacked.shape[0]} rows exceed bucket {bucket}")
    if pad == 0:
        return stacked
    return np.concatenate(
        [stacked, np.zeros((pad,) + stacked.shape[1:], stacked.dtype)],
        axis=0)


class DynamicBatcher:
    """Pulls requests off a :class:`RequestQueue` into padded batches.

    Coalescing: block for the first request, then keep absorbing queued
    requests until the batch holds ``max_batch_size`` rows or
    ``max_delay_ms`` has elapsed since the first pop — the classic
    size-or-deadline trigger. The result is padded to the smallest
    bucket that fits (see :func:`pow2_buckets`).

    Thread-safe: several workers may call :meth:`next_batch`
    concurrently; the queue's lock makes each request land in exactly
    one batch.
    """

    def __init__(self, queue: RequestQueue, max_batch_size: int = 32,
                 max_delay_ms: float = 5.0,
                 buckets: Optional[Sequence[int]] = None):
        self.queue = queue
        self.max_batch_size = int(max_batch_size)
        self.max_delay_ms = float(max_delay_ms)
        self.spec = BucketSpec(buckets if buckets is not None
                               else pow2_buckets(self.max_batch_size))
        if self.spec.max_rows < self.max_batch_size:
            raise ValueError(
                f"largest bucket {self.spec.max_rows} < max_batch_size "
                f"{self.max_batch_size}: full batches could not dispatch")

    def next_batch(self, poll_timeout: float = 0.1) -> Optional[Batch]:
        """Build the next batch, or return None on timeout/shutdown."""
        reqs = self.queue.take(self.max_batch_size, timeout=poll_timeout,
                               strict=True)
        if not reqs:
            return None
        rows = sum(r.rows for r in reqs)
        deadline = time.monotonic() + self.max_delay_ms / 1000.0
        while rows < self.max_batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            more = self.queue.take(self.max_batch_size - rows,
                                   timeout=remaining, strict=True)
            if not more:
                break
            reqs.extend(more)
            rows += sum(r.rows for r in more)
        try:
            bucket = self.spec.bucket_for(rows)
            # req.x is the per-input list built by submit(); batching is
            # single-input, so the first (only) entry is the feature array
            with _tracer.span("serving.pad", cat="serving", rows=rows,
                              bucket=bucket):
                features = pad_to_bucket(
                    [np.asarray(r.x[0] if isinstance(r.x, (list, tuple))
                                else r.x) for r in reqs], bucket)
        except Exception as e:
            # never strand popped requests: a malformed batch (e.g.
            # mismatched feature widths) fails ITS requests, not the
            # worker thread
            for r in reqs:
                r.fail(e)
            return None
        return Batch(requests=reqs, features=features, rows=rows,
                     bucket=bucket)


__all__ = ["Batch", "BucketSpec", "DynamicBatcher", "pad_to_bucket",
           "pow2_buckets", "scatter_rows"]
