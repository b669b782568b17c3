"""Power-of-two shape buckets.

Counterpart of ``deeplearning4j_tpu/serving/batching.py``, cut to
:func:`pow2_buckets` and :class:`BucketSpec` (host code, copied): the
generative servers pad a prompt to the smallest bucket of a pow2 ladder,
so a prompt-length mix meets at most log2(max_seq) + 1 prefill shapes,
each built and run once at warmup. ``DynamicBatcher`` and the padded
``Batch`` belong to ``ParallelInference``, not ported yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple


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


__all__ = ["BucketSpec", "pow2_buckets"]
