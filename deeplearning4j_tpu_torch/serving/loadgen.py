"""Closed- and open-loop load generation for the serving stack.

Counterpart of ``deeplearning4j_tpu/serving/loadgen.py``, copied as host
code: :class:`LoadResult` (:47), :class:`LoadGenerator` (:156), the
fixed-shape loops over ``ParallelInference``, and
:class:`GenerativeLoadGenerator` (:255) over the generative servers.

- **closed loop**: ``concurrency`` client threads, each issuing its next
  request only when the previous one finished: latency at a fixed
  concurrency, throughput an output;
- **open loop**: requests submitted on a fixed-rate clock whatever the
  completions: the arrival process of real traffic, which shows queueing
  collapse as sheds and timeouts.

``LoadGenerator``'s ``request_fn(rng, i)`` builds request ``i`` from a
seeded numpy ``Generator`` (one a client thread in the closed loop,
seeded ``seed + thread``; one for the open loop), as in the JAX package.
``GenerativeLoadGenerator``'s request ``i`` is a pure function of
``(seed, i)`` (``default_rng((seed, i))``: prompt length, prompt tokens,
output budget, deadline, temperature, sampling seed, drawn in the JAX
package's order), so two servers (float32 and int8 KV, say) run the same
trace, and the trace is the JAX package's for the same seed. TTFT and
inter-token gaps are taken on the host's monotonic clock as the stream
delivers each token.

Not ported yet: ``FleetLoadGenerator`` (the fleet router's replay,
ROADMAP queue 1 item 8); with the fleet goes the per-request row that
``LoadResult.slo_attainment`` reads, so that method is refused by name.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.serving.queue import (RequestTimeoutError,
                                                    ServerClosedError,
                                                    ServerOverloadedError)


@dataclass
class LoadResult:
    """Outcome of one load run."""

    n_ok: int = 0
    n_rejected: int = 0             # ServerOverloadedError at submit
    n_timed_out: int = 0            # RequestTimeoutError from the stream
    n_failed: int = 0               # anything else
    duration_s: float = 0.0
    latencies_ms: List[float] = field(default_factory=list)
    # per-request time to the first streamed token, per-gap inter-token
    # latencies, tokens delivered in all
    ttft_ms: List[float] = field(default_factory=list)
    intertoken_ms: List[float] = field(default_factory=list)
    tokens_total: int = 0

    @property
    def n_issued(self) -> int:
        return self.n_ok + self.n_rejected + self.n_timed_out + self.n_failed

    @property
    def throughput_rps(self) -> float:
        return self.n_ok / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens_total / self.duration_s \
            if self.duration_s > 0 else 0.0

    @staticmethod
    def _pct(values: List[float], p: float) -> float:
        if not values:
            return 0.0
        return float(np.percentile(np.asarray(values), p))

    def percentile(self, p: float) -> float:
        return self._pct(self.latencies_ms, p)

    def ttft_percentile(self, p: float) -> float:
        return self._pct(self.ttft_ms, p)

    def intertoken_percentile(self, p: float) -> float:
        return self._pct(self.intertoken_ms, p)

    def slo_attainment(self, slo_ms: float, lane: str = "ttft_ms") -> float:
        raise NotImplementedError(
            "LoadResult.slo_attainment: not ported yet; it reads the "
            "per-request rows of FleetLoadGenerator (ROADMAP queue 1 item 8)")

    def stats(self) -> str:
        s = (f"LoadResult: {self.n_ok}/{self.n_issued} ok "
             f"({self.n_rejected} rejected, {self.n_timed_out} timed "
             f"out, {self.n_failed} failed) in {self.duration_s:.2f}s "
             f"-> {self.throughput_rps:.1f} req/s; latency p50 "
             f"{self.percentile(50):.2f} ms, p95 "
             f"{self.percentile(95):.2f} ms, p99 "
             f"{self.percentile(99):.2f} ms")
        if self.tokens_total:
            s += (f"; {self.tokens_total} tokens -> "
                  f"{self.tokens_per_sec:.1f} tok/s; TTFT p50 "
                  f"{self.ttft_percentile(50):.2f} ms, p99 "
                  f"{self.ttft_percentile(99):.2f} ms; inter-token p50 "
                  f"{self.intertoken_percentile(50):.2f} ms")
        return s


class LoadGenerator:
    """Drives a :class:`~deeplearning4j_tpu_torch.serving.ParallelInference`.

    ``request_fn(rng, i)`` builds the i-th request payload (a
    (rows, *features) array); each worker thread gets an independent
    seeded Generator so runs are reproducible.
    """

    def __init__(self, server,
                 request_fn: Callable[[np.random.Generator, int], object],
                 seed: int = 0):
        self.server = server
        self.request_fn = request_fn
        self.seed = int(seed)

    # -- closed loop ----------------------------------------------------
    def run_closed(self, n_requests: int = 256, concurrency: int = 4,
                   timeout_ms: Optional[float] = None) -> LoadResult:
        result = LoadResult()
        lock = threading.Lock()
        counter = {"next": 0}

        def worker(wid: int):
            rng = np.random.default_rng(self.seed + wid)
            while True:
                with lock:
                    i = counter["next"]
                    if i >= n_requests:
                        return
                    counter["next"] = i + 1
                x = self.request_fn(rng, i)
                t0 = time.monotonic()
                try:
                    self.server.output(x, timeout_ms=timeout_ms)
                except ServerOverloadedError:
                    with lock:
                        result.n_rejected += 1
                    continue
                except RequestTimeoutError:
                    with lock:
                        result.n_timed_out += 1
                    continue
                except Exception:       # noqa: BLE001 -- counted as failed
                    with lock:
                        result.n_failed += 1
                    continue
                ms = (time.monotonic() - t0) * 1000.0
                with lock:
                    result.n_ok += 1
                    result.latencies_ms.append(ms)

        t_start = time.monotonic()
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(max(1, int(concurrency)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        result.duration_s = time.monotonic() - t_start
        return result

    # -- open loop ------------------------------------------------------
    def run_open(self, n_requests: int = 256, rate_rps: float = 200.0,
                 timeout_ms: Optional[float] = None) -> LoadResult:
        result = LoadResult()
        lock = threading.Lock()
        rng = np.random.default_rng(self.seed)
        interval = 1.0 / max(rate_rps, 1e-9)
        pending = []
        t_start = time.monotonic()
        for i in range(n_requests):
            target = t_start + i * interval
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            x = self.request_fn(rng, i)
            t0 = time.monotonic()
            try:
                fut = self.server.submit(x, timeout_ms=timeout_ms)
            except ServerOverloadedError:
                with lock:              # callbacks also mutate result
                    result.n_rejected += 1
                continue
            except ServerClosedError:
                with lock:
                    result.n_failed += 1
                continue

            def _done(f, t0=t0):
                with lock:
                    try:
                        f.result()
                    except RequestTimeoutError:
                        result.n_timed_out += 1
                    except Exception:   # noqa: BLE001 -- counted as failed
                        result.n_failed += 1
                    else:
                        result.n_ok += 1
                        result.latencies_ms.append(
                            (time.monotonic() - t0) * 1000.0)

            fut.add_done_callback(_done)
            pending.append(fut)
        for fut in pending:
            try:
                fut.exception()     # wait for completion; counted above
            except Exception:       # noqa: BLE001 -- counted by _done
                pass
        result.duration_s = time.monotonic() - t_start
        return result


class GenerativeLoadGenerator:
    """Drives a ``GenerativeServer`` or ``PagedGenerativeServer`` with a
    seeded mixed-length trace.

    ``prompt_len`` and ``new_tokens`` are ``(lo, hi)`` (uniform,
    inclusive) or a ``callable(rng) -> int``; ``deadline_ms`` None, a
    value or ``(lo, hi)``; ``temperature`` a value or ``(lo, hi)`` (0.0:
    greedy). Per-token timings land on the :class:`LoadResult` as
    ``ttft_ms`` / ``intertoken_ms``; ``tokens_total`` and
    ``tokens_per_sec`` are the generative throughput."""

    def __init__(self, server, seed: int = 0,
                 prompt_len=(1, 16), new_tokens=(4, 32),
                 deadline_ms=None, vocab_size: Optional[int] = None,
                 temperature=0.0):
        self.server = server
        self.seed = int(seed)
        self.prompt_len = prompt_len
        self.new_tokens = new_tokens
        self.deadline_ms = deadline_ms
        self.temperature = temperature
        self.vocab_size = int(vocab_size if vocab_size is not None
                              else server.spec.vocab_size)

    @staticmethod
    def _sample_len(spec, rng) -> int:
        if callable(spec):
            return max(1, int(spec(rng)))
        lo, hi = spec
        return int(rng.integers(int(lo), int(hi) + 1))

    @staticmethod
    def _sample_temperature(spec, rng) -> float:
        if isinstance(spec, (tuple, list)):
            lo, hi = spec
            return float(rng.uniform(float(lo), float(hi)))
        return float(spec)

    def request(self, i: int):
        """The i-th trace entry: ``(prompt, max_new_tokens, deadline_ms,
        temperature, sample_seed)``, a function of ``(seed, i)`` alone."""
        rng = np.random.default_rng((self.seed, int(i)))
        plen = self._sample_len(self.prompt_len, rng)
        prompt = rng.integers(0, self.vocab_size, plen).astype(np.int32)
        n_new = self._sample_len(self.new_tokens, rng)
        deadline = None
        if self.deadline_ms is not None:
            dlo, dhi = (self.deadline_ms
                        if isinstance(self.deadline_ms, (tuple, list))
                        else (self.deadline_ms, self.deadline_ms))
            deadline = float(rng.uniform(dlo, dhi))
        temp = self._sample_temperature(self.temperature, rng)
        sample_seed = int(rng.integers(0, 2 ** 63))
        return prompt, n_new, deadline, temp, sample_seed

    def _consume(self, handle, t0: float, result: LoadResult,
                 lock: threading.Lock) -> None:
        """Drain one generation's stream, recording TTFT and the gaps, and
        count its outcome."""
        ttft = None
        gaps: List[float] = []
        n_tokens = 0
        last = t0
        try:
            for _tok in handle.tokens():
                now = time.monotonic()
                if ttft is None:
                    ttft = (now - t0) * 1000.0
                else:
                    gaps.append((now - last) * 1000.0)
                last = now
                n_tokens += 1
            handle.result(timeout=0)   # a failure the stream did not raise
        except RequestTimeoutError:
            with lock:
                result.n_timed_out += 1
                result.tokens_total += n_tokens
                if ttft is not None:
                    result.ttft_ms.append(ttft)
                result.intertoken_ms.extend(gaps)
            return
        except Exception:           # noqa: BLE001 -- counted as failed
            with lock:
                result.n_failed += 1
                result.tokens_total += n_tokens
            return
        with lock:
            result.n_ok += 1
            result.tokens_total += n_tokens
            result.latencies_ms.append((last - t0) * 1000.0)
            if ttft is not None:
                result.ttft_ms.append(ttft)
            result.intertoken_ms.extend(gaps)

    def _submit(self, i: int, result: LoadResult, lock: threading.Lock):
        """Submit request ``i``: ``(handle, t0)``, or None when it was
        shed or the server was closed (counted)."""
        prompt, n_new, deadline, temp, sseed = self.request(i)
        t0 = time.monotonic()
        try:
            return self.server.submit(prompt, n_new, timeout_ms=deadline,
                                      temperature=temp, seed=sseed), t0
        except ServerOverloadedError:
            with lock:
                result.n_rejected += 1
        except ServerClosedError:
            with lock:
                result.n_failed += 1
        return None

    def run_closed(self, n_requests: int = 64,
                   concurrency: int = 4) -> LoadResult:
        """``concurrency`` threads, each taking the next request index
        once its previous request finished."""
        result = LoadResult()
        lock = threading.Lock()
        counter = {"next": 0}

        def worker():
            while True:
                with lock:
                    i = counter["next"]
                    if i >= n_requests:
                        return
                    counter["next"] = i + 1
                sub = self._submit(i, result, lock)
                if sub is not None:
                    self._consume(*sub, result, lock)

        t_start = time.monotonic()
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, int(concurrency)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        result.duration_s = time.monotonic() - t_start
        return result

    def run_open(self, n_requests: int = 64,
                 rate_rps: float = 50.0) -> LoadResult:
        """Request ``i`` submitted at ``i / rate_rps`` after the start,
        whatever the completions; a thread a request drains its stream."""
        result = LoadResult()
        lock = threading.Lock()
        interval = 1.0 / max(rate_rps, 1e-9)
        consumers: List[threading.Thread] = []
        t_start = time.monotonic()
        for i in range(n_requests):
            delay = t_start + i * interval - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            sub = self._submit(i, result, lock)
            if sub is None:
                continue
            t = threading.Thread(target=self._consume,
                                 args=(*sub, result, lock), daemon=True)
            t.start()
            consumers.append(t)
        for t in consumers:
            t.join()
        result.duration_s = time.monotonic() - t_start
        return result


__all__ = ["LoadResult", "LoadGenerator", "GenerativeLoadGenerator"]
