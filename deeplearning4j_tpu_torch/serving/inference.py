"""ParallelInference: a thread-safe, batching model server.

Counterpart of ``deeplearning4j_tpu/serving/inference.py`` (reference:
deeplearning4j-parallelwrapper's ParallelInference). A trained
``MultiLayerNetwork`` or ``ComputationGraph`` goes behind a shared
front end; modes:

- ``SEQUENTIAL``: each request runs alone, in arrival order;
- ``BATCHED``: concurrent requests coalesce into one forward, padded to
  a power-of-two bucket (serving/batching.py);
- ``INPLACE``: no queue, the forward runs in the calling thread.

The workers share ONE serving executor (``serving_spec()``: an
inference graph holding its own copy of the parameters, refreshed by
``update_model()``) on the network's device: the card, unless the
network was built with ``device="cpu"``. Device execution is serialized
behind a lock: the forward's kernels go to one stream, and thread-level
concurrency buys host-side overlap (padding, the host-to-device copy of
the next batch, the scatter of the last one) with device compute. An
exec's outputs come back by one device-to-host copy into pinned memory,
waited on after the lock is released. ``warmup`` runs every bucket once
before traffic, so that cuDNN's heuristics, its workspace and the
caching allocator are settled: ``compiles`` then counts only shapes
first seen under traffic. Backpressure, deadlines and drain come from
serving/queue.py; counters and latency histograms from
serving/metrics.py; admission, the circuit breaker, supervised workers
and bisecting poisoned-batch isolation from serving/resilience.py.

An exec failure is a typed error that the breaker counts and the
request's future carries; nothing is retried on another device.

Not ported yet, each refused by name: the telemetry endpoint
(``telemetry_port``, ROADMAP queue 1 item 2.5), the stats-storage
records (``stats_storage``, item 2.8), per-batch profiler traces
(``profile_dir``, item 7: ``profiler/``), pre-compile graph analysis
(a truthy ``analyze``, item 7: ``analyze/``; the port's default is
``analyze=False``) and checkpoint hot reload (``reload_from``, item 7:
``checkpoint/`` hot reload; the checkpoints themselves are ported). ``memory_sample_every`` is kept: it publishes memory
records only into a stats storage, so it does nothing yet, as in the
JAX package without one. The stall watchdog around an exec waits for
``integrity/`` (item 7).
"""
from __future__ import annotations

import enum
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitor import memstats
from deeplearning4j_tpu_torch.monitor.trace import TRACER as _tracer
from deeplearning4j_tpu_torch.serving.batching import (DynamicBatcher,
                                                       pad_to_bucket,
                                                       pow2_buckets,
                                                       scatter_rows)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.queue import (
    InferenceRequest, RequestQueue, RequestTimeoutError, ServerClosedError,
    ServerOverloadedError, ServingError, ServingTimeoutError,
    collapse_outputs)
from deeplearning4j_tpu_torch.serving.resilience import (
    AdmissionController, CircuitBreaker, InflightSlot, PoisonedRequestError,
    ReloadFailedError, ResilienceConfig, WorkerSupervisor)


class InferenceMode(enum.Enum):
    """Request scheduling policy (reference: ParallelInference
    InferenceMode)."""

    SEQUENTIAL = "sequential"
    BATCHED = "batched"
    INPLACE = "inplace"


class ServingSpec(NamedTuple):
    """A network's serving contract (``MultiLayerNetwork.serving_spec()``
    / ``ComputationGraph.serving_spec()``): the executor, with
    ``output(placeholders, names) -> {name: tensor}``,
    ``infer_shape(input) -> shape`` (-1 for the batch dim) and
    ``device``; the input and output names; and the sync that copies the
    network's current parameters into the executor."""

    sd: object
    input_names: List[str]
    output_names: List[str]
    sync: Callable[[], None]


def _extract_spec(model) -> ServingSpec:
    if hasattr(model, "serving_spec"):
        return ServingSpec(*model.serving_spec())
    raise TypeError(
        f"{type(model).__name__} is not servable: expected a "
        f"MultiLayerNetwork / ComputationGraph (anything exposing "
        f"serving_spec())")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"ParallelInference {what} is not ported yet "
                              f"(ROADMAP queue 1 item {item})")


class ParallelInference:
    """Shared, thread-safe inference front end over a trained network.

    ::

        pi = ParallelInference(net, mode=InferenceMode.BATCHED,
                               max_batch_size=32, max_delay_ms=3.0)
        y = pi.output(x)                  # blocking
        fut = pi.submit(x)                # async -> Future
        ...
        pi.shutdown()                     # drains the queue

    ``output``/``submit`` accept a (rows, *features) array, one
    unbatched example (*features), or, for multi-input graphs in
    SEQUENTIAL/INPLACE mode, a tuple of per-input arrays. Results are
    numpy arrays mirroring the wrapped model's ``output()`` (one array,
    or a list for multi-output graphs). Overload raises
    :class:`ServerOverloadedError` at submit; expired deadlines surface
    as :class:`RequestTimeoutError` from the future.

    ``warmup_buckets``: ``True`` runs every batching bucket once at
    construction (before any worker serves), a sequence of ints runs
    exactly those row counts. ``resilience=True`` (or a
    :class:`ResilienceConfig`) arms SLO admission shedding, the circuit
    breaker on consecutive exec failures, supervised workers with crash
    requeue, and bisecting poisoned-batch isolation.
    """

    def __init__(self, model,
                 mode: InferenceMode = InferenceMode.BATCHED,
                 workers: int = 2,
                 max_batch_size: int = 32,
                 max_delay_ms: float = 5.0,
                 max_queue_len: int = 256,
                 buckets: Optional[Sequence[int]] = None,
                 default_timeout_ms: Optional[float] = None,
                 stats_storage=None,
                 profile_dir: Optional[str] = None,
                 warmup_buckets=None,
                 telemetry_port: Optional[int] = None,
                 resilience=None,
                 memory_sample_every: Optional[int] = 64,
                 analyze=False):
        if telemetry_port is not None:
            _not_ported("telemetry_port", "2.5: monitor/server.py")
        if stats_storage is not None:
            _not_ported("stats_storage", "2.8: the stats-storage records")
        if profile_dir is not None:
            _not_ported("profile_dir", "7: profiler/")
        if analyze:
            _not_ported("analyze", "7: analyze/")
        self.model = model
        self.mode = InferenceMode(mode)
        self.max_batch_size = int(max_batch_size)
        if self.mode is InferenceMode.INPLACE and \
                default_timeout_ms is not None:
            raise ValueError("INPLACE mode executes synchronously in the "
                             "calling thread — there is no queue wait for "
                             "default_timeout_ms to bound")
        self.default_timeout_ms = default_timeout_ms
        self.memory_sample_every = memory_sample_every
        self.metrics = ServingMetrics()
        self._spec = _extract_spec(model)
        self.device = torch.device(self._spec.sd.device)
        if self.mode is InferenceMode.BATCHED and \
                len(self._spec.input_names) != 1:
            raise ValueError(
                f"BATCHED mode needs a single-input model; "
                f"{type(model).__name__} has inputs "
                f"{self._spec.input_names} — use SEQUENTIAL or INPLACE")
        self._ph_shapes = [self._placeholder_shape(n)
                           for n in self._spec.input_names]
        self._feat_rank = (len(self._ph_shapes[0])
                           if self._ph_shapes[0] is not None else None)
        self._exec_lock = threading.Lock()
        self._shapes_seen = set()
        self._req_id = 0
        self._id_lock = threading.Lock()
        self._closed = False
        self._spec.sync()           # pull current trained params once
        self._queue = RequestQueue(
            max_queue_len,
            on_timeout=lambda req: self.metrics.record_timeout("deadline"))
        self._batcher = DynamicBatcher(
            self._queue, max_batch_size=self.max_batch_size,
            max_delay_ms=max_delay_ms, buckets=buckets) \
            if self.mode is InferenceMode.BATCHED else None
        self.max_queue_len = int(max_queue_len)
        self.resilience = ResilienceConfig.normalize(resilience)
        self.admission: Optional[AdmissionController] = None
        self.breaker: Optional[CircuitBreaker] = None
        if self.resilience is not None:
            if self.resilience.admission:
                self.admission = AdmissionController(
                    window=self.resilience.window,
                    percentile=self.resilience.percentile,
                    min_samples=self.resilience.min_exec_samples)
            if self.resilience.breaker_failure_threshold > 0:
                self.breaker = CircuitBreaker(
                    failure_threshold=(
                        self.resilience.breaker_failure_threshold),
                    reset_timeout_s=self.resilience.breaker_reset_s,
                    on_transition=self._breaker_transition)
                self.metrics.set_resilience(breaker_state="closed")
        self.warmup_report: Optional[dict] = None
        if warmup_buckets:
            # before any worker thread exists: warmed shapes are settled
            # before the first request can race them
            self.warmup(None if warmup_buckets is True else warmup_buckets)
        self._workers: List[threading.Thread] = []
        self._supervisor: Optional[WorkerSupervisor] = None
        if self.mode is not InferenceMode.INPLACE:
            if self.resilience is not None and self.resilience.supervise:
                self._supervisor = WorkerSupervisor(
                    spawn=self._spawn_worker,
                    n_workers=max(1, int(workers)),
                    queue=self._queue, metrics=self.metrics,
                    backoff_base_s=self.resilience.worker_backoff_base_s,
                    backoff_max_s=self.resilience.worker_backoff_max_s,
                    # a worker that dies holding the half-open probe
                    # must not gate dispatch forever
                    on_crash=(self.breaker.release
                              if self.breaker is not None else None))
            else:
                for i in range(max(1, int(workers))):
                    self._workers.append(
                        self._spawn_worker(i, InflightSlot()))

    # ------------------------------------------------------------------
    def _placeholder_shape(self, input_name: str):
        shape = self._spec.sd.infer_shape(input_name)
        return tuple(shape) if shape is not None else None

    def _next_id(self) -> int:
        with self._id_lock:
            self._req_id += 1
            return self._req_id

    # -- warmup ---------------------------------------------------------
    def warmup(self, buckets: Optional[Sequence[int]] = None) -> dict:
        """Run the forward once at each bucket row count (zeros), so that
        live traffic meets no first-seen shape: cuDNN's heuristics, its
        workspace and the caching allocator are settled for it.

        ``buckets=None`` takes the batching tier's bucket spec (BATCHED
        mode) or bucket 1 plus the pow2 ladder up to ``max_batch_size``
        (SEQUENTIAL/INPLACE, where requests run at their own row count,
        so only warmed sizes are covered). Requires static feature dims
        on every input. Returns (and stores as ``warmup_report``) the
        bucket list and wall seconds."""
        if buckets is None:
            if self._batcher is not None:
                buckets = self._batcher.spec.buckets
            else:
                buckets = (1,) + tuple(pow2_buckets(self.max_batch_size))
        bucket_list = sorted({int(b) for b in buckets})
        if not bucket_list or bucket_list[0] <= 0:
            raise ValueError(f"invalid warmup buckets {buckets!r}")
        for name, shp in zip(self._spec.input_names, self._ph_shapes):
            if shp is None or any(d is None or d == -1 for d in shp[1:]):
                raise ValueError(
                    f"cannot warm up input {name!r}: feature dims {shp} "
                    f"are not static — pass concrete shapes to the "
                    f"model, or skip warmup for this graph")
        t0 = time.perf_counter()
        for b in bucket_list:
            feats = [np.zeros((b,) + tuple(int(d) for d in shp[1:]),
                              np.float32) for shp in self._ph_shapes]
            # the exec lock: warmup() is public and may run on a LIVE
            # server; the shape is marked under the same hold, so a
            # worker dispatching this bucket meanwhile counts no compile
            xs = [self._to_device(f) for f in feats]
            with self._exec_lock, \
                    _tracer.span("serving.warmup", cat="serving", bucket=b):
                _, done = self._forward(xs)
                if done is not None:
                    done.synchronize()
                sig = tuple(f.shape for f in feats)
                if sig not in self._shapes_seen:
                    self._shapes_seen.add(sig)
                    self.metrics.inc("warmup_compiles")
        self.warmup_report = {
            "buckets": bucket_list,
            "seconds": round(time.perf_counter() - t0, 4)}
        return self.warmup_report

    def _prepare(self, x) -> tuple:
        """-> (list of per-input arrays with a batch dim, squeeze flag)."""
        if isinstance(x, (tuple, list)):
            arrs = [np.asarray(a) for a in x]
        else:
            arrs = [np.asarray(x)]
        if len(arrs) != len(self._spec.input_names):
            raise ValueError(
                f"model has {len(self._spec.input_names)} inputs "
                f"{self._spec.input_names}; got {len(arrs)} arrays")
        squeeze = False
        if len(arrs) == 1 and self._feat_rank is not None and \
                arrs[0].ndim == self._feat_rank - 1:
            arrs = [arrs[0][None]]      # single example: add the row dim
            squeeze = True
        if arrs[0].ndim == 0:
            raise ValueError("scalar input is not a request")
        # reject wrong feature shapes at admission: a mismatched request
        # must not reach a coalesced batch (it would fail the whole
        # dispatch, or worse, a worker thread)
        for arr, ph, name in zip(arrs, self._ph_shapes,
                                 self._spec.input_names):
            if ph is None:
                continue
            if arr.ndim != len(ph) or any(
                    d is not None and d != a
                    for d, a in zip(ph[1:], arr.shape[1:])):
                raise ValueError(
                    f"input {name!r} expects shape {ph} (leading dim = "
                    f"rows); got {arr.shape}")
        return arrs, squeeze

    # -- execution core (shared by every mode/worker) -------------------
    def _to_device(self, f: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of a feature array: staged in pinned
        memory, then queued on the stream without a host wait."""
        t = torch.from_numpy(np.ascontiguousarray(f))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _forward(self, xs: List[torch.Tensor]):
        """The executor on the inputs ``xs`` (on the device); the exec
        lock is held. Returns the outputs on the host (pinned, for a
        card) and the event their copy completes (None off the card)."""
        ph = dict(zip(self._spec.input_names, xs))
        with torch.inference_mode():
            res = self._spec.sd.output(ph, self._spec.output_names)
            outs = [res[n] for n in self._spec.output_names]
            if self.device.type != "cuda":
                return outs, None
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in outs]
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return host, done

    def _execute(self, features: List[np.ndarray],
                 real_rows: Optional[int] = None) -> List[np.ndarray]:
        """Run one forward: the padded bucket's one host-to-device copy,
        the executor, one device-to-host copy of the outputs. The lock
        serializes the forwards; the wait for the copy back happens
        after it is released, so the next batch's forward is already
        queued behind it."""
        sig = tuple(tuple(f.shape) for f in features)
        rows = features[0].shape[0]
        real = rows if real_rows is None else real_rows
        t0 = time.perf_counter()
        try:
            # staged outside the lock: the copy queues behind the forward
            # that holds it
            xs = [self._to_device(f) for f in features]
            with self._exec_lock, \
                    _tracer.span("serving.exec", cat="serving", rows=real,
                                 padding=rows - real):
                if sig not in self._shapes_seen:
                    self._shapes_seen.add(sig)
                    self.metrics.inc("compiles")
                host, done = self._forward(xs)
            if done is not None:
                done.synchronize()
        except Exception as e:
            # an allocation failure becomes the structured OOM with the
            # card's counters; anything else propagates as it is
            if memstats.is_resource_exhausted(e):
                raise memstats.oom_error(e, program=f"serving_b{rows}") \
                    from e
            raise
        outs = [h.numpy() for h in host]
        exec_ms = (time.perf_counter() - t0) * 1000.0
        self.metrics.observe_batch(rows=real, padding=rows - real,
                                   exec_ms=exec_ms)
        if self.admission is not None:
            self.admission.observe(exec_ms)
        return outs

    # -- worker loops ---------------------------------------------------
    def _spawn_worker(self, index: int, slot: InflightSlot
                      ) -> threading.Thread:
        t = threading.Thread(target=self._worker_main, args=(slot,),
                             name=f"ParallelInference-{index}",
                             daemon=True)
        t.start()
        return t

    def _worker_main(self, slot: InflightSlot) -> None:
        try:
            self._worker_loop(slot)
            slot.exited = True          # clean drain: do not restart
        except BaseException as e:      # noqa: BLE001 — supervisor's cue
            slot.crashed = e            # the supervisor requeues slot's
            #                             in-flight and respawns; without
            #                             one the crash is at least
            #                             visible in the failure metrics

    def _worker_loop(self, slot: InflightSlot) -> None:
        if self.mode is InferenceMode.BATCHED:
            loop_body = self._batched_step
        else:
            loop_body = self._sequential_step
        # gate on the CONFIG, not self._supervisor: the supervisor's
        # constructor spawns these threads before ParallelInference's
        # `self._supervisor =` assignment completes
        max_con = (self.resilience.worker_max_consecutive_errors
                   if self.resilience is not None and
                   self.resilience.supervise else None)
        consecutive = 0
        while True:
            try:
                progressed = loop_body(slot)
                consecutive = 0
                if progressed:
                    # evidence for the supervisor: this worker actually
                    # dispatched
                    slot.progressed = True
            except Exception as e:
                # last-ditch guard: per-request failure paths live inside
                # the step fns; anything reaching here is unexpected. It
                # is RECORDED, never swallowed silently, and under a
                # supervisor a persistent failure kills the worker so a
                # fresh one can take over.
                consecutive += 1
                if self.breaker is not None:
                    # the step may have died while HOLDING the half-open
                    # probe; a leaked probe gates every worker forever
                    self.breaker.release()
                stranded = slot.requests
                slot.requests = None
                for r in stranded or []:
                    r.fail(e)       # no-op for already-resolved futures
                self.metrics.record_failure(
                    e, cause="worker_guard",
                    n=max(1, len(stranded or [])))
                if max_con is not None and consecutive >= max_con:
                    raise
                time.sleep(0.01)
                progressed = True
            if not progressed and self._queue.finished:
                return

    def _breaker_gate(self) -> Optional[bool]:
        """Dispatch-side breaker check. None -> proceed (probe acquired
        if half-open); True/False -> return that from the step fn (the
        breaker is open: nothing was popped, or the drain shed)."""
        if self.breaker is None:
            return None
        allowed, wait_s = self.breaker.acquire()
        if allowed:
            return None
        if self._queue.closed:
            # drain under an open breaker: futures must not be held
            # hostage until the probe window — shed them typed
            reqs = self._queue.take(self.max_batch_size, timeout=0,
                                    strict=False)
            if not reqs:
                return False
            err = ServerOverloadedError(
                "circuit breaker open during shutdown drain",
                retry_after_s=round(wait_s, 3))
            for r in reqs:
                r.fail(err)
            self.metrics.inc("requests_shed", len(reqs))
            return True
        time.sleep(min(0.05, max(wait_s, 0.001)))
        return False

    def _batched_step(self, slot: InflightSlot) -> bool:
        gated = self._breaker_gate()
        if gated is not None:
            return gated
        # the span is discarded on an empty poll — an idle server must
        # not fill the trace ring with 50 ms waits
        with _tracer.span("serving.batch", cat="serving") as bsp:
            batch = self._batcher.next_batch(poll_timeout=0.05)
            if batch is None:
                bsp.discard()
                if self.breaker is not None:
                    self.breaker.release()      # unused half-open probe
                return False
            bsp.set(rows=batch.rows, bucket=batch.bucket,
                    requests=len(batch.requests))
        # slot stays populated if an exception ESCAPES (worker death /
        # guard): the supervisor requeues exactly what was in flight.
        # It is cleared only once every popped future is resolved.
        slot.requests = batch.requests
        if self.resilience is not None and \
                self.resilience.isolate_poisoned:
            self._exec_group(batch.requests, created_t=batch.created_t,
                             features=batch.features)
            slot.requests = None
            return True
        try:
            outs = self._execute([batch.features], real_rows=batch.rows)
        except Exception as e:
            if self.breaker is not None:
                self.breaker.on_failure()
            self.metrics.inc("exec_faults")
            self.metrics.record_failure(e, n=len(batch.requests))
            batch.fail(e)
            slot.requests = None
            return True
        if self.breaker is not None:
            self.breaker.on_success()
        self._resolve_rows(batch.requests, outs, batch.created_t)
        slot.requests = None
        return True

    def _sequential_step(self, slot: InflightSlot) -> bool:
        gated = self._breaker_gate()
        if gated is not None:
            return gated
        reqs = self._queue.take(max_rows=1, timeout=0.05)
        if not reqs:
            if self.breaker is not None:
                self.breaker.release()          # unused half-open probe
            return False
        req = reqs[0]
        slot.requests = reqs            # cleared only once resolved (see
        t_pop = time.monotonic()        # _batched_step)
        try:
            outs = self._execute(list(req.x))
        except Exception as e:
            if self.breaker is not None:
                self.breaker.on_failure()
            self.metrics.inc("exec_faults")
            self.metrics.record_failure(e)
            req.fail(e)
            slot.requests = None
            return True
        if self.breaker is not None:
            self.breaker.on_success()
        with _tracer.span("serving.reply", cat="serving", requests=1):
            completed = req.complete(outs)
        slot.requests = None
        if not completed:
            self.metrics.record_timeout("deadline")
            return True
        done = time.monotonic()
        self.metrics.observe_request(
            queue_wait_ms=(t_pop - req.enqueue_t) * 1000.0,
            e2e_ms=(done - req.enqueue_t) * 1000.0)
        return True

    # -- resilient dispatch: bisecting poisoned-batch isolation ---------
    def _resolve_rows(self, reqs: Sequence[InferenceRequest],
                      outs: List[np.ndarray], created_t: float) -> None:
        """Scatter per-request row slices to futures, re-checking each
        deadline at reply time (a request that expired during exec gets
        ServingTimeoutError, not a stale success), and record latency
        for the completed ones."""
        with _tracer.span("serving.reply", cat="serving",
                          requests=len(reqs)):
            expired_ids = {id(r) for r in scatter_rows(reqs, outs)}
        if expired_ids:
            self.metrics.record_timeout("deadline", n=len(expired_ids))
        done = time.monotonic()
        for req in reqs:
            if id(req) in expired_ids:
                continue
            self.metrics.observe_request(
                queue_wait_ms=(created_t - req.enqueue_t) * 1000.0,
                e2e_ms=(done - req.enqueue_t) * 1000.0)

    def _nonfinite_requests(self, reqs: Sequence[InferenceRequest],
                            outs: List[np.ndarray]
                            ) -> List[InferenceRequest]:
        """Requests whose output rows contain non-finite values — how a
        NaN/garbage input actually manifests (the device does not raise
        on it). Non-floating outputs (class indices, ...) are skipped."""
        float_outs = [o for o in outs
                      if np.issubdtype(np.asarray(o).dtype, np.floating)]
        if not float_outs:
            return []
        bad: List[InferenceRequest] = []
        off = 0
        for req in reqs:
            for o in float_outs:
                if not np.all(np.isfinite(o[off:off + req.rows])):
                    bad.append(req)
                    break
            off += req.rows
        return bad

    def _group_features(self, reqs: Sequence[InferenceRequest]) -> tuple:
        rows = sum(r.rows for r in reqs)
        bucket = self._batcher.spec.bucket_for(rows)
        features = pad_to_bucket(
            [np.asarray(r.x[0] if isinstance(r.x, (list, tuple))
                        else r.x) for r in reqs], bucket)
        return features, rows

    def _exec_group(self, reqs: List[InferenceRequest], created_t: float,
                    features: Optional[np.ndarray] = None,
                    top: bool = True) -> None:
        """Bisecting dispatch: execute ``reqs`` as one padded forward; on
        failure (a raise, or, with ``check_finite_outputs``, any
        non-finite output row) split in half and retry each side, down
        to singletons, so exactly the poisoned request is quarantined
        with :class:`PoisonedRequestError` while every healthy request
        resolves, at the bucket of its sub-group. Every request's future
        is resolved by the time this returns.

        Only the TOP-level exec outcome feeds the circuit breaker: the
        bisection's internal retries of one poisoned raising request
        would otherwise count log2(batch)+retries consecutive
        "failures" and open the breaker on a healthy device."""
        cfg = self.resilience
        rows = sum(r.rows for r in reqs)
        if features is None:
            features, rows = self._group_features(reqs)
        exc: Optional[BaseException] = None
        outs = None
        try:
            outs = self._execute([features], real_rows=rows)
        except Exception as e:
            exc = e
            self.metrics.inc("exec_faults")
            if top and self.breaker is not None:
                self.breaker.on_failure()
        if outs is not None:
            if top and self.breaker is not None:
                self.breaker.on_success()
            bad = self._nonfinite_requests(reqs, outs) \
                if cfg.check_finite_outputs else []
            if not bad:
                self._resolve_rows(reqs, outs, created_t)
                return
        if len(reqs) == 1:
            req = reqs[0]
            if exc is not None:
                # a RAISING singleton may have hit a transient exec
                # fault rather than carrying poison — retry before
                # declaring it poisoned (a non-finite OUTPUT is a pure
                # function of the input; no retry can change it)
                for _ in range(max(0, cfg.single_retries)):
                    try:
                        outs = self._execute([features], real_rows=rows)
                    except Exception as e:
                        exc = e
                        self.metrics.inc("exec_faults")
                        continue
                    if not (cfg.check_finite_outputs and
                            self._nonfinite_requests(reqs, outs)):
                        self._resolve_rows(reqs, outs, created_t)
                        return
                    break
            err = PoisonedRequestError(
                f"request {req.id} quarantined: "
                + (f"exec fails on it alone ({exc!r})" if exc is not None
                   else "its output rows are non-finite"),
                request_id=req.id)
            err.__cause__ = exc
            req.fail(err)
            self.metrics.inc("poisoned_quarantined")
            self.metrics.record_failure(err, cause="poisoned")
            return
        self.metrics.inc("bisect_splits")
        mid = len(reqs) // 2
        self._exec_group(reqs[:mid], created_t, top=False)
        self._exec_group(reqs[mid:], created_t, top=False)

    # -- client API -----------------------------------------------------
    def submit(self, x, timeout_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the model
        output rows for exactly this request. Raises
        :class:`ServerOverloadedError` (queue full) or
        :class:`ServerClosedError` (after shutdown) at the call site."""
        if self._closed:
            raise ServerClosedError("ParallelInference is shut down")
        features, squeeze = self._prepare(x)
        if self.mode is InferenceMode.BATCHED and \
                features[0].shape[0] > self.max_batch_size:
            raise ValueError(
                f"request of {features[0].shape[0]} rows exceeds "
                f"max_batch_size {self.max_batch_size}; split it or call "
                f"the model's output() directly")
        self.metrics.inc("requests_submitted")
        if self.mode is InferenceMode.INPLACE:
            if timeout_ms is not None:
                raise ValueError("INPLACE mode has no queue; timeout_ms "
                                 "is not applicable (use BATCHED or "
                                 "SEQUENTIAL for deadline-bounded "
                                 "requests)")
            return self._inplace(features, squeeze)
        timeout_ms = timeout_ms if timeout_ms is not None \
            else self.default_timeout_ms
        deadline = time.monotonic() + timeout_ms / 1000.0 \
            if timeout_ms is not None else None
        self._admit(features[0].shape[0], timeout_ms)
        fut: Future = Future()
        req = InferenceRequest(x=features, future=fut,
                               rows=features[0].shape[0], deadline=deadline,
                               squeeze=squeeze, id=self._next_id())
        with _tracer.span("serving.enqueue", cat="serving", id=req.id,
                          rows=req.rows):
            try:
                self._queue.put(req)
            except ServerOverloadedError:
                self.metrics.inc("requests_rejected")
                raise
        return fut

    def _inplace(self, features: List[np.ndarray], squeeze: bool) -> Future:
        fut: Future = Future()
        t0 = time.monotonic()
        try:
            outs = self._execute(features)
        except Exception as e:
            self.metrics.record_failure(e)
            fut.set_exception(e)
            return fut
        fut.set_result(collapse_outputs(outs, squeeze))
        self.metrics.observe_request(
            queue_wait_ms=0.0, e2e_ms=(time.monotonic() - t0) * 1000.0)
        return fut

    def output(self, x, timeout_ms: Optional[float] = None):
        """Blocking convenience around :meth:`submit` (reference:
        ParallelInference.output)."""
        return self.submit(x, timeout_ms=timeout_ms).result()

    def _admit(self, rows: int, timeout_ms: Optional[float]) -> None:
        """Resilience admission: shed while the circuit breaker is open,
        and shed deadline-carrying requests whose estimated queue wait
        already exceeds their deadline — both as
        :class:`ServerOverloadedError` with a ``retry_after_s`` backoff
        hint, at the call site, instead of letting the request expire in
        queue."""
        if self.breaker is not None:
            wait = self.breaker.reject_for()
            if wait is not None:
                self.metrics.inc("requests_shed")
                raise ServerOverloadedError(
                    f"circuit breaker open "
                    f"({self.breaker.failure_threshold} consecutive exec "
                    f"failures); next probe in {wait:.2f}s",
                    retry_after_s=round(wait, 3))
        if self.admission is None or timeout_ms is None:
            return
        if self.mode is InferenceMode.BATCHED:
            est = self.admission.estimate_wait_ms(
                self._queue.pending_rows() + rows, self.max_batch_size)
        else:           # sequential: one request per dispatch
            est = self.admission.estimate_wait_ms(
                self._queue.pending() + 1, 1)
        if est is not None and est > timeout_ms:
            self.metrics.inc("requests_shed")
            raise ServerOverloadedError(
                f"estimated queue wait {est:.1f} ms exceeds the "
                f"{timeout_ms:.1f} ms deadline — shed at admission "
                f"(queue depth x p{self.admission.percentile:g} exec "
                f"time)", retry_after_s=round(est / 1000.0, 3))

    def _breaker_transition(self, old: str, new: str) -> None:
        self.metrics.set_resilience(breaker_state=new)
        if new == "open":
            self.metrics.inc("breaker_opens")

    def update_model(self) -> None:
        """Copy the network's current parameters into the serving
        executor (reference: ParallelInference.updateModel), between
        forwards: call after further ``fit()``."""
        with self._exec_lock:
            self._spec.sync()

    def reload_from(self, *a, **k):
        _not_ported("reload_from", "7: checkpoint/ hot reload")

    # -- lifecycle ------------------------------------------------------
    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop intake; with ``drain`` (default) serve what is queued,
        otherwise fail pending futures with ServerClosedError. Further
        submits raise :class:`ServerClosedError`. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._queue.close(drain=drain)
        if self._supervisor is not None:
            self._supervisor.stop(timeout=timeout)
        for t in self._workers:
            t.join(timeout=timeout)

    def __enter__(self) -> "ParallelInference":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)


__all__ = ["InferenceMode", "ParallelInference", "ServingSpec",
           "ServingError", "ServerOverloadedError", "ServerClosedError",
           "RequestTimeoutError", "ServingTimeoutError",
           "ResilienceConfig", "PoisonedRequestError", "ReloadFailedError"]
