"""Continuous-batching generative serving: slotted KV caches,
step-boundary admission, streaming decode.

Counterpart of ``deeplearning4j_tpu/serving/generative.py``
(``GenerativeSpec`` :88, ``SlotAllocator`` :129, ``GenerationRequest``
:178, ``GenerationHandle`` :244, ``GenerativeMetrics`` :297,
``GenerativeServer`` :435 with its speculative tier :1286-1404,
``greedy_decode`` :1632), copied and adapted to tensors on the card:

- **KV slabs**: two tensors (K and V) shaped ``[layers, max_slots,
  heads, max_seq, head_dim]``, allocated ONCE at construction (headroom
  guarded by ``monitor/memstats``) and updated in place by every
  dispatch, the counterpart of the JAX donation.
- **one decode step** advances every active slot per dispatch (active
  mask and per-slot positions); each layer's K/V write and attention are
  one ``paged_decode_attention`` kernel launch.
- **pow2 prefill buckets**: a prompt is padded to the smallest bucket of
  a pow2 ladder, so a prompt-length mix meets at most log2(max_seq) + 1
  prefill shapes.
- **continuous batching**: queued requests are admitted into free slots
  at every step boundary, each token is streamed as it resolves, and a
  finished slot (EOS / ``max_new_tokens`` / deadline / cancel / sequence
  capacity) is retired at once; ``admit="static"`` is the
  wait-for-full-batch baseline.
- **SLO admission**: a rolling p99 of decode-step time turns queue depth
  into a TTFT estimate; a deadline-carrying request that cannot make it is
  shed typed (``ServerOverloadedError(retry_after_s=...)``).
- **crash recovery**: the worker runs under the ``WorkerSupervisor``; a
  crashed worker's in-flight generations are requeued at the front
  exactly once and re-enter at prefill with ``prompt + tokens generated
  so far``; the respawned worker starts from fresh slabs.
- **speculative decoding** (``draft_spec=``, ``speculate_k=``): a small
  draft model, always dense, proposes ``speculate_k - 1`` tokens a slot
  in ``speculate_k`` decode dispatches, and the target scores the whole
  window in one verify dispatch; every emitted token is the target's
  own, so the output is the non-speculative server's.

**Warmup** builds the kernels (``nvcc`` at their first launch) and runs
the decode step and every prefill bucket once (with a draft also the
verify at the window's shape, the draft's decode and its prefill
buckets), the decode and verify with no lane active and the prefills on
throwaway one-slot slabs, so that nothing is built under traffic. **Dispatch** calls the spec's functions directly
under ``torch.inference_mode()`` (there is no program to compile ahead).

Correctness contract (``tests/test_torch_serving.py``): greedy tokens
equal :func:`greedy_decode` for every request of a mixed-length run; a
retired slot's cache, even poisoned with NaNs, cannot reach its successor
(the kernel reads keys ``<= position`` only).

Not ported yet, each refused where it is asked for: the telemetry
endpoint (``telemetry_port``, which waits for ``monitor/server.py``). The fleet's hooks (``submit_continuation``,
``params_snapshot``/``restore_params``, ``abort``, request trace
contexts), the stats-storage records, ``memory_report``, custom bucket
ladders and the stall watchdog around a dispatch wait for the fleet, the
UI and ``integrity/``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from queue import Empty, SimpleQueue
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.environment import DeviceLike, default_device
from deeplearning4j_tpu_torch.memory import AllocationsTracker
from deeplearning4j_tpu_torch.monitor import memstats
from deeplearning4j_tpu_torch.monitor.trace import TRACER as _tracer
from deeplearning4j_tpu_torch.serving.batching import BucketSpec, pow2_buckets
from deeplearning4j_tpu_torch.serving.metrics import (LatencyHistogram,
                                                      ServingMetrics,
                                                      safe_ratio)
from deeplearning4j_tpu_torch.serving.queue import (
    InferenceRequest, RequestQueue, ServerClosedError, ServerOverloadedError,
    ServingError, ServingTimeoutError)
from deeplearning4j_tpu_torch.serving.resilience import (AdmissionController,
                                                         InflightSlot,
                                                         ResilienceConfig,
                                                         WorkerSupervisor)
from deeplearning4j_tpu_torch.serving.sampling import sample_token


class GenerationCancelled(ServingError):
    """The request was cancelled by its client; ``tokens`` holds what
    was generated before the cancel took effect at a step boundary."""

    def __init__(self, message: str, tokens: Optional[List[int]] = None):
        super().__init__(message)
        self.tokens = list(tokens or [])


@dataclass
class GenerativeSpec:
    """A model's generative-serving contract (produced by
    ``zoo.gpt.gpt_generative_spec``).

    - ``params()`` pulls the current parameter tensors by name
      (``GenerativeServer.update_model()`` re-pulls).
    - ``prefill(params, kc, vc, io)`` with ``io = {"tokens": [L],
      "length": (), "slot": ()}`` fills slot ``io["slot"]``'s KV rows
      from a bucket-padded prompt and returns ``(kc, vc, next_token,
      last_logits)``.
    - ``decode(params, kc, vc, io)`` with ``io = {"tokens": [S],
      "positions": [S], "active": [S] bool}`` advances every active slot
      one token and returns ``(kc, vc, next_tokens, logits)``.
    - ``kv_shape(max_slots, max_seq)`` is the shape of ONE slab (K and V
      are two tensors of this shape), of dtype ``kv_dtype`` (``"int8"``
      for an int8 KV cache, whose scales the functions hold; the server's
      ``kv_slab_bytes`` count its bytes at that dtype).
    - ``verify(params, kc, vc, io)`` with ``io = {"tokens": [S, W],
      "positions": [S], "active": [S] bool}``: the speculative verifier,
      returning ``(kc, vc, out [S, W], logits [S, W, vocab])``.

    The functions update the slabs in place and return them.
    """

    params: Callable[[], Dict[str, torch.Tensor]]
    prefill: Callable
    decode: Callable
    kv_shape: Callable[[int, int], tuple]
    vocab_size: int
    max_seq_len: int
    kv_dtype: str = "float32"
    eos_id: Optional[int] = None
    verify: Optional[Callable] = None


class SlotAllocator:
    """Free-list allocator over ``n`` KV slots. ``free()`` of a slot
    that is not currently allocated raises — the slot-lifecycle
    invariant ("freed exactly once") is enforced here, not hoped for."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError("need at least one slot")
        self.n = int(n)
        self._free = list(range(self.n - 1, -1, -1))   # pop() -> slot 0 first
        self._inuse: set = set()

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("no free slots")
        s = self._free.pop()
        self._inuse.add(s)
        return s

    def free(self, s: int) -> None:
        if s not in self._inuse:
            raise RuntimeError(f"slot {s} freed twice (or never allocated)")
        self._inuse.discard(s)
        self._free.append(s)

    def free_count(self) -> int:
        return len(self._free)

    def in_use(self) -> set:
        return set(self._inuse)

    def reset(self) -> None:
        self._free = list(range(self.n - 1, -1, -1))
        self._inuse.clear()


_STREAM_DONE = object()


@dataclass
class GenerationRequest(InferenceRequest):
    """One queued generation: prompt + budget + the per-token stream.
    Rides the :class:`RequestQueue` (deadlines expire queued requests,
    ``requeue`` puts crash-recovered ones back at the front) and the
    :class:`WorkerSupervisor`'s exactly-once requeue contract
    (``requeues``)."""

    prompt: np.ndarray = None
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    on_token: Optional[Callable[[int], None]] = None
    # temperature 0 = exact greedy (device argmax); otherwise
    # serving/sampling.py draws from the logits with the (seed,
    # absolute-token-index) fold
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    cancelled: bool = False
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    _stream: SimpleQueue = field(default_factory=SimpleQueue)

    def prefix(self) -> np.ndarray:
        """Prompt + tokens generated so far — what a crash-requeued
        request re-prefills with (greedy decode is deterministic, so
        the continuation is the one the dead worker would have
        produced; already-streamed tokens are not re-emitted)."""
        if not self.generated:
            return np.asarray(self.prompt, np.int32)
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.generated, np.int32)])

    # stream closure rides every resolution path (success, failure,
    # queued-deadline expiry) so a consumer iterating tokens() can
    # never hang on a finished request
    def close_stream(self, error: Optional[BaseException] = None) -> None:
        self._stream.put((_STREAM_DONE, error))

    def emit(self, token: int) -> None:
        self.generated.append(int(token))
        self._stream.put((int(token), None))

    def succeed(self) -> None:
        if not self.future.done():
            self.future.set_result(list(self.generated))
        self.close_stream()

    def fail(self, exc: BaseException) -> None:
        super().fail(exc)
        self.close_stream(exc)

    def time_out(self) -> None:
        super().time_out()
        self.close_stream(self.future.exception()
                          if self.future.done() else None)


class GenerationHandle:
    """Client view of one generation: a Future of the full token list
    plus a streaming iterator of tokens as they resolve."""

    def __init__(self, req: GenerationRequest):
        self._req = req
        self.future = req.future

    @property
    def id(self) -> int:
        return self._req.id

    def result(self, timeout: Optional[float] = None) -> List[int]:
        return self.future.result(timeout)

    def partial(self) -> List[int]:
        """Tokens generated so far (snapshot)."""
        return list(self._req.generated)

    def cancel(self) -> None:
        """Request cancellation; takes effect at the next step boundary
        (the slot is freed, the future resolves to the partial token
        list, the stream closes cleanly)."""
        self._req.cancelled = True

    def tokens(self, timeout: Optional[float] = None):
        """Iterate tokens as they are generated. Raises the request's
        failure (deadline, crash, ...) at the point the stream closed
        on it; a clean finish (EOS/max_new_tokens/cancel) just ends
        the iteration. ``timeout`` bounds the wait for EACH token: a
        gap longer than that raises the builtin :class:`TimeoutError`
        (iterating again resumes from the next undelivered token)."""
        while True:
            try:
                token, err = self._req._stream.get(timeout=timeout)
            except Empty:
                raise TimeoutError(
                    f"no token from generation {self._req.id} within "
                    f"{timeout}s (the request is still in flight; "
                    f"re-iterate to resume the stream)") from None
            if token is _STREAM_DONE:
                if err is not None and \
                        not isinstance(err, GenerationCancelled):
                    raise err
                return
            yield token

    def __iter__(self):
        return self.tokens()


class GenerativeMetrics(ServingMetrics):
    """ServingMetrics plus the generative lanes: TTFT (submit -> first
    streamed token), inter-token latency, prefill time, token/step
    counters and slot occupancy."""

    def __init__(self, max_slots: int = 0):
        super().__init__()
        self.max_slots = int(max_slots)
        self.ttft_ms = LatencyHistogram()
        self.intertoken_ms = LatencyHistogram()
        self.prefill_ms = LatencyHistogram()
        for c in ("tokens_generated", "prefills", "decode_steps",
                  "slots_active_sum", "requests_cancelled",
                  "spec_rounds", "draft_tokens", "draft_accepted",
                  "draft_rejected"):
            self.counters[c] = 0

    def observe_ttft(self, ms: float) -> None:
        with self._lock:
            self.ttft_ms.record(ms)

    def observe_intertoken(self, ms: float) -> None:
        with self._lock:
            self.intertoken_ms.record(ms)

    def observe_prefill(self, ms: float) -> None:
        with self._lock:
            self.counters["prefills"] += 1
            self.prefill_ms.record(ms)

    def observe_spec_round(self, drafted: int, accepted: int) -> None:
        """One speculative round: ``drafted`` proposals across the batch,
        ``accepted`` of them matched by the target. Every emitted token
        (accepted drafts included) is counted in ``tokens_generated`` by
        the emission path exactly once; rejected drafts land only here."""
        with self._lock:
            self.counters["spec_rounds"] += 1
            self.counters["draft_tokens"] += int(drafted)
            self.counters["draft_accepted"] += int(accepted)
            self.counters["draft_rejected"] += int(drafted) - int(accepted)

    def observe_decode_step(self, active: int, ms: float) -> None:
        with self._lock:
            self.counters["decode_steps"] += 1
            self.counters["slots_active_sum"] += int(active)
            self.counters["batches_dispatched"] += 1
            self.counters["rows_served"] += int(active)
            self.counters["rows_padded"] += max(0, self.max_slots
                                                - int(active))
            self.batch_sizes[int(active)] = \
                self.batch_sizes.get(int(active), 0) + 1
            self.exec_ms.record(ms)

    def to_record(self) -> dict:
        rec = super().to_record()
        with self._lock:
            rec["latency_ms"]["ttft"] = self.ttft_ms.summary()
            rec["latency_ms"]["intertoken"] = self.intertoken_ms.summary()
            rec["latency_ms"]["prefill"] = self.prefill_ms.summary()
            steps = self.counters["decode_steps"]
            occ = (self.counters["slots_active_sum"]
                   / (steps * self.max_slots)) \
                if steps and self.max_slots else 0.0
            uptime = max(time.time() - self._start_t, 1e-9)
            rec["generative"] = {
                "max_slots": self.max_slots,
                "tokens_generated": self.counters["tokens_generated"],
                "prefills": self.counters["prefills"],
                "decode_steps": steps,
                "slot_occupancy": round(occ, 4),
                "tokens_per_sec": round(
                    self.counters["tokens_generated"] / uptime, 3),
                "spec_rounds": self.counters["spec_rounds"],
                "draft_tokens": self.counters["draft_tokens"],
                "draft_accepted": self.counters["draft_accepted"],
                "draft_rejected": self.counters["draft_rejected"],
                "draft_acceptance_rate": round(safe_ratio(
                    self.counters["draft_accepted"],
                    self.counters["draft_tokens"]), 4)}
        return rec

    def stats(self) -> str:
        rec = self.to_record()
        g = rec["generative"]
        lines = [super().stats(),
                 f"  generative: {g['tokens_generated']} tokens "
                 f"({g['tokens_per_sec']} tok/s lifetime), "
                 f"{g['prefills']} prefills, {g['decode_steps']} decode "
                 f"steps, slot occupancy {g['slot_occupancy']:.1%} of "
                 f"{g['max_slots']} slots"]
        if g["spec_rounds"]:
            lines.append(
                f"  speculative: {g['spec_rounds']} rounds, acceptance "
                f"{g['draft_acceptance_rate']:.1%} "
                f"({g['draft_accepted']}/{g['draft_tokens']} drafts)")
        for name in ("ttft", "intertoken", "prefill"):
            s = rec["latency_ms"][name]
            lines.append(f"  {name:<10} p50 {s['p50']:.3f} ms  "
                         f"p95 {s['p95']:.3f} ms  p99 {s['p99']:.3f} ms  "
                         f"max {s['max']:.3f} ms  (n={s['count']})")
        return "\n".join(lines)


def _prefill_buckets(max_seq_len: int) -> BucketSpec:
    """The pow2 prefill ladder: halving down from ``max_seq_len`` to 1."""
    return BucketSpec(pow2_buckets(max_seq_len,
                                   n_buckets=int(max_seq_len).bit_length()))


def _sig(io: dict, role: str = "target") -> tuple:
    """A dispatch's shape signature: its io arrays' names and shapes, and
    for the draft's dispatches the role (draft and target share io
    signatures)."""
    sig = tuple(sorted((k, tuple(np.shape(v))) for k, v in io.items()))
    return sig if role == "target" else sig + (("role", role),)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _slab(shape, dtype: str, device) -> torch.Tensor:
    """One zeroed KV slab. Allocated under inference mode, as the
    dispatches that write it in place run."""
    with torch.inference_mode():
        return torch.zeros(tuple(shape), dtype=getattr(torch, dtype),
                           device=device)


class GenerativeServer:
    """Continuous-batching autoregressive model server.

    ::

        spec = zoo.gpt.gpt_generative_spec(sd, cfg)
        srv = GenerativeServer(spec, max_slots=8, max_seq_len=128)
        handle = srv.submit([1, 2, 3], max_new_tokens=32)
        for tok in handle.tokens():      # streams as decoded
            ...
        tokens = handle.result()         # or the full list
        srv.shutdown()

    ``admit="continuous"`` (default) fills free slots from the queue at
    every step boundary; ``admit="static"`` is the wait-for-full-batch
    baseline (a new wave is admitted only when every slot is free).

    ``warmup=True`` builds the kernels and runs the decode step and every
    prefill bucket once before the worker starts. ``resilience=True``
    arms SLO admission (p99 decode-step TTFT estimates) and worker
    supervision (crash requeue at prefill, exactly once). ``device``: the
    card unless ``device="cpu"`` (the parameters are moved there).

    ``draft_spec`` (a dense :class:`GenerativeSpec` over the same
    vocabulary) arms speculative decoding with windows of ``speculate_k``
    (>= 2) tokens: the draft proposes, the spec's ``verify`` scores each
    window in one dispatch, and the longest agreeing prefix is emitted.
    """

    def __init__(self, spec, max_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 max_queue_len: int = 256,
                 default_timeout_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 telemetry_port: Optional[int] = None,
                 resilience=True,
                 warmup: bool = True,
                 admit: str = "continuous",
                 draft_spec=None,
                 speculate_k: int = 4,
                 start: bool = True,
                 device: DeviceLike = None):
        spec = self._coerce_spec(spec)
        if admit not in ("continuous", "static"):
            raise ValueError(f"admit= must be 'continuous' or 'static', "
                             f"got {admit!r}")
        if telemetry_port is not None:
            raise NotImplementedError(
                "the telemetry endpoint (telemetry_port) is not ported yet: "
                "it waits for monitor/server.py (ROADMAP queue 1 item 2.5)")
        self.device = default_device(device)
        self.spec = spec
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len or spec.max_seq_len)
        if self.max_seq_len > spec.max_seq_len:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"positional capacity {spec.max_seq_len}")
        # speculative decoding: misconfigurations that can never work fail
        # here, not mid-decode
        self.speculate_k = int(speculate_k)
        self.draft_spec = self._check_draft(draft_spec, spec)
        self.draft_slab_bytes = 0
        self.admit_mode = admit
        self.eos_id = eos_id if eos_id is not None else spec.eos_id
        self.default_timeout_ms = default_timeout_ms
        self.max_queue_len = int(max_queue_len)
        self.metrics = self._make_metrics()
        # pow2 prefill bucket ladder: halving down from max_seq_len to 1
        self._buckets = _prefill_buckets(self.max_seq_len)
        # the generative tier estimates TTFT from p99 decode-step time
        if resilience is True:
            resilience = ResilienceConfig(percentile=99.0)
        self.resilience = ResilienceConfig.normalize(resilience)
        self.admission: Optional[AdmissionController] = None
        if self.resilience is not None and self.resilience.admission:
            self.admission = AdmissionController(
                window=self.resilience.window,
                percentile=self.resilience.percentile,
                min_samples=self.resilience.min_exec_samples)
        self._queue = RequestQueue(
            self.max_queue_len,
            on_timeout=lambda req: self.metrics.record_timeout("deadline"))
        self._exec_lock = threading.Lock()
        self._shapes_seen: set = set()
        self._req_id = 0
        self._id_lock = threading.Lock()
        self._closed = False
        self._dirty = False          # a respawned worker must reset state
        self._params = self._pull_params()
        # KV slabs + host scheduler state (serving/paged overrides)
        self._init_kv()
        self._init_draft()
        self.warmup_report: Optional[dict] = None
        if warmup:
            self.warmup()
        self._workers: List[threading.Thread] = []
        self._supervisor: Optional[WorkerSupervisor] = None
        self._supervised = (self.resilience is not None
                            and self.resilience.supervise)
        self._cur_slot: Optional[InflightSlot] = None
        self._started = False
        if start:
            self.start()

    # -- subclass hooks (serving/paged/server.py overrides) -------------
    def _coerce_spec(self, spec):
        if not isinstance(spec, GenerativeSpec):
            if hasattr(spec, "generative_spec"):
                spec = spec.generative_spec()
            else:
                raise TypeError(
                    f"{type(spec).__name__} is not generatively servable: "
                    f"pass a GenerativeSpec (e.g. from "
                    f"zoo.gpt.gpt_generative_spec)")
        return spec

    def _check_draft(self, draft_spec, spec):
        """The draft spec, checked against the target: a dense
        :class:`GenerativeSpec` over the same vocabulary covering every
        position served, and a window of at least 2."""
        if draft_spec is None:
            return None
        if not isinstance(draft_spec, GenerativeSpec):
            if hasattr(draft_spec, "generative_spec"):
                draft_spec = draft_spec.generative_spec()
            else:
                raise TypeError(
                    f"{type(draft_spec).__name__} is not usable as a draft: "
                    f"pass a dense GenerativeSpec (the draft always runs "
                    f"dense, even under a paged target)")
        if int(draft_spec.vocab_size) != int(spec.vocab_size):
            raise ValueError(
                f"draft vocab_size {draft_spec.vocab_size} != target "
                f"vocab_size {spec.vocab_size}: speculation compares token "
                f"ids, the vocabularies must match")
        if int(draft_spec.max_seq_len) < self.max_seq_len:
            raise ValueError(
                f"draft max_seq_len {draft_spec.max_seq_len} < served "
                f"max_seq_len {self.max_seq_len}: the draft must cover "
                f"every position the target can reach")
        if self.speculate_k < 2:
            raise ValueError(
                f"speculate_k must be >= 2, got {self.speculate_k} (a "
                f"window of 1 holds only the already-emitted token and "
                f"drafts nothing)")
        return draft_spec

    def _make_metrics(self) -> GenerativeMetrics:
        return GenerativeMetrics(self.max_slots)

    def _pull_params(self) -> Dict[str, torch.Tensor]:
        return {n: t.to(self.device) for n, t in self.spec.params().items()}

    def _slab_shape(self) -> tuple:
        return tuple(self.spec.kv_shape(self.max_slots, self.max_seq_len))

    def _init_kv(self) -> None:
        """Allocate the KV memory tier + host scheduler state: two
        ``[layers, max_slots, heads, max_seq, head_dim]`` slabs allocated
        ONCE, headroom-guarded, updated in place by every dispatch."""
        shape = self._slab_shape()
        itemsize = torch.empty((), dtype=getattr(
            torch, self.spec.kv_dtype)).element_size()
        self.kv_slab_bytes = 2 * int(np.prod(shape)) * itemsize
        memstats.check_headroom(
            self.kv_slab_bytes,
            f"generative KV slabs ({self.max_slots} slots x "
            f"{self.max_seq_len} positions)", self.device)
        self._kc = _slab(shape, self.spec.kv_dtype, self.device)
        self._vc = _slab(shape, self.spec.kv_dtype, self.device)
        AllocationsTracker.get_instance().allocate("kv_slab",
                                                   self.kv_slab_bytes)
        # host-side slot state (the worker thread owns mutation)
        self._slots = SlotAllocator(self.max_slots)
        self._slot_reqs: List[Optional[GenerationRequest]] = \
            [None] * self.max_slots
        self._tokens = np.zeros(self.max_slots, np.int32)
        self._positions = np.zeros(self.max_slots, np.int32)
        self._active = np.zeros(self.max_slots, bool)
        self._decode_disp = self.spec.decode
        self._prefill_disp = self.spec.prefill
        self._verify_disp = self.spec.verify

    def _init_draft(self) -> None:
        """Speculative decoding's memory: the draft's own DENSE per-slot
        KV slabs (one row per target slot, kept position-synced through
        partial acceptance) and its parameters. A no-op without a
        draft."""
        ds = self.draft_spec
        self._draft_params = None
        self._dkc = self._dvc = None
        if ds is None:
            return
        if self._verify_disp is None:
            raise ValueError(
                "speculative decoding needs a target spec with a verify "
                "function: build it with zoo.gpt.gpt_generative_spec or "
                "gpt_paged_spec")
        shape = tuple(ds.kv_shape(self.max_slots, self.max_seq_len))
        itemsize = torch.empty((), dtype=getattr(
            torch, ds.kv_dtype)).element_size()
        self.draft_slab_bytes = 2 * int(np.prod(shape)) * itemsize
        memstats.check_headroom(
            self.draft_slab_bytes,
            f"draft KV slabs (speculative decoding, {self.max_slots} slots "
            f"x {self.max_seq_len} positions)", self.device)
        self._reset_draft_slabs()
        AllocationsTracker.get_instance().allocate("kv_slab",
                                                   self.draft_slab_bytes)
        self._draft_params = self._pull_draft_params()

    def _pull_draft_params(self) -> Dict[str, torch.Tensor]:
        return {n: t.to(self.device)
                for n, t in self.draft_spec.params().items()}

    def _reset_draft_slabs(self) -> None:
        if self.draft_spec is None:
            return
        shape = tuple(self.draft_spec.kv_shape(self.max_slots,
                                               self.max_seq_len))
        self._dkc = _slab(shape, self.draft_spec.kv_dtype, self.device)
        self._dvc = _slab(shape, self.draft_spec.kv_dtype, self.device)

    def _can_place(self, req: GenerationRequest) -> bool:
        """Whether the memory tier can hold ``req``'s prefill right now.
        Dense slabs: a free slot IS the capacity. The paged subclass
        gates on free KV blocks."""
        return True

    # ------------------------------------------------------------------
    def start(self) -> None:
        """Start the decode worker (a no-op when already started).
        ``start=False`` + queued submits + a late ``start()`` makes
        admission order deterministic for tests."""
        if self._started or self._closed:
            return
        self._started = True
        if self._supervised:
            self._supervisor = WorkerSupervisor(
                spawn=self._spawn_worker, n_workers=1, queue=self._queue,
                metrics=self.metrics,
                backoff_base_s=self.resilience.worker_backoff_base_s,
                backoff_max_s=self.resilience.worker_backoff_max_s)
        else:
            self._workers.append(self._spawn_worker(0, InflightSlot()))

    def _next_id(self) -> int:
        with self._id_lock:
            self._req_id += 1
            return self._req_id

    # -- warmup ----------------------------------------------------------
    def _warm_calls(self, bucket_list):
        """(label, role, function, kc, vc, io) of every shape the server
        will dispatch: the decode step with no lane active (it writes
        nothing), each prefill bucket into slot 0 of throwaway one-slot
        slabs and, with a draft, the verify at the window's shape with no
        lane active and the draft's own decode and prefills (role
        ``"draft"``: the draft's parameters)."""
        S = self.max_slots
        off = {"tokens": np.zeros(S, np.int32),
               "positions": np.zeros(S, np.int32),
               "active": np.zeros(S, bool)}
        yield (f"generative_decode_s{S}", "target", self._decode_disp,
               self._kc, self._vc, off)
        shape = tuple(self.spec.kv_shape(1, self.max_seq_len))
        kc = _slab(shape, self.spec.kv_dtype, self.device)
        vc = _slab(shape, self.spec.kv_dtype, self.device)
        for b in bucket_list:
            yield (f"generative_prefill_b{b}", "target", self._prefill_disp,
                   kc, vc, {"tokens": np.zeros(b, np.int32),
                            "length": np.int32(b), "slot": np.int32(0)})
        if self.draft_spec is not None:
            W = self.speculate_k
            yield (f"generative_verify_s{S}w{W}", "target",
                   self._verify_disp, self._kc, self._vc,
                   {**off, "tokens": np.zeros((S, W), np.int32)})
            yield from self._warm_draft_calls(bucket_list)

    def _warm_draft_calls(self, bucket_list):
        """The draft's decode with no lane active and each of its prefill
        buckets on throwaway one-slot draft slabs."""
        S, ds = self.max_slots, self.draft_spec
        yield (f"draft_decode_s{S}", "draft", ds.decode, self._dkc,
               self._dvc, {"tokens": np.zeros(S, np.int32),
                           "positions": np.zeros(S, np.int32),
                           "active": np.zeros(S, bool)})
        shape = tuple(ds.kv_shape(1, self.max_seq_len))
        kc = _slab(shape, ds.kv_dtype, self.device)
        vc = _slab(shape, ds.kv_dtype, self.device)
        for b in bucket_list:
            yield (f"draft_prefill_b{b}", "draft", ds.prefill, kc, vc,
                   {"tokens": np.zeros(b, np.int32), "length": np.int32(b),
                    "slot": np.int32(0)})

    def warmup(self) -> dict:
        """Build the kernels (``nvcc`` at their first launch) and run the
        decode step and every prefill bucket once, so that live traffic
        builds nothing: one decode shape + <= log2(max_seq) + 1 prefill
        shapes. Returns (and stores as ``warmup_report``) the shape list,
        wall seconds and the kernel libraries built."""
        from deeplearning4j_tpu_torch.kernels import _cuda
        bucket_list = list(self._buckets.buckets)
        built = set(_cuda.BUILDS)
        t0 = time.perf_counter()
        for label, role, fn, kc, vc, io in self._warm_calls(bucket_list):
            sig = _sig(io, role)
            params = self._draft_params if role == "draft" else self._params
            with self._exec_lock, torch.inference_mode(), \
                    _tracer.span("serving.warmup", cat="serving",
                                 target=label):
                fn(params, kc, vc, io)
                if sig not in self._shapes_seen:
                    self._shapes_seen.add(sig)
                    self.metrics.inc("warmup_compiles")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_report = {
            "decode_slots": self.max_slots,
            "prefill_buckets": bucket_list,
            "speculative": self.draft_spec is not None,
            "seconds": round(time.perf_counter() - t0, 4),
            "kernel_builds": sorted(set(_cuda.BUILDS) - built)}
        return self.warmup_report

    # -- client API -----------------------------------------------------
    def _validate_submit(self, prompt, max_new_tokens: int) -> np.ndarray:
        """The cheap permanent-error checks every submit path runs
        BEFORE any capacity accounting, returning the coerced prompt (the
        paged subclass validates ahead of its block commitment: an
        invalid request surfaces its ValueError even under pool
        pressure)."""
        if self._closed:
            raise ServerClosedError("GenerativeServer is shut down")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if prompt.size > self.max_seq_len - 1:
            raise ValueError(
                f"prompt of {prompt.size} tokens leaves no room to "
                f"generate within max_seq_len {self.max_seq_len}")
        if prompt.min() < 0 or prompt.max() >= self.spec.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, {self.spec.vocab_size})")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        return prompt

    def submit(self, prompt, max_new_tokens: int = 16,
               timeout_ms: Optional[float] = None,
               on_token: Optional[Callable[[int], None]] = None,
               eos_id: Optional[int] = None,
               temperature: float = 0.0,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None) -> GenerationHandle:
        """Enqueue one generation; returns a :class:`GenerationHandle`
        streaming tokens as they decode. Sheds typed at the call site:
        :class:`ServerOverloadedError` when the queue is full or the
        estimated TTFT (queue depth x rolling p99 decode-step time)
        already exceeds the deadline.

        ``temperature`` 0 (default) is exact greedy; > 0 samples from
        the logits with optional ``top_k``/``top_p`` truncation, seeded
        by ``(seed, absolute token index)``; ``seed`` defaults to the
        request id."""
        prompt = self._validate_submit(prompt, max_new_tokens)
        temperature = float(temperature)
        if not np.isfinite(temperature) or temperature < 0.0:
            raise ValueError(
                f"temperature must be a finite float >= 0, "
                f"got {temperature}")
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.metrics.inc("requests_submitted")
        timeout_ms = timeout_ms if timeout_ms is not None \
            else self.default_timeout_ms
        self._admit_check(timeout_ms)
        deadline = time.monotonic() + timeout_ms / 1000.0 \
            if timeout_ms is not None else None
        rid = self._next_id()
        req = GenerationRequest(
            x=[prompt], future=Future(), rows=1, deadline=deadline,
            id=rid, prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            eos_id=eos_id if eos_id is not None else self.eos_id,
            on_token=on_token,
            temperature=temperature,
            top_k=int(top_k) if top_k is not None else None,
            top_p=float(top_p) if top_p is not None else None,
            seed=int(seed) if seed is not None else rid)
        with _tracer.span("serving.enqueue", cat="serving", id=req.id,
                          prompt=int(prompt.size)):
            try:
                self._queue.put(req)
            except ServerOverloadedError:
                self.metrics.inc("requests_rejected")
                raise
        return GenerationHandle(req)

    def generate(self, prompt, max_new_tokens: int = 16,
                 timeout_ms: Optional[float] = None) -> List[int]:
        """Blocking convenience around :meth:`submit`."""
        return self.submit(prompt, max_new_tokens,
                           timeout_ms=timeout_ms).result()

    def _admit_check(self, timeout_ms: Optional[float]) -> None:
        """SLO admission: TTFT estimate = (queue depth + 1) x rolling
        p99 decode-step time. A deadline the estimate already exceeds
        is shed typed, with the estimate as the backoff hint."""
        if self.admission is None or timeout_ms is None:
            return
        est = self.admission.estimate_wait_ms(self._queue.pending() + 1, 1)
        if est is not None and est > timeout_ms:
            self.metrics.inc("requests_shed")
            raise ServerOverloadedError(
                f"estimated TTFT {est:.1f} ms exceeds the "
                f"{timeout_ms:.1f} ms deadline — shed at admission "
                f"(queue depth x p{self.admission.percentile:g} "
                f"decode-step time)", retry_after_s=round(est / 1000.0, 3))

    def update_model(self) -> None:
        """Re-pull the parameters from the spec's source graph between
        dispatches (a quantized spec re-quantizes them), and the draft's
        from its own."""
        fresh = self._pull_params()
        draft = self._pull_draft_params() if self.draft_spec is not None \
            else None
        with self._exec_lock:
            self._params = fresh
            if draft is not None:
                self._draft_params = draft

    # -- worker ---------------------------------------------------------
    def _spawn_worker(self, index: int, slot: InflightSlot
                      ) -> threading.Thread:
        t = threading.Thread(target=self._worker_main, args=(slot,),
                             name=f"GenerativeServer-{index}", daemon=True)
        t.start()
        return t

    def _worker_main(self, slot: InflightSlot) -> None:
        self._cur_slot = slot
        try:
            if self._dirty:
                # a respawned worker after a crash: the in-flight
                # requests were requeued (they re-enter at prefill) and
                # the slabs may hold a half-written step: start from
                # fresh slabs + a clean slot table
                self._reset_state()
            self._dirty = True
            self._worker_loop(slot)
            slot.exited = True
        except BaseException as e:      # noqa: BLE001 — supervisor's cue
            slot.crashed = e
            if not self._supervised:
                # no supervisor to requeue them: in-flight generations
                # must not hang their clients forever
                for r in list(slot.requests or []):
                    r.fail(e)
                self.metrics.record_failure(
                    e, cause="worker_crash",
                    n=max(1, len(slot.requests or [])))

    def _reset_state(self) -> None:
        shape = self._slab_shape()
        self._kc = _slab(shape, self.spec.kv_dtype, self.device)
        self._vc = _slab(shape, self.spec.kv_dtype, self.device)
        self._reset_draft_slabs()
        self._slots.reset()
        self._slot_reqs = [None] * self.max_slots
        self._tokens[:] = 0
        self._positions[:] = 0
        self._active[:] = False

    def _worker_loop(self, slot: InflightSlot) -> None:
        while True:
            progressed = self._step(slot)
            if progressed:
                slot.progressed = True
            elif self._queue.finished and not self._active.any():
                return

    def _n_active(self) -> int:
        return int(self._active.sum())

    def _sync_inflight(self, slot: InflightSlot) -> None:
        """Keep the supervisor's crash-requeue window exact: every
        popped-but-unresolved generation, at all times."""
        reqs = [r for r in self._slot_reqs if r is not None]
        slot.requests = reqs or None

    def _step(self, slot: InflightSlot) -> bool:
        progressed = self._admit(slot)
        if not self._active.any():
            return progressed
        if self._spec_ready():
            self._speculate_once(slot)
        else:
            self._decode_once(slot)
        return True

    def _admit(self, slot: InflightSlot) -> bool:
        """Step-boundary admission: fill free slots from the queue
        (continuous batching). In ``static`` mode a new wave is only
        admitted when every slot is free."""
        if self.admit_mode == "static" and self._n_active() > 0:
            return False
        admitted = False
        while self._slots.free_count() > 0:
            # block briefly only when idle — an active decode batch
            # must not stall at the boundary waiting for new work
            block = not self._active.any() and not admitted
            reqs = self._queue.take(1, timeout=0.05 if block else 0.0)
            if not reqs:
                break
            req = reqs[0]
            if req.cancelled:
                req.future.set_result(list(req.generated))
                req.close_stream()
                self.metrics.inc("requests_cancelled")
                continue
            if not self._can_place(req):
                # memory-tier backpressure (paged: not enough free KV
                # blocks): back to the FRONT, and stop admitting until a
                # retirement frees capacity
                self._queue.requeue(req)
                break
            s = self._slots.alloc()
            self._slot_reqs[s] = req
            self._sync_inflight(slot)
            try:
                self._prefill(s, req)
                admitted = True
            except Exception as e:      # noqa: BLE001 — per-request fail
                # a failing prompt fails ITS request, not the worker
                self._retire(s, error=e)
        return admitted

    def _prefill(self, s: int, req: GenerationRequest) -> None:
        prefix = req.prefix()
        L = int(prefix.size)
        if L > self.max_seq_len - 1:
            # a crash-requeued request whose prefix already fills the
            # sequence: nothing left to decode — finish with what it has
            self._retire(s)
            return
        bucket = self._buckets.bucket_for(L)
        padded = np.zeros(bucket, np.int32)
        padded[:L] = prefix
        io = {"tokens": padded, "length": np.int32(L), "slot": np.int32(s)}
        t0 = time.perf_counter()
        out = self._dispatch(self._prefill_disp, io, "serving.prefill",
                             bucket=bucket, slot=s)
        tok = self._resolve_token(req, int(out[2]), out[3])
        self.metrics.observe_prefill((time.perf_counter() - t0) * 1000.0)
        self._positions[s] = L
        self._tokens[s] = tok
        self._active[s] = True
        self._emit(s, req, tok)
        self._draft_prefill(s, prefix, L)

    def _draft_prefill(self, s: int, prefix: np.ndarray, L: int) -> None:
        """Fill the draft's KV rows of a freshly admitted slot with the
        FULL prefix (the draft has no prefix cache, even under a paged
        target). Its token is discarded: the target's prefill emitted the
        real one; the draft only needs its cache position-synced before
        the first speculative round."""
        if self.draft_spec is None or not self._active[s]:
            return
        bucket = self._buckets.bucket_for(L)
        padded = np.zeros(bucket, np.int32)
        padded[:L] = prefix
        io = {"tokens": padded, "length": np.int32(L), "slot": np.int32(s)}
        self._dispatch(self.draft_spec.prefill, io, "serving.draft",
                       draft=True, phase="prefill", bucket=bucket, slot=s)

    def _resolve_token(self, req: GenerationRequest, device_tok: int,
                       logits_row) -> int:
        """The next token for one slot: the device argmax at temperature
        0, otherwise a seeded host sample from the logits at this
        request's absolute token index."""
        if not req.temperature or req.temperature <= 0.0:
            return int(device_tok)
        seed = req.seed if req.seed is not None else req.id
        return sample_token(_host(logits_row),
                            temperature=req.temperature,
                            top_k=req.top_k, top_p=req.top_p,
                            seed=seed,
                            index=int(np.asarray(req.prompt).size)
                            + len(req.generated))

    def _sampled_active(self) -> bool:
        return any(r is not None and r.temperature > 0
                   for r in self._slot_reqs)

    def _decode_io(self) -> dict:
        return {"tokens": self._tokens.copy(),
                "positions": self._positions.copy(),
                "active": self._active.copy()}

    def _decode_once(self, slot: InflightSlot) -> None:
        n_active = self._n_active()
        io = self._decode_io()
        t0 = time.perf_counter()
        _, _, nxt_d, logits_d = self._dispatch(
            self._decode_disp, io, "serving.decode", active=n_active)
        nxt = _host(nxt_d)
        ms = (time.perf_counter() - t0) * 1000.0
        self.metrics.observe_decode_step(n_active, ms)
        if self.admission is not None:
            self.admission.observe(ms)
        self._observe_step()
        lg = _host(logits_d) if self._sampled_active() else None
        for s in np.flatnonzero(io["active"]):
            req = self._slot_reqs[int(s)]
            if req is None:
                continue
            s = int(s)
            tok = self._resolve_token(req, int(nxt[s]),
                                      lg[s] if lg is not None else None)
            self._positions[s] += 1
            self._tokens[s] = tok
            self._emit(s, req, tok)
        self._after_step()

    def _observe_step(self) -> None:
        """Post-dispatch memory-tier bookkeeping hook, after each decode
        step and verify (paged: pool occupancy sample)."""

    def _after_step(self) -> None:
        """Post-step memory-tier check hook, after each decode step and
        speculative round (paged: the leak invariant under
        ``debug_leaks``)."""

    # -- speculative decoding (draft K, verify once) --------------------
    def _spec_ready(self) -> bool:
        """Whether the next round can run speculatively: a draft is armed
        and every active slot has a full verify window of positions left.
        The paged subclass also grows block tables to cover the window up
        front, falling back to a plain step when the pool cannot."""
        if self.draft_spec is None:
            return False
        act = np.flatnonzero(self._active)
        if act.size == 0:
            return False
        return bool(np.all(self._positions[act].astype(np.int64)
                           + self.speculate_k <= self.max_seq_len))

    def _verify_io(self, window: np.ndarray, positions: np.ndarray,
                   active: np.ndarray) -> dict:
        return {"tokens": window, "positions": positions.copy(),
                "active": active.copy()}

    def _speculate_once(self, slot: InflightSlot) -> None:
        """One draft-K / verify-once speculative round (Leviathan et al.):
        ``speculate_k`` draft decode dispatches propose a window per
        active slot, then the target scores the whole window in ONE verify
        dispatch. Every emitted token is the target's own
        (:meth:`_resolve_token`), so the output does not depend on the
        draft; the draft decides how many positions the verify resolves. A
        rejected tail needs no KV rollback: positions never advance over
        it, and rows past a slot's position are never read before they
        are written again. The draft's KV stays row-synced because
        dispatch ``m`` feeds window column ``m - 1``."""
        W = self.speculate_k
        active = self._active.copy()
        positions = self._positions.copy()
        n_active = int(active.sum())
        window = np.zeros((self.max_slots, W), np.int32)
        window[:, 0] = self._tokens
        reqs = list(self._slot_reqs)
        act_idx = [int(s) for s in np.flatnonzero(active)
                   if reqs[int(s)] is not None]
        sampled = any(reqs[s].temperature > 0 for s in act_idx)
        t0 = time.perf_counter()
        # dispatch m feeds column m-1 at position pos0+m-1, writing that
        # draft KV row and proposing column m; the W-th exists only for
        # its KV write (the draft cache must cover the window before the
        # next round), its proposal is discarded
        d_tokens = window[:, 0].copy()
        for m in range(1, W + 1):
            dio = {"tokens": d_tokens.copy(),
                   "positions": (positions + np.int32(m - 1)
                                 * active).astype(np.int32),
                   "active": active.copy()}
            _, _, dnxt, dlg = self._dispatch(
                self.draft_spec.decode, dio, "serving.draft", draft=True,
                active=n_active, step=m)
            if m >= W:
                break
            dnxt = _host(dnxt)
            dlg_h = _host(dlg) if sampled else None
            for s in act_idx:
                req = reqs[s]
                d = int(dnxt[s])
                if req.temperature and req.temperature > 0:
                    # the proposal takes the SAME (seed, index) draw the
                    # target will use to resolve this position
                    d = sample_token(
                        dlg_h[s], temperature=req.temperature,
                        top_k=req.top_k, top_p=req.top_p,
                        seed=req.seed if req.seed is not None else req.id,
                        index=int(np.asarray(req.prompt).size)
                        + len(req.generated) + m - 1)
                window[s, m] = d
            d_tokens = window[:, m].copy()
        vio = self._verify_io(window, positions, active)
        _, _, out_d, vlg_d = self._dispatch(
            self._verify_disp, vio, "serving.verify", active=n_active,
            window=W)
        out = _host(out_d)
        ms = (time.perf_counter() - t0) * 1000.0
        self.metrics.observe_decode_step(n_active, ms)
        if self.admission is not None:
            self.admission.observe(ms)
        self._observe_step()
        lg = _host(vlg_d) if sampled else None
        drafted = accepted = 0
        for s in act_idx:
            req = reqs[s]
            drafted += W - 1
            pos0 = int(positions[s])
            for j in range(W):
                tok = self._resolve_token(
                    req, int(out[s, j]),
                    lg[s, j] if lg is not None else None)
                self._positions[s] = pos0 + j + 1
                self._tokens[s] = tok
                self._emit(s, req, tok)
                if not self._active[s]:
                    break     # retired: EOS / budget / deadline / cancel
                if j + 1 >= W:
                    break
                if int(window[s, j + 1]) != tok:
                    break     # draft rejected: the window's tail is void
                accepted += 1
        self.metrics.observe_spec_round(drafted, accepted)
        self._after_step()

    def _dispatch(self, disp, io: dict, span: str, draft: bool = False,
                  **attrs):
        """One device dispatch of prefill/decode/verify with the shared
        plumbing: exec lock, inference mode, span, first-shape
        accounting, OOM forensics. The slabs are updated in place.
        ``draft=True`` routes to the draft's parameters and slabs; the
        shapes-seen key carries the role, since draft and target share io
        signatures."""
        sig = _sig(io, "draft" if draft else "target")
        with self._exec_lock, torch.inference_mode(), \
                _tracer.span(span, cat="serving", **attrs):
            if sig not in self._shapes_seen:
                self._shapes_seen.add(sig)
                self.metrics.inc("compiles")
            try:
                if draft:
                    kc, vc, nxt, logits = disp(self._draft_params, self._dkc,
                                               self._dvc, io)
                else:
                    kc, vc, nxt, logits = disp(self._params, self._kc,
                                               self._vc, io)
            except Exception as e:
                raise self._wrap_exec_error(e, span) from e
            if draft:
                self._dkc, self._dvc = kc, vc
            else:
                self._kc, self._vc = kc, vc
        return kc, vc, nxt, logits

    def _wrap_exec_error(self, e: BaseException, what: str):
        if memstats.is_resource_exhausted(e):
            return memstats.oom_error(e, program=f"generative_{what}")
        return e

    # -- token delivery + retirement ------------------------------------
    def _emit(self, s: int, req: GenerationRequest, tok: int) -> None:
        """Deliver one decoded token to its request's stream at the
        step boundary it resolved, then retire the slot if this token
        finished the generation (EOS / budget / capacity / deadline /
        cancel) — a freed slot is admissible on the very next step."""
        now = time.monotonic()
        # deadline re-checked at DELIVERY time: a generation that
        # outlived its deadline mid-decode surfaces as a timeout
        if req.expired(now):
            err = ServingTimeoutError(
                f"generation {req.id} missed its deadline after "
                f"{len(req.generated)} tokens")
            err.tokens = list(req.generated)
            self.metrics.record_timeout("deadline")
            self._retire(s, error=err, timed_out=True)
            return
        if req.cancelled:
            self._retire(s, cancelled=True)
            return
        with _tracer.span("serving.reply", cat="serving", id=req.id):
            req.emit(tok)
        self.metrics.inc("tokens_generated")
        if req.first_token_t is None:
            req.first_token_t = now
            self.metrics.observe_ttft((now - req.enqueue_t) * 1000.0)
        else:
            self.metrics.observe_intertoken(
                (now - req.last_token_t) * 1000.0)
        req.last_token_t = now
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception as e:      # noqa: BLE001 — user callback
                self._retire(s, error=e)
                return
        done = (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
                or int(self._positions[s]) + 1 >= self.max_seq_len)
        if done:
            self._retire(s)

    def _retire(self, s: int, error: Optional[BaseException] = None,
                timed_out: bool = False, cancelled: bool = False) -> None:
        """Free slot ``s`` exactly once and resolve its request."""
        req = self._slot_reqs[s]
        self._slot_reqs[s] = None
        self._active[s] = False
        self._slots.free(s)
        if req is not None:
            now = time.monotonic()
            if error is not None:
                req.fail(error)
                if not timed_out:
                    self.metrics.record_failure(error)
            elif cancelled:
                # resolve the future BEFORE closing the stream: a
                # consumer that sees the stream end must find the
                # result already set
                if not req.future.done():
                    req.future.set_result(list(req.generated))
                req.close_stream(GenerationCancelled(
                    f"generation {req.id} cancelled",
                    tokens=req.generated))
                self.metrics.inc("requests_cancelled")
            else:
                req.succeed()
                self.metrics.observe_request(
                    queue_wait_ms=((req.first_token_t or now)
                                   - req.enqueue_t) * 1000.0,
                    e2e_ms=(now - req.enqueue_t) * 1000.0)
        # keep the supervisor's crash-requeue window exact
        if self._cur_slot is not None:
            self._sync_inflight(self._cur_slot)

    # -- lifecycle ------------------------------------------------------
    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop intake; with ``drain`` (default) finish queued and
        in-flight generations, otherwise fail queued futures
        immediately (in-flight slots still finish their current
        generation). Idempotent."""
        if self._closed:
            return
        self._closed = True
        # a server that was never start()ed has no worker to drain —
        # queued futures fail typed instead of hanging their clients
        self._queue.close(drain=drain and self._started)
        if self._supervisor is not None:
            self._supervisor.stop(timeout=timeout)
        for t in self._workers:
            t.join(timeout=timeout)
        AllocationsTracker.get_instance().release("kv_slab",
                                                  self.kv_slab_bytes)
        if self.draft_slab_bytes:
            AllocationsTracker.get_instance().release(
                "kv_slab", self.draft_slab_bytes)

    def __enter__(self) -> "GenerativeServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)


def greedy_decode(spec: GenerativeSpec, prompt, max_new_tokens: int = 16,
                  eos_id: Optional[int] = None,
                  max_seq_len: Optional[int] = None,
                  device: DeviceLike = None) -> List[int]:
    """Unbatched single-request greedy decode — the REFERENCE the
    server is held to: fresh one-slot slabs, the same pow2 prefill
    bucketing, then one decode step per token. Greedy tokens from the
    server match this for every request in a mixed run."""
    dev = default_device(device)
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    msl = int(max_seq_len or spec.max_seq_len)
    bspec = _prefill_buckets(msl)
    kc = _slab(spec.kv_shape(1, msl), spec.kv_dtype, dev)
    vc = _slab(spec.kv_shape(1, msl), spec.kv_dtype, dev)
    params = {n: t.to(dev) for n, t in spec.params().items()}
    L = int(prompt.size)
    if not 1 <= L <= msl - 1:
        raise ValueError(f"prompt length {L} not in [1, {msl - 1}]")
    bucket = bspec.bucket_for(L)
    padded = np.zeros(bucket, np.int32)
    padded[:L] = prompt
    with torch.inference_mode():
        kc, vc, nxt, _ = spec.prefill(params, kc, vc,
                                      {"tokens": padded,
                                       "length": np.int32(L),
                                       "slot": np.int32(0)})
        out = [int(nxt)]
        pos = L
        while (len(out) < int(max_new_tokens)
               and not (eos_id is not None and out[-1] == eos_id)
               and pos + 1 < msl):
            io = {"tokens": np.asarray([out[-1]], np.int32),
                  "positions": np.asarray([pos], np.int32),
                  "active": np.asarray([True])}
            kc, vc, nxt, _ = spec.decode(params, kc, vc, io)
            pos += 1
            out.append(int(_host(nxt)[0]))
    return out


__all__ = ["GenerativeSpec", "GenerativeServer", "GenerativeMetrics",
           "GenerationHandle", "GenerationRequest", "GenerationCancelled",
           "SlotAllocator", "greedy_decode"]
