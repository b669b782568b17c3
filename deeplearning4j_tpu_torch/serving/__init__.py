"""serving: model serving on the card (counterpart of
``deeplearning4j_tpu/serving/``).

- ``inference``: :class:`ParallelInference`, the thread-safe submit /
  output front end with SEQUENTIAL / BATCHED / INPLACE modes over any
  MultiLayerNetwork or ComputationGraph (``serving_spec()``);
- ``batching``: the dynamic batcher coalescing requests up to
  ``max_batch_size`` rows or ``max_delay_ms``, padded to power-of-two
  shape buckets;
- ``queue``: the bounded request queue: admission backpressure
  (:class:`ServerOverloadedError`), per-request deadlines
  (:class:`RequestTimeoutError`), graceful drain on shutdown;
- ``metrics``: counters and latency histograms
  (``{"type": "serving", ...}`` records);
- ``resilience``: SLO admission control, the circuit breaker on
  consecutive exec failures, supervised workers with exactly-once crash
  requeue, bisecting poisoned-batch isolation
  (:class:`PoisonedRequestError`);
- ``generative``: continuous-batching autoregressive serving
  (:class:`GenerativeServer`): slotted KV slabs on the device updated in
  place, step-boundary admission into free slots, one decode step
  advancing every active slot, pow2 prefill buckets, streaming token
  delivery, SLO admission on p99 decode-step time, supervised crash
  recovery (requeue at prefill, exactly once), speculative decoding
  with a draft model (``draft_spec=``, ``speculate_k=``);
- ``paged``: the paged-KV tier (:class:`~.paged.PagedGenerativeServer`):
  a block pool, block tables and prefix caching;
- ``loadgen``: closed- and open-loop load generators over
  ``ParallelInference`` (:class:`~.loadgen.LoadGenerator`) and over
  either generative server (:class:`~.loadgen.GenerativeLoadGenerator`);
- ``sampling``: the host sampler.

The fleet with its ``FleetLoadGenerator`` is not ported yet (ROADMAP
queue 1 item 8).
"""
from deeplearning4j_tpu_torch.serving.batching import (
    Batch, BucketSpec, DynamicBatcher, pad_to_bucket, pow2_buckets)
from deeplearning4j_tpu_torch.serving.generative import (
    GenerationCancelled, GenerationHandle, GenerationRequest,
    GenerativeMetrics, GenerativeServer, GenerativeSpec, SlotAllocator,
    greedy_decode)
from deeplearning4j_tpu_torch.serving.inference import (
    InferenceMode, ParallelInference, ServingSpec)
from deeplearning4j_tpu_torch.serving.loadgen import (
    GenerativeLoadGenerator, LoadGenerator, LoadResult)
from deeplearning4j_tpu_torch.serving.metrics import (LatencyHistogram,
                                                      ServingMetrics,
                                                      safe_ratio)
from deeplearning4j_tpu_torch.serving.queue import (
    InferenceRequest, RequestQueue, RequestTimeoutError, ServerClosedError,
    ServerOverloadedError, ServingError, ServingTimeoutError)
from deeplearning4j_tpu_torch.serving.resilience import (
    AdmissionController, CircuitBreaker, InflightSlot, PoisonedRequestError,
    ReloadFailedError, ResilienceConfig, RetryableServingError,
    WorkerSupervisor)
from deeplearning4j_tpu_torch.serving.sampling import sample_token

__all__ = [
    "ParallelInference", "InferenceMode", "ServingSpec",
    "DynamicBatcher", "Batch", "BucketSpec", "pow2_buckets",
    "pad_to_bucket",
    "RequestQueue", "InferenceRequest",
    "ServingError", "RetryableServingError", "ServerOverloadedError",
    "RequestTimeoutError", "ServerClosedError", "ServingTimeoutError",
    "ServingMetrics", "LatencyHistogram", "safe_ratio",
    "ResilienceConfig", "AdmissionController", "CircuitBreaker",
    "InflightSlot", "WorkerSupervisor", "PoisonedRequestError",
    "ReloadFailedError",
    "LoadGenerator", "LoadResult", "GenerativeLoadGenerator",
    "GenerativeServer", "GenerativeSpec", "GenerativeMetrics",
    "GenerationHandle", "GenerationCancelled", "GenerationRequest",
    "SlotAllocator", "greedy_decode", "sample_token",
]
