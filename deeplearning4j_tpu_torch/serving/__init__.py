"""serving: generative serving on the card (counterpart of
``deeplearning4j_tpu/serving/``).

- ``generative``: continuous-batching autoregressive serving
  (:class:`GenerativeServer`): slotted KV slabs on the device updated in
  place, step-boundary admission into free slots, one decode step
  advancing every active slot, pow2 prefill buckets, streaming token
  delivery, SLO admission on p99 decode-step time, supervised crash
  recovery (requeue at prefill, exactly once), speculative decoding
  with a draft model (``draft_spec=``, ``speculate_k=``);
- ``paged``: the paged-KV tier (:class:`~.paged.PagedGenerativeServer`):
  a block pool, block tables and prefix caching;
- ``loadgen``: the seeded closed- and open-loop load generator over
  either server (:class:`~.loadgen.GenerativeLoadGenerator`);
- ``queue``, ``metrics``, ``resilience``, ``batching``, ``sampling``:
  the host code they ride on.

``ParallelInference`` with its ``LoadGenerator``, and the fleet with its
``FleetLoadGenerator``, are not ported yet (ROADMAP queue 1 items 2.6 and
8).
"""
from deeplearning4j_tpu_torch.serving.batching import BucketSpec, pow2_buckets
from deeplearning4j_tpu_torch.serving.generative import (
    GenerationCancelled, GenerationHandle, GenerationRequest,
    GenerativeMetrics, GenerativeServer, GenerativeSpec, SlotAllocator,
    greedy_decode)
from deeplearning4j_tpu_torch.serving.loadgen import (GenerativeLoadGenerator,
                                                      LoadResult)
from deeplearning4j_tpu_torch.serving.metrics import (LatencyHistogram,
                                                      ServingMetrics,
                                                      safe_ratio)
from deeplearning4j_tpu_torch.serving.queue import (
    InferenceRequest, RequestQueue, RequestTimeoutError, ServerClosedError,
    ServerOverloadedError, ServingError, ServingTimeoutError)
from deeplearning4j_tpu_torch.serving.resilience import (
    AdmissionController, InflightSlot, ResilienceConfig,
    RetryableServingError, WorkerSupervisor)
from deeplearning4j_tpu_torch.serving.sampling import sample_token

__all__ = [
    "BucketSpec", "pow2_buckets",
    "GenerationCancelled", "GenerationHandle", "GenerationRequest",
    "GenerativeMetrics", "GenerativeServer", "GenerativeSpec",
    "SlotAllocator", "greedy_decode",
    "GenerativeLoadGenerator", "LoadResult",
    "LatencyHistogram", "ServingMetrics", "safe_ratio",
    "InferenceRequest", "RequestQueue", "RequestTimeoutError",
    "ServerClosedError", "ServerOverloadedError", "ServingError",
    "ServingTimeoutError",
    "AdmissionController", "InflightSlot", "ResilienceConfig",
    "RetryableServingError", "WorkerSupervisor",
    "sample_token",
]
