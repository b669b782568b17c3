"""Paged KV serving: block-pooled KV caches and prefix caching over the
continuous-batching scheduler (counterpart of
``deeplearning4j_tpu/serving/paged/``). See :mod:`.pool` (the allocator
and prefix-cache bookkeeping) and :mod:`.server` (the server itself).
"""
from deeplearning4j_tpu_torch.serving.paged.pool import (NULL_BLOCK,
                                                         BlockPool,
                                                         PoolExhaustedError,
                                                         blocks_for_tokens,
                                                         prefix_block_hashes)
from deeplearning4j_tpu_torch.serving.paged.server import (
    PagedGenerativeServer, PagedGenerativeSpec, PagedMetrics)

__all__ = ["BlockPool", "PoolExhaustedError", "NULL_BLOCK",
           "prefix_block_hashes", "blocks_for_tokens",
           "PagedGenerativeSpec", "PagedGenerativeServer", "PagedMetrics"]
