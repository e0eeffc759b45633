"""KV-cache-aware routing (port of `dynamo_tpu/llm/kv_router/`).

Mirrors the reference's `lib/llm/src/kv_router/` capability set: a radix
index of block sequence-hashes → per-worker residency fed by KV events,
an overlap-scoring worker selector with softmax sampling, router-local
active-sequence load tracking, and a TTL-based approximate indexer for
engines that do not emit KV events.
"""

from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, OverlapScores, RadixTree
from dynamo_tpu_torch.llm.kv_router.protocols import (
    KvCacheEvent,
    KvCacheEventData,
    RouterEvent,
    WorkerId,
)
from dynamo_tpu_torch.llm.kv_router.router import KvRouter, KvRouterConfig
from dynamo_tpu_torch.llm.kv_router.scheduler import DefaultWorkerSelector, KVHitRateEvent
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequences, ActiveSequencesMultiWorker

__all__ = [
    "ActiveSequences",
    "ActiveSequencesMultiWorker",
    "DefaultWorkerSelector",
    "KVHitRateEvent",
    "KvCacheEvent",
    "KvCacheEventData",
    "KvIndexer",
    "KvRouter",
    "KvRouterConfig",
    "OverlapScores",
    "RadixTree",
    "RouterEvent",
    "WorkerId",
]
