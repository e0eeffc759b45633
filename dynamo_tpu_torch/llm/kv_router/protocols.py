"""KV event and metric wire types (port of
`dynamo_tpu/llm/kv_router/protocols.py`).

Role of the reference's `lib/llm/src/kv_router/protocols.rs` (KvCacheEvent
stored/removed/cleared) and the `ForwardPassMetrics{WorkerStats, KvStats}`
surface of `publisher.rs:482` — the two feedback channels the router consumes:
*which blocks live where* (events) and *how loaded each worker is* (metrics).

Plain dataclasses with dict (msgpack/json-ready) codecs; no pydantic on this
hot path.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import List, Optional, Sequence

WorkerId = str


class KvEventKind(str, Enum):
    STORED = "stored"
    REMOVED = "removed"
    CLEARED = "cleared"


@dataclass(frozen=True)
class KvCacheStoreData:
    """Blocks became resident on a worker.

    `block_hashes` are chained sequence hashes (see dynamo_tpu.tokens), in
    sequence order; `parent_hash` is the sequence hash of the block preceding
    block_hashes[0] (None = sequence start).
    """

    block_hashes: Sequence[int]
    parent_hash: Optional[int] = None
    token_counts: Optional[Sequence[int]] = None  # tokens per block, if partial tails matter


@dataclass(frozen=True)
class KvCacheRemoveData:
    block_hashes: Sequence[int]


@dataclass(frozen=True)
class KvCacheEventData:
    kind: KvEventKind
    store: Optional[KvCacheStoreData] = None
    remove: Optional[KvCacheRemoveData] = None

    @staticmethod
    def stored(block_hashes: Sequence[int], parent_hash: Optional[int] = None) -> "KvCacheEventData":
        return KvCacheEventData(KvEventKind.STORED, store=KvCacheStoreData(tuple(block_hashes), parent_hash))

    @staticmethod
    def removed(block_hashes: Sequence[int]) -> "KvCacheEventData":
        return KvCacheEventData(KvEventKind.REMOVED, remove=KvCacheRemoveData(tuple(block_hashes)))

    @staticmethod
    def cleared() -> "KvCacheEventData":
        return KvCacheEventData(KvEventKind.CLEARED)


@dataclass(frozen=True)
class KvCacheEvent:
    """One engine-side cache mutation, ordered per worker by `event_id`."""

    event_id: int
    data: KvCacheEventData


@dataclass(frozen=True)
class RouterEvent:
    """A KvCacheEvent attributed to its emitting worker (what the indexer consumes)."""

    worker_id: WorkerId
    event: KvCacheEvent

    def to_dict(self) -> dict:
        d = asdict(self)
        d["event"]["data"]["kind"] = self.event.data.kind.value
        return d

    @staticmethod
    def from_dict(d: dict) -> "RouterEvent":
        data = d["event"]["data"]
        kind = KvEventKind(data["kind"])
        store = KvCacheStoreData(**data["store"]) if data.get("store") else None
        remove = KvCacheRemoveData(**data["remove"]) if data.get("remove") else None
        return RouterEvent(
            worker_id=d["worker_id"],
            event=KvCacheEvent(
                event_id=d["event"]["event_id"],
                data=KvCacheEventData(kind, store=store, remove=remove),
            ),
        )


# ---------------------------------------------------------------------------
# Worker load metrics (the `load_metrics` stats surface)
# ---------------------------------------------------------------------------


@dataclass
class WorkerStats:
    request_active_slots: int = 0
    request_total_slots: int = 0
    num_requests_waiting: int = 0


@dataclass
class KvStats:
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    gpu_cache_usage_perc: float = 0.0  # name kept engine-agnostic: device cache usage
    gpu_prefix_cache_hit_rate: float = 0.0


@dataclass
class SpecDecodeStats:
    num_spec_tokens: int = 0
    num_drafts: int = 0
    num_accepted_tokens: int = 0
    num_accepted_tokens_per_pos: List[int] = field(default_factory=list)


@dataclass
class ForwardPassMetrics:
    """Per-forward-pass load snapshot published by every worker
    (reference `publisher.rs` ForwardPassMetrics).  `expert_load` carries
    the cumulative per-expert token-assignment counts for MoE engines
    (the expert-distribution surface of reference
    `sglang/common/base_handlers.py:40-62`); None for dense models.
    `moe_dropped_tokens` is the capacity-honesty counter: assignments a
    bounded `ModelConfig.moe_capacity` dropped (0 forever at the exact
    serving default — a nonzero value means the deployment explicitly
    traded exactness for dispatch-buffer size)."""

    worker_stats: WorkerStats = field(default_factory=WorkerStats)
    kv_stats: KvStats = field(default_factory=KvStats)
    spec_decode_stats: Optional[SpecDecodeStats] = None
    expert_load: Optional[List[int]] = None
    moe_dropped_tokens: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ForwardPassMetrics":
        spec = d.get("spec_decode_stats")
        return ForwardPassMetrics(
            worker_stats=WorkerStats(**d.get("worker_stats", {})),
            kv_stats=KvStats(**d.get("kv_stats", {})),
            spec_decode_stats=SpecDecodeStats(**spec) if spec else None,
            expert_load=d.get("expert_load"),
            moe_dropped_tokens=d.get("moe_dropped_tokens", 0),
        )
