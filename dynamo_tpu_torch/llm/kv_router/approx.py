"""Approximate KV residency for engines that do not emit KV events (port
of `dynamo_tpu/llm/kv_router/approx.py`).

Role of the reference's `lib/llm/src/kv_router/approx.rs` (ApproxKvIndexer
:166): when a request is routed to a worker, *assume* that worker will hold
the request's prefix blocks for a TTL (default 120 s, refreshed on re-use),
and score future requests against those assumptions.  Strictly optimistic —
it never learns about evictions — which is why it is a fallback, not the
default.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dynamo_tpu_torch.llm.kv_router.indexer import OverlapScores
from dynamo_tpu_torch.llm.kv_router.protocols import WorkerId

DEFAULT_TTL_SECS = 120.0


class ApproxKvIndexer:
    """TTL-decayed assumed residency, indexed hash-first for O(prefix)
    lookups: block_hash → {worker: expiry}."""

    def __init__(self, block_size: int = 64, ttl_secs: float = DEFAULT_TTL_SECS) -> None:
        self.block_size = block_size
        self.ttl_secs = ttl_secs
        self._lock = threading.Lock()
        self._by_hash: Dict[int, Dict[WorkerId, float]] = {}
        self._heap: List[Tuple[float, WorkerId, int]] = []  # lazy-deleted min-heap

    def _now(self) -> float:
        return time.monotonic()

    def process_routing_decision(
        self, worker: WorkerId, sequence_hashes: Sequence[int]
    ) -> None:
        """Record that `worker` will (presumably) cache these prefix blocks."""
        now = self._now()
        exp = now + self.ttl_secs
        with self._lock:
            self._expire(now)
            for h in sequence_hashes:
                self._by_hash.setdefault(h, {})[worker] = exp
                heapq.heappush(self._heap, (exp, worker, h))

    def find_matches(self, sequence_hashes: Sequence[int]) -> OverlapScores:
        now = self._now()
        scores: Dict[WorkerId, int] = {}
        with self._lock:
            self._expire(now)
            active: Optional[Set[WorkerId]] = None
            for depth, h in enumerate(sequence_hashes, start=1):
                entry = self._by_hash.get(h)
                if not entry:
                    break
                holders = {w for w, exp in entry.items() if exp > now}
                if active is not None:
                    holders &= active
                if not holders:
                    break
                for w in holders:
                    scores[w] = depth
                active = holders
        return OverlapScores(scores=scores)

    def remove_worker(self, worker: WorkerId) -> None:
        with self._lock:
            empty = []
            for h, entry in self._by_hash.items():
                entry.pop(worker, None)
                if not entry:
                    empty.append(h)
            for h in empty:
                del self._by_hash[h]

    def _expire(self, now: float) -> None:
        while self._heap and self._heap[0][0] <= now:
            _, w, h = heapq.heappop(self._heap)
            entry = self._by_hash.get(h)
            if entry is not None:
                exp = entry.get(w)
                if exp is not None and exp <= now:
                    del entry[w]
                    if not entry:
                        del self._by_hash[h]
