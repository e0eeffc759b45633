"""Radix index of KV-block residency: sequence-hash → which workers hold it
(port of `dynamo_tpu/llm/kv_router/indexer.py`; the worker-sharded
indexer is not ported).

Role of the reference's `lib/llm/src/kv_router/indexer.rs` (RadixTree :222,
KvIndexer :641, find_matches :274, OverlapScores :520).

Because block hashes are *chained* (a hash commits to its whole prefix —
see dynamo_tpu_torch.tokens), the prefix tree can be stored flat: a map
block_hash → {workers}.  Matching a request is walking its sequence hashes
in order and intersecting with the shrinking set of workers that still
match; no trie traversal needed.  Parent links are kept only for eviction
bookkeeping and diagnostics.

Event ordering: events are applied per-worker in `event_id` order; stale or
duplicate events (e.g. re-delivered after worker restart) are dropped with a
counter rather than corrupting the index.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from dynamo_tpu_torch.llm.kv_router.protocols import (
    KvEventKind,
    RouterEvent,
    WorkerId,
)

logger = logging.getLogger(__name__)


@dataclass
class OverlapScores:
    """Per-worker count of matched prefix blocks for one request
    (reference OverlapScores, `indexer.rs:520`).

    `scores[w] = n` means worker `w` holds the first `n` blocks of the
    request's block sequence (prefix overlap, not total overlap — only a
    cached *prefix* saves prefill work).
    """

    scores: Dict[WorkerId, int] = field(default_factory=dict)
    # Tokens known resident but on no worker queried (frequency data etc.)
    # reserved for future use.

    def best(self) -> int:
        return max(self.scores.values(), default=0)


class RadixTree:
    """Flat chained-hash index with per-worker reverse maps.

    Thread-compatible but not thread-safe; KvIndexer serializes access.
    """

    def __init__(self) -> None:
        # block_hash -> set of workers with the block resident
        self._residency: Dict[int, Set[WorkerId]] = defaultdict(set)
        # worker -> set of resident block hashes (for clear/remove-worker)
        self._worker_blocks: Dict[WorkerId, Set[int]] = defaultdict(set)

    # -- mutation ---------------------------------------------------------
    def store(self, worker: WorkerId, block_hashes: Sequence[int]) -> None:
        wb = self._worker_blocks[worker]
        for h in block_hashes:
            self._residency[h].add(worker)
            wb.add(h)

    def remove(self, worker: WorkerId, block_hashes: Sequence[int]) -> None:
        wb = self._worker_blocks.get(worker)
        if wb is None:
            return
        for h in block_hashes:
            wb.discard(h)
            ws = self._residency.get(h)
            if ws is not None:
                ws.discard(worker)
                if not ws:
                    del self._residency[h]

    def clear_worker(self, worker: WorkerId) -> None:
        """Remove every block attributed to `worker` (cache cleared, or the
        worker left the cluster)."""
        wb = self._worker_blocks.pop(worker, None)
        if not wb:
            return
        for h in wb:
            ws = self._residency.get(h)
            if ws is not None:
                ws.discard(worker)
                if not ws:
                    del self._residency[h]

    # -- queries ----------------------------------------------------------
    def find_matches(
        self, sequence_hashes: Sequence[int], early_exit: bool = False
    ) -> OverlapScores:
        """Prefix-overlap scores for a request's chained block hashes.

        Walks hashes in sequence order; a worker's score is the length of
        its *contiguous* matched prefix.  `early_exit` stops at the first
        depth where a single worker holds the full prefix so far and no
        other worker can catch up (used for latency-sensitive lookups).
        """
        scores: Dict[WorkerId, int] = {}
        active: Optional[Set[WorkerId]] = None  # None = all workers still eligible
        for depth, h in enumerate(sequence_hashes, start=1):
            holders = self._residency.get(h)
            if not holders:
                break
            matched = holders if active is None else (holders & active)
            if not matched:
                break
            for w in matched:
                scores[w] = depth
            active = set(matched)
            if early_exit and len(active) == 1:
                # The single remaining worker's score keeps growing only for
                # itself; deeper walk cannot change the *relative* ranking.
                remaining = sequence_hashes[depth:]
                w = next(iter(active))
                for h2 in remaining:
                    ws = self._residency.get(h2)
                    if not ws or w not in ws:
                        break
                    scores[w] += 1
                break
        return OverlapScores(scores=scores)

    def num_blocks(self) -> int:
        return len(self._residency)

    def workers(self) -> List[WorkerId]:
        return [w for w, b in self._worker_blocks.items() if b]

    def blocks_for_worker(self, worker: WorkerId) -> Set[int]:
        return set(self._worker_blocks.get(worker, ()))


class KvIndexer:
    """Serialized event-application front of the RadixTree
    (reference KvIndexer, `indexer.rs:641`: a single-threaded event loop).

    Synchronous core guarded by a lock — Python event volumes make a
    dedicated thread unnecessary.
    """

    def __init__(self, block_size: int = 64) -> None:
        self.block_size = block_size
        self.tree = RadixTree()
        self._lock = threading.Lock()
        self._last_event_id: Dict[WorkerId, int] = {}
        self.stale_events_dropped = 0
        self.malformed_events = 0

    def apply_event(self, ev: RouterEvent) -> None:
        with self._lock:
            last = self._last_event_id.get(ev.worker_id)
            if last is not None and ev.event.event_id <= last:
                self.stale_events_dropped += 1
                logger.debug(
                    "dropping stale kv event %s from %s (last=%s)",
                    ev.event.event_id,
                    ev.worker_id,
                    last,
                )
                return
            # Validate *before* advancing the cursor so a malformed event can
            # be corrected and redelivered under the same event_id.
            data = ev.event.data
            if data.kind == KvEventKind.STORED and data.store is None:
                raise ValueError(f"stored event without store data: {ev}")
            if data.kind == KvEventKind.REMOVED and data.remove is None:
                raise ValueError(f"removed event without remove data: {ev}")
            self._last_event_id[ev.worker_id] = ev.event.event_id
            if data.kind == KvEventKind.STORED:
                self.tree.store(ev.worker_id, data.store.block_hashes)
            elif data.kind == KvEventKind.REMOVED:
                self.tree.remove(ev.worker_id, data.remove.block_hashes)
            elif data.kind == KvEventKind.CLEARED:
                self.tree.clear_worker(ev.worker_id)

    def remove_worker(self, worker: WorkerId) -> None:
        """Worker left (lease expired): forget its residency and event cursor."""
        with self._lock:
            self.tree.clear_worker(worker)
            self._last_event_id.pop(worker, None)

    def find_matches(self, sequence_hashes: Sequence[int]) -> OverlapScores:
        with self._lock:
            return self.tree.find_matches(sequence_hashes)
