"""Block-level KV manager with prefix caching + LRU eviction (mock engine).

Role of the reference's `mocker/kv_manager.rs` (519 LoC) + `evictor.rs`:
tracks which token blocks (chained hashes) are resident, refcounts active
use, keeps freed blocks in an LRU "inactive" pool for prefix reuse, evicts
when capacity is needed, and reports every mutation as KV events — the
exact stream the router's indexer consumes.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, KvCacheEventData


@dataclass
class _Block:
    block_hash: int
    parent_hash: Optional[int]
    ref_count: int = 0


class MockKvManager:
    """Capacity-bounded prefix cache keyed by chained block hashes."""

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        event_sink: Optional[Callable[[KvCacheEvent], None]] = None,
    ) -> None:
        self.capacity = num_blocks
        self.block_size = block_size
        self._active: Dict[int, _Block] = {}
        self._inactive: "OrderedDict[int, _Block]" = OrderedDict()  # LRU
        self._event_sink = event_sink
        self._event_id = 0
        # Stats for metrics/tests.
        self.hit_blocks = 0
        self.miss_blocks = 0
        self.evicted_blocks = 0

    # -- capacity views ---------------------------------------------------

    @property
    def used_blocks(self) -> int:
        return len(self._active) + len(self._inactive)

    @property
    def active_blocks(self) -> int:
        return len(self._active)

    @property
    def usage(self) -> float:
        return self.active_blocks / self.capacity if self.capacity else 1.0

    def free_capacity(self) -> int:
        """Blocks allocatable right now (free + evictable inactive)."""
        return self.capacity - len(self._active)

    # -- matching ---------------------------------------------------------

    def match_prefix(self, block_hashes: Sequence[int]) -> int:
        """Longest resident prefix (active or inactive), in blocks."""
        n = 0
        for h in block_hashes:
            if h in self._active or h in self._inactive:
                n += 1
            else:
                break
        return n

    # -- allocation -------------------------------------------------------

    def can_allocate(self, block_hashes: Sequence[int],
                     extra_new: int = 0) -> bool:
        cached = self.match_prefix(block_hashes)
        need_new = len(block_hashes) - cached + extra_new
        return need_new <= self.free_capacity() - self._inactive_pinned(
            block_hashes[:cached])

    def _inactive_pinned(self, hashes: Sequence[int]) -> int:
        """Inactive blocks a reuse would revive (they stop being evictable
        but don't consume new capacity) — always 0 toward free capacity."""
        return 0

    def acquire(self, block_hashes: Sequence[int],
                parents: Sequence[Optional[int]]) -> int:
        """Pin `block_hashes` (full prefix of a sequence), reusing resident
        blocks and registering the rest.  Returns #blocks reused.

        Atomic: either the whole sequence is pinned or nothing is — a
        partial pin on capacity failure would leak refcounts and wedge
        admission forever.  Eviction of LRU inactive blocks makes room as
        needed; raises RuntimeError when even eviction can't free enough."""
        reused = 0
        pinned: List[int] = []
        try:
            for h, parent in zip(block_hashes, parents):
                blk = self._active.get(h)
                if blk is not None:
                    blk.ref_count += 1
                    pinned.append(h)
                    reused += 1
                    self.hit_blocks += 1
                    continue
                blk = self._inactive.pop(h, None)
                if blk is not None:
                    blk.ref_count = 1
                    self._active[h] = blk
                    pinned.append(h)
                    reused += 1
                    self.hit_blocks += 1
                    continue
                # New block: make room, then register.
                self._ensure_room(1)
                self._active[h] = _Block(h, parent, ref_count=1)
                pinned.append(h)
                self.miss_blocks += 1
                self._emit(KvCacheEventData.stored([h], parent_hash=parent))
        except RuntimeError:
            self.release(pinned)
            raise
        return reused

    def extend(self, block_hash: int, parent: Optional[int]) -> None:
        """Register one decode-grown block for an already-active sequence."""
        blk = self._active.get(block_hash)
        if blk is not None:
            blk.ref_count += 1
            return
        blk = self._inactive.pop(block_hash, None)
        if blk is not None:
            blk.ref_count = 1
            self._active[block_hash] = blk
            return
        self._ensure_room(1)
        self._active[block_hash] = _Block(block_hash, parent, ref_count=1)
        self._emit(KvCacheEventData.stored([block_hash], parent_hash=parent))

    def release(self, block_hashes: Sequence[int]) -> None:
        """Unpin a sequence's blocks; refcount-0 blocks go to the LRU pool
        (still resident → still a prefix-cache hit until evicted)."""
        for h in reversed(list(block_hashes)):
            blk = self._active.get(h)
            if blk is None:
                continue
            blk.ref_count -= 1
            if blk.ref_count <= 0:
                del self._active[h]
                self._inactive[h] = blk
                self._inactive.move_to_end(h)

    # -- eviction ---------------------------------------------------------

    def _ensure_room(self, n: int) -> None:
        while self.used_blocks + n > self.capacity:
            if not self._inactive:
                raise RuntimeError(
                    f"KV capacity exhausted: {self.active_blocks} active / "
                    f"{self.capacity} total")
            h, _ = self._inactive.popitem(last=False)  # LRU
            self.evicted_blocks += 1
            self._emit(KvCacheEventData.removed([h]))

    # -- events -----------------------------------------------------------

    def _emit(self, data: KvCacheEventData) -> None:
        if self._event_sink is None:
            return
        self._event_id += 1
        self._event_sink(KvCacheEvent(event_id=self._event_id, data=data))
