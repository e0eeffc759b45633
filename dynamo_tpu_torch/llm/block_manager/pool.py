"""Block pool: slot allocation, sequence-hash registry and LRU reuse (copy
of `dynamo_tpu/llm/block_manager/pool.py`), with JAX's QoS primitives:
`discard`, `demote_hash` (the QoS preemption demotion) and the SLO-aware
eviction bias (`set_eviction_bias`, `slo_eviction_bias`).

A pool owns `capacity` slots of one tier.  Slot states:

- free     — on the free list, contents meaningless;
- active   — pinned by one or more sequences (refcounted), maybe
             registered;
- inactive — refcount 0 but registered under its hash: reusable as a
             prefix-cache hit until evicted (LRU).

Registration keys are chained block hashes (dynamo_tpu_torch.tokens), so
a hash match means the whole token prefix matches.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from itertools import islice
from typing import Callable, Dict, List, Optional, Sequence

from dynamo_tpu_torch.runtime.contracts import engine_thread_only, hot_path


@dataclass
class Slot:
    index: int
    block_hash: Optional[int] = None
    ref_count: int = 0
    # Prefix-cache matches served by this slot since allocation: the
    # hotness signal the SLO-aware eviction bias reads.
    hits: int = 0


class BlockRegistry:
    """hash -> slot mapping with active refcounts and an inactive LRU."""

    def __init__(self) -> None:
        self.by_hash: Dict[int, Slot] = {}
        self.inactive: "OrderedDict[int, Slot]" = OrderedDict()  # LRU order

    def lookup(self, block_hash: int) -> Optional[Slot]:
        return self.by_hash.get(block_hash)


class BlockPool:
    """One tier's slots."""

    def __init__(self, capacity: int, name: str = "pool",
                 reserve_null: bool = False,
                 on_evict: Optional[Callable[[int, int], None]] = None
                 ) -> None:
        """With `reserve_null`, slot 0 is never allocated (the engine's
        null block).  `on_evict(block_hash, slot)` fires when a registered
        block is evicted under allocation pressure."""
        self.name = name
        self.capacity = capacity
        start = 1 if reserve_null else 0
        self._free: List[int] = list(range(capacity - 1, start - 1, -1))
        self._slots: Dict[int, Slot] = {}
        self.registry = BlockRegistry()
        self.hits = 0
        self.misses = 0
        self.evictions = 0     # LRU evictions under allocation pressure
        self.on_evict = on_evict
        # Eviction-bias hook (SLO-aware demotion): `bias(slot) -> float`
        # protection score, 0.0 = evict freely; the lowest score in a
        # bounded LRU window is evicted.  None = pure LRU.
        self.eviction_bias: Optional[Callable[[Slot], float]] = None
        self.bias_scan = 8
        # Evictions where the bias skipped over >= 1 protected block.
        self.bias_protected = 0

    # -- views ------------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def reusable_slots(self) -> int:
        return len(self._free) + len(self.registry.inactive)

    @property
    def active_slots(self) -> int:
        return len(self._slots) - len(self.registry.inactive)

    @property
    def usage(self) -> float:
        return self.active_slots / max(1, self.capacity)

    # -- matching ---------------------------------------------------------

    @engine_thread_only
    def match_sequence_hashes(self, hashes: Sequence[int]) -> List[Slot]:
        """Longest registered prefix; the slots are not pinned yet (see
        acquire_matched)."""
        out = []
        for h in hashes:
            slot = self.registry.lookup(h)
            if slot is None:
                break
            out.append(slot)
        return out

    @engine_thread_only
    def acquire_matched(self, slots: Sequence[Slot]) -> List[int]:
        """Pin matched slots (reviving inactive ones); returns slot ids."""
        ids = []
        for slot in slots:
            if slot.ref_count == 0:
                self.registry.inactive.pop(slot.block_hash, None)
            slot.ref_count += 1
            slot.hits += 1
            ids.append(slot.index)
            self.hits += 1
        return ids

    # -- allocation -------------------------------------------------------

    def can_allocate(self, n: int) -> bool:
        return n <= self.reusable_slots

    @engine_thread_only
    @hot_path
    def allocate(self, n: int) -> List[int]:
        """Take n fresh slots, evicting LRU inactive blocks as needed."""
        if not self.can_allocate(n):
            raise RuntimeError(
                f"{self.name}: out of blocks (want {n}, reusable "
                f"{self.reusable_slots})")
        out = []
        for _ in range(n):
            if not self._free:
                self._evict_one()
            idx = self._free.pop()
            self._slots[idx] = Slot(index=idx, ref_count=1)
            out.append(idx)
            self.misses += 1
        return out

    def set_eviction_bias(self, fn: Optional[Callable[[Slot], float]],
                          scan: int = 8) -> None:
        """Install (or clear, fn=None) the eviction-bias hook.  `scan`
        bounds how far past the LRU head `_evict_one` searches for an
        unprotected victim."""
        self.eviction_bias = fn
        self.bias_scan = max(1, scan)

    def _evict_one(self) -> None:
        h, slot = next(iter(self.registry.inactive.items()))  # LRU head
        if self.eviction_bias is not None:
            # SLO-aware demotion: the least-protected block of a bounded
            # LRU window.  With every score 0 (budget healthy) the LRU
            # head wins outright.
            best_score = self.eviction_bias(slot)
            if best_score > 0.0:
                for h2, s2 in list(islice(
                        self.registry.inactive.items(), 1, self.bias_scan)):
                    score = self.eviction_bias(s2)
                    if score < best_score:
                        h, slot, best_score = h2, s2, score
                    if best_score <= 0.0:
                        break
                if h != next(iter(self.registry.inactive)):
                    self.bias_protected += 1
        del self.registry.inactive[h]
        del self.registry.by_hash[h]
        del self._slots[slot.index]
        self._free.append(slot.index)
        self.evictions += 1
        if self.on_evict:
            self.on_evict(h, slot.index)

    # -- registration -----------------------------------------------------

    @engine_thread_only
    def register(self, slot_index: int, block_hash: int) -> bool:
        """Publish a completed block under its hash.  A hash already
        registered (to any slot) keeps its registration and this returns
        False: the caller's slot stays unregistered."""
        if block_hash in self.registry.by_hash:
            return False
        slot = self._slots.get(slot_index)
        if slot is None:
            raise KeyError(f"{self.name}: slot {slot_index} not allocated")
        slot.block_hash = block_hash
        self.registry.by_hash[block_hash] = slot
        return True

    def discard(self, block_hash: int) -> bool:
        """Drop a registered block entirely (failed fill, bad bytes): the
        registration disappears and an unpinned slot returns to the free
        list.  Pinned slots just lose their registration."""
        slot = self.registry.by_hash.pop(block_hash, None)
        if slot is None:
            return False
        self.registry.inactive.pop(block_hash, None)
        slot.block_hash = None
        if slot.ref_count == 0:
            self._slots.pop(slot.index, None)
            self._free.append(slot.index)
        return True

    # -- release ----------------------------------------------------------

    @engine_thread_only
    def release(self, slot_indices: Sequence[int]) -> None:
        """Unpin; refcount-0 slots go inactive if registered (a future
        prefix hit), else straight back to the free list.  The last page
        of a sequence is released first, so its prefix outlives it in
        the LRU order."""
        for idx in reversed(list(slot_indices)):
            slot = self._slots.get(idx)
            if slot is None:
                continue
            slot.ref_count -= 1
            if slot.ref_count > 0:
                continue
            if slot.block_hash is not None:
                self.registry.inactive[slot.block_hash] = slot
                self.registry.inactive.move_to_end(slot.block_hash)
            else:
                del self._slots[idx]
                self._free.append(idx)

    def demote_hash(self, block_hash: int) -> bool:
        """Evict a specific INACTIVE registered block now, firing the
        on_evict chain: the QoS preemption demotion primitive.  Pinned or
        unknown hashes are refused.  Not counted in `evictions`:
        demotion is policy, not pressure."""
        slot = self.registry.inactive.get(block_hash)
        if slot is None:
            return False
        del self.registry.inactive[block_hash]
        del self.registry.by_hash[block_hash]
        del self._slots[slot.index]
        self._free.append(slot.index)
        if self.on_evict:
            self.on_evict(block_hash, slot.index)
        return True

    def clear_inactive(self) -> List[int]:
        """Drop every inactive registered block (an admin cache flush);
        returns the dropped hashes.  Pinned blocks stay; no eviction hook
        fires."""
        dropped = []
        while self.registry.inactive:
            h, slot = self.registry.inactive.popitem(last=False)
            del self.registry.by_hash[h]
            del self._slots[slot.index]
            self._free.append(slot.index)
            dropped.append(h)
        return dropped


def slo_eviction_bias(burn_fn: Callable[[], float], *,
                      hot_hits: int = 1,
                      burn_threshold: float = 1.0,
                      ) -> Callable[[Slot], float]:
    """SLO-aware eviction bias: while the error budget burns (`burn_fn()`,
    the SLO monitor's worst fast-window burn rate, at or above
    `burn_threshold`), protect hot prefix blocks (>= `hot_hits` cache
    hits) from eviction.  Below the threshold every block scores 0 and
    the pool is pure LRU.  Install with `set_eviction_bias`."""

    def bias(slot: Slot) -> float:
        try:
            burn = burn_fn()
        except Exception:
            return 0.0  # a broken signal must not wedge eviction
        if burn is None or burn < burn_threshold:
            return 0.0
        return float(slot.hits) if slot.hits >= hot_hits else 0.0

    return bias
