"""Tiered KV block manager, G1 (device) tier (port of
`dynamo_tpu/llm/block_manager/manager.py`).

The device tier's KV bytes live in the engine's paged cache; the manager
keeps the pool of its pages: prefix matching, pinning, allocation,
registration of sealed blocks and release, and the G1 end of the
worker-to-worker data plane: `export_block` / `export_block_device` hand
out a resident block's wire bytes and `import_block` / `import_blocks`
inject a peer's blocks as registered, matchable prefix-cache entries
(`onboarded_blocks` counts them).  The engine hands the manager its
batched `extract_fn(pages) -> [n, *wire]` and `inject_fn(pages, data)`
so the manager stays agnostic of the cache layout.  `demote_blocks`
(QoS preemption) and `set_eviction_bias` (the SLO-aware eviction hook)
are JAX's; without a host tier a demotion is a no-op, as on every JAX
worker.  The host (G2) and disk (G3) tiers with their offload and
onboard copies are not ported yet (ROADMAP queue A, item 6): a config
that sizes them raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dynamo_tpu_torch.llm.block_manager.pool import BlockPool
from dynamo_tpu_torch.runtime.contracts import engine_thread_only

ExtractFn = Callable[[List[int]], torch.Tensor]
InjectFn = Callable[[List[int], torch.Tensor], None]


@dataclass(frozen=True)
class TieredConfig:
    """Capacities per tier, in blocks."""

    device_blocks: int           # G1, includes the reserved null block 0
    host_blocks: int = 0         # G2: not ported yet, must be 0
    disk_blocks: int = 0         # G3: not ported yet, must be 0
    block_size: int = 64

    def __post_init__(self):
        if self.host_blocks or self.disk_blocks:
            raise ValueError(
                "the host and disk KV tiers are not ported yet (ROADMAP "
                "queue A item 6); host_blocks and disk_blocks must be 0")


class KvBlockManager:
    """Owns the device pool (page 0, the null block, is never handed
    out)."""

    def __init__(self, config: TieredConfig,
                 extract_fn: Optional[ExtractFn] = None,
                 inject_fn: Optional[InjectFn] = None) -> None:
        self.config = config
        self.extract_fn = extract_fn
        self.inject_fn = inject_fn
        self.device = BlockPool(config.device_blocks, name="G1-device",
                                reserve_null=True)
        self.host = None     # G2 pool: not ported yet (TieredConfig refuses)
        self.onboarded_blocks = 0

    @engine_thread_only
    def match_and_onboard(self, hashes: Sequence[int]) -> Tuple[int, List[int]]:
        """The longest prefix of `hashes` resident on the device, pinned
        for the caller (release with `release`): (blocks, page ids).  With
        only G1 there is nothing to onboard from a lower tier."""
        ids = self.device.acquire_matched(
            self.device.match_sequence_hashes(hashes))
        return len(ids), ids

    @engine_thread_only
    def demote_blocks(self, hashes: Sequence[int]) -> int:
        """QoS preemption demotion: push the given G1-resident inactive
        blocks down to the host tier now.  Without a host tier (always,
        until G2 is ported) this is a no-op: the blocks stay inactive in
        G1, resumable until LRU pressure reclaims them.  Returns how many
        blocks moved."""
        if self.host is None:
            return 0
        return sum(1 for h in hashes if self.device.demote_hash(h))

    def set_eviction_bias(self, fn, scan: int = 8) -> None:
        """Install the eviction-bias hook on every demoting tier (G1
        only, until G2 is ported)."""
        self.device.set_eviction_bias(fn, scan)

    # -- cross-worker transfer ---------------------------------------------

    def resident_pages(self, hashes: Sequence[int]) -> Dict[int, int]:
        """hash -> page of every requested block resident in G1, in
        request order."""
        out: Dict[int, int] = {}
        for h in hashes:
            slot = self.device.registry.lookup(h)
            if slot is not None:
                out[h] = slot.index
        return out

    def extract(self, hashes: Sequence[int]
                ) -> Tuple[List[int], Optional[torch.Tensor]]:
        """(the G1-resident requested hashes in request order, their wire
        blocks as one [n, ...] staging tensor on the device that shares no
        storage with the cache), or ([], None): one extract a batch."""
        pages = self.resident_pages(hashes)
        if not pages or self.extract_fn is None:
            return [], None
        return list(pages), self.extract_fn(list(pages.values()))

    def export_blocks_device(self, hashes: Sequence[int]
                             ) -> Dict[int, torch.Tensor]:
        """The G1-resident requested blocks as device tensors: views of
        one staging tensor the caller owns."""
        present, staged = self.extract(hashes)
        return dict(zip(present, staged.unbind(0))) if present else {}

    def export_block_device(self, block_hash: int) -> Optional[torch.Tensor]:
        """A G1-resident block as a device tensor, None if not resident."""
        return self.export_blocks_device([block_hash]).get(block_hash)

    def export_block(self, block_hash: int) -> Optional[torch.Tensor]:
        """A G1-resident block's wire bytes on the host (CPU tensor)."""
        data = self.export_block_device(block_hash)
        return None if data is None else data.cpu()

    def import_blocks(self, blocks: Dict[int, torch.Tensor]) -> int:
        """Inject peer blocks into fresh G1 pages and register them
        (inactive, matchable), in the dict's order: one inject for the
        batch.  Blocks already resident are skipped; the batch stops at
        the pool's capacity.  Returns how many were injected.  An inject
        that raises (a format the engine refuses) leaves no page
        allocated and nothing registered."""
        todo = [(h, d) for h, d in blocks.items()
                if self.device.registry.lookup(h) is None]
        if self.inject_fn is None:
            return 0
        n = min(len(todo), self.device.reusable_slots)
        if n == 0:
            return 0
        todo = todo[:n]
        pages = self.device.allocate(n)
        try:
            self.inject_fn(pages, torch.stack([d for _, d in todo]))
        except Exception:
            self.device.release(pages)     # no page keeps junk bytes
            raise
        done = 0
        for page, (h, _) in zip(pages, todo):
            if self.device.register(page, h):
                done += 1
        self.device.release(pages)         # -> inactive: resident, matchable
        self.onboarded_blocks += done
        return done

    @engine_thread_only
    def import_block(self, block_hash: int, data: torch.Tensor) -> bool:
        """Inject one fetched block (see `import_blocks`); False when it
        is already resident or the pool has no room."""
        return self.import_blocks({block_hash: data}) == 1

    # -- passthrough G1 ops ------------------------------------------------

    def allocate(self, n: int) -> List[int]:
        return self.device.allocate(n)

    def register(self, slot: int, block_hash: int) -> bool:
        return self.device.register(slot, block_hash)

    def release(self, slots: Sequence[int]) -> None:
        self.device.release(slots)

    @property
    def stats(self) -> Dict[str, float]:
        return {"g1_active": self.device.active_slots,
                "g1_free": self.device.free_slots,
                "g1_inactive": len(self.device.registry.inactive),
                "g1_hits": self.device.hits,
                "g1_misses": self.device.misses,
                "g1_evictions": self.device.evictions,
                "onboarded": self.onboarded_blocks}

    def clear_cache(self) -> List[int]:
        """Admin flush: drop every reusable cached block; returns the
        dropped hashes."""
        return self.device.clear_inactive()
