"""Tiered KV block manager, G1 (device) tier (port of
`dynamo_tpu/llm/block_manager/manager.py`).

The device tier's KV bytes live in the engine's paged cache; the manager
keeps the pool of its pages: prefix matching, pinning, allocation,
registration of sealed blocks and release.  The host (G2) and disk (G3)
tiers with their offload and onboard copies are not ported yet (ROADMAP
queue A, item 6): a config that sizes them raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from dynamo_tpu_torch.llm.block_manager.pool import BlockPool


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

    def __init__(self, config: TieredConfig) -> None:
        self.config = config
        self.device = BlockPool(config.device_blocks, name="G1-device",
                                reserve_null=True)

    def match_and_onboard(self, hashes: Sequence[int]) -> Tuple[int, List[int]]:
        """The longest prefix of `hashes` resident on the device, pinned
        for the caller (release with `release`): (blocks, page ids).  With
        only G1 there is nothing to onboard from a lower tier."""
        ids = self.device.acquire_matched(
            self.device.match_sequence_hashes(hashes))
        return len(ids), ids

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
                "g1_hits": self.device.hits,
                "g1_misses": self.device.misses,
                "g1_evictions": self.device.evictions}

    def clear_cache(self) -> List[int]:
        """Admin flush: drop every reusable cached block; returns the
        dropped hashes."""
        return self.device.clear_inactive()
