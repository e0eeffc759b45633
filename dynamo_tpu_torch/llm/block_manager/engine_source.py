"""ManagedBlockSource: the engine's page supplier backed by the block
manager (port of `dynamo_tpu/llm/block_manager/engine_source.py`, G1
only).

It has the scheduler's allocator interface (BlockAllocator) and adds the
prefix cache: `match(prompt_tokens)` pins the longest cached run of the
prompt's sealed blocks and the engine skips their prefill;
`register_block(page, hash)` publishes a sealed block for later requests.
Pages a request releases stay matchable until LRU pressure reuses them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.llm.block_manager.manager import (
    ExtractFn,
    InjectFn,
    KvBlockManager,
    TieredConfig,
)
from dynamo_tpu_torch.tokens import compute_block_hashes


class ManagedBlockSource:
    def __init__(self, config: TieredConfig,
                 on_removed: Optional[Callable[[int], None]] = None,
                 extract_fn: Optional[ExtractFn] = None,
                 inject_fn: Optional[InjectFn] = None) -> None:
        """`on_removed(block_hash)` fires when a block leaves the device
        tier (the engine turns it into a REMOVED KV event);
        `extract_fn` / `inject_fn` are the engine's batched block copies
        (`KvBlockManager`)."""
        self._on_removed = on_removed
        self.manager = KvBlockManager(config, extract_fn=extract_fn,
                                      inject_fn=inject_fn)
        if on_removed is not None:
            self.manager.device.on_evict = (
                lambda block_hash, _slot: on_removed(block_hash))
        self.block_size = config.block_size

    # -- scheduler allocator interface ------------------------------------

    @property
    def num_blocks(self) -> int:
        return self.manager.device.capacity

    @property
    def free_blocks(self) -> int:
        # Inactive registered blocks are evictable, hence allocatable.
        return self.manager.device.reusable_slots

    @property
    def usage(self) -> float:
        return self.manager.device.usage

    def prompt_hashes(self, prompt_tokens: Sequence[int]) -> Tuple[int, ...]:
        """Chained hashes of the sealed prompt blocks; the scheduler keeps
        them on the request so admission retries do not hash again."""
        n_sealed = len(prompt_tokens) // self.block_size
        if n_sealed == 0:
            return ()
        return tuple(compute_block_hashes(
            prompt_tokens[: n_sealed * self.block_size], self.block_size))

    def match(self, prompt_tokens: Sequence[int],
              hashes: Optional[Sequence[int]] = None) -> Tuple[int, List[int]]:
        """(cached prompt tokens, their pinned pages); only sealed prompt
        blocks take part."""
        if hashes is None:
            hashes = self.prompt_hashes(prompt_tokens)
        if not hashes:
            return 0, []
        n, pages = self.manager.match_and_onboard(hashes)
        return n * self.block_size, pages

    def allocate(self, n: int) -> List[int]:
        return self.manager.allocate(n)

    def release(self, pages: Sequence[int]) -> None:
        self.manager.release(pages)

    def register_block(self, page: int, block_hash: int) -> None:
        self.manager.register(page, block_hash)

    @property
    def stats(self):
        return self.manager.stats

    def clear_cache(self) -> int:
        """Flush all reusable cached blocks; returns how many went.  Each
        leaves as a REMOVED event, so the routers' indexes stay true."""
        dropped = self.manager.clear_cache()
        if self._on_removed is not None:
            for h in dropped:
                self._on_removed(h)
        return len(dropped)
