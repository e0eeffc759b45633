"""The tiered KV block manager and the KV data plane (port of
`dynamo_tpu/llm/block_manager/`).

Block pools keyed by chained sequence hashes with LRU reuse of inactive
blocks: the engine's prefix cache.  A G1 block is a page of the engine's
paged cache, so the pool tracks page ids; evicted blocks ride down to
pinned host memory (G2) and disk (G3) and onboard back on a match, and a
G4 hook fetches from a peer (`manager.py`).  Worker-to-worker block
transfer rides two planes: host-staged over the RPC (`transfer.py`) and
device-direct (`device_transfer.py`: CUDA IPC between processes on one
card, a same-process fabric otherwise), used by eager disagg streaming
(`eager.py`) and fleet prefix sharing (`prefix_share.py`).
"""

from dynamo_tpu_torch.llm.block_manager.engine_source import ManagedBlockSource
from dynamo_tpu_torch.llm.block_manager.manager import KvBlockManager, TieredConfig
from dynamo_tpu_torch.llm.block_manager.pool import BlockPool, BlockRegistry, Slot

__all__ = ["BlockPool", "BlockRegistry", "KvBlockManager",
           "ManagedBlockSource", "Slot", "TieredConfig"]
