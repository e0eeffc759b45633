"""Paged KV cache as preallocated tensors (port of
`dynamo_tpu/engine/kv_cache.py`, bf16 subset).

Same layout as the JAX package:

- storage is per-layer K and V buffers `[S = num_blocks * block_size,
  F = num_kv_heads * head_dim]` — a flat slot axis by a flat, head-major
  feature axis, which is exactly the view the CUDA attention kernels
  read (one page of one kv head is `block_size` rows of a `D`-wide
  column band);
- block 0 is the null block: unallocated block-table entries and pad
  positions resolve into it, and its contents are never read unmasked.

Unlike JAX, the port updates the buffers in place (`index_copy_`): the
cache is the largest allocation of the process and a functional update
would double it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch

from dynamo_tpu_torch.models.config import ModelConfig

# Block-table entries for never-allocated pages point at the null block.
NULL_BLOCK = 0


@dataclass(frozen=True)
class KvCacheConfig:
    """Geometry of the paged cache."""

    num_blocks: int          # includes the reserved null block 0
    block_size: int          # tokens per block
    num_layers: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_slots(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def feature_dim(self) -> int:
        """Flat per-token K (or V) width: num_kv_heads * head_dim."""
        return self.num_kv_heads * self.head_dim

    @staticmethod
    def for_model(config: ModelConfig, num_blocks: int,
                  block_size: int = 64) -> "KvCacheConfig":
        return KvCacheConfig(
            num_blocks=num_blocks,
            block_size=block_size,
            num_layers=config.num_layers,
            num_kv_heads=config.num_kv_heads,
            head_dim=config.head_dim,
            dtype=config.dtype,
        )


def init_cache(cfg: KvCacheConfig, device: Union[str, torch.device]) -> dict:
    """Allocate {'k': [L x [S, F]], 'v': [L x [S, F]]} zeroed on `device`."""
    shape = (cfg.num_slots, cfg.feature_dim)
    return {
        "k": [torch.zeros(shape, dtype=cfg.dtype, device=device)
              for _ in range(cfg.num_layers)],
        "v": [torch.zeros(shape, dtype=cfg.dtype, device=device)
              for _ in range(cfg.num_layers)],
    }


def slots_for_positions(block_tables: torch.Tensor,  # [B, P] int
                        positions: torch.Tensor,     # [B, T] int
                        block_size: int) -> torch.Tensor:
    """Flat slot of each (sequence, position): `bt[pos//bs]*bs + pos%bs`.

    Positions whose page index falls past the table width resolve to the
    null block explicitly (not clip-to-last-column, which would alias a
    real page); within-table entries never allocated are NULL_BLOCK by
    construction and must stay masked by the caller."""
    positions = positions.long()
    block_idx = torch.div(positions, block_size, rounding_mode="floor")
    offset = positions % block_size
    P = block_tables.shape[1]
    in_range = block_idx < P
    block_ids = torch.gather(block_tables.long(), 1,
                             torch.clamp(block_idx, max=P - 1))
    block_ids = torch.where(in_range, block_ids,
                            torch.zeros_like(block_ids) + NULL_BLOCK)
    return block_ids * block_size + offset


def write_kv(cache_layer_k: torch.Tensor,  # [S, F], updated in place
             cache_layer_v: torch.Tensor,
             slots: torch.Tensor,          # [N] flat slot ids
             k: torch.Tensor,              # [N, F]
             v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K/V rows into one layer's slot axis, in place.

    Pad tokens carry null-block slots, so their writes land in the junk
    block.  Slots outside [0, S), which JAX drops (`mode="drop"`), are
    sent to slot 0 — the null block — instead: dropping them would need
    a host sync to size the kept set, and the null block is junk by
    contract either way."""
    S = cache_layer_k.shape[0]
    slots = slots.long()
    slots = torch.where((slots >= 0) & (slots < S), slots,
                        torch.zeros_like(slots))
    cache_layer_k.index_copy_(0, slots, k.to(cache_layer_k.dtype))
    cache_layer_v.index_copy_(0, slots, v.to(cache_layer_v.dtype))
    return cache_layer_k, cache_layer_v


def gather_kv(cache_layer_k: torch.Tensor,  # [S, F]
              cache_layer_v: torch.Tensor,
              slots: torch.Tensor,          # [B, C] flat slot ids
              num_kv_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather per-sequence context K/V: returns [B, C, Hkv, D] pairs
    (out-of-range slots clip, as JAX's `mode="clip"`)."""
    B, C = slots.shape
    S, F = cache_layer_k.shape
    D = F // num_kv_heads
    idx = torch.clamp(slots.long(), 0, S - 1).reshape(-1)
    k = cache_layer_k.index_select(0, idx)
    v = cache_layer_v.index_select(0, idx)
    return (k.reshape(B, C, num_kv_heads, D),
            v.reshape(B, C, num_kv_heads, D))
