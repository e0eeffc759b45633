"""Sharded steps of the port (port of the `role="sp_prefill"` part of
`dynamo_tpu/parallel/sharding.py`).

`plane_capability` is the capability table: every (feature x mesh)
combination that cannot work is declared here with the pointed error the
serving code raises, and the engine reads this one function instead of a
hand-kept list.  The port's table holds the rows that concern the
sequence-parallel prefill; the rows of tp/dp/pp/ep meshes come with
those meshes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import make_forward_step
from dynamo_tpu_torch.parallel.mesh import SpRing


@dataclass(frozen=True)
class PlaneSpec:
    """What a step is asked to do, as far as the table needs to know.

    - `dp_attention`: batch-sharded attention with slot-sharded KV.
    - `moe`: the model has expert layers.
    - `role`: "decode" (the unified step family) or "sp_prefill" (ring-SP
      whole-prompt prefill).
    """

    dp_attention: bool = False
    moe: bool = False
    role: str = "decode"


@dataclass(frozen=True)
class Capability:
    ok: bool
    reason: Optional[str] = None


def plane_capability(plane: PlaneSpec) -> Capability:
    """THE capability table."""

    def no(reason: str) -> Capability:
        return Capability(False, reason)

    if plane.moe and plane.role == "sp_prefill":
        return no(
            "ring-SP prefill is declared impossible for MoE: the sp "
            "step shards the TOKEN axis around the ICI ring while "
            "expert dispatch shards tokens over dp×ep — the two "
            "chunkings conflict; MoE prefill rides the padded or "
            "packed plane")
    if plane.role == "sp_prefill" and plane.dp_attention:
        return no("ring-SP prefill is not wired for dp_attention (the "
                  "sp step's cache specs conflict with slot sharding)")
    return Capability(True)


def check_plane(plane: PlaneSpec) -> None:
    """Raise the capability table's pointed error for impossible combos."""
    cap = plane_capability(plane)
    if not cap.ok:
        raise ValueError(cap.reason)


def make_sp_prefill_step(cfg: ModelConfig, block_size: int, ring: SpRing,
                         kv_quant: bool = False, use_kernel: bool = False):
    """Ring-SP whole-prompt prefill (`role="sp_prefill"`):

        logits [R, V], cache = step(params, cache, tokens [R, T],
                                    positions [R, T], seq_lens [R],
                                    block_tables [R, P], sample_pos [R])

    with tokens and positions cut over the ring's ranks on the T axis and
    the parameters replicated per card; T must divide by sp.  `kv_quant`
    says the cache is int8 (its rows and scales then ride the ring);
    `use_kernel` selects the flash-fold kernel's ring
    (ops/cuda/ring_attention.py) where the geometry rule passes; without
    it attention takes the plain ring, the oracle."""
    check_plane(PlaneSpec(role="sp_prefill", moe=cfg.is_moe))
    inner = make_forward_step(cfg, block_size, moe_mode="dense",
                              sp_ring=ring, sp_ring_kernel=use_kernel)

    def step(params, cache, tokens, positions, seq_lens, block_tables,
             sample_pos):
        if kvc.cache_is_quantized(cache) != kv_quant:
            raise ValueError("the step was built for kv_quant="
                             f"{kv_quant} and got the other cache")
        if tokens.shape[1] % ring.sp:
            raise ValueError(f"sp prefill: chunk length {tokens.shape[1]} "
                             f"must divide by sp={ring.sp}")
        return inner(params, cache, tokens, positions, seq_lens,
                     block_tables, sample_pos)

    return step
