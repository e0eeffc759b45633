"""Sharding rules and sharded steps of the port (port of the tp and
`role="sp_prefill"` parts of `dynamo_tpu/parallel/sharding.py`).

Megatron-style tensor parallelism, the JAX package's split: attention's
wq/wk/wv column-parallel (heads over tp) and wo row-parallel; the MLP's
w_gate/w_up column-parallel and w_down row-parallel; the embedding over
vocab rows and the lm head over vocab columns; norms replicated; the KV
cache's head-major feature axis (and an int8 cache's scale heads) over
tp.  `param_pspecs` / `cache_pspecs` say so as JAX's PartitionSpecs do,
each spec a tuple naming the mesh axis of each tensor axis ("tp" or
None), and `shard_state` cuts a state by them into the per-rank states a
`TpGroup` runs (models/llama.py).

`plane_capability` is the capability table: every (feature x mesh)
combination that cannot work is declared here with the pointed error the
serving code raises, and the engine reads this one function instead of a
hand-kept list.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import make_forward_step
from dynamo_tpu_torch.parallel.mesh import QUEUED, MeshConfig, SpRing, TpGroup


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


def plane_capability(plane: PlaneSpec,
                     mesh: Optional[MeshConfig] = None) -> Capability:
    """THE capability table.  `mesh` None is the meshless engine."""
    tp = mesh is not None and mesh.tp > 1

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
    if plane.moe and tp:
        return no(
            f"MoE under a tp mesh ({mesh.describe()}) is not ported: the "
            "port has no moe_dispatch and no dense-MoE tp split yet; "
            + QUEUED["ep"] + " — serve MoE models meshless")
    return Capability(True)


def check_plane(plane: PlaneSpec, mesh: Optional[MeshConfig] = None) -> None:
    """Raise the capability table's pointed error for impossible combos."""
    cap = plane_capability(plane, mesh)
    if not cap.ok:
        raise ValueError(cap.reason)


# ---------------------------------------------------------------------------
# Tensor-parallel rules

Spec = tuple   # one mesh axis name or None per tensor axis


def param_pspecs(cfg: ModelConfig) -> Dict:
    """The spec tree of a dense model's state (`weights.init_params`'s
    structure): JAX's `param_pspecs(cfg)` on a tp mesh, tp rules only."""
    layer = {
        "attn": {"wq": (None, "tp"), "wk": (None, "tp"),
                 "wv": (None, "tp"), "wo": ("tp", None)},
        "attn_norm": (None,),
        "mlp_norm": (None,),
        "mlp": {"w_gate": (None, "tp"), "w_up": (None, "tp"),
                "w_down": ("tp", None)},
    }
    if cfg.post_norms:
        layer["post_attn_norm"] = (None,)
        layer["post_mlp_norm"] = (None,)
    specs = {"embed": ("tp", None), "final_norm": (None,),
             "layers": [layer] * cfg.num_layers}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def cache_pspecs(num_layers: int, kv_quant: bool = False) -> Dict:
    """The paged cache's spec tree: each layer's [S, F] buffers shard
    their head-major feature axis over tp, which IS head sharding, and an
    int8 cache's [S, Hkv] scales ride their heads (JAX's
    `cache_pspecs(num_layers, kv_quant=...)`)."""
    out = {"k": [(None, "tp")] * num_layers, "v": [(None, "tp")] * num_layers}
    if kv_quant:
        out["k_scale"] = [(None, "tp")] * num_layers
        out["v_scale"] = [(None, "tp")] * num_layers
    return out


def validate(cfg: ModelConfig, mesh: MeshConfig) -> None:
    """JAX's `validate` for the axes the port runs: tp must divide the
    kv heads, the MLP's intermediate width and the vocabulary."""
    tp = mesh.tp
    if cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads} "
            "(head-sharded KV cache; use dp_attention for tp beyond the "
            "kv-head count)")
    if cfg.intermediate_size % tp:
        raise ValueError(
            f"tp={tp} must divide intermediate={cfg.intermediate_size}")
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab={cfg.vocab_size}")


def _cut(t: torch.Tensor, spec: Spec, rank: int, tp: int,
         device: torch.device) -> torch.Tensor:
    """Rank's slice of `t` along the spec's "tp" axis (the whole tensor
    for a replicated spec), as a contiguous tensor of its own on
    `device`: no rank keeps a view of the whole."""
    part = t
    if "tp" in spec:
        axis = spec.index("tp")
        n = t.shape[axis] // tp
        part = t.narrow(axis, rank * n, n)
    out = torch.empty(part.shape, dtype=part.dtype, device=device)
    out.copy_(part)
    return out


def shard_state(tree, specs, group: TpGroup) -> List:
    """Per-rank trees of `tree` (a state or a cache: nested dicts and
    lists of tensors) cut along exactly the axes `specs` names, rank r's
    on `group.devices[r]`."""
    def walk(t, s, rank):
        if isinstance(t, dict):
            return {k: walk(v, s[k], rank) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, sv, rank) for v, sv in zip(t, s)]
        return _cut(t, s, rank, group.tp, group.devices[rank])

    return [walk(tree, specs, r) for r in range(group.tp)]


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
