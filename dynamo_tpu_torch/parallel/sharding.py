"""Sharding rules and sharded steps of the port (port of the tp, dp, ep,
pp and `role="sp_prefill"` parts of `dynamo_tpu/parallel/sharding.py`).

Megatron-style tensor parallelism, the JAX package's split: attention's
wq/wk/wv column-parallel (heads over tp) and wo row-parallel; the MLP's
w_gate/w_up column-parallel and w_down row-parallel; the embedding over
vocab rows and the lm head over vocab columns; norms replicated; the KV
cache's head-major feature axis (and an int8 cache's scale heads) over
tp.  `param_pspecs` / `cache_pspecs` say so as JAX's PartitionSpecs do,
each spec a tuple naming the mesh axis of each tensor axis ("tp", ("dp",
"tp") or None), and `shard_state` cuts a state by them into the per-rank
states a `DpGrid` runs (models/llama.py).

The dp axis, as JAX's: batch rows shard over dp (`data_pspecs`), the
weights replicate over dp, and the cache is head-sharded over tp and
replicated over dp.  Under dp-attention the attention weights replicate
over tp too and the cache's SLOT axis shards over tp; under dp-local the
slots shard over the flat (dp, tp) grid.

The ep axis, as JAX's: an MoE layer's expert axis shards over ep and
each expert's intermediate width over tp ("dispatch": the router
replicated, every shard routing its own tokens; "dense": the router's
expert columns over ep too), and everything else replicates over ep.

The sp axis, as JAX's `sp_prefill` plane: the weights and the cache are
cut by the same specs (tp-sharded, replicated over dp and sp), and the
ring prefill's tokens and positions shard `P("dp", "sp")`: rows over dp,
the whole prompt's T axis over sp (`make_sp_prefill_step`).
`resolve_moe_mode` is JAX's mode ladder on a mesh (the meshless branch
lies in ops/moe.py).

`plane_capability` is the capability table: every (feature x mesh)
combination that cannot work is declared here with the pointed error the
serving code raises, and the engine reads this one function instead of a
hand-kept list.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import make_forward_step
from dynamo_tpu_torch.ops import moe as moe_ops
from dynamo_tpu_torch.parallel.mesh import MeshConfig


@dataclass(frozen=True)
class PlaneSpec:
    """What a step is asked to do, as far as the table needs to know.

    - `use_kernel`: decode attention through K1, the paged-decode kernel
      (JAX's `use_pallas`).
    - `dp_attention` / `dp_local`: batch-sharded attention with
      slot-sharded KV, optionally with page locality.
    - `moe`: the model has expert layers.
    - `spec`: speculative decode (the T = K+1 verify chunk).
    - `role`: "decode" (the unified step family), "embed"
      (return_hidden), "mm" (input-embeds prefill) or "sp_prefill"
      (ring-SP whole-prompt prefill).
    """

    use_kernel: bool = False
    dp_attention: bool = False
    dp_local: bool = False
    moe: bool = False
    spec: bool = False
    role: str = "decode"


@dataclass(frozen=True)
class Capability:
    ok: bool
    reason: Optional[str] = None


def plane_capability(plane: PlaneSpec,
                     mesh: Optional[MeshConfig] = None,
                     multihost: bool = False) -> Capability:
    """THE capability table.  `mesh` None is the meshless engine;
    `multihost`: the mesh spans processes (parallel/multihost.py).

    JAX's row "pallas paged decode is not wired into the pp stage scan"
    is not the port's: each pp stage attends its own pages through K1
    and K2 (parallel/pipeline.py).  Nor is its "pallas paged decode under
    a multi-process mesh" row: each process runs K1 and K2 on its own
    ranks, as a tp rank does in one process."""
    pp = mesh is not None and mesh.pp > 1

    def no(reason: str) -> Capability:
        return Capability(False, reason)

    if plane.dp_local and not plane.dp_attention:
        return no("dp_local implies dp_attention")
    if (plane.dp_attention or plane.dp_local) and mesh is None:
        return no("dp_attention needs a mesh")
    if plane.use_kernel and plane.dp_attention and not plane.dp_local:
        return no(
            "pallas decode under dp_attention needs page locality "
            "(dp_attention_local=True): without it a row's pages may "
            "live on any shard and the kernel's slot indexing cannot "
            "cross chips — set dp_attention_local (plain allocator) or "
            "drop use_pallas_decode for the gather path")
    if pp and multihost:
        return no("pipeline parallelism under a multi-process mesh is "
                  "not wired yet (multihost v2 covers tp/dp/dp-attention "
                  "with int8 and fused steps)")
    if plane.moe:
        if pp:
            return no(
                "MoE on the pp engine is declared impossible: the stage "
                "scan stacks per-stage layer weights into one batched "
                "pytree and its body has no expert branch (router / "
                "grouped / dispatch all need per-layer expert weights); "
                "serve MoE models on a tp/ep/dp mesh or drop --pp")
        if plane.role == "sp_prefill":
            return no(
                "ring-SP prefill is declared impossible for MoE: the sp "
                "step shards the TOKEN axis around the ICI ring while "
                "expert dispatch shards tokens over dp×ep — the two "
                "chunkings conflict; MoE prefill rides the padded or "
                "packed plane")
    if plane.spec:
        if pp:
            return no(
                "speculative decode on the pp engine is declared "
                "impossible: the stage program banks ONE sampled row "
                "per microbatch, and the T=K+1 verify chunk needs "
                "all-positions logits; drop --spec-decode or --pp")
        if multihost:
            return no(
                "speculative decode under a multi-process mesh is "
                "loudly versioned out of the audited lockstep stream "
                "(the host-side verify jit carries no multihost "
                "shardings); drop --spec-decode or run single-process")
    if plane.role == "embed":
        if pp:
            return no("embeddings are not wired for the pp engine "
                      "(pipeline stages have no return_hidden path)")
        if multihost:
            return no("embeddings are not wired for multihost (the "
                      "embed route isn't in the lockstep command "
                      "stream)")
    if plane.role == "mm":
        if pp:
            return no("prompt_embeds (multimodal) on the pp engine is "
                      "not wired (stage step has no input-embeds "
                      "variant)")
        if multihost:
            return no("prompt_embeds (multimodal) under a multi-process "
                      "mesh is not in the lockstep command stream yet")
    if plane.role == "sp_prefill" and plane.dp_attention:
        return no("ring-SP prefill is not wired for dp_attention (the "
                  "sp step's cache specs conflict with slot sharding)")
    return Capability(True)


def check_plane(plane: PlaneSpec, mesh: Optional[MeshConfig] = None,
                multihost: bool = False) -> None:
    """Raise the capability table's pointed error for impossible combos."""
    cap = plane_capability(plane, mesh, multihost)
    if not cap.ok:
        raise ValueError(cap.reason)


# ---------------------------------------------------------------------------
# Tensor-parallel rules

Spec = tuple   # one mesh axis name or None per tensor axis


def param_pspecs(cfg: ModelConfig, moe_mode: str = "dense",
                 dp_attention: bool = False) -> Dict:
    """The spec tree of a model's state (`weights.init_params`'s
    structure): JAX's `param_pspecs(cfg, moe_mode, dp_attention)`.  Every
    weight replicates over dp; `dp_attention` replicates the attention
    weights over tp as well (attention then runs data-parallel over the
    flat grid while the MLP stays tp-sharded).  An MoE layer's experts
    shard over ep and each expert's intermediate width over tp; its
    router replicates under "dispatch" (every shard routes its own
    tokens over all experts) and shards its expert columns over ep
    otherwise."""
    if dp_attention:
        attn = {"wq": (None, None), "wk": (None, None),
                "wv": (None, None), "wo": (None, None)}
    else:
        attn = {"wq": (None, "tp"), "wk": (None, "tp"),
                "wv": (None, "tp"), "wo": ("tp", None)}
    layer = {
        "attn": attn,
        "attn_norm": (None,),
        "mlp_norm": (None,),
    }
    if cfg.is_moe:
        layer["moe"] = {
            "router": ((None, None) if moe_mode == "dispatch"
                       else (None, "ep")),
            "w_gate": ("ep", None, "tp"), "w_up": ("ep", None, "tp"),
            "w_down": ("ep", "tp", None)}
    else:
        layer["mlp"] = {"w_gate": (None, "tp"), "w_up": (None, "tp"),
                        "w_down": ("tp", None)}
    if cfg.post_norms:
        layer["post_attn_norm"] = (None,)
        layer["post_mlp_norm"] = (None,)
    specs = {"embed": ("tp", None), "final_norm": (None,),
             "layers": [layer] * cfg.num_layers}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def cache_pspecs(num_layers: int, dp_attention: bool = False,
                 dp_local: bool = False, kv_quant: bool = False) -> Dict:
    """The paged cache's spec tree (JAX's `cache_pspecs`): each layer's
    [S, F] buffers shard their head-major feature axis over tp, which IS
    head sharding, replicated over dp, and an int8 cache's [S, Hkv]
    scales ride their heads.  `dp_attention` shards the SLOT axis over
    tp instead (replicated over dp); `dp_local` shards it over the flat
    (dp, tp) grid.  Scales shard as their pages."""
    if dp_local:
        spec = (("dp", "tp"), None)
    elif dp_attention:
        spec = ("tp", None)
    else:
        spec = (None, "tp")
    out = {"k": [spec] * num_layers, "v": [spec] * num_layers}
    if kv_quant:
        out["k_scale"] = [spec] * num_layers
        out["v_scale"] = [spec] * num_layers
    return out


def data_pspecs() -> Dict:
    """Per-step input batch: the batch axis over dp (JAX's
    `data_pspecs`)."""
    return {
        "tokens": ("dp", None),
        "positions": ("dp", None),
        "seq_lens": ("dp",),
        "block_tables": ("dp", None),
    }


def validate(cfg: ModelConfig, mesh: MeshConfig,
             dp_attention: bool = False) -> None:
    """JAX's `validate`: tp must divide the kv heads (unless
    dp-attention shards slots instead of heads), the MLP's intermediate
    width and the vocabulary; ep must divide the experts, and only an
    MoE model takes an ep axis.  A pp mesh holds JAX's `_validate_pp`
    (parallel/pipeline.py)."""
    if mesh.pp > 1:
        from dynamo_tpu_torch.parallel.pipeline import _validate_pp

        _validate_pp(cfg, mesh)
    tp, ep = mesh.tp, mesh.ep
    if not dp_attention and cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads} "
            "(head-sharded KV cache; use dp_attention for tp beyond the "
            "kv-head count)")
    if cfg.intermediate_size % tp:
        raise ValueError(
            f"tp={tp} must divide intermediate={cfg.intermediate_size}")
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab={cfg.vocab_size}")
    if cfg.is_moe and cfg.num_experts % ep:
        raise ValueError(f"ep={ep} must divide num_experts={cfg.num_experts}")
    if not cfg.is_moe and ep > 1:
        raise ValueError("ep > 1 on a dense model wastes chips; use tp/dp")


def resolve_moe_mode(cfg: ModelConfig, mesh: Optional[MeshConfig],
                     moe_mode: str = "auto",
                     device: torch.device = torch.device("cpu")) -> str:
    """JAX's MoE mode ladder: dense | grouped | dispatch.  Meshless
    (`mesh` None) it is ops/moe.resolve_moe_mode on `device`; on a mesh
    "grouped" raises (the grouped kernel runs whole experts a rank), and
    'auto' gives "dispatch" where an ep axis exceeds 1, else "dense"."""
    if mesh is None or not cfg.is_moe:
        return moe_ops.resolve_moe_mode(cfg, device, moe_mode)
    if moe_mode not in moe_ops.MOE_MODES:
        raise ValueError(f"moe_mode={moe_mode!r} not in {moe_ops.MOE_MODES}")
    if moe_mode == "grouped":
        raise ValueError(
            "moe_mode='grouped' is the meshless fast path (the Pallas "
            "grouped GEMM runs whole experts per chip); sharded meshes "
            "use 'dispatch' (ep all-to-all, tp-sharded expert MLPs) or "
            "'dense' (GSPMD einsums)")
    if moe_mode == "auto":
        return "dispatch" if mesh.ep > 1 else "dense"
    return moe_mode


def _coords(spec: Spec, d: int, t: int, tp: int, e: int = 0,
            ep: int = 1) -> Tuple[tuple, tuple]:
    """For rank (d, e, t): ((axis, index, parts) of each cut axis) and the
    indices that name its piece."""
    cuts = []
    for axis, name in enumerate(spec):
        if name == "tp":
            cuts.append((axis, t, tp))
        elif name == "ep":
            cuts.append((axis, e, ep))
        elif name == ("dp", "tp"):
            cuts.append((axis, d * tp + t, None))
        elif name == "dp":
            cuts.append((axis, d, None))
        elif name is not None:
            raise ValueError(f"unknown mesh axis {name!r} in {spec}")
    return tuple(cuts), tuple(c[1] for c in cuts)


def _cut(t: torch.Tensor, cuts: tuple, parts: Dict[int, int],
         device: torch.device, junk_row: bool) -> torch.Tensor:
    """The piece of `t` the cuts name, as a contiguous tensor of its own
    on `device`: no rank keeps a view of the whole.  `junk_row` (a slot
    shard of a cache) backs the piece with one more row, where writes
    that fall outside the shard land (kv_cache.write_routes)."""
    part = t
    for axis, index, n in cuts:
        n = n or parts[axis]
        size = t.shape[axis] // n
        part = part.narrow(axis, index * size, size)
    if device.type == "meta":
        return torch.empty(part.shape, dtype=part.dtype, device=device)
    if junk_row and cuts and cuts[0][0] == 0:
        out = torch.zeros((part.shape[0] + 1,) + tuple(part.shape[1:]),
                          dtype=part.dtype, device=device)[:part.shape[0]]
    else:
        out = torch.empty(part.shape, dtype=part.dtype, device=device)
    out.copy_(part)
    return out


def shard_state(tree, specs, group, junk_rows: bool = False) -> List:
    """Per-rank trees of `tree` (a state or a cache: nested dicts and
    lists of tensors) cut along exactly the axes `specs` names, rank r's
    on `group.devices[r]`.  `group` is a parallel.mesh.DpGrid (tp alone:
    its one dp row; a cache: its `attention` grid); the ranks that share
    a place and a piece share one tensor (one copy of each piece a card).
    `junk_rows`: the tree is a cache, and its slot shards get their junk
    row."""
    tp, dp, places = group.tp, group.dp, group.places
    ep = getattr(group, "ep", 1)
    # Every rank of sp index s > 0 takes its (d, t) piece: no spec names
    # sp, so it shares the copy of its place.
    sp = getattr(group, "sp", 1)
    mine = getattr(group, "mine", None) or [True] * len(group.devices)
    shared: Dict[tuple, torch.Tensor] = {}

    def walk(t, s, r, path):
        if isinstance(t, dict):
            return {k: walk(v, s[k], r, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, sv, r, path + (i,))
                    for i, (v, sv) in enumerate(zip(t, s))]
        cuts, idx = _coords(s, r // (sp * ep * tp), r % tp, tp,
                            (r // tp) % ep, ep)
        parts = {axis: (dp * tp if s[axis] == ("dp", "tp") else dp)
                 for axis, _, n in cuts if n is None}
        key = (path, places[r], idx)
        if key not in shared:
            # Another process's rank: its shape alone (a meta tensor).
            dev = group.devices[r] if mine[r] else torch.device("meta")
            shared[key] = _cut(t, cuts, parts, dev, junk_rows)
        return shared[key]

    return [walk(tree, specs, r, ()) for r in range(len(group.devices))]


def make_sp_prefill_step(cfg: ModelConfig, block_size: int, ring,
                         kv_quant: bool = False, use_kernel: bool = False):
    """Ring-SP whole-prompt prefill (`role="sp_prefill"`):

        logits [R, V], cache = step(params, cache, tokens [R, T],
                                    positions [R, T], seq_lens [R],
                                    block_tables [R, P], sample_pos [R])

    `ring` an SpRing (the meshless ring): tokens and positions are cut
    over its ranks on the T axis, the parameters replicated per card and
    the cache one, on rank 0's card.  `ring` a DpGrid with sp > 1 (JAX's
    plane on a mesh): tokens and positions shard `P("dp", "sp")`, the
    params and the cache are the grid's per-rank lists (`shard_state`,
    kv_cache.init_grid_caches), and each (dp row, tp slice) runs its own
    ring of its heads; R must divide by dp.  T must divide by sp.
    `kv_quant` says the cache is int8 (its rows and scales then ride the
    ring); `use_kernel` selects the flash-fold kernel's ring
    (ops/cuda/ring_attention.py) where the geometry rule passes; without
    it attention takes the plain ring, the oracle."""
    grid = ring if hasattr(ring, "rows") else None
    sp = ring.sp
    if grid is None:
        check_plane(PlaneSpec(role="sp_prefill", moe=cfg.is_moe))
    else:
        check_plane(PlaneSpec(role="sp_prefill", moe=cfg.is_moe,
                              dp_attention=grid.dp_attention),
                    MeshConfig(dp=grid.dp, sp=sp, ep=grid.ep, tp=grid.tp))
    inner = make_forward_step(cfg, block_size, moe_mode="dense",
                              sp_ring=ring, sp_ring_kernel=use_kernel,
                              tp=grid)

    def step(params, cache, tokens, positions, seq_lens, block_tables,
             sample_pos):
        first = cache[0] if grid is not None else cache
        if kvc.cache_is_quantized(first) != kv_quant:
            raise ValueError("the step was built for kv_quant="
                             f"{kv_quant} and got the other cache")
        if tokens.shape[1] % sp:
            raise ValueError(f"sp prefill: chunk length {tokens.shape[1]} "
                             f"must divide by sp={sp}")
        return inner(params, cache, tokens, positions, seq_lens,
                     block_tables, sample_pos)

    return step
