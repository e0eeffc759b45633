"""Llama-family decoder (dense or MoE), meshless, in PyTorch (port of
`dynamo_tpu/models/llama.py`).

Forward contract (unified prefill/decode, as in the JAX package):

    logits, cache = forward_step(state, cache, tokens, positions,
                                 seq_lens, block_tables, sample_positions)

- tokens/positions: [B, T]; seq_lens: [B] context length AFTER the chunk;
  block_tables: [B, P] int32 page ids; sample_positions: [B] index within
  the chunk whose logits come back ([B, V]), or None for every position.
- The chunk's K/V are written into the paged cache first (in place), then
  the chunk attends to all cached context with an absolute-position causal
  mask.  At T == 1 with `use_decode_kernel` attention goes through the
  paged-decode kernel (ops/cuda/paged_attention.py); otherwise through
  the gather path (kv_cache.gather_kv + ops/attention.paged_attention).
- An int8 cache (its dict carries `k_scale` / `v_scale`, as the JAX
  package's) quantizes each written row with its per-token, per-head
  scale and reads through the kernels' int8 bodies, or through
  kv_cache.gather_kv_quant on the gather path; the cache dict's keys
  decide the branch.
- `sp_ring` (a parallel.mesh.SpRing) turns a T > 1 call into the
  sequence-parallel whole-prompt prefill: every rank runs the token-wise
  ops on its T / sp slice and attention runs on the ring, through the
  flash-fold kernel (ops/cuda/ring_attention.py) where `sp_ring_kernel`
  asks for it and the geometry rule passes, else through the plain ring.
- `tp` (a parallel.mesh.DpGrid) runs the step over the (dp, tp) rank
  grid, the JAX package's dp and tp axes (parallel/sharding.py):
  `state` and `cache` are then lists of per-rank states and caches
  (`shard_state`, kv_cache.init_grid_caches).  The batch splits over the
  dp rows in contiguous ranges; each row runs its share in Megatron's
  split, each rank projecting its own heads and MLP columns on its own
  stream, the row-parallel products (wo, w_down) and the vocab-sharded
  embedding lookup summed by `all_reduce` over the row's ranks, the
  vocab-sharded logits gathered on rank 0.  Tensor parallelism alone is
  the grid of one dp row.  Plain dp (and tp): each rank attends its
  rows' heads through its own K1 / K2 call against its card's copy of
  the head-sharded cache.  dp-attention: each rank attends its own rows
  (or packed segments) with the whole attention weights, and the row's
  MLP runs over all its rows (`all_gather_all` in, `all_reduce` out).
  Non-local dp-attention reads each row's context from whichever tp
  slot shard holds its pages (one masked gather per shard) and runs no
  attention kernel; dp-local runs K1 and K2 per shard on shard-local
  block tables (`clip(bt - flat * pages_local, 0, pages_local - 1)`,
  JAX's rebase), and every write to a slot outside a shard lands in the
  shard's junk row (engine/kv_cache.py).  A meshless call runs no grid.
  With an ep axis (a grid of dp x ep x tp ranks) everything but the MoE
  layers runs on the ranks of ep index 0, the ep ranks of a card sharing
  their weights and cache, and an MoE layer's tokens split over the row's
  ep ranks (`_grid_moe`).  With an sp axis (dp x sp x tp ranks) every
  step but the ring prefill runs on the ranks of sp index 0, and the
  ring prefill (`sp_ring` the grid itself) runs rank (d, s, t) on token
  slice s of dp row d with tp slice t's weights, each (d, t) attending
  its heads on its own ring (`_grid_sp_forward`).
- `tp` a parallel.mesh.PpStages routes the step factories to the
  pipeline's (parallel/pipeline.py): per-stage states and caches, JAX's
  GPipe microbatch schedule, each stage running its layers through the
  meshless step's own bodies (`_decoder_layers`, `_packed_layers`) on
  its own cache list, K1 / K2 included.
- MoE layers run `moe_mode` "dense" (the exact oracle) or "grouped" (the
  grouped-expert kernel, ops/cuda/moe_grouped.py) meshless, and "dense"
  (each rank its F/tp slices, an ep rank its experts) or "dispatch" (the
  all-to-all over the ep ranks, ops/moe.py) on a grid, with
  `cfg.moe_capacity` per expert and source shard; each gives an [E+1]
  expert-load stats vector; `with_expert_load` (and the packed prefill
  step of a MoE model) returns their sum over the layers as a third
  output, as in the JAX package.

Matrix products stay `torch.matmul`, as the JAX package left them to XLA.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import moe as moe_ops
from dynamo_tpu_torch.ops.attention import paged_attention
from dynamo_tpu_torch.ops.cuda import (
    paged_decode_attention,
    paged_prefill_attention,
    ring_flash_attention,
    ring_kernel_supported,
)
from dynamo_tpu_torch.ops.ring_attention import ring_causal_attention

State = Dict


# ---------------------------------------------------------------------------
# Building blocks


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wf = w.float()
    if offset:
        wf = wf + 1.0  # Gemma convention: scale is (1 + w)
    return (norm * wf).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin of the rotary angles, [B, T, 1, D/2] each — computed once
    per step and shared by every layer."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions[..., None].float() * freqs           # [B, T, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    cos, sin = tables
    x1, x2 = x.float().split(x.shape[-1] // 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves (rotate-half, as the JAX package —
    not HF's interleaved layout).  x: [B, T, H, D], positions: [B, T]."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


def _attention_block(
    cfg: ModelConfig,
    p_attn: State,
    x: torch.Tensor,              # [B, T, H]
    positions: torch.Tensor,      # [B, T]
    rot,                          # rope_tables(positions, ...)
    seq_lens: torch.Tensor,       # [B] int32
    write_slots: torch.Tensor,    # [B*T] flat cache slots for this chunk
    ctx_slots: Optional[torch.Tensor],     # [B, C], or None (decode kernel)
    kv_positions: Optional[torch.Tensor],  # [B, C], or None
    block_tables: torch.Tensor,   # [B, P] int32
    block_size: int,
    k_cache: torch.Tensor,        # [S, F] this layer's cache, written in place
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # [S, Hkv] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    B, T, _ = x.shape
    q, k, v = _qkv(cfg, p_attn, x, rot)
    _write_chunk(k_cache, v_cache, k_scale, v_scale, write_slots,
                 k.reshape(B * T, cfg.kv_size), v.reshape(B * T, cfg.kv_size))
    if ctx_slots is None:
        # Decode: stream each row's live pages through the kernel — no
        # gathered context.
        out = paged_decode_attention(
            q[:, 0].contiguous(), k_cache, v_cache, block_tables, seq_lens,
            block_size=block_size, scale=cfg.query_scale,
            soft_cap=cfg.attn_soft_cap, k_scale=k_scale,
            v_scale=v_scale)[:, None]
    else:
        if k_scale is not None:
            # Same dequantized operands as the kernels' int8 loader, in
            # q's dtype.
            k_ctx, v_ctx = kvc.gather_kv_quant(
                k_cache, v_cache, k_scale, v_scale, ctx_slots,
                cfg.num_kv_heads, out_dtype=q.dtype)
        else:
            k_ctx, v_ctx = kvc.gather_kv(k_cache, v_cache, ctx_slots,
                                         cfg.num_kv_heads)
        out = paged_attention(q, k_ctx, v_ctx, positions, kv_positions,
                              seq_lens, scale=cfg.query_scale,
                              soft_cap=cfg.attn_soft_cap)
    return out.reshape(B, T, cfg.q_size) @ p_attn["wo"]


def _qkv(cfg: ModelConfig, p_attn: State, x: torch.Tensor, rot):
    """The chunk's projected heads, q and k rotated: q [B, T, Hq, D] and
    k, v [B, T, Hkv, D]."""
    B, T, _ = x.shape
    q = (x @ p_attn["wq"]).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = (x @ p_attn["wk"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p_attn["wv"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(q, rot), apply_rope(k, rot), v


def _write_chunk(k_cache, v_cache, k_scale, v_scale,
                 slots: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a chunk's [N, F] K/V rows into one layer, in place: quantized
    with their scales into an int8 cache, as they are otherwise."""
    if k_scale is not None:
        kvc.write_kv_quant(k_cache, v_cache, k_scale, v_scale, slots, k, v)
    else:
        kvc.write_kv(k_cache, v_cache, slots, k, v)


def _layer_scales(cache: Dict, i: int):
    """Layer i's (k_scale, v_scale) buffers; (None, None) for a cache
    that is not quantized."""
    if not kvc.cache_is_quantized(cache):
        return None, None
    return cache["k_scale"][i], cache["v_scale"][i]


def _dense_mlp(p: State, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    gate = x @ p["w_gate"]
    act = (F.silu(gate) if activation == "silu"
           else F.gelu(gate, approximate="tanh"))
    return (act * (x @ p["w_up"])) @ p["w_down"]


def _embed(cfg: ModelConfig, state: State, tokens: torch.Tensor,
           input_embeds: Optional[torch.Tensor] = None,
           embed_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _embed_finish(cfg, state["embed"][tokens.long()], input_embeds,
                         embed_mask)


def _embed_rows(table: torch.Tensor, tokens: torch.Tensor,
                start: int) -> torch.Tensor:
    """One rank's part of a vocab-sharded lookup: the rows of the tokens
    in [start, start + rows) of its slice, zero for every other token, so
    that the ranks' parts sum to the whole lookup exactly."""
    local = tokens.long() - start
    hit = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(hit[..., None], rows, torch.zeros_like(rows))


def _embed_finish(cfg: ModelConfig, x: torch.Tensor,
                  input_embeds: Optional[torch.Tensor] = None,
                  embed_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if input_embeds is not None:
        # Multimodal prefill: masked positions take the given embeddings
        # (an encode worker's output) in place of the token lookup.
        x = torch.where(embed_mask[..., None], input_embeds.to(x.dtype), x)
    if cfg.embed_scale:
        # Gemma: the multiplier is cast to the model dtype first.
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _moe_block(cfg: ModelConfig, p: State, x: torch.Tensor,
               moe_mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE layer, meshless → (out, stats [E+1]): "grouped" runs the
    grouped-expert kernel over expert-sorted assignments, anything else
    the exact dense oracle."""
    if moe_mode == "grouped":
        return moe_ops.moe_grouped(cfg, p, x)
    return moe_ops.moe_dense(cfg, p, x)


def _mlp_in(cfg: ModelConfig, layer: State, x: torch.Tensor,
            attn_out: torch.Tensor):
    """Residual add of the (summed) attention output: (x, the MLP's
    normed input)."""
    off = cfg.rms_offset
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, layer["post_attn_norm"],
                            cfg.rms_norm_eps, off)
    x = x + attn_out
    return x, rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps, off)


def _mlp(cfg: ModelConfig, layer: State, h: torch.Tensor, moe_mode: str,
         loads: List[torch.Tensor]) -> torch.Tensor:
    """The MLP or MoE sub-block (a rank's row-parallel partial under tp);
    a MoE layer appends its [E+1] stats to `loads`."""
    if cfg.is_moe:
        out, load = _moe_block(cfg, layer["moe"], h, moe_mode)
        loads.append(load)
        return out
    return _dense_mlp(layer["mlp"], h, cfg.activation)


def _mlp_out(cfg: ModelConfig, layer: State, x: torch.Tensor,
             mlp_out: torch.Tensor) -> torch.Tensor:
    """Residual add of the (summed) MLP output."""
    if cfg.post_norms:
        mlp_out = rms_norm(mlp_out, layer["post_mlp_norm"],
                           cfg.rms_norm_eps, cfg.rms_offset)
    return x + mlp_out


def _layer_tail(cfg: ModelConfig, layer: State, x: torch.Tensor,
                attn_out: torch.Tensor, moe_mode: str,
                loads: List[torch.Tensor]) -> torch.Tensor:
    """Residual add of the attention output, then the MLP or MoE
    sub-block, on one rank that holds the whole layer."""
    x, h = _mlp_in(cfg, layer, x, attn_out)
    return _mlp_out(cfg, layer, x, _mlp(cfg, layer, h, moe_mode, loads))


def _decoder_layers(cfg: ModelConfig, layers: Sequence[State], cache: Dict,
                    x: torch.Tensor, positions, rot, seq_lens, write_slots,
                    ctx_slots, ctx_positions, block_tables, block_size: int,
                    moe_mode: str, loads: List[torch.Tensor]) -> torch.Tensor:
    """`layers` in order over x [B, T, H], layer j on the cache's layer
    j (a stage's cache holds its own layers only): the unified step's
    body, which the meshless step and each pipeline stage run."""
    off = cfg.rms_offset
    for j, layer in enumerate(layers):
        attn_out = _attention_block(
            cfg, layer["attn"],
            rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps, off),
            positions, rot, seq_lens, write_slots, ctx_slots, ctx_positions,
            block_tables, block_size, cache["k"][j], cache["v"][j],
            *_layer_scales(cache, j))
        x = _layer_tail(cfg, layer, x, attn_out, moe_mode, loads)
    return x


def _packed_layers(cfg: ModelConfig, layers: Sequence[State], cache: Dict,
                   x: torch.Tensor, rot, write_slots, args, block_size: int,
                   moe_mode: str, loads: List[torch.Tensor]) -> torch.Tensor:
    """`layers` in order over a packed [1, T, H] chunk, attending through
    the paged-prefill kernel on the cache's layer j: the packed prefill's
    body, which the meshless step and each pipeline stage run.  `args`
    is (block_tables, seq_lens, q_starts, q_lens) in int32."""
    T = x.shape[1]
    off = cfg.rms_offset
    for j, layer in enumerate(layers):
        p_attn = layer["attn"]
        h_in = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps, off)
        q, k, v = _qkv(cfg, p_attn, h_in, rot)
        ks, vs = _layer_scales(cache, j)
        _write_chunk(cache["k"][j], cache["v"][j], ks, vs,
                     write_slots, k.reshape(T, cfg.kv_size),
                     v.reshape(T, cfg.kv_size))
        # Write-then-attend: the chunk's own K/V are pool rows now, so
        # cached prefix and in-chunk causality are one position mask.
        attn = paged_prefill_attention(
            q[0].contiguous(), cache["k"][j], cache["v"][j], *args,
            block_size=block_size, scale=cfg.query_scale,
            soft_cap=cfg.attn_soft_cap, k_scale=ks, v_scale=vs)
        attn = attn.reshape(1, T, cfg.q_size) @ p_attn["wo"]
        x = _layer_tail(cfg, layer, x, attn, moe_mode, loads)
    return x


def _expert_load(loads: List[torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    """Sum of the layers' [E+1] stats ([1] zeros for a dense model)."""
    if not loads:
        return torch.zeros((1,), dtype=torch.int32, device=device)
    return torch.stack(loads).sum(0, dtype=torch.int32)


def _lm_head(cfg: ModelConfig, state: State, x: torch.Tensor) -> torch.Tensor:
    head = state.get("lm_head")
    if head is None:
        head = state["embed"].T
    logits = (x @ head).float()
    if cfg.final_soft_cap is not None:
        logits = cfg.final_soft_cap * torch.tanh(logits / cfg.final_soft_cap)
    return logits


# ---------------------------------------------------------------------------
# Sequence-parallel whole-prompt prefill


def _sp_ring_attention(cfg: ModelConfig, q, k, v, positions, ring_quant,
                       ring, use_kernel: bool):
    """Sequence-parallel whole-prompt attention dispatch over per-rank
    lists (q [B, T/sp, Hq, D], k and v [B, T/sp, Hkv, D], positions
    [B, T/sp]): the flash-fold kernel's ring when asked for, else the
    plain ring, which stays the oracle.  `ring_quant` is None or the
    per-rank lists (kq, vq, k_scale, v_scale) of the quantized chunk,
    which then rotate in place of k and v.

    `cfg` is the geometry the ranks compute (`rank_config`: a tp rank's
    heads on a grid).  For ranks on a card the choice is
    `ring_kernel_supported` at those heads, the same predicate the
    engine's kernel-path counter reads, so the two cannot disagree on
    which ring a geometry runs.  A geometry the kernel does
    not take is a declared rule, not a caught failure: once chosen, the
    kernel launches or raises.  For CPU ranks the kernel's ring folds
    with the kernel's plain version, as every kernel wrapper of the port
    does for CPU tensors."""
    B, t_loc, Hq, D = q[0].shape
    kw = dict(scale=cfg.query_scale, soft_cap=cfg.attn_soft_cap)
    if ring_quant is not None:
        k, v, ks, vs = ring_quant
        kw.update(k_scale=ks, v_scale=vs)
    if use_kernel and (not ring.cuda or ring_kernel_supported(
            Hq, cfg.num_kv_heads, D, t_loc, q[0].device, q[0].dtype)):
        return ring_flash_attention(ring, q, k, v, positions, **kw)
    # The plain ring runs on each card's current stream: let those catch
    # up with the ranks' streams, and the ranks' streams with them after.
    ring.join()
    outs = ring_causal_attention(q, k, v, positions, **kw)
    ring.fork()
    return outs


def _sp_qkv(cfg: ModelConfig, p_attn: State, h: torch.Tensor, rot,
            quant: bool):
    """One rank's (q, k, v, k_scale, v_scale) of its token slice h
    [B, T/sp, H].  With an int8 cache the rank quantizes its k and v rows
    ONCE: the same int8 rows and scales [B, T/sp, Hkv] are written into
    the cache and rotated around the ring, so the ring attends what every
    later cache read will see; without one the scales are None."""
    q, k, v = _qkv(cfg, p_attn, h, rot)
    if not quant:
        return q, k, v, None, None
    B, t_loc = k.shape[:2]
    kq, ksc = kvc.quantize_kv_rows(k.reshape(B * t_loc, cfg.kv_size),
                                   cfg.num_kv_heads)
    vq, vsc = kvc.quantize_kv_rows(v.reshape(B * t_loc, cfg.kv_size),
                                   cfg.num_kv_heads)
    return (q, kq.reshape(k.shape), vq.reshape(v.shape),
            ksc.reshape(k.shape[:3]), vsc.reshape(v.shape[:3]))


def _sp_write_rows(cache: Dict, i: int, slots, rows) -> None:
    """The chunk's rows into layer i of one cache: (k, v) in the model
    dtype, or the int8 rows and their scales."""
    if len(rows) == 4:
        kvc.scatter_kv_quant(cache["k"][i], cache["v"][i],
                             cache["k_scale"][i], cache["v_scale"][i],
                             slots, *rows)
    else:
        kvc.write_kv(cache["k"][i], cache["v"][i], slots, *rows)


def _sp_ring_layer(cfg: ModelConfig, ring, use_kernel: bool, qkv,
                   positions, write, wos):
    """One layer's attention over the ring from its ranks' `qkv[r]`
    (`_sp_qkv`): the chunk's rows gather in token order on rank 0, where
    `write(rows)` puts them into the cache; the chunk attends itself on
    the ring (no cached context is read); rank r's output goes through
    its `wos[r]`."""
    quant = qkv[0][3] is not None
    parts = [[x[j] for x in qkv] for j in range(5 if quant else 3)]
    B, t_loc = parts[0][0].shape[:2]
    rows = [ring.gather(p, dim=1).reshape(B * ring.sp * t_loc, -1)
            for p in parts[1:]]
    with ring.on(0):
        write(rows)
    outs = _sp_ring_attention(cfg, *parts[:3], positions,
                              parts[1:] if quant else None, ring, use_kernel)
    attn = []
    for r in range(ring.sp):
        with ring.on(r):
            attn.append(outs[r].reshape(B, t_loc, cfg.q_size) @ wos[r])
    return attn


def _sp_sample_rows(cfg: ModelConfig, ring, xs, norms, smps, t_loc: int):
    """Each row's final-normed sampled row [B, H] on rank 0: row b's
    sample position lies on rank smps[b] // t_loc; every rank r norms its
    candidate rows (`xs[r]` [B, T/sp, H], `norms[r]` its final norm,
    `smps[r]` the sample positions), rank 0 keeps the owners'."""
    cands = []
    for r in range(ring.sp):
        with ring.on(r):
            x = xs[r]
            idx = (smps[r].to(x.device).long() - r * t_loc).clamp(
                0, t_loc - 1)
            row = x[torch.arange(x.shape[0], device=x.device), idx]
            cands.append(rms_norm(row, norms[r], cfg.rms_norm_eps,
                                  cfg.rms_offset)[None])
    stacked = ring.gather(cands, dim=0)                        # [sp, B, H]
    with ring.on(0):
        owner = torch.div(smps[0].to(stacked.device).long(), t_loc,
                          rounding_mode="floor").clamp(0, ring.sp - 1)
        return stacked[owner, torch.arange(stacked.shape[1],
                                           device=stacked.device)]


def _sp_forward(cfg: ModelConfig, block_size: int, ring, use_kernel: bool,
                state: State, cache: Dict, tokens, positions, block_tables,
                sample_positions):
    """The whole-prompt prefill step over the ring's ranks.  The chunk is
    the WHOLE prompt of every row (positions 0..len-1, pad positions past
    the block table); rank r runs every token-wise op of every layer on
    tokens [r * T/sp, (r + 1) * T/sp) with its card's replica of the
    parameters, and only attention sees the other ranks' tokens.  The
    chunk's rows are gathered on rank 0's card and written to the paged
    cache there.

    The paged cache and all of decode stay on rank 0's card: after the
    step the cache holds what a meshless prefill of the same prompts
    writes.  (The JAX step replicates the cache and decode over sp; that
    is how GSPMD keeps one program, not something a user sees.)"""
    B, T = tokens.shape
    sp = ring.sp
    if T % sp:
        raise ValueError(f"sp prefill: chunk length {T} must divide by "
                         f"sp={sp}")
    if cfg.is_moe:
        raise ValueError("sp prefill runs dense models only")
    if sample_positions is None:
        raise ValueError("sp prefill gives one logits row per sequence: "
                         "pass sample_positions")
    t_loc = T // sp
    block_tables = block_tables.to(torch.int32)
    write_slots = kvc.slots_for_positions(
        block_tables, positions, block_size).reshape(B * T)
    quant = kvc.cache_is_quantized(cache)
    ring.fork()
    states = ring.replicas(state)
    xs, pos, rots = [], [], []
    for r in range(sp):
        with ring.on(r):
            cut = slice(r * t_loc, (r + 1) * t_loc)
            dev = ring.devices[r]
            pos_r = positions[:, cut].to(dev).contiguous()
            xs.append(_embed(cfg, states[r], tokens[:, cut].to(dev)))
            pos.append(pos_r)
            rots.append(rope_tables(pos_r, cfg.head_dim, cfg.rope_theta))
    off = cfg.rms_offset
    for i in range(cfg.num_layers):
        layers = [st["layers"][i] for st in states]
        qkv = []
        for r in range(sp):
            with ring.on(r):
                h = rms_norm(xs[r], layers[r]["attn_norm"], cfg.rms_norm_eps,
                             off)
                qkv.append(_sp_qkv(cfg, layers[r]["attn"], h, rots[r],
                                   quant))
        attn = _sp_ring_layer(
            cfg, ring, use_kernel, qkv, pos,
            functools.partial(_sp_write_rows, cache, i, write_slots),
            [layer["attn"]["wo"] for layer in layers])
        for r in range(sp):
            with ring.on(r):
                xs[r] = _layer_tail(cfg, layers[r], xs[r], attn[r], "dense", [])
    sel = _sp_sample_rows(cfg, ring, xs, [st["final_norm"] for st in states],
                          [sample_positions] * sp, t_loc)
    with ring.on(0):
        logits = _lm_head(cfg, states[0], sel)
    ring.join()
    return logits, cache


# ---------------------------------------------------------------------------
# The rank grid (parallel/mesh.DpGrid; tensor parallelism alone is the
# grid of one dp row, and a meshless step runs no grid)


def rank_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The geometry one rank of a tp group computes: its query and kv
    heads, its intermediate columns and its vocab slice."""
    if tp == 1:
        return cfg
    return cfg.replace(num_heads=cfg.num_heads // tp,
                       num_kv_heads=cfg.num_kv_heads // tp,
                       intermediate_size=cfg.intermediate_size // tp,
                       vocab_size=cfg.vocab_size // tp)


def _grid(tp):
    """The step's DpGrid, or None for the meshless step."""
    if tp is not None and not hasattr(tp, "rows"):
        raise TypeError("a sharded step runs over a parallel.mesh.DpGrid "
                        "(tp alone: DpGrid(devices, dp=1)) or, pipelined, "
                        "over a parallel.mesh.PpStages")
    return tp


def _stages(tp):
    """The step's PpStages (parallel/pipeline.py), or None."""
    return tp if hasattr(tp, "microbatches") else None


def _pp_refusals(stages, sp_ring=None, with_expert_load: bool = False,
                 return_hidden: bool = False) -> None:
    """What a pipelined step does not take, in the words of JAX's mesh
    rule and capability table."""
    from dynamo_tpu_torch.parallel.mesh import MeshConfig
    from dynamo_tpu_torch.parallel.sharding import PlaneSpec, check_plane

    mesh = MeshConfig(pp=stages.pp,
                      sp=sp_ring.sp if sp_ring is not None else 1)
    if return_hidden:
        check_plane(PlaneSpec(role="embed"), mesh)
    if with_expert_load:
        raise ValueError("pp v1 supports dense models only")


def _check_grid(cfg: ModelConfig, grid, sp_ring=None,
                use_kernel: bool = False, moe_mode: str = "dense") -> None:
    """The mesh's and the capability table's refusals of a sharded step
    (parallel/mesh.py, parallel/sharding.py)."""
    from dynamo_tpu_torch.parallel.mesh import MeshConfig
    from dynamo_tpu_torch.parallel.multihost import grid_spans_processes
    from dynamo_tpu_torch.parallel.sharding import (
        PlaneSpec, check_plane, validate)

    mesh = MeshConfig(dp=grid.dp, sp=getattr(grid, "sp", 1), ep=grid.ep,
                      tp=grid.tp)
    check_plane(PlaneSpec(use_kernel=use_kernel,
                          dp_attention=grid.dp_attention,
                          dp_local=grid.dp_local, moe=cfg.is_moe), mesh,
                multihost=grid_spans_processes(grid))
    validate(cfg, mesh, grid.dp_attention)
    if cfg.is_moe and moe_mode not in ("dense", "dispatch"):
        raise ValueError(f"a sharded MoE step runs 'dense' or 'dispatch', "
                         f"not {moe_mode!r} (parallel/sharding."
                         "resolve_moe_mode)")


def _tp_embed(cfg: ModelConfig, group, states, toks, embeds, masks):
    """The embeddings on every rank: each rank looks up the tokens of
    its vocab slice, and the parts sum to the whole lookup."""
    rows = states[0]["embed"].shape[0]
    parts = [None] * group.tp
    for r in group.local:
        with group.on(r):
            parts[r] = _embed_rows(states[r]["embed"], toks[r], r * rows)
    xs = group.all_reduce(parts)
    out = [None] * group.tp
    for r in group.local:
        with group.on(r):
            out[r] = _embed_finish(cfg, xs[r], embeds[r], masks[r])
    return out


def _tp_head(cfg: ModelConfig, rcfg: ModelConfig, group, states, xs,
             select, hidden: bool) -> torch.Tensor:
    """The final norm, `select(r, x)` (the sampled rows), then the hidden
    state of rank 0 (`hidden`) or the full-vocab logits gathered from
    the ranks' columns, on rank 0 (spanning processes: on each one's
    lead rank; None where this process has no rank of the group)."""
    if not group.local:
        return None
    outs = [None] * group.tp
    for r in group.local:
        with group.on(r):
            x = select(r, rms_norm(xs[r], states[r]["final_norm"],
                                   cfg.rms_norm_eps, cfg.rms_offset))
            outs[r] = x if hidden else _lm_head(rcfg, states[r], x)
    if hidden:
        # The last token's final-norm hidden state is the embedding (the
        # causal-LM convention).
        with group.on(group.lead):
            return outs[group.lead].float()
    return group.all_gather(outs, dim=-1)


def _grid_rank_config(cfg: ModelConfig, grid) -> ModelConfig:
    """One rank's geometry: its tp slice's heads under plain dp; every
    head under dp-attention (the attention weights replicate), with its
    intermediate columns and vocab slice in both."""
    if not grid.dp_attention:
        return rank_config(cfg, grid.tp)
    return cfg.replace(intermediate_size=cfg.intermediate_size // grid.tp,
                       vocab_size=cfg.vocab_size // grid.tp)


def _grid_shards(grid, state, cache) -> None:
    n_cache = grid.attention.n
    if not isinstance(state, list) or len(state) != grid.n or \
            not isinstance(cache, list) or len(cache) != n_cache:
        mesh = (f"tp={grid.tp}" if grid.dp == grid.ep == grid.sp == 1
                else f"dp{grid.dp}xtp{grid.tp}" if grid.ep == grid.sp == 1
                else f"dp{grid.dp}xsp{grid.sp}xep{grid.ep}xtp{grid.tp}")
        caches = "" if n_cache == grid.n else f" ({n_cache} caches)"
        raise ValueError(f"a {mesh} step takes a list of {grid.n} rank "
                         f"states and caches{caches} (shard_state, "
                         "kv_cache.init_grid_caches)")


def _counted(grid, f: int, fn, *args, **kw):
    """Call a kernel wrapper and add its launches to flat rank f's
    count."""
    before = fn.launches + fn.launches_int8
    out = fn(*args, **kw)
    grid.launches[f] += fn.launches + fn.launches_int8 - before
    return out


def _grid_write(grid, cache, f: int, i: int, slots, k, v, routes) -> None:
    """Rank f's chunk rows [N, F] into every copy that holds them: the
    copies of its tp column band (plain dp), else along `routes`
    (`_grid_routes`); the copies another process holds take them at the
    step's end (`_exchange_writes`)."""
    if grid.writes_cross(f):
        # Copies in other processes take these rows at the step's end.
        grid.pending_writes.append((f, i, slots, k, v))
    if routes is not None:
        if routes:
            kvc.write_routed(routes, i, k, v)
        return
    for g in grid.holders(f % grid.tp):
        c = cache[g]
        if not kvc.held(c):
            continue
        dev = c["k"][i].device
        _write_chunk(c["k"][i], c["v"][i], *_layer_scales(c, i),
                     slots.to(dev), k.to(dev), v.to(dev))


def _exchange_writes(grid, cache) -> None:
    """The step's cache writes whose copies live in other processes
    (`grid.pending_writes`: rank, layer, slots, K rows, V rows), swapped
    through the fabric and written into this process's copies, each into
    the copies it would reach in one process.  Every process of a
    spanning grid joins, in step order."""
    if not grid.spans:
        return
    pending, grid.pending_writes = grid.pending_writes, []
    if not any(grid.writes_cross(f) for f in range(grid.n)):
        return
    dev = next(c for c in cache if kvc.held(c))["k"][0].device
    head, body = [], []
    for f, i, slots, k, v in pending:
        head += [f, i, slots.numel(), k.shape[1], _dtype_code(k.dtype)]
        body += [slots.reshape(-1).to(torch.int64).view(torch.uint8),
                 k.contiguous().reshape(-1).view(torch.uint8),
                 v.contiguous().reshape(-1).view(torch.uint8)]
    head_t = torch.tensor([len(pending)] + head, dtype=torch.int64)
    raw = torch.cat([head_t.view(torch.uint8).to(dev)]
                    + [b.to(dev) for b in body])
    got = grid.fabric.gather_bytes(raw, grid.fabric.world)
    for q, blob in enumerate(got):
        if q == grid.fabric.process_id:
            continue
        count = int(blob[:8].view(torch.int64).item())
        meta = blob[8:8 + 40 * count].view(torch.int64).reshape(
            count, 5).tolist()
        pos = 8 + 40 * count
        for f, i, N, F, code in meta:
            dtype = _DTYPE_CODES[code]
            slots = blob[pos:pos + 8 * N].view(torch.int64)
            pos += 8 * N
            size = N * F * dtype.itemsize
            k = blob[pos:pos + size].view(dtype).reshape(N, F)
            pos += size
            v = blob[pos:pos + size].view(dtype).reshape(N, F)
            pos += size
            _write_remote(grid, cache, f, i, slots, k, v)


_DTYPE_CODES = [torch.float32, torch.bfloat16, torch.float16]


def _dtype_code(dtype: torch.dtype) -> int:
    return _DTYPE_CODES.index(dtype)


def _write_remote(grid, cache, f: int, i: int, slots, k, v) -> None:
    """Another process's rank f's rows of layer i, into the copies this
    process holds of what f writes."""
    targets = [g for g in grid.write_targets(f) if grid.mine[g]]
    if not targets:
        return
    if grid.dp_attention:
        S = cache[0]["k"][0].shape[0]
        shards = [(cache[g], (g % grid.tp) * S) for g in targets]
        kvc.write_routed(kvc.write_routes(shards, slots), i, k, v)
        return
    for g in targets:
        c = cache[g]
        _write_chunk(c["k"][i], c["v"][i], *_layer_scales(c, i), slots,
                     k, v)


def _grid_routes(grid, cache, f: int, write_slots, read_slots, local: bool):
    """A slot-sharded rank's routes for a step, the same for every layer:
    its writes go to its own shard (`local`: dp-local decode, whose rows'
    pages all lie there) or to every copy of every shard; its reads come
    from its own shard or every shard its dp row sees.  (None, None)
    under plain dp; read routes None where the step reads no gathered
    context."""
    if not grid.dp_attention:
        return None, None
    own = [(cache[f], f * cache[f]["k"][0].shape[0])]
    writes = kvc.write_routes(own if local else kvc.slot_copies(cache, grid),
                              write_slots)
    if read_slots is None:
        return writes, None
    reads = own if local else kvc.slot_shards(cache, grid, f // grid.tp)
    return writes, kvc.read_routes(reads, read_slots)


def _local_tables(block_tables, f: int, pages_local: int):
    """JAX's dp-local rebase: rank f's shard-local page ids, clipped into
    its range (entries past a row's live pages are never read)."""
    return torch.clamp(block_tables - f * pages_local, 0,
                       pages_local - 1).to(torch.int32)


def _grid_moe(cfg: ModelConfig, grid, states, i: int, d: int, hs,
              moe_mode: str, loads: Dict[int, List[torch.Tensor]]):
    """Layer i's MoE sub-block of dp row d over its ep x tp ranks: hs[t]
    is the row's normed input on rank (d, 0, t); returns each tp slice's
    partial on (d, 0, t), which the row's `all_reduce` sums.

    - "dispatch": the row's tokens split over the ep ranks in contiguous
      ranges (JAX's `P(("dp", "ep"))`); each rank routes its range and
      runs the dispatch body (ops/moe._dispatch_shards, the all-to-alls
      over `grid.eps[d][t]`) on its E/ep experts' F/tp slices, and the
      ranges' partial outputs join on ep index 0.  The combine is linear,
      so the tp partials are summed after it, by the row's all_reduce
      (JAX psums the expert outputs before the combine).
    - "dense", ep 1: each tp rank runs `moe_dense` over its F/tp slices.
    - "dense", ep > 1: every ep rank sees the row's tokens, routes them
      from the gathered router columns and adds its experts' terms
      (`moe_dense_local`); the terms sum on ep index 0.

    `loads[f]` collects the [E+1] stats of each routing rank f: (d, e, 0)
    under dispatch, (d, 0, 0) otherwise, so the stats sum over dp and ep
    and never over tp."""
    ep, tp = grid.ep, grid.tp
    E = cfg.num_experts
    parts = [None] * tp
    for t in grid.rows[d].local:
        g = grid.eps[d][t]
        h = hs[t]
        with g.on(0):
            x = h.reshape(-1, h.shape[-1])
        ps = [states[grid.flat(d, e, t)]["layers"][i]["moe"]
              for e in range(ep)]
        if moe_mode == "dispatch":
            n = x.shape[0]
            if n % ep:
                raise ValueError(f"dispatch: a dp row's {n} tokens must "
                                 f"split over ep={ep}")
            cap = n // ep if cfg.moe_capacity is None else cfg.moe_capacity
            outs, stats = moe_ops._dispatch_shards(
                cfg, ps, g.scatter(x), cap, g if ep > 1 else None)
            out = g.gather(outs, 0)
            if t == 0:
                for e in range(ep):
                    loads.setdefault(grid.flat(d, e, 0), []).append(stats[e])
        elif ep == 1:
            with g.on(0):
                out, st = moe_ops.moe_dense(cfg, ps[0], h)
            if t == 0:
                loads.setdefault(grid.flat(d, 0, 0), []).append(st)
        else:
            xs = [g._move(e, 0, x) for e in range(ep)]
            logits = []
            for e in range(ep):
                with g.on(e):
                    logits.append(xs[e] @ ps[e]["router"])
            logits = g.all_gather(logits, -1)
            terms = []
            for e in range(ep):
                with g.on(e):
                    ids, gates = moe_ops.topk_of(cfg, logits[e], x.dtype)
                    terms.append(moe_ops.moe_dense_local(
                        cfg, ps[e], xs[e], ids, gates, e * (E // ep)))
                    if e == 0 and t == 0:
                        loads.setdefault(grid.flat(d, 0, 0), []).append(
                            moe_ops._with_drop_tail(moe_ops._counts(ids, E)))
            out = g.reduce(terms)
        with g.on(0):
            parts[t] = out.to(h.dtype).reshape(h.shape)
    return parts


def _grid_layers(cfg: ModelConfig, grid, states, xs, attend, moe_mode: str,
                 loads: List[torch.Tensor], rows_dim: int):
    """Every decoder layer over the grid, the dp rows interleaved layer by
    layer so that every row's stream has work queued: `attend(d, t, i,
    p_attn, h)` is rank (d, 0, t)'s part of layer i's attention output,
    its heads' partial (summed by `all_reduce`) or, under dp-attention,
    its rows' whole output (joined along `rows_dim` by `all_gather_all`).
    An MoE layer runs `_grid_moe`; its stats are summed a rank and
    appended to `loads` on the caller's stream."""
    off = cfg.rms_offset
    tp = grid.tp
    moe_loads: Dict[int, List[torch.Tensor]] = {}
    for i in range(cfg.num_layers):
        for d, row in enumerate(grid.rows):
            if not row.local:
                continue            # another process's row
            x_row = xs[d]
            st = grid.row_states(states, d)
            parts = [None] * tp
            for t in row.local:
                with row.on(t):
                    layer = st[t]["layers"][i]
                    parts[t] = attend(d, t, i, layer["attn"], rms_norm(
                        x_row[t], layer["attn_norm"], cfg.rms_norm_eps, off))
            attn = (row.all_gather_all(parts, rows_dim) if grid.dp_attention
                    else row.all_reduce(parts))
            hs = [None] * tp
            for t in row.local:
                with row.on(t):
                    x_row[t], hs[t] = _mlp_in(cfg, st[t]["layers"][i],
                                              x_row[t], attn[t])
            if cfg.is_moe:
                parts = _grid_moe(cfg, grid, states, i, d, hs, moe_mode,
                                  moe_loads)
            else:
                parts = [None] * tp
                for t in row.local:
                    with row.on(t):
                        parts[t] = _dense_mlp(st[t]["layers"][i]["mlp"],
                                              hs[t], cfg.activation)
            mlp = row.all_reduce(parts)
            for t in row.local:
                with row.on(t):
                    x_row[t] = _mlp_out(cfg, st[t]["layers"][i], x_row[t],
                                        mlp[t])
    homed = []
    for f, got in moe_loads.items():
        with grid.on(f):
            total = torch.stack(got).sum(0, dtype=torch.int32)
        homed.append(grid.home(f, total))
    if grid.spans and cfg.is_moe:
        # Every process's routing ranks' load, summed on each.
        E1 = cfg.num_experts + 1
        mine = (torch.stack(homed).sum(0, dtype=torch.int32) if homed
                else torch.zeros((E1,), dtype=torch.int32,
                                 device=grid.fabric.device))
        homed = [grid.sum_world(mine)]
    loads.extend(homed)
    return xs


def _grid_embed(cfg: ModelConfig, grid, states, toks, embs, masks):
    """Each row's embeddings on its ranks (`toks[d]` etc. replicated
    per rank of row d)."""
    tp = grid.tp
    out = []
    for d, row in enumerate(grid.rows):
        st = grid.row_states(states, d)
        if not row.local:
            out.append([None] * tp)         # another process's row
        elif tp == 1:
            with row.on(0):
                out.append([_embed(cfg, st[0], toks[d][0], embs[d][0],
                                   masks[d][0])])
        else:
            out.append(_tp_embed(cfg, row, st, toks[d], embs[d], masks[d]))
    return out


def _grid_split(grid, tensors, dim: int = 0):
    """Row d's contiguous share of each tensor along `dim`: views, taken
    on the caller's stream before the fork; None stays None."""
    return [[None if t is None else t.narrow(
                dim, d * (t.shape[dim] // grid.dp), t.shape[dim] // grid.dp)
             for d in range(grid.dp)] for t in tensors]


def _grid_spread(grid, shares):
    """Each row's shares replicated over its ranks, after the fork:
    `out[k][d][t]` is tensor k of row d on rank t."""
    return [[row.replicate(t) if t is not None and row.local
             else [None] * grid.tp
             for row, t in zip(grid.rows, share)] for share in shares]


def _grid_forward(cfg: ModelConfig, block_size: int, grid, use_kernel: bool,
                  moe_mode: str, return_hidden: bool, state, cache,
                  tokens, positions, seq_lens, block_tables,
                  sample_positions, input_embeds, embed_mask):
    """The unified step over a DpGrid (module docstring)."""
    B, T = tokens.shape
    dp, tp = grid.dp, grid.tp
    split = grid.attention.n if grid.dp_attention else dp
    if B % split:
        raise ValueError(
            f"{grid.mode}: batch {B} must be a multiple of "
            f"{'dp*tp' if grid.dp_attention else 'dp'} = {split}")
    _grid_shards(grid, state, cache)
    rcfg = _grid_rank_config(cfg, grid)
    Bd, Br = B // dp, B // split
    P = block_tables.shape[1]
    bt = block_tables.to(torch.int32)
    sl = seq_lens.to(torch.int32)
    write_slots = kvc.slots_for_positions(bt, positions, block_size)
    kernel = use_kernel and T == 1
    local = grid.dp_local and T == 1
    ctx_slots = ctx_pos = None
    if not kernel:
        ctx_pos = torch.arange(P * block_size, device=tokens.device).expand(
            B, P * block_size)
        ctx_slots = kvc.slots_for_positions(bt, ctx_pos, block_size)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    shares = _grid_split(grid, (
        tokens, positions, sl, bt, write_slots, ctx_slots, ctx_pos,
        sample_positions, input_embeds, embed_mask, cos, sin))
    grid.fork()
    (tok, pos, sls, bts, ws, cs, cp, smp, emb, msk, cos, sin) = (
        _grid_spread(grid, shares))
    xs = _grid_embed(cfg, grid, state, tok, emb, msk)
    S = cache[0]["k"][0].shape[0]
    pages_local = S // block_size

    routes = {}

    def attend(d, t, i, p_attn, h):
        f = d * tp + t
        c = cache[f]
        rows = slice(None) if not grid.dp_attention else slice(
            t * Br, (t + 1) * Br)
        h = h[rows]
        n = h.shape[0]
        if f not in routes:
            routes[f] = _grid_routes(
                grid, cache, f, ws[d][t][rows].reshape(n * T),
                None if kernel else cs[d][t][rows], local)
        q, k, v = _qkv(rcfg, p_attn, h, (cos[d][t][rows], sin[d][t][rows]))
        _grid_write(grid, cache, f, i, ws[d][t][rows].reshape(n * T),
                    k.reshape(n * T, rcfg.kv_size),
                    v.reshape(n * T, rcfg.kv_size), routes[f][0])
        ks, vs = _layer_scales(c, i)
        if kernel:
            tables = bts[d][t][rows]
            if grid.dp_attention:
                tables = _local_tables(tables, f, pages_local)
            out = _counted(
                grid, grid.flat(d, 0, t), paged_decode_attention,
                q[:, 0].contiguous(),
                c["k"][i], c["v"][i], tables, sls[d][t][rows],
                block_size=block_size, scale=rcfg.query_scale,
                soft_cap=rcfg.attn_soft_cap, k_scale=ks,
                v_scale=vs)[:, None]
        else:
            slots = cs[d][t][rows]
            if grid.dp_attention:
                k_ctx, v_ctx = kvc.gather_routed(
                    routes[f][1], i, tuple(slots.shape), rcfg.num_kv_heads,
                    q.dtype, slots.device)
            elif ks is not None:
                k_ctx, v_ctx = kvc.gather_kv_quant(
                    c["k"][i], c["v"][i], ks, vs, slots, rcfg.num_kv_heads,
                    out_dtype=q.dtype)
            else:
                k_ctx, v_ctx = kvc.gather_kv(c["k"][i], c["v"][i], slots,
                                             rcfg.num_kv_heads)
            out = paged_attention(q, k_ctx, v_ctx, pos[d][t][rows],
                                  cp[d][t][rows], sls[d][t][rows],
                                  scale=rcfg.query_scale,
                                  soft_cap=rcfg.attn_soft_cap)
        return out.reshape(n, T, rcfg.q_size) @ p_attn["wo"]

    loads: List[torch.Tensor] = []
    xs = _grid_layers(cfg, grid, state, xs, attend, moe_mode, loads, 0)
    outs = []
    for d, row in enumerate(grid.rows):
        def select(t, x, d=d):
            if sample_positions is None:
                return x
            return x[torch.arange(Bd, device=x.device), smp[d][t].long()]

        outs.append(_tp_head(cfg, rcfg, row, grid.row_states(state, d),
                             xs[d], select, return_hidden))
    out = grid.gather_rows(outs)
    grid.join()
    _exchange_writes(grid, cache)
    return out, cache, loads


def _packed_gather_attention(rcfg: ModelConfig, q, routes, i: int,
                             ctx_pos, seq_lens, seg, positions):
    """Packed prefill attention on the gather path: each token attends
    its segment's context [R, C] (`ctx_pos`), read along `routes` from
    the slot shards that hold it (non-local dp-attention runs no kernel,
    as JAX's capability table sends it).  q [N, Hq, D], seg [N] the
    token's segment row."""
    k_ctx, v_ctx = kvc.gather_routed(routes, i, tuple(ctx_pos.shape),
                                     rcfg.num_kv_heads, q.dtype, q.device)
    seg = seg.long()
    out = paged_attention(q[:, None], k_ctx[seg], v_ctx[seg],
                          positions[:, None], ctx_pos[seg], seq_lens[seg],
                          scale=rcfg.query_scale, soft_cap=rcfg.attn_soft_cap)
    return out[:, 0]


def _grid_packed(cfg: ModelConfig, block_size: int, grid, moe_mode: str,
                 state, cache, tokens, positions, seg_ids, block_tables,
                 q_starts, q_lens, seq_lens, sample_positions, input_embeds,
                 embed_mask):
    """The packed prefill over a DpGrid.  The pack is grid-shaped: its
    token axis and its segments split into equal contiguous groups, one
    per dp row (dp-attention: per rank), group g's segments lying in its
    token range; `q_starts` and `sample_positions` index the whole pack."""
    T, R = tokens.shape[0], block_tables.shape[0]
    dp, tp = grid.dp, grid.tp
    split = grid.attention.n if grid.dp_attention else dp
    if T % split or R % split:
        raise ValueError(
            f"{grid.mode}: a packed prefill of {T} tokens and {R} segments "
            f"must split into {split} equal groups")
    _grid_shards(grid, state, cache)
    rcfg = _grid_rank_config(cfg, grid)
    Tg, Rg = T // split, R // split
    Td, Rd = T // dp, R // dp
    bt = block_tables.to(torch.int32)
    seg = seg_ids.long()
    write_slots = kvc.slots_for_positions(
        bt[seg], positions[:, None], block_size).reshape(T)
    r_idx = torch.arange(R, device=tokens.device)
    # Each segment's start within its group (attention) and each
    # sample position within its dp row (the head); a pad segment's
    # (zeros) clamp into its group.
    qs_group = (q_starts.long() - (r_idx // Rg) * Tg).clamp(0, Tg).to(
        torch.int32)
    smp_row = (sample_positions.long() - (r_idx // Rd) * Td).clamp(0, Td - 1)
    # Each token's segment row within its group (pad tokens: clamped).
    t_idx = torch.arange(T, device=tokens.device)
    seg_group = (seg - (t_idx // Tg) * Rg).clamp(0, Rg - 1)
    cos, sin = rope_tables(positions[None], cfg.head_dim, cfg.rope_theta)
    tok_shares = _grid_split(grid, (
        tokens, positions, write_slots, seg_group, input_embeds,
        embed_mask))
    seg_shares = _grid_split(grid, (
        bt, seq_lens.to(torch.int32), qs_group, q_lens.to(torch.int32),
        smp_row))
    rot_shares = _grid_split(grid, (cos, sin), dim=1)
    grid.fork()
    tok, pos, ws, sg, emb, msk = _grid_spread(grid, tok_shares)
    bts, sls, qss, qls, smp = _grid_spread(grid, seg_shares)
    cos, sin = _grid_spread(grid, rot_shares)
    xs = [[None if x is None else x[None] for x in row]
          for row in _grid_embed(cfg, grid, state, tok, emb, msk)]
    S = cache[0]["k"][0].shape[0]
    pages_local = S // block_size
    gather = grid.dp_attention and not grid.dp_local
    routes = {}

    def attend(d, t, i, p_attn, h):
        f = d * tp + t
        c = cache[f]
        toks = slice(None) if not grid.dp_attention else slice(
            t * Tg, (t + 1) * Tg)
        segs = slice(None) if not grid.dp_attention else slice(
            t * Rg, (t + 1) * Rg)
        h = h[:, toks]
        n = h.shape[1]
        tables, lens = bts[d][t][segs], sls[d][t][segs]
        if f not in routes:
            ctx_pos = ctx_slots = None
            if gather:
                R_, P_ = tables.shape
                ctx_pos = torch.arange(P_ * block_size,
                                       device=tables.device).expand(
                    R_, P_ * block_size)
                ctx_slots = kvc.slots_for_positions(tables, ctx_pos,
                                                    block_size)
            routes[f] = _grid_routes(grid, cache, f, ws[d][t][toks],
                                     ctx_slots, grid.dp_local) + (ctx_pos,)
        q, k, v = _qkv(rcfg, p_attn, h, (cos[d][t][:, toks],
                                         sin[d][t][:, toks]))
        _grid_write(grid, cache, f, i, ws[d][t][toks],
                    k.reshape(n, rcfg.kv_size), v.reshape(n, rcfg.kv_size),
                    routes[f][0])
        ks, vs = _layer_scales(c, i)
        starts = qss[d][t][segs]
        if gather:
            out = _packed_gather_attention(
                rcfg, q[0], routes[f][1], i, routes[f][2], lens,
                sg[d][t][toks], pos[d][t][toks])
        else:
            if grid.dp_local:
                tables = _local_tables(tables, f, pages_local)
            out = _counted(
                grid, grid.flat(d, 0, t), paged_prefill_attention,
                q[0].contiguous(),
                c["k"][i], c["v"][i], tables, lens, starts,
                qls[d][t][segs], block_size=block_size,
                scale=rcfg.query_scale, soft_cap=rcfg.attn_soft_cap,
                k_scale=ks, v_scale=vs)
        return out.reshape(1, n, rcfg.q_size) @ p_attn["wo"]

    loads: List[torch.Tensor] = []
    xs = _grid_layers(cfg, grid, state, xs, attend, moe_mode, loads, 1)
    outs = []
    for d, row in enumerate(grid.rows):
        outs.append(_tp_head(cfg, rcfg, row, grid.row_states(state, d),
                             xs[d], lambda t, x, d=d: x[0][smp[d][t].long()],
                             False))
    logits = grid.gather_rows(outs)
    grid.join()
    _exchange_writes(grid, cache)
    return logits, cache, loads


def _sp_write(grid, cache, f: int, i: int, slots, rows) -> None:
    """The ring prefill's chunk rows of (dp row, tp slice) f = d * tp + t,
    gathered on rank (d, 0, t), into every copy of tp slice t's cache
    (`_sp_write_rows`)."""
    for g in grid.holders(f % grid.tp):
        dev = cache[g]["k"][i].device
        _sp_write_rows(cache[g], i, slots.to(dev), [r.to(dev) for r in rows])


def _grid_sp_forward(cfg: ModelConfig, block_size: int, grid,
                     use_kernel: bool, state, cache, tokens, positions,
                     block_tables, sample_positions):
    """The whole-prompt ring prefill over a DpGrid with an sp axis (JAX's
    `sp_prefill` plane on a (dp, sp, tp) mesh).  The chunk is the WHOLE
    prompt of every row, as `_sp_forward`'s; rows split over the dp rows
    in contiguous ranges and T over sp.  Rank (d, s, t) runs every
    token-wise op of token slice s of row d's rows with tp slice t's
    weights (`rank_config`: its heads, its MLP columns, its vocab
    slice): the embedding summed over t, its heads projected (int8 rows
    and scales quantized once, on the rank that made them), `wo` and the
    MLP's down projection all-reduced over t within (d, s).  Attention
    runs on (d, t)'s ring over its s ranks, carrying slice t's K/V only.
    The chunk's rows gather on rank (d, 0, t) and are written into every
    copy of slice t's cache (`_sp_write`), so after the step the cache
    holds what a grid prefill of the same prompts writes.  The sampled
    rows' candidates gather on (d, 0, t); the vocab-sharded head gathers
    over t as `_tp_head`'s, and the logits come home to rank 0.  Each
    ring's part is `_sp_forward`'s own (`_sp_qkv`, `_sp_ring_layer`,
    `_sp_sample_rows`)."""
    R, T = tokens.shape
    dp, sp, tp = grid.dp, grid.sp, grid.tp
    if T % sp:
        raise ValueError(f"sp prefill: chunk length {T} must divide by "
                         f"sp={sp}")
    if R % dp:
        raise ValueError(f"sp prefill: {R} rows must split over dp={dp}")
    if sample_positions is None:
        raise ValueError("sp prefill gives one logits row per sequence: "
                         "pass sample_positions")
    _grid_shards(grid, state, cache)
    rcfg = rank_config(cfg, tp)
    quant = kvc.cache_is_quantized(cache[0])
    t_loc, Rd = T // sp, R // dp
    bt = block_tables.to(torch.int32)
    write_slots = kvc.slots_for_positions(bt, positions, block_size)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    smp = sample_positions.long()
    # (d, s)'s shares, views taken on the caller's stream before the fork;
    # the write slots and the sample positions are whole rows of row d.
    shares = [[[t.narrow(0, d * Rd, Rd).narrow(1, s * t_loc, t_loc)
                for t in (tokens, positions, cos, sin)]
               for s in range(sp)] for d in range(dp)]
    rows_of = [[t.narrow(0, d * Rd, Rd) for t in (write_slots, smp)]
               for d in range(dp)]
    grid.fork(sp=True)
    # ins[d][s][k][t]: input k of rank (d, s, t).
    ins = [[[g.replicate(x) for x in shares[d][s]]
            for s, g in enumerate(grid.sp_tps[d])] for d in range(dp)]
    ws = [grid.rows[d].replicate(rows_of[d][0].reshape(Rd * T))
          for d in range(dp)]
    smps = [[g.replicate(rows_of[d][1]) for g in grid.sp_tps[d]]
            for d in range(dp)]
    sts = [[grid.row_states(state, d, s) for s in range(sp)]
           for d in range(dp)]
    xs = []
    for d in range(dp):
        xs.append([])
        for s, g in enumerate(grid.sp_tps[d]):
            toks = ins[d][s][0]
            if tp == 1:
                with g.on(0):
                    xs[d].append([_embed(cfg, sts[d][s][0], toks[0])])
            else:
                xs[d].append(_tp_embed(cfg, g, sts[d][s], toks,
                                       [None] * tp, [None] * tp))
    off = cfg.rms_offset
    for i in range(cfg.num_layers):
        for d in range(dp):
            # qkv[s][t]: `_sp_qkv` of rank (d, s, t).
            qkv = []
            for s, g in enumerate(grid.sp_tps[d]):
                qkv.append([])
                for t in range(tp):
                    with g.on(t):
                        layer = sts[d][s][t]["layers"][i]
                        h = rms_norm(xs[d][s][t], layer["attn_norm"],
                                     cfg.rms_norm_eps, off)
                        qkv[s].append(_sp_qkv(
                            rcfg, layer["attn"], h,
                            (ins[d][s][2][t], ins[d][s][3][t]), quant))
            attn = [[None] * tp for _ in range(sp)]
            for t in range(tp):
                outs = _sp_ring_layer(
                    rcfg, grid.rings[d][t], use_kernel,
                    [qkv[s][t] for s in range(sp)],
                    [ins[d][s][1][t] for s in range(sp)],
                    functools.partial(_sp_write, grid, cache, d * tp + t, i,
                                      ws[d][t]),
                    [sts[d][s][t]["layers"][i]["attn"]["wo"]
                     for s in range(sp)])
                for s in range(sp):
                    attn[s][t] = outs[s]
            for s, g in enumerate(grid.sp_tps[d]):
                st, x = sts[d][s], xs[d][s]
                summed = g.all_reduce(attn[s])
                hs = []
                for t in range(tp):
                    with g.on(t):
                        x[t], h = _mlp_in(cfg, st[t]["layers"][i], x[t],
                                          summed[t])
                        hs.append(_dense_mlp(st[t]["layers"][i]["mlp"], h,
                                             cfg.activation))
                mlp = g.all_reduce(hs)
                for t in range(tp):
                    with g.on(t):
                        x[t] = _mlp_out(cfg, st[t]["layers"][i], x[t], mlp[t])
    # (d, 0, t) keeps the sampled rows' owners (`_sp_sample_rows`) and
    # runs its vocab slice of the head.
    outs = []
    for d in range(dp):
        heads = []
        for t in range(tp):
            ring = grid.rings[d][t]
            sel = _sp_sample_rows(
                cfg, ring, [xs[d][s][t] for s in range(sp)],
                [sts[d][s][t]["final_norm"] for s in range(sp)],
                [smps[d][s][t] for s in range(sp)], t_loc)
            with ring.on(0):
                heads.append(_lm_head(rcfg, sts[d][0][t], sel))
        outs.append(grid.rows[d].all_gather(heads, dim=-1))
    logits = grid.gather_rows(outs)
    grid.join(sp=True)
    return logits, cache


# ---------------------------------------------------------------------------
# Forward


def make_forward_step(cfg: ModelConfig, block_size: int,
                      use_decode_kernel: bool = False,
                      moe_mode: str = "dense",
                      with_expert_load: bool = False,
                      sp_ring=None,
                      sp_ring_kernel: bool = False,
                      return_hidden: bool = False,
                      tp=None):
    """The unified prefill/decode step for one cache geometry.  With
    `use_decode_kernel`, T == 1 calls attend through the paged-decode
    kernel (its plain version for CPU tensors); everything else takes the
    gather path.  `with_expert_load` makes the step return (logits, cache,
    stats [E+1]) — the MoE layers' summed expert load.

    `sp_ring` (an SpRing): sequence-parallel FULL-PROMPT prefill — a T > 1
    chunk is cut over the ring's ranks and attends itself on the ring.
    The chunk must be the whole sequence (no cached context is read) and
    T must divide by sp; build it with
    parallel.sharding.make_sp_prefill_step.  `sp_ring_kernel` sends
    eligible geometry through the flash-fold kernel in place of the plain
    ring.  On a grid with an sp axis `sp_ring` is the grid itself (`tp`),
    and a T > 1 call is `_grid_sp_forward`.

    `tp` (a DpGrid): the sharded step over per-rank states and caches
    (module docstring); inputs and outputs lie on rank 0's card.  `tp`
    a PpStages: the pipelined step (parallel/pipeline.make_pp_step, its
    `microbatches` GPipe microbatches) over per-stage states and caches.

    `return_hidden` (the embeddings step): the step returns the
    final-norm hidden state at `sample_positions` in f32 ([B, H]) in
    place of the logits and skips the LM head."""
    cfg.validate()
    if return_hidden and (sp_ring is not None or with_expert_load):
        raise ValueError("return_hidden takes neither sp_ring nor "
                         "with_expert_load")
    stages = _stages(tp)
    if stages is not None:
        from dynamo_tpu_torch.parallel.pipeline import make_pp_step

        _pp_refusals(stages, sp_ring, with_expert_load, return_hidden)
        return make_pp_step(cfg, block_size, stages, stages.microbatches,
                            use_decode_kernel=use_decode_kernel)
    grid = _grid(tp)
    if grid is not None:
        _check_grid(cfg, grid, sp_ring, use_decode_kernel, moe_mode)
        if sp_ring is not None and (sp_ring is not grid
                                    or getattr(grid, "sp", 1) < 2):
            raise ValueError("a grid's ring prefill runs on the grid's own "
                             "sp axis: pass the DpGrid (sp > 1) as sp_ring")

        def grid_step(state, cache, tokens, positions, seq_lens,
                      block_tables, sample_positions=None,
                      input_embeds=None, embed_mask=None):
            if sp_ring is not None and tokens.shape[1] > 1:
                if input_embeds is not None or return_hidden:
                    raise ValueError("the sp ring prefill takes no "
                                     "input_embeds")
                return _grid_sp_forward(
                    cfg, block_size, grid, sp_ring_kernel, state, cache,
                    tokens, positions, block_tables, sample_positions)
            out, cache, loads = _grid_forward(
                cfg, block_size, grid, use_decode_kernel, moe_mode,
                return_hidden, state, cache, tokens, positions, seq_lens,
                block_tables, sample_positions, input_embeds, embed_mask)
            if with_expert_load:
                return out, cache, _expert_load(loads, out.device)
            return out, cache

        return grid_step

    def step(state: State, cache: Dict, tokens: torch.Tensor,
             positions: torch.Tensor, seq_lens: torch.Tensor,
             block_tables: torch.Tensor,
             sample_positions: Optional[torch.Tensor] = None,
             input_embeds: Optional[torch.Tensor] = None,
             embed_mask: Optional[torch.Tensor] = None):
        B, T = tokens.shape
        if input_embeds is not None and sp_ring is not None:
            raise ValueError("the sp ring prefill takes no input_embeds")
        if sp_ring is not None and T > 1:
            return _sp_forward(cfg, block_size, sp_ring, sp_ring_kernel,
                               state, cache, tokens, positions, block_tables,
                               sample_positions)
        P = block_tables.shape[1]
        block_tables = block_tables.to(torch.int32)
        seq_lens = seq_lens.to(torch.int32)
        write_slots = kvc.slots_for_positions(
            block_tables, positions, block_size).reshape(B * T)
        if use_decode_kernel and T == 1:
            ctx_positions = ctx_slots = None
        else:
            ctx_positions = torch.arange(
                P * block_size, device=tokens.device).expand(B, P * block_size)
            ctx_slots = kvc.slots_for_positions(block_tables, ctx_positions,
                                                block_size)
        x = _embed(cfg, state, tokens, input_embeds, embed_mask)
        rot = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        loads: List[torch.Tensor] = []
        x = _decoder_layers(cfg, state["layers"], cache, x, positions, rot,
                            seq_lens, write_slots, ctx_slots, ctx_positions,
                            block_tables, block_size, moe_mode, loads)
        x = rms_norm(x, state["final_norm"], cfg.rms_norm_eps, cfg.rms_offset)
        if sample_positions is not None:
            x = x[torch.arange(B, device=x.device), sample_positions.long()]
        if return_hidden:
            # The last token's final-norm hidden state is the embedding
            # (the causal-LM convention).
            return x.float(), cache
        logits = _lm_head(cfg, state, x)
        if with_expert_load:
            return logits, cache, _expert_load(loads, x.device)
        return logits, cache

    return step


# ---------------------------------------------------------------------------
# Packed ragged prefill


def make_packed_prefill_step(cfg: ModelConfig, block_size: int,
                             moe_mode: str = "dense", tp=None):
    """Packed ragged prefill: several sequences' chunks ride one flat [T]
    token axis ("segments") and attention runs through the paged-prefill
    kernel straight from the block pool.

        logits, cache = step(state, cache, tokens[T], positions[T],
                             seg_ids[T], block_tables[R, P], q_starts[R],
                             q_lens[R], seq_lens[R], sample_positions[R])

    Pad rows carry the engine's pad position (null-block writes); logits
    come back [R, V], one row per segment (pad segments give junk rows).
    An int8 pool attends through the prefill kernel's int8 body.
    A MoE model's step returns a third output, the [E+1] expert load.
    `input_embeds [T, H]` with `embed_mask [T]` (the multimodal prefill):
    masked positions take those embeddings in place of the token lookup;
    a batch mixes such segments with plain ones freely.  `tp` (a
    DpGrid): the pack is grid-shaped (`_grid_packed`) and each rank runs
    the kernel on its heads and cache shard; a PpStages: the pack rides
    the stages as one microbatch, each stage running the kernel on its
    own layers (parallel/pipeline.make_pp_packed_prefill_step)."""
    cfg.validate()
    stages = _stages(tp)
    if stages is not None:
        from dynamo_tpu_torch.parallel.pipeline import (
            make_pp_packed_prefill_step)

        return make_pp_packed_prefill_step(cfg, block_size, stages)
    grid = _grid(tp)
    if grid is not None:
        _check_grid(cfg, grid, moe_mode=moe_mode)

        def grid_step(state, cache, tokens, positions, seg_ids,
                      block_tables, q_starts, q_lens, seq_lens,
                      sample_positions, input_embeds=None, embed_mask=None):
            logits, cache, loads = _grid_packed(
                cfg, block_size, grid, moe_mode, state, cache, tokens,
                positions, seg_ids, block_tables, q_starts, q_lens,
                seq_lens, sample_positions, input_embeds, embed_mask)
            if cfg.is_moe:
                return logits, cache, _expert_load(loads, logits.device)
            return logits, cache

        return grid_step

    def step(state, cache, tokens, positions, seg_ids, block_tables,
             q_starts, q_lens, seq_lens, sample_positions,
             input_embeds=None, embed_mask=None):
        T = tokens.shape[0]
        block_tables = block_tables.to(torch.int32)
        bt_tok = block_tables[seg_ids.long()]                     # [T, P]
        write_slots = kvc.slots_for_positions(
            bt_tok, positions[:, None], block_size).reshape(T)
        x = _embed(cfg, state, tokens, input_embeds,
                   embed_mask)[None]                               # [1, T, H]
        rot = rope_tables(positions[None], cfg.head_dim, cfg.rope_theta)
        args = (block_tables, seq_lens.to(torch.int32),
                q_starts.to(torch.int32), q_lens.to(torch.int32))
        loads: List[torch.Tensor] = []
        x = _packed_layers(cfg, state["layers"], cache, x, rot, write_slots,
                           args, block_size, moe_mode, loads)
        x = rms_norm(x, state["final_norm"], cfg.rms_norm_eps, cfg.rms_offset)
        sel = x[0][sample_positions.long()]                       # [R, H]
        logits = _lm_head(cfg, state, sel)
        if cfg.is_moe:
            return logits, cache, _expert_load(loads, x.device)
        return logits, cache

    return step


# ---------------------------------------------------------------------------
# Decode window


def make_decode_window(cfg: ModelConfig, block_size: int, window: int,
                       use_decode_kernel: bool = False,
                       greedy_only: bool = False,
                       moe_mode: str = "dense",
                       with_expert_load: bool = False, tp=None):
    """K decode steps per call with the sampled token fed back on the
    device (a Python loop in place of JAX's `fori_loop`; no host sync
    inside).

        cache, tokens[K, B], positions0 + K, seq_lens0 + K, offsets + K =
            run(state, cache, last_tokens[B], positions0[B], seq_lens0[B],
                block_tables[B, P], temp[B], top_k[B], top_p[B],
                seeds[B], key_offsets[B])

    `seeds` / `key_offsets` are host sequences: row b's draw at window step
    i is keyed by (seeds[b], key_offsets[b] + i) (see sampling.sample);
    greedy rows carry seed None.  Pad rows (seq_lens0 == 0) stay dead: their
    positions and lengths do not advance.  `with_expert_load` appends the
    window's summed [E+1] expert load to the returned tuple.  `tp` (a
    DpGrid): every step runs over the grid and samples the gathered
    full-vocab logits on rank 0's card; a PpStages: every step is the
    pipelined one (parallel/pipeline.make_pp_decode_window)."""
    stages = _stages(tp)
    if stages is not None:
        from dynamo_tpu_torch.parallel.pipeline import make_pp_decode_window

        _pp_refusals(stages, with_expert_load=with_expert_load)
        return make_pp_decode_window(cfg, block_size, stages,
                                     stages.microbatches, window,
                                     greedy_only=greedy_only,
                                     use_decode_kernel=use_decode_kernel)
    step = make_forward_step(cfg, block_size, use_decode_kernel, moe_mode,
                             with_expert_load, tp=tp)
    return _window_loop(step, window, greedy_only, with_expert_load)


def _window_loop(step, window: int, greedy_only: bool,
                 with_expert_load: bool):
    """`make_decode_window`'s run() over one step function: K calls of
    `step`, each fed the tokens the last one sampled, on the device."""
    from dynamo_tpu_torch.engine.sampling import sample

    def run(state, cache, last_tokens, positions0, seq_lens0, block_tables,
            temp, top_k, top_p, seeds: Sequence, key_offsets: Sequence):
        B = last_tokens.shape[0]
        dev = last_tokens.device
        zero_pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        live = seq_lens0 > 0
        out = torch.empty((window, B), dtype=torch.int32, device=dev)
        toks = last_tokens
        loads: List[torch.Tensor] = []
        for i in range(window):
            adv = live.to(positions0.dtype) * i
            res = step(state, cache, toks[:, None],
                       (positions0 + adv)[:, None], seq_lens0 + adv,
                       block_tables, zero_pos)
            logits, cache = res[:2]
            loads.extend(res[2:])
            if greedy_only:
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                toks = sample(logits, temp, top_k, top_p, seeds,
                              [o + i for o in key_offsets])
            out[i] = toks
        adv = live.to(positions0.dtype) * window
        base = (cache, out, positions0 + adv, seq_lens0 + adv,
                [o + window for o in key_offsets])
        if with_expert_load:
            return base + (_expert_load(loads, dev),)
        return base

    return run
