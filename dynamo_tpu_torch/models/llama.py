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
- MoE layers run `moe_mode` "dense" (the exact oracle) or "grouped" (the
  grouped-expert kernel, ops/cuda/moe_grouped.py) and give an [E+1]
  expert-load stats vector each; `with_expert_load` (and the packed
  prefill step of a MoE model) returns their sum over the layers as a
  third output, as in the JAX package.

Matrix products stay `torch.matmul`, as the JAX package left them to XLA.
"""

from __future__ import annotations

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
    x = state["embed"][tokens.long()]
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


def _layer_tail(cfg: ModelConfig, layer: State, x: torch.Tensor,
                attn_out: torch.Tensor, moe_mode: str,
                loads: List[torch.Tensor]) -> torch.Tensor:
    """Residual add of the attention output, then the MLP or MoE
    sub-block; a MoE layer appends its [E+1] stats to `loads`."""
    off = cfg.rms_offset
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, layer["post_attn_norm"],
                            cfg.rms_norm_eps, off)
    x = x + attn_out
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps, off)
    if cfg.is_moe:
        moe_out, load = _moe_block(cfg, layer["moe"], h, moe_mode)
        loads.append(load)
        return x + moe_out
    mlp_out = _dense_mlp(layer["mlp"], h, cfg.activation)
    if cfg.post_norms:
        mlp_out = rms_norm(mlp_out, layer["post_mlp_norm"],
                           cfg.rms_norm_eps, off)
    return x + mlp_out


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

    For ranks on a card the choice is `ring_kernel_supported`, the same
    predicate the engine's kernel-path counter reads, so the two cannot
    disagree on which ring a geometry runs.  A geometry the kernel does
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


def _sp_attention_layer(cfg: ModelConfig, ring, use_kernel: bool,
                        layers, hs, positions, rots, write_slots,
                        k_cache, v_cache, k_scale, v_scale):
    """One layer's attention over the ring: `layers[r]` is rank r's
    replica of the layer, `hs[r]` its normed [B, T/sp, H] slice.  Each
    rank projects and rotates its own slice; the chunk's rows are
    gathered on rank 0's card and written to the paged cache there; the
    chunk attends itself on the ring (no cached context is read).  With an
    int8 cache each rank quantizes its rows ONCE, and the same int8 rows
    and scales are scattered into the cache and rotated around the ring,
    so the ring attends what every later cache read will see."""
    sp = ring.sp
    quant = k_scale is not None
    qs, ks, vs, kscs, vscs = [], [], [], [], []
    for r in range(sp):
        with ring.on(r):
            q, k, v = _qkv(cfg, layers[r]["attn"], hs[r], rots[r])
            B, t_loc = q.shape[:2]
            if quant:
                kq, ksc = kvc.quantize_kv_rows(
                    k.reshape(B * t_loc, cfg.kv_size), cfg.num_kv_heads)
                vq, vsc = kvc.quantize_kv_rows(
                    v.reshape(B * t_loc, cfg.kv_size), cfg.num_kv_heads)
                k = kq.reshape(B, t_loc, cfg.num_kv_heads, cfg.head_dim)
                v = vq.reshape(B, t_loc, cfg.num_kv_heads, cfg.head_dim)
                kscs.append(ksc.reshape(B, t_loc, cfg.num_kv_heads))
                vscs.append(vsc.reshape(B, t_loc, cfg.num_kv_heads))
            qs.append(q)
            ks.append(k)
            vs.append(v)
    # The chunk's rows in token order [B, T, ...], on the cache's card.
    B = qs[0].shape[0]
    rows = [ring.gather(parts, dim=1).reshape(B * sp * t_loc, -1)
            for parts in ((ks, vs, kscs, vscs) if quant else (ks, vs))]
    with ring.on(0):
        if quant:
            kvc.scatter_kv_quant(k_cache, v_cache, k_scale, v_scale,
                                 write_slots, *rows)
        else:
            kvc.write_kv(k_cache, v_cache, write_slots, *rows)
    outs = _sp_ring_attention(
        cfg, qs, ks, vs, positions,
        (ks, vs, kscs, vscs) if quant else None, ring, use_kernel)
    attn = []
    for r in range(sp):
        with ring.on(r):
            B, t_loc = outs[r].shape[:2]
            attn.append(outs[r].reshape(B, t_loc, cfg.q_size)
                        @ layers[r]["attn"]["wo"])
    return attn


def _sp_forward(cfg: ModelConfig, block_size: int, ring, use_kernel: bool,
                state: State, cache: Dict, tokens, positions, block_tables,
                sample_positions):
    """The whole-prompt prefill step over the ring's ranks.  The chunk is
    the WHOLE prompt of every row (positions 0..len-1, pad positions past
    the block table); rank r runs every token-wise op of every layer on
    tokens [r * T/sp, (r + 1) * T/sp) with its card's replica of the
    parameters, and only attention sees the other ranks' tokens.

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
        hs = []
        for r in range(sp):
            with ring.on(r):
                hs.append(rms_norm(xs[r], layers[r]["attn_norm"],
                                   cfg.rms_norm_eps, off))
        attn = _sp_attention_layer(
            cfg, ring, use_kernel, layers, hs, pos, rots, write_slots,
            cache["k"][i], cache["v"][i],
            cache["k_scale"][i] if quant else None,
            cache["v_scale"][i] if quant else None)
        for r in range(sp):
            with ring.on(r):
                xs[r] = _layer_tail(cfg, layers[r], xs[r], attn[r], "dense", [])
    # Row b's sample position lies on rank sample_positions[b] // t_loc;
    # every rank norms its candidate row, rank 0 keeps the owner's.
    cands = []
    for r in range(sp):
        with ring.on(r):
            idx = (sample_positions.to(ring.devices[r]).long()
                   - r * t_loc).clamp(0, t_loc - 1)
            row = xs[r][torch.arange(B, device=ring.devices[r]), idx]
            cands.append(rms_norm(row, states[r]["final_norm"],
                                  cfg.rms_norm_eps, off)[None])
    stacked = ring.gather(cands, dim=0)                        # [sp, B, H]
    with ring.on(0):
        owner = torch.div(sample_positions.long(), t_loc,
                          rounding_mode="floor").clamp(0, sp - 1)
        sel = stacked[owner, torch.arange(B, device=stacked.device)]
        logits = _lm_head(cfg, states[0], sel)
    ring.join()
    return logits, cache


# ---------------------------------------------------------------------------
# Forward


def make_forward_step(cfg: ModelConfig, block_size: int,
                      use_decode_kernel: bool = False,
                      moe_mode: str = "dense",
                      with_expert_load: bool = False,
                      sp_ring=None,
                      sp_ring_kernel: bool = False,
                      return_hidden: bool = False):
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
    ring.

    `return_hidden` (the embeddings step): the step returns the
    final-norm hidden state at `sample_positions` in f32 ([B, H]) in
    place of the logits and skips the LM head."""
    cfg.validate()
    if return_hidden and (sp_ring is not None or with_expert_load):
        raise ValueError("return_hidden takes neither sp_ring nor "
                         "with_expert_load")

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
        off = cfg.rms_offset
        loads: List[torch.Tensor] = []
        for i, layer in enumerate(state["layers"]):
            attn_out = _attention_block(
                cfg, layer["attn"],
                rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps, off),
                positions, rot, seq_lens, write_slots, ctx_slots, ctx_positions,
                block_tables, block_size, cache["k"][i], cache["v"][i],
                *_layer_scales(cache, i))
            x = _layer_tail(cfg, layer, x, attn_out, moe_mode, loads)
        x = rms_norm(x, state["final_norm"], cfg.rms_norm_eps, off)
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
                             moe_mode: str = "dense"):
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
    a batch mixes such segments with plain ones freely."""
    cfg.validate()

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
        off = cfg.rms_offset
        args = (block_tables, seq_lens.to(torch.int32),
                q_starts.to(torch.int32), q_lens.to(torch.int32))
        loads: List[torch.Tensor] = []
        for i, layer in enumerate(state["layers"]):
            p_attn = layer["attn"]
            h_in = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps, off)
            q, k, v = _qkv(cfg, p_attn, h_in, rot)
            ks, vs = _layer_scales(cache, i)
            _write_chunk(cache["k"][i], cache["v"][i], ks, vs,
                         write_slots, k.reshape(T, cfg.kv_size),
                         v.reshape(T, cfg.kv_size))
            # Write-then-attend: the chunk's own K/V are pool rows now, so
            # cached prefix and in-chunk causality are one position mask.
            attn = paged_prefill_attention(
                q[0].contiguous(), cache["k"][i], cache["v"][i], *args,
                block_size=block_size, scale=cfg.query_scale,
                soft_cap=cfg.attn_soft_cap, k_scale=ks, v_scale=vs)
            attn = attn.reshape(1, T, cfg.q_size) @ p_attn["wo"]
            x = _layer_tail(cfg, layer, x, attn, moe_mode, loads)
        x = rms_norm(x, state["final_norm"], cfg.rms_norm_eps, off)
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
                       with_expert_load: bool = False):
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
    window's summed [E+1] expert load to the returned tuple."""
    from dynamo_tpu_torch.engine.sampling import sample

    step = make_forward_step(cfg, block_size, use_decode_kernel, moe_mode,
                             with_expert_load)

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
