"""Llama-family decoder, dense and meshless, in PyTorch (port of
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

Matrix products stay `torch.matmul`, as the JAX package left them to XLA.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.attention import paged_attention
from dynamo_tpu_torch.ops.cuda import paged_decode_attention, paged_prefill_attention

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
) -> torch.Tensor:
    B, T, _ = x.shape
    q = (x @ p_attn["wq"]).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = (x @ p_attn["wk"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p_attn["wv"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, rot)
    k = apply_rope(k, rot)
    kvc.write_kv(k_cache, v_cache, write_slots,
                 k.reshape(B * T, cfg.kv_size), v.reshape(B * T, cfg.kv_size))
    if ctx_slots is None:
        # Decode: stream each row's live pages through the kernel — no
        # gathered context.
        out = paged_decode_attention(
            q[:, 0].contiguous(), k_cache, v_cache, block_tables, seq_lens,
            block_size=block_size, scale=cfg.query_scale,
            soft_cap=cfg.attn_soft_cap)[:, None]
    else:
        k_ctx, v_ctx = kvc.gather_kv(k_cache, v_cache, ctx_slots,
                                     cfg.num_kv_heads)
        out = paged_attention(q, k_ctx, v_ctx, positions, kv_positions,
                              seq_lens, scale=cfg.query_scale,
                              soft_cap=cfg.attn_soft_cap)
    return out.reshape(B, T, cfg.q_size) @ p_attn["wo"]


def _dense_mlp(p: State, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    gate = x @ p["w_gate"]
    act = (F.silu(gate) if activation == "silu"
           else F.gelu(gate, approximate="tanh"))
    return (act * (x @ p["w_up"])) @ p["w_down"]


def _embed(cfg: ModelConfig, state: State, tokens: torch.Tensor) -> torch.Tensor:
    x = state["embed"][tokens.long()]
    if cfg.embed_scale:
        # Gemma: the multiplier is cast to the model dtype first.
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _layer_tail(cfg: ModelConfig, layer: State, x: torch.Tensor,
                attn_out: torch.Tensor) -> torch.Tensor:
    """Residual add of the attention output, then the MLP sub-block."""
    off = cfg.rms_offset
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, layer["post_attn_norm"],
                            cfg.rms_norm_eps, off)
    x = x + attn_out
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps, off)
    mlp_out = _dense_mlp(layer["mlp"], h, cfg.activation)
    if cfg.post_norms:
        mlp_out = rms_norm(mlp_out, layer["post_mlp_norm"],
                           cfg.rms_norm_eps, off)
    return x + mlp_out


def _lm_head(cfg: ModelConfig, state: State, x: torch.Tensor) -> torch.Tensor:
    head = state.get("lm_head")
    if head is None:
        head = state["embed"].T
    logits = (x @ head).float()
    if cfg.final_soft_cap is not None:
        logits = cfg.final_soft_cap * torch.tanh(logits / cfg.final_soft_cap)
    return logits


def _check_dense(cfg: ModelConfig) -> None:
    cfg.validate()
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet")


# ---------------------------------------------------------------------------
# Forward


def make_forward_step(cfg: ModelConfig, block_size: int,
                      use_decode_kernel: bool = False):
    """The unified prefill/decode step for one cache geometry.  With
    `use_decode_kernel`, T == 1 calls attend through the paged-decode
    kernel (its plain version for CPU tensors); everything else takes the
    gather path."""
    _check_dense(cfg)

    def step(state: State, cache: Dict, tokens: torch.Tensor,
             positions: torch.Tensor, seq_lens: torch.Tensor,
             block_tables: torch.Tensor,
             sample_positions: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict]:
        B, T = tokens.shape
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
        x = _embed(cfg, state, tokens)
        rot = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        off = cfg.rms_offset
        for i, layer in enumerate(state["layers"]):
            attn_out = _attention_block(
                cfg, layer["attn"],
                rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps, off),
                positions, rot, seq_lens, write_slots, ctx_slots, ctx_positions,
                block_tables, block_size, cache["k"][i], cache["v"][i])
            x = _layer_tail(cfg, layer, x, attn_out)
        x = rms_norm(x, state["final_norm"], cfg.rms_norm_eps, off)
        if sample_positions is not None:
            x = x[torch.arange(B, device=x.device), sample_positions.long()]
        return _lm_head(cfg, state, x), cache

    return step


# ---------------------------------------------------------------------------
# Packed ragged prefill


def make_packed_prefill_step(cfg: ModelConfig, block_size: int):
    """Packed ragged prefill: several sequences' chunks ride one flat [T]
    token axis ("segments") and attention runs through the paged-prefill
    kernel straight from the block pool.

        logits, cache = step(state, cache, tokens[T], positions[T],
                             seg_ids[T], block_tables[R, P], q_starts[R],
                             q_lens[R], seq_lens[R], sample_positions[R])

    Pad rows carry the engine's pad position (null-block writes); logits
    come back [R, V], one row per segment (pad segments give junk rows)."""
    _check_dense(cfg)

    def step(state, cache, tokens, positions, seg_ids, block_tables,
             q_starts, q_lens, seq_lens, sample_positions):
        T = tokens.shape[0]
        block_tables = block_tables.to(torch.int32)
        bt_tok = block_tables[seg_ids.long()]                     # [T, P]
        write_slots = kvc.slots_for_positions(
            bt_tok, positions[:, None], block_size).reshape(T)
        x = _embed(cfg, state, tokens)[None]                       # [1, T, H]
        rot = rope_tables(positions[None], cfg.head_dim, cfg.rope_theta)
        off = cfg.rms_offset
        args = (block_tables, seq_lens.to(torch.int32),
                q_starts.to(torch.int32), q_lens.to(torch.int32))
        for i, layer in enumerate(state["layers"]):
            p_attn = layer["attn"]
            h_in = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps, off)
            q = (h_in @ p_attn["wq"]).reshape(1, T, cfg.num_heads, cfg.head_dim)
            k = (h_in @ p_attn["wk"]).reshape(1, T, cfg.num_kv_heads, cfg.head_dim)
            v = (h_in @ p_attn["wv"]).reshape(1, T, cfg.num_kv_heads, cfg.head_dim)
            q = apply_rope(q, rot)
            k = apply_rope(k, rot)
            kvc.write_kv(cache["k"][i], cache["v"][i], write_slots,
                         k.reshape(T, cfg.kv_size), v.reshape(T, cfg.kv_size))
            # Write-then-attend: the chunk's own K/V are pool rows now, so
            # cached prefix and in-chunk causality are one position mask.
            attn = paged_prefill_attention(
                q[0].contiguous(), cache["k"][i], cache["v"][i], *args,
                block_size=block_size, scale=cfg.query_scale,
                soft_cap=cfg.attn_soft_cap)
            attn = attn.reshape(1, T, cfg.q_size) @ p_attn["wo"]
            x = _layer_tail(cfg, layer, x, attn)
        x = rms_norm(x, state["final_norm"], cfg.rms_norm_eps, off)
        sel = x[0][sample_positions.long()]                       # [R, H]
        return _lm_head(cfg, state, sel), cache

    return step


# ---------------------------------------------------------------------------
# Decode window


def make_decode_window(cfg: ModelConfig, block_size: int, window: int,
                       use_decode_kernel: bool = False,
                       greedy_only: bool = False):
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
    positions and lengths do not advance."""
    from dynamo_tpu_torch.engine.sampling import sample

    step = make_forward_step(cfg, block_size, use_decode_kernel)

    def run(state, cache, last_tokens, positions0, seq_lens0, block_tables,
            temp, top_k, top_p, seeds: Sequence, key_offsets: Sequence):
        B = last_tokens.shape[0]
        dev = last_tokens.device
        zero_pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        live = seq_lens0 > 0
        out = torch.empty((window, B), dtype=torch.int32, device=dev)
        toks = last_tokens
        for i in range(window):
            adv = live.to(positions0.dtype) * i
            logits, cache = step(state, cache, toks[:, None],
                                 (positions0 + adv)[:, None], seq_lens0 + adv,
                                 block_tables, zero_pos)
            if greedy_only:
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                toks = sample(logits, temp, top_k, top_p, seeds,
                              [o + i for o in key_offsets])
            out[i] = toks
        adv = live.to(positions0.dtype) * window
        return (cache, out, positions0 + adv, seq_lens0 + adv,
                [o + window for o in key_offsets])

    return run
