"""Ring attention in plain PyTorch: causal self-attention with
sequence-sharded K/V (port of `dynamo_tpu/ops/ring_attention.py`).

The sequence axis is cut into `sp` shards.  Every shard keeps its Q block
and an online-softmax state `(m, l, acc)`, and the K/V blocks (with their
absolute positions and, when quantized, their scales) visit every shard
in turn, one hop per step: the block shard i holds moves to shard
`(i + 1) % sp`.  After sp hops every Q block has seen every K/V block.

Where the JAX module is one function called under `shard_map` with
`lax.ppermute` between the hops, this one is written out: a per-shard
`ring_fold` / `ring_finish` pair with the JAX arithmetic, and a loop,
`ring_causal_attention`, that runs them over a list of shards.  The
module is also the plain version of the CUDA flash-fold kernel
(ops/cuda/ring_attention.py): the CPU tests use it, and the sp prefill
step uses it where the kernel's geometry rule refuses a shape.

Arithmetic, as in JAX: q is scaled once in f32; the state starts at
`m = NEG`, `l = 0`, `acc = 0` with the finite `NEG = -1e30`; the visiting
order starts at the shard's OWN block, so every real row's `m` is finite
after hop 0 and a later wholly masked block adds `exp(NEG - m) == 0`; a
row that has seen no key yet adds `exp(0) == 1` per masked key, which
leaves padding rows junk but finite; int8 rows are dequantized to q's
dtype first and widened to f32 after; the final divide is guarded by
`max(l, 1e-30)`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from dynamo_tpu_torch.engine.kv_cache import dequantize_rows

NEG = -1e30

RingState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ring_init(q_scaled: torch.Tensor) -> RingState:
    """The empty online-softmax state of one shard: `m, l [B, Hq, T]` and
    `acc [B, T, Hq, D]`, f32 (the layout the CUDA kernel keeps between
    its launches)."""
    B, T, Hq, D = q_scaled.shape
    dev = q_scaled.device
    return (torch.full((B, Hq, T), NEG, dtype=torch.float32, device=dev),
            torch.zeros((B, Hq, T), dtype=torch.float32, device=dev),
            torch.zeros((B, T, Hq, D), dtype=torch.float32, device=dev))


def ring_fold(
    state: RingState,
    q_scaled: torch.Tensor,   # [B, T, Hq, D] f32, already times the scale
    q_pos: torch.Tensor,      # [B, T] absolute positions
    k: torch.Tensor,          # [B, C, Hkv, D] (int8 when k_scale is given)
    v: torch.Tensor,          # [B, C, Hkv, D]
    kv_pos: torch.Tensor,     # [B, C] absolute positions of the block
    soft_cap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # [B, C, Hkv] f32
    v_scale: Optional[torch.Tensor] = None,
    dequant_dtype: torch.dtype = torch.bfloat16,
) -> RingState:
    """Fold one visiting K/V block into a shard's state; returns the new
    state.  `dequant_dtype` is the dtype q had before it was scaled (int8
    rows pass through it on their way to f32)."""
    m, l, acc = state
    B, T, Hq, D = q_scaled.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if k_scale is None:
        kf, vf = k.float(), v.float()
    else:
        kf = dequantize_rows(k, k_scale, dequant_dtype).float()
        vf = dequantize_rows(v, v_scale, dequant_dtype).float()
    qg = q_scaled.reshape(B, T, Hkv, G, D)
    s = torch.einsum("btkgd,bckd->bkgtc", qg, kf)       # [B, Hkv, G, T, C]
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    mask = (kv_pos[:, None, :] <= q_pos[:, :, None])[:, None, None, :, :]
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m_old = m.reshape(B, Hkv, G, T, 1)
    m_new = torch.maximum(m_old, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m_old - m_new)
    p = torch.exp(s - m_new)
    l_new = l.reshape(B, Hkv, G, T, 1) * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgtc,bckd->btkgd", p, vf)
    acc_new = (acc.reshape(B, T, Hkv, G, D) * alpha.permute(0, 3, 1, 2, 4)
               + pv)
    return (m_new.reshape(B, Hq, T), l_new.reshape(B, Hq, T),
            acc_new.reshape(B, T, Hq, D))


def ring_finish(state: RingState, dtype: torch.dtype) -> torch.Tensor:
    """`acc / max(l, 1e-30)` as [B, T, Hq, D] in `dtype`.  Rows that saw
    no key keep l == 0 or junk: the guard keeps them finite."""
    _, l, acc = state
    denom = torch.clamp_min(l, 1e-30).permute(0, 2, 1)[..., None]
    return (acc / denom).to(dtype)


Shards = Sequence[torch.Tensor]


def ring_causal_attention(
    q: Shards,                # per shard [B, T_loc, Hq, D]
    k: Shards,                # per shard [B, T_loc, Hkv, D] (int8 + scales)
    v: Shards,
    q_positions: Shards,      # per shard [B, T_loc] absolute positions
    kv_positions: Optional[Shards] = None,   # defaults to q_positions
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    k_scale: Optional[Shards] = None,        # per shard [B, T_loc, Hkv] f32
    v_scale: Optional[Shards] = None,
) -> List[torch.Tensor]:
    """Blockwise-causal attention over a list of sequence shards; returns
    one `[B, T_loc, Hq, D]` output per shard, in q's dtype.  One shard is
    masked causal attention.  A visiting block is moved to the device of
    the shard it visits, so the shards may lie on different devices."""
    sp = len(q)
    if kv_positions is None:
        kv_positions = q_positions
    if scale is None:
        scale = q[0].shape[-1] ** -0.5
    quant = k_scale is not None
    q_scaled = [x.float() * scale for x in q]
    states = [ring_init(x) for x in q_scaled]
    # The block each shard holds: (k, v, positions[, k_scale, v_scale]).
    cur: List[tuple] = [
        (k[r], v[r], kv_positions[r]) + ((k_scale[r], v_scale[r]) if quant
                                         else ())
        for r in range(sp)]
    for hop in range(sp):
        for r in range(sp):
            blk = cur[r]
            states[r] = ring_fold(
                states[r], q_scaled[r], q_positions[r], blk[0], blk[1],
                blk[2], soft_cap, *(blk[3:] if quant else (None, None)),
                dequant_dtype=q[r].dtype)
        if hop + 1 < sp:
            # i -> (i + 1) % sp: shard r now holds what r - 1 held.
            cur = [tuple(t.to(q[r].device) for t in cur[(r - 1) % sp])
                   for r in range(sp)]
    return [ring_finish(states[r], q[r].dtype) for r in range(sp)]
