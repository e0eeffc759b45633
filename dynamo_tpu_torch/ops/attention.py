"""Attention over gathered paged context in plain PyTorch (port of
`dynamo_tpu/ops/attention.py`).

One op serves chunked prefill, full prefill and single-token decode: the
chunk's queries attend to every gathered context slot with the mask
`kv_pos < seq_len AND kv_pos <= q_pos` on absolute positions.  This is the
port's gather path and the oracle the CUDA kernels are held against.

GQA is blocked (the HF Llama convention): query head h uses kv head
h // G, so kv stays the slow axis of the head reshape.  Products run in
float32 on the operands' own values (exact for bf16 inputs, as the JAX
version's f32-accumulating einsum), softmax in float32, and the
probabilities round to V's dtype before the second product, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention(
    q: torch.Tensor,             # [B, T, Hq, D] chunk queries
    k_ctx: torch.Tensor,         # [B, C, Hkv, D] gathered context keys
    v_ctx: torch.Tensor,         # [B, C, Hkv, D] gathered context values
    q_positions: torch.Tensor,   # [B, T] absolute position of each query
    kv_positions: torch.Tensor,  # [B, C] absolute position of each slot
    seq_lens: torch.Tensor,      # [B] valid context length per sequence
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Masked GQA attention of chunk queries against gathered context;
    returns [B, T, Hq, D] in q's dtype."""
    B, T, Hq, D = q.shape
    _, C, Hkv, _ = k_ctx.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, T, Hkv, G, D).float()
    # [B, Hkv, G, T, C]
    scores = torch.einsum("btkgd,bckd->bkgtc", qg, k_ctx.float()) * scale
    if soft_cap is not None:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    valid = kv_positions[:, None, :] < seq_lens[:, None, None]      # [B,1,C]
    causal = kv_positions[:, None, :] <= q_positions[:, :, None]    # [B,T,C]
    mask = (valid & causal)[:, None, None, :, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgtc,bckd->btkgd",
                       probs.to(v_ctx.dtype).float(), v_ctx.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def causal_attention(q: torch.Tensor,  # [B, T, Hq, D]
                     k: torch.Tensor,  # [B, T, Hkv, D]
                     v: torch.Tensor,  # [B, T, Hkv, D]
                     scale: Optional[float] = None) -> torch.Tensor:
    """Plain causal self-attention with no cache — the ground truth the
    paged paths reproduce."""
    B, T, Hq, D = q.shape
    positions = torch.arange(T, device=q.device).expand(B, T)
    seq_lens = torch.full((B,), T, dtype=torch.long, device=q.device)
    return paged_attention(q, k, v, positions, positions, seq_lens,
                           scale=scale)
