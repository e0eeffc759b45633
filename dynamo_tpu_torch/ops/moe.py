"""Mixture-of-Experts compute paths, meshless (port of
`dynamo_tpu/ops/moe.py` and the meshless branch of
`dynamo_tpu/parallel/sharding.py:resolve_moe_mode`).

- `moe_dense` — every expert runs over every token and the non-selected
  ones are gated to zero.  Exact; the CPU path of `auto` and the plain
  reference of the whole block.
- `moe_grouped` — the (token, expert) assignments are sorted by expert,
  each expert's group padded to `block_rows`, and one ragged grouped
  GEMM (`ops/cuda/moe_grouped.py`, kernel `csrc/moe_grouped.cu`) runs
  only the selected work, reading each live expert's weights once per row
  tile.  bf16 weights, or the int8 dict of `quantize_moe_params`.
- `moe_dispatch` (all-to-all over an `ep` mesh axis) is not ported yet.

Every path returns an int32 stats vector of length E+1: per-expert
assignment counts and a dropped-assignments tail slot (always 0 here —
both paths are exact).  Both reduce the top-k choices in EXPERT-INDEX
order, the one combine structure the JAX package's paths share.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.cuda import (
    DEFAULT_BLOCK_ROWS,
    grouped_expert_ffn,
    moe_grouped_geometry_ok,
    moe_params_quantized,
)

MOE_MODES = ("auto", "dense", "grouped", "dispatch")


def router_topk(cfg: ModelConfig, p_moe: dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing, softmax over the selected experts' f32 logits (the
    Mixtral convention).  x: [N, H] → (expert_ids [N, k], gates [N, k]).
    Ties go to the lower expert index, as `jax.lax.top_k` breaks them."""
    logits = (x @ p_moe["router"]).float()                       # [N, E]
    k = cfg.num_experts_per_token
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :k], dim=-1)
    return idx[:, :k], gates.to(x.dtype)


def _counts(ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Assignments per expert, [E] int64.  (`torch.bincount` would read
    the ids' maximum back to the host on a card: a sync per layer.)"""
    flat = ids.reshape(-1)
    return torch.zeros((num_experts,), dtype=torch.int64,
                       device=ids.device).index_add_(0, flat,
                                                     torch.ones_like(flat))


def _with_drop_tail(load: torch.Tensor) -> torch.Tensor:
    """[E] per-expert counts → [E+1] stats with the dropped-assignments
    tail slot (0: the meshless paths are exact)."""
    return torch.cat([load.to(torch.int32),
                      torch.zeros((1,), dtype=torch.int32, device=load.device)])


def _combine(picked: torch.Tensor, expert_ids: torch.Tensor,
             gates: torch.Tensor) -> torch.Tensor:
    """out[n] = sum over the k choices, in expert-index order, of
    gate * expert output; picked [N, k, H] follows expert_ids [N, k].
    Products and sum in f32, rounded once to picked's dtype."""
    kord = torch.argsort(expert_ids, dim=1, stable=True)
    p = torch.take_along_dim(picked, kord[:, :, None], dim=1)
    g = torch.take_along_dim(gates, kord, dim=1)
    return torch.einsum("nkh,nk->nh", p.float(), g.float()).to(picked.dtype)


def moe_dense(cfg: ModelConfig, p_moe: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dense-compute MoE.  x: [B, T, H] → (out, stats [E+1])."""
    if moe_params_quantized(p_moe):
        raise ValueError("moe_dense takes bf16/f32 experts; int8 experts "
                         "run moe_mode='grouped' (or dequantize_moe_params "
                         "first)")
    B, T, H = x.shape
    E = cfg.num_experts
    expert_ids, gates = router_topk(cfg, p_moe, x.reshape(B * T, H))
    hidden = F.silu(torch.einsum("bth,ehf->betf", x, p_moe["w_gate"]))
    hidden = hidden * torch.einsum("bth,ehf->betf", x, p_moe["w_up"])
    expert_out = torch.einsum("betf,efh->beth", hidden, p_moe["w_down"])
    per_token = expert_out.permute(0, 2, 1, 3).reshape(B * T, E, H)
    picked = torch.take_along_dim(per_token, expert_ids[:, :, None], dim=1)
    out = _combine(picked, expert_ids, gates)
    load = _counts(expert_ids, E)
    return out.reshape(B, T, H), _with_drop_tail(load)


def expert_tiles(flat_e: torch.Tensor, num_experts: int, block_rows: int):
    """Row plan of the grouped GEMM for the flat assignment list
    `flat_e [S]` (expert of each assignment):

    - order [S]: the stable sort of the assignments by expert;
    - dest_sorted [S]: packed row of each sorted assignment (its expert's
      group offset plus its rank in the group, groups padded to
      block_rows);
    - tile_expert [n_tiles] int32: the expert whose padded span covers
      each tile's first row (tiles past the last span clamp to E-1);
    - tile_rows [n_tiles] int32: live rows of each tile (0 past the last
      span);
    - counts [E]: assignments per expert.

    S_pad = max(bm, (S + E (bm - 1)) // bm * bm) depends on S only, so the
    shapes are static and nothing syncs the host."""
    S = flat_e.shape[0]
    E, bm = num_experts, block_rows
    dev = flat_e.device
    counts = _counts(flat_e, E)                                   # [E]
    padded = (counts + bm - 1) // bm * bm
    S_pad = max(bm, (S + E * (bm - 1)) // bm * bm)
    n_tiles = S_pad // bm
    pend = torch.cumsum(padded, 0)
    offs = pend - padded
    order = torch.argsort(flat_e, stable=True)
    es = flat_e[order]
    rank = torch.arange(S, device=dev) - (torch.cumsum(counts, 0) - counts)[es]
    dest_sorted = offs[es] + rank
    start = torch.arange(n_tiles, device=dev) * bm
    tile_expert = torch.searchsorted(pend, start, right=True).clamp(0, E - 1)
    tile_rows = (offs[tile_expert] + counts[tile_expert] - start).clamp(0, bm)
    return (order, dest_sorted, S_pad, tile_expert.to(torch.int32),
            tile_rows.to(torch.int32), counts)


def moe_grouped(cfg: ModelConfig, p_moe: dict, x: torch.Tensor, *,
                block_rows: int = DEFAULT_BLOCK_ROWS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped-GEMM MoE.  x: [B, T, H] → (out, stats [E+1]).  Exact —
    no capacity, nothing dropped.  Padding rows of the packed buffer are
    zero and the kernel skips them (`tile_rows`)."""
    B, T, H = x.shape
    N = B * T
    E, k = cfg.num_experts, cfg.num_experts_per_token
    x2 = x.reshape(N, H)
    expert_ids, gates = router_topk(cfg, p_moe, x2)               # [N, k]
    order, dest_sorted, S_pad, tile_expert, tile_rows, counts = expert_tiles(
        expert_ids.reshape(-1), E, block_rows)
    token_of = torch.arange(N, device=x.device).repeat_interleave(k)
    x_pad = torch.zeros((S_pad, H), dtype=x.dtype, device=x.device)
    x_pad[dest_sorted] = x2[token_of[order]]
    kw = {}
    if moe_params_quantized(p_moe):
        kw = {n: p_moe[n] for n in ("w_gate_scale", "w_up_scale",
                                    "w_down_scale")}
    y_pad = grouped_expert_ffn(
        x_pad, tile_expert, p_moe["w_gate"], p_moe["w_up"], p_moe["w_down"],
        tile_rows=tile_rows, block_rows=block_rows, **kw)
    dest = torch.empty_like(dest_sorted)
    dest[order] = dest_sorted
    out = _combine(y_pad[dest].reshape(N, k, H), expert_ids, gates)
    return out.reshape(B, T, H), _with_drop_tail(counts)


def resolve_moe_mode(cfg: ModelConfig, device: torch.device,
                     moe_mode: str = "auto") -> str:
    """The meshless MoE mode: "dense" or "grouped".

    'auto' → "grouped" on a CUDA device when the expert geometry passes
    the kernel's rule (`moe_grouped_geometry_ok`), else "dense" (as the
    JAX package resolves 'auto' off a TPU).  "dispatch" needs a mesh with
    an ep axis, which the port does not have yet."""
    if not cfg.is_moe:
        return "dense"
    if moe_mode not in MOE_MODES:
        raise ValueError(f"moe_mode={moe_mode!r} not in {MOE_MODES}")
    if moe_mode == "dispatch":
        raise ValueError(
            "moe_mode='dispatch' needs a mesh with an ep axis (the "
            "all-to-all is an ep collective); meshless engines use "
            "'grouped' (the CUDA kernel) or 'dense'")
    if moe_mode == "auto":
        ok = (torch.device(device).type == "cuda"
              and moe_grouped_geometry_ok(cfg.hidden_size,
                                          cfg.intermediate_size, cfg.dtype))
        return "grouped" if ok else "dense"
    return moe_mode
