"""Mixture-of-Experts compute paths (port of `dynamo_tpu/ops/moe.py` and
the meshless branch of `dynamo_tpu/parallel/sharding.py:resolve_moe_mode`).

- `moe_dense` — every expert runs over every token and the non-selected
  ones are gated to zero.  Exact; the CPU path of `auto` and the plain
  reference of the whole block.  `moe_dense_local` is one ep rank's part
  of it (its experts' terms) under a mesh's "dense" mode.
- `moe_grouped` — the (token, expert) assignments are sorted by expert,
  each expert's group padded to `block_rows`, and one ragged grouped
  GEMM (`ops/cuda/moe_grouped.py`, kernel `csrc/moe_grouped.cu`) runs
  only the selected work, reading each live expert's weights once per row
  tile.  bf16 weights, or the int8 dict of `quantize_moe_params`.
- `moe_dispatch` — Switch-style token dispatch with a static per-expert
  capacity C (tokens per expert per source shard): each shard's
  assignments are scattered into per-expert buffers `[E, C, H]` at their
  position in the expert's buffer (a cumulative one-hot count), the
  buffers move to the shard that owns each expert (`EpGroup.all_to_all`
  over the ep ranks, in place of JAX's `jax.lax.all_to_all` over the
  `ep` axis), the local experts run one batched product (`expert_ffn`,
  JAX's einsum, which JAX computes outside any Pallas kernel), a second
  all-to-all brings the outputs home, and the gate-weighted combine runs
  in f32, rounded once to x's dtype.  `capacity=None` is exact (C = the
  shard's tokens); a smaller C drops the overflow assignments, whose
  gate mass is lost, and counts them.  `_dispatch_shards` takes the ep
  group in place of JAX's `ep_axis`; with no group it is the meshless
  plain reference.

Every path returns an int32 stats vector of length E+1: per-expert
assignment counts and a dropped-assignments tail slot (0 on the exact
paths).  Dense and grouped reduce the top-k choices in EXPERT-INDEX
order, the one combine structure the JAX package's exact paths share;
dispatch combines in routing order, as JAX's.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, Optional, Sequence, Tuple

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
    return topk_of(cfg, x @ p_moe["router"], x.dtype)


def topk_of(cfg: ModelConfig, logits: torch.Tensor, dtype: torch.dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`router_topk` from the router's logits [N, E] in x's dtype (an ep
    rank's expert columns gathered first, under a mesh's "dense")."""
    k = cfg.num_experts_per_token
    vals, idx = torch.sort(logits.float(), dim=-1, descending=True,
                           stable=True)
    gates = torch.softmax(vals[:, :k], dim=-1)
    return idx[:, :k], gates.to(dtype)


def _counts(ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Assignments per expert, [E] int64.  (`torch.bincount` would read
    the ids' maximum back to the host on a card: a sync per layer.)"""
    flat = ids.reshape(-1)
    return torch.zeros((num_experts,), dtype=torch.int64,
                       device=ids.device).index_add_(0, flat,
                                                     torch.ones_like(flat))


def _with_drop_tail(load: torch.Tensor,
                    dropped: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[E] per-expert counts → [E+1] stats with the dropped-assignments
    tail slot (0 for the exact paths)."""
    tail = (torch.zeros((1,), dtype=torch.int32, device=load.device)
            if dropped is None else dropped.to(torch.int32).reshape(1))
    return torch.cat([load.to(torch.int32), tail])


def _combine(picked: torch.Tensor, expert_ids: torch.Tensor,
             gates: torch.Tensor, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """out[n] = sum over the k choices, in expert-index order, of
    gate * expert output; picked [N, k, H] follows expert_ids [N, k].
    Products and sum in f32, rounded once to `dtype` (picked's)."""
    kord = torch.argsort(expert_ids, dim=1, stable=True)
    p = torch.take_along_dim(picked, kord[:, :, None], dim=1)
    g = torch.take_along_dim(gates, kord, dim=1)
    return torch.einsum("nkh,nk->nh", p.float(), g.float()).to(
        dtype or picked.dtype)


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


def moe_dense_local(cfg: ModelConfig, p_moe: dict, x: torch.Tensor,
                    expert_ids: torch.Tensor, gates: torch.Tensor,
                    first: int) -> torch.Tensor:
    """One ep rank's part of `moe_dense` under a mesh's "dense" mode: the
    terms of its experts [first, first + E_local) for every token of x
    [N, H], given the whole routing; the other choices add zero.  f32
    [N, H]: the ranks' parts sum to the block's output (rounded once to
    x's dtype by the caller)."""
    E_local = p_moe["w_gate"].shape[0]
    hidden = F.silu(torch.einsum("nh,ehf->enf", x, p_moe["w_gate"]))
    hidden = hidden * torch.einsum("nh,ehf->enf", x, p_moe["w_up"])
    expert_out = torch.einsum("enf,efh->neh", hidden, p_moe["w_down"])
    local = expert_ids - first
    mine = (local >= 0) & (local < E_local)
    picked = torch.take_along_dim(expert_out,
                                  local.clamp(0, E_local - 1)[:, :, None],
                                  dim=1)
    picked = torch.where(mine[:, :, None], picked, torch.zeros_like(picked))
    return _combine(picked, expert_ids, gates, torch.float32)


def expert_ffn(p_moe: dict, h: torch.Tensor) -> torch.Tensor:
    """Batched expert MLPs: h [E, C, H] with weights [E, H, F] (a rank's
    F/tp slices give its partial of the down projection)."""
    up = F.silu(torch.einsum("ech,ehf->ecf", h, p_moe["w_gate"]))
    up = up * torch.einsum("ech,ehf->ecf", h, p_moe["w_up"])
    return torch.einsum("ecf,efh->ech", up, p_moe["w_down"])


def _dispatch_send(cfg: ModelConfig, p_moe: dict, x: torch.Tensor,
                   capacity: int):
    """A shard's routing and scatter: x [N, H] → (send [E, C, H], the
    combine's (dest, keep, gates), stats [E+1]).  Each (token, choice)
    goes to position `pos` of its expert's buffer, pos its cumulative
    one-hot count, i.e. row `dest = e * C + pos` of the flat buffers;
    `pos >= C` drops it (its row is a junk row past the buffers), counted
    in the stats' tail."""
    N, H = x.shape
    E, k, C = cfg.num_experts, cfg.num_experts_per_token, capacity
    expert_ids, gates = router_topk(cfg, p_moe, x)
    flat_e = expert_ids.reshape(-1)                               # [N*k]
    onehot = (flat_e[:, None] == torch.arange(
        E, device=x.device)).to(torch.int32)                      # [N*k, E]
    pos = (torch.cumsum(onehot, 0, dtype=torch.int32) * onehot).sum(-1) - 1
    keep = pos < C
    dest = torch.where(keep, flat_e * C + pos, E * C)
    send = x.new_zeros((E * C + 1, H))
    send[dest] = x.repeat_interleave(k, dim=0)
    stats = _with_drop_tail(onehot.sum(0), (~keep).sum())        # pre-drop
    return send[:E * C].view(E, C, H), (dest, keep, gates), stats


def _dispatch_combine(out_buf: torch.Tensor, how, dtype: torch.dtype
                      ) -> torch.Tensor:
    """out[t] = sum over its choices j of gate[t, j] * out_buf[e(t, j),
    pos(t, j)] in f32, the dropped ones adding zero, rounded once."""
    dest, keep, gates = how
    N, k = gates.shape
    rows = out_buf.reshape(-1, out_buf.shape[-1])                 # [E*C, H]
    picked = rows[dest.clamp(max=rows.shape[0] - 1)]              # [N*k, H]
    picked = torch.where(keep[:, None], picked, 0.0)
    out = torch.einsum("nkh,nk->nh", picked.reshape(N, k, -1).float(),
                       gates.float())
    return out.to(dtype)


def _dispatch_shards(cfg: ModelConfig, p_moes: Sequence[dict],
                     xs: Sequence[torch.Tensor], capacity: int,
                     group=None) -> Tuple[List[torch.Tensor],
                                          List[torch.Tensor]]:
    """The dispatch body of every ep rank of one (row, tp slice), stage by
    stage on the ranks' streams: rank e's local tokens xs[e] [N, H] and
    expert slices p_moes[e] ([E/ep, H, F'] ...) → (its outputs [N, H],
    its stats [E+1]).  `group` (a parallel.mesh.EpGroup) carries the two
    all-to-alls; None is the meshless plain reference (one shard, every
    expert).  With F/tp slices the outputs are tp partials."""
    ep = len(xs)
    if (group is None) != (ep == 1):
        raise ValueError(f"{ep} dispatch shards need an ep group of {ep}")
    E, C = cfg.num_experts, capacity
    E_local = p_moes[0]["w_gate"].shape[0]
    if E_local * ep != E:
        raise ValueError(f"{ep} shards of {E_local} experts for E={E}")
    on = group.on if group is not None else (lambda e: nullcontext())
    sends, hows, stats = [], [], []
    for e in range(ep):
        with on(e):
            send, how, st = _dispatch_send(cfg, p_moes[e], xs[e], C)
            sends.append(send)
            hows.append(how)
            stats.append(st)
    H = xs[0].shape[1]
    if ep > 1:
        # [E, C, H] = [ep, E_local, C, H]: slice s is bound for rank s;
        # after the exchange slice s came FROM rank s.
        recv = group.all_to_all([s.reshape(ep, E_local * C, H)
                                 for s in sends])
    h_outs = []
    for e in range(ep):
        with on(e):
            h_in = sends[e] if ep == 1 else recv[e].reshape(
                ep, E_local, C, H).transpose(0, 1).reshape(
                E_local, ep * C, H)
            h_out = expert_ffn(p_moes[e], h_in)               # [E_l, ep*C, H]
            if ep > 1:
                # Slice s of the reply goes back to source shard s.
                h_out = h_out.reshape(E_local, ep, C, H).transpose(
                    0, 1).reshape(ep, E_local * C, H)
            h_outs.append(h_out)
    if ep > 1:
        got = group.all_to_all(h_outs)
    outs = []
    for e in range(ep):
        with on(e):
            out_buf = h_outs[e] if ep == 1 else got[e].reshape(E, C, H)
            outs.append(_dispatch_combine(out_buf, hows[e], xs[e].dtype))
    return outs, stats


def moe_dispatch(cfg: ModelConfig, p_moe: dict, x: torch.Tensor,
                 capacity: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-to-all MoE, meshless (one shard holding every expert): x [B,
    T, H] → (out [B, T, H], stats [E+1]).  `capacity` None is exact (C =
    B * T: no assignment can overflow, top-k choices being distinct
    experts); a bound drops the overflow and counts it."""
    B, T, H = x.shape
    N = B * T
    outs, stats = _dispatch_shards(cfg, [p_moe], [x.reshape(N, H)],
                                   N if capacity is None else capacity)
    return outs[0].reshape(B, T, H), stats[0]


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
    an ep axis (parallel/sharding.resolve_moe_mode)."""
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
