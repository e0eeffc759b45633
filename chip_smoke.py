#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dynamo_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (a failed phase exits non-zero and prints no
`ok` line):

1. device   — the card's name, count, torch/CUDA versions.
2. build    — nvcc builds every kernel source, one process each, at once.
3. kernel_list — the kernels of the main paths.
4. one line per kernel and geometry, held against its plain PyTorch
   version at a main path's shapes, with its time (CUDA events), the plain
   version's, a one-call PyTorch yardstick where one exists
   (scaled_dot_product_attention on the gathered context for K1/K2; the
   port never calls it) and the least time the card could take (bytes
   over 3.35 TB/s, operations over 989 TFLOP/s bf16 — NVIDIA's H100 SXM
   data sheet):
   - paged decode / prefill attention (K1 / K2) at llama-3-1b's geometry
     (Hq 32, Hkv 8, D 64, block 64) and at mixtral-8x7b's (D 128);
   - the grouped expert FFN (K3), bf16 and int8 weights, at mixtral-8x7b
     width (E 8, top-2, H 4096, F 14336) with decode (64 tokens) and
     prefill (512 tokens) row counts routed by the port's own MoE routing.
5. model    — llama-3-1b at full width, random weights: packed prefill and
   decode steps through the kernels against the gather path.
6. model_moe — mixtral-8x7b at full width and 2 layers, random weights:
   packed prefill (K2 + K3) and decode steps (K1 + K3) against the gather
   path with the dense MoE oracle, once with bf16 experts and once with
   int8 experts (the oracle on the dequantised weights).
7. serve    — `python -m dynamo_tpu_torch.frontend --model llama-3-1b` as a
   subprocess; launch counts zeroed, then concurrent streaming and unary
   greedy chat requests over HTTP; each must return its tokens and the
   streams their `[DONE]`; K1 and K2 must have launched.
8. serve_moe — the same against `--model mixtral-8x7b --num-layers 16`
   (one card cannot hold its 32 layers): K1, K2 and K3 must have
   launched and the expert load must count every routed row.

Then the card's `nvidia-smi` name/power-limit line, the kernels summary
`{"kernels": [...]}` and, last, `{"ok": true, "device": {...}}`.
It needs CUDA and the repository around it.
"""

from __future__ import annotations

import contextlib
import json
import signal
import socket
import statistics
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "smoke_out"      # server log (gitignored)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
# Kernel vs plain, two checks, each kernel with its own limits:
# - every element: |kernel - plain| <= ATOL + RTOL * |plain|.  RTOL * |x|
#   is one to two bf16 units in the last place of x; ATOL covers outputs
#   near zero, where the two versions' probability roundings (the plain
#   version rounds normalised probabilities, the kernel unnormalised ones)
#   do not cancel as the terms do.
# - every output row (one token, one head: D values): ||kernel - plain|| <=
#   ROW_TOL * ||plain||, and exact zeros where the plain row is zero.
#   Rounding noise averages out over a row and an error of the kernel's
#   own (a lost or extra token) does not, so this catches on small rows
#   what the elementwise allowance would hide.
# The grouped expert FFN's rounding differs from its plain version's only
# where an f32 sum lands near a bf16 rounding boundary of h, u or the
# activation (the two sum in other orders).
RTOL = 2.0 ** -7
ATOL = {"paged_decode_attention": 3e-3, "paged_prefill_attention": 8e-3,
        "moe_grouped": 4e-3, "moe_grouped_int8": 4e-3}
# Limits about twice the largest reading on an H100 80GB HBM3 at these
# shapes and at those of tests/test_torch_cuda.py.
ROW_TOL = {"paged_decode_attention": 1e-2, "paged_prefill_attention": 1e-2,
           "moe_grouped": 4e-3, "moe_grouped_int8": 4e-3}
# Relative logits error, kernel path vs gather path.  The MoE model's is
# larger: the two attention paths differ in the last bf16 bit, and a
# router whose 2nd and 3rd expert logits nearly tie then picks another
# expert for that token (model_moe's `routing_differs`: 2 of 217 prompt
# tokens in layer 0 and 1 in layer 1 on an H100 80GB HBM3, 0.067 at the
# prefill step), while on identical inputs the grouped kernel and the
# dense oracle agree (`block_vs_dense`).
MODEL_TOL = {"llama-3-1b": 5e-2, "mixtral-8x7b": 1.5e-1}
SEED = 0                       # also the server's weight seed (EngineConfig)
BS, HQ, HKV = 64, 32, 8        # attention geometry of both models, block 64
MOE_LAYERS = 16                # mixtral-8x7b depth served on one 80 GB card
# Each kernel's source and the TPU kernel it replaces.
SOURCES = {
    "paged_decode_attention": ("dynamo_tpu_torch/csrc/paged_decode.cu",
                               "dynamo_tpu/ops/pallas/paged_attention.py:258"),
    "paged_prefill_attention": ("dynamo_tpu_torch/csrc/paged_prefill.cu",
                                "dynamo_tpu/ops/pallas/paged_prefill.py:227"),
    "moe_grouped": ("dynamo_tpu_torch/csrc/moe_grouped.cu",
                    "dynamo_tpu/ops/pallas/moe_grouped.py:141"),
}


class SmokeError(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def bound(nbytes: float, flops: float):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / BF16_FLOPS_PER_S * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


def closeness(torch, name: str, out, ref) -> dict:
    """The readings of a kernel-vs-plain comparison beside the kernel's
    limits: the largest absolute error, the smallest ATOL that passes
    under RTOL, and the largest row-normalised error."""
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    diff = (o - r).abs()
    need = (diff - RTOL * r.abs()).max().clamp(min=0).item()
    r_norm, e_norm = r.norm(dim=1), (o - r).norm(dim=1)
    live = r_norm > 0
    row = (e_norm[live] / r_norm[live]).max().item() if live.any() else 0.0
    reading = {"max_abs_err": diff.max().item(), "atol_needed": need,
               "atol": ATOL[name], "rtol": RTOL, "row_rel_err": row,
               "row_tol": ROW_TOL[name]}
    check(not bool((e_norm[~live] > 0).any()),
          f"{name}: rows the plain version zeroes are not zero")
    check(need <= ATOL[name] and row <= ROW_TOL[name],
          f"{name} disagrees with its plain version: {reading}")
    return reading


def time_ms(torch, fn, samples: int = 25, per_sample: int = 10) -> float:
    """Median over `samples` of (CUDA-event time of `per_sample`
    back-to-back calls) / per_sample."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per_sample):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / per_sample)
    return statistics.median(out)


def sdpa_inputs(torch, kvc, q, kc, vc, block_tables, seq_lens, q_pos):
    """Dense [R, Hq, *, D] tensors of each row's gathered context plus
    its boolean mask, for torch's scaled_dot_product_attention."""
    R, P = block_tables.shape
    C = P * BS
    ctx = torch.arange(C, device=q.device).expand(R, C)
    slots = kvc.slots_for_positions(block_tables, ctx, BS)
    k, v = kvc.gather_kv(kc, vc, slots, HKV)                   # [R, C, Hkv, D]
    g = HQ // HKV
    k = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    mask = (ctx[:, None, None, :] < seq_lens[:, None, None, None].long()) & (
        ctx[:, None, None, :] <= q_pos[:, None, :, None])
    return k, v, mask


def decode_phase(torch, gen, D):
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.ops.cuda import (
        paged_decode_attention, paged_decode_attention_plain)

    dev = torch.device("cuda")
    B, P, ctx = 64, 8, 512
    nblocks = 1 + B * P + 64
    S = nblocks * BS
    kc = torch.randn(S, HKV * D, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(S, HKV * D, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(B, HQ, D, generator=gen, device=dev).to(torch.bfloat16)
    # Shuffled, non-contiguous pages; a few ragged and empty rows.
    perm = torch.randperm(nblocks - 1, generator=gen, device=dev)[: B * P] + 1
    bt = perm.reshape(B, P).to(torch.int32)
    lens = [ctx] * B
    for i, n in ((1, 0), (2, 1), (3, 63), (4, 65), (5, 300), (6, 0), (7, 129)):
        lens[i] = n
    for i, n in enumerate(lens):
        bt[i, -(-n // BS):] = 0  # unallocated entries are the null block
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = D ** -0.5

    def kern():
        return paged_decode_attention(q, kc, vc, bt, sl, block_size=BS)

    def plain():
        return paged_decode_attention_plain(q, kc, vc, bt, sl, block_size=BS)

    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    check(out[1].abs().max().item() == 0.0, "decode kernel: seq_len 0 row not zero")
    reading = closeness(torch, "paged_decode_attention", out, ref)
    k_ms = time_ms(torch, kern)
    p_ms = time_ms(torch, plain, samples=5, per_sample=2)
    k4, v4, mask = sdpa_inputs(torch, kvc, q, kc, vc, bt, sl,
                               (sl.long() - 1)[:, None])
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask, scale=scale))
    tokens = sum(lens)
    pages = sum(-(-n // BS) for n in lens)
    nbytes = (q.numel() * 2 + 2 * tokens * HKV * D * 2 + pages * 4 + B * 4
              + out.numel() * 2)
    flops = 4 * HQ * D * tokens
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "paged_decode_attention",
            "shape": {"B": B, "ctx": ctx, "block": BS, "Hq": HQ, "Hkv": HKV,
                      "D": D, "seq_lens": lens[:8]},
            **reading, "kernel_ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}


def prefill_phase(torch, gen, D):
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.ops.cuda import (
        paged_prefill_attention, paged_prefill_attention_plain)

    dev = torch.device("cuda")
    T, R, P = 512, 8, 8
    lens = [192, 136, 120, 64]           # sums to T; all PACK_ALIGN'd
    prefix = [0, 64, 0, 0]               # segment 1 has a cached prefix
    nblocks = 1 + R * P + 8
    S = nblocks * BS
    kc = torch.randn(S, HKV * D, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(S, HKV * D, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(T, HQ, D, generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(nblocks - 1, generator=gen, device=dev)[: R * P] + 1
    bt = torch.zeros(R, P, dtype=torch.int32, device=dev)
    sl, qs, ql = ([0] * R for _ in range(3))
    off = 0
    for i, (n, pre) in enumerate(zip(lens, prefix)):
        sl[i], qs[i], ql[i] = pre + n, off, n
        npg = -(-(pre + n) // BS)
        bt[i, :npg] = perm[i * P: i * P + npg].to(torch.int32)
        off += n
    sl_t, qs_t, ql_t = (torch.tensor(x, dtype=torch.int32, device=dev)
                        for x in (sl, qs, ql))

    def kern():
        return paged_prefill_attention(q, kc, vc, bt, sl_t, qs_t, ql_t,
                                       block_size=BS)

    def plain():
        return paged_prefill_attention_plain(q, kc, vc, bt, sl_t, qs_t, ql_t,
                                             block_size=BS)

    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    reading = closeness(torch, "paged_prefill_attention", out, ref)
    k_ms = time_ms(torch, kern)
    p_ms = time_ms(torch, plain, samples=5, per_sample=2)
    # Yardstick: one SDPA call over the real segments padded to the
    # longest, each against its gathered context with the same mask.
    n_real = len(lens)
    Lmax = max(lens)
    q4 = torch.zeros(n_real, HQ, Lmax, D, dtype=torch.bfloat16, device=dev)
    q_pos = torch.zeros(n_real, Lmax, dtype=torch.long, device=dev)
    for i in range(n_real):
        q4[i, :, : lens[i]] = q[qs[i]: qs[i] + lens[i]].transpose(0, 1)
        q_pos[i] = torch.arange(Lmax, device=dev) + prefix[i]
    k4, v4, mask = sdpa_inputs(torch, kvc, q4, kc, vc, bt[:n_real],
                               sl_t[:n_real], q_pos)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask,
                                         scale=D ** -0.5))
    kv_tokens = sum(sl)
    visible = sum(sum(pre + i + 1 for i in range(n))
                  for n, pre in zip(lens, prefix))
    pages = sum(-(-s // BS) for s in sl)
    nbytes = (q.numel() * 2 + 2 * kv_tokens * HKV * D * 2 + pages * 4
              + 3 * R * 4 + out.numel() * 2)
    flops = 4 * HQ * D * visible
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "paged_prefill_attention",
            "shape": {"T": T, "segments": lens, "cached_prefix": prefix,
                      "block": BS, "Hq": HQ, "Hkv": HKV, "D": D},
            **reading, "kernel_ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}


def moe_phase(torch, gen, p, name, n_tokens):
    """K3 at mixtral-8x7b width: n_tokens tokens routed by the port's own
    MoE routing (router_topk + expert_tiles), so the tiles are ragged and
    padding rows and dead tiles exist, against the plain version."""
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.ops.cuda import (
        grouped_expert_ffn, grouped_expert_ffn_plain)
    from dynamo_tpu_torch.ops.moe import expert_tiles, router_topk

    dev = torch.device("cuda")
    cfg = get_config("mixtral-8x7b")
    E, k = cfg.num_experts, cfg.num_experts_per_token
    H, Fi = cfg.hidden_size, cfg.intermediate_size
    x = torch.randn(n_tokens, H, generator=gen, device=dev).to(torch.bfloat16)
    ids, _ = router_topk(cfg, p, x)
    order, dest, S_pad, te, tr, counts = expert_tiles(ids.reshape(-1), E, 64)
    token_of = torch.arange(n_tokens, device=dev).repeat_interleave(k)
    x_pad = torch.zeros(S_pad, H, dtype=torch.bfloat16, device=dev)
    x_pad[dest] = x[token_of[order]]
    scales = {n: p.get(n) for n in ("w_gate_scale", "w_up_scale",
                                    "w_down_scale")}
    args = (x_pad, te, p["w_gate"], p["w_up"], p["w_down"])

    def kern():
        return grouped_expert_ffn(*args, tile_rows=tr, **scales)

    def plain():
        return grouped_expert_ffn_plain(*args, tile_rows=tr, **scales)

    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    live = torch.zeros(S_pad, dtype=torch.bool, device=dev)
    live[dest] = True
    check(out[~live].abs().max().item() == 0.0,
          f"{name}: padding rows are not exact zeros")
    reading = closeness(torch, name, out, ref)
    k_ms = time_ms(torch, kern)
    p_ms = time_ms(torch, plain, samples=5, per_sample=2)
    S = n_tokens * k
    n_live = int((counts > 0).sum())
    itemsize = p["w_gate"].element_size()
    # Each live expert's three weights (and their f32 column scales) read
    # once, the live rows of x read once, the whole output written once.
    nbytes = n_live * 3 * H * Fi * itemsize + S * H * 2 + S_pad * H * 2
    if scales["w_gate_scale"] is not None:
        nbytes += n_live * (2 * Fi + H) * 4
    flops = 6 * S * H * Fi                 # three products over live rows
    b_ms, b_by = bound(nbytes, flops)
    return {"name": name,
            "shape": {"tokens": n_tokens, "assignments": S, "S_pad": S_pad,
                      "E": E, "k": k, "H": H, "F": Fi, "block_rows": 64,
                      "live_experts": n_live,
                      "tile_rows": tr.tolist()},
            **reading, "kernel_ms": k_ms, "plain_ms": p_ms,
            "library_ms": None,
            "library_note": "no single PyTorch call computes a ragged "
                            "grouped SwiGLU",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops}


def moe_kernel_phases(torch, gen):
    """K3, bf16 and int8 weights, at decode and prefill row counts."""
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.ops.cuda import quantize_moe_params

    dev = torch.device("cuda")
    cfg = get_config("mixtral-8x7b")
    E, H, Fi = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size

    def w(fan_in, *shape):
        return (torch.randn(shape, generator=gen, device=dev)
                .mul_(fan_in ** -0.5).to(torch.bfloat16))

    p = {"router": w(H, H, E), "w_gate": w(H, E, H, Fi),
         "w_up": w(H, E, H, Fi), "w_down": w(Fi, E, Fi, H)}
    q = quantize_moe_params(p)
    out = []
    for name, weights in (("moe_grouped", p), ("moe_grouped_int8", q)):
        for n_tokens in (64, 512):
            out.append(moe_phase(torch, gen, weights, name, n_tokens))
    return out


@contextlib.contextmanager
def routing_log(log: list):
    """Record the expert ids of every `router_topk` call (one per MoE
    layer) into `log` while the block runs."""
    from dynamo_tpu_torch.ops import moe

    router_topk = moe.router_topk

    def spy(cfg, p, x):
        ids, gates = router_topk(cfg, p, x)
        log.append(ids)
        return ids, gates

    moe.router_topk = spy
    try:
        yield log
    finally:
        moe.router_topk = router_topk


def routing_differs(ids_k, ids_g, rows_k, rows_g) -> int:
    """Prompt tokens whose top-k expert set differs between the two paths
    (rows_*: each prompt token's row in that path's flat token axis)."""
    a = ids_k[rows_k].sort(1).values
    b = ids_g[rows_g].sort(1).values
    return int((a != b).any(1).sum())


def compare_paths(torch, cfg, kstate, pstate):
    """A packed prefill of two prompts through K2 (and K3 for a MoE
    model), then 4 greedy decode steps through K1 (and K3), against the
    gather path (and the dense MoE oracle) on `pstate`, fed the same
    tokens.  Returns the per-step logits relative errors, argmax
    agreements, and for a MoE model each path's expert-load sum beside
    the token rows it routed."""
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.models import llama

    dev = torch.device("cuda")
    moe = cfg.is_moe
    prompts = [list(range(3, 3 + 77)), list(range(100, 100 + 140))]
    ccfg = kvc.KvCacheConfig.for_model(cfg, num_blocks=16, block_size=BS)
    cache_k, cache_g = kvc.init_cache(ccfg, dev), kvc.init_cache(ccfg, dev)
    P = 4
    pages = [[1, 2, 3, 4], [5, 6, 7, 8]]
    bt = torch.tensor(pages, dtype=torch.int32, device=dev)
    # Kernels: one packed prefill of both prompts.
    T, R = 224, 8
    tokens = torch.zeros(T, dtype=torch.int32)
    positions = torch.full((T,), 128 * BS, dtype=torch.int32)
    seg = torch.zeros(T, dtype=torch.int32)
    bt8 = torch.zeros(R, P, dtype=torch.int32)
    qs, ql, sl, smp = (torch.zeros(R, dtype=torch.int32) for _ in range(4))
    off = 0
    for i, p in enumerate(prompts):
        n = len(p)
        tokens[off: off + n] = torch.tensor(p)
        positions[off: off + n] = torch.arange(n)
        seg[off: off + n] = i
        bt8[i] = torch.tensor(pages[i])
        qs[i], ql[i], sl[i], smp[i] = off, n, n, off + n - 1
        off += -(-n // 8) * 8
    packed = llama.make_packed_prefill_step(cfg, BS, moe_mode="grouped")
    with routing_log([]) as ids_k:
        res = packed(kstate, cache_k, *(t.to(dev) for t in (
            tokens, positions, seg, bt8, qs, ql, sl, smp)))
    logits_k = res[0][:2]
    loads_k, loads_g = list(res[2:]), []
    # Gather path: the padded [2, Lmax] prefill through the forward step.
    Lmax = max(len(p) for p in prompts)
    tok2 = torch.zeros(2, Lmax, dtype=torch.int32)
    pos2 = torch.full((2, Lmax), 128 * BS, dtype=torch.int32)
    for i, p in enumerate(prompts):
        tok2[i, : len(p)] = torch.tensor(p)
        pos2[i, : len(p)] = torch.arange(len(p))
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    gather = llama.make_forward_step(cfg, BS, use_decode_kernel=False,
                                     moe_mode="dense", with_expert_load=moe)
    with routing_log([]) as ids_g:
        res = gather(pstate, cache_g, tok2.to(dev), pos2.to(dev),
                     lens.to(dev), bt, (lens - 1).to(dev))
    logits_g = res[0]
    loads_g += res[2:]
    errs = [((logits_k - logits_g).abs().max() / logits_g.abs().max()).item()]
    agree = [(logits_k.argmax(-1) == logits_g.argmax(-1)).float().mean().item()]
    # Decode: both caches fed the kernel path's greedy tokens.
    step_k = llama.make_forward_step(cfg, BS, use_decode_kernel=True,
                                     moe_mode="grouped", with_expert_load=moe)
    cur = lens.clone().to(dev)
    nxt = logits_k.argmax(-1).to(torch.int32)
    zero = torch.zeros(2, dtype=torch.int32, device=dev)
    steps = 4
    for _ in range(steps):
        cur = cur + 1
        res = step_k(kstate, cache_k, nxt[:, None], (cur - 1)[:, None], cur,
                     bt, zero)
        lk = res[0]
        loads_k += res[2:]
        res = gather(pstate, cache_g, nxt[:, None], (cur - 1)[:, None], cur,
                     bt, zero)
        lg = res[0]
        loads_g += res[2:]
        errs.append(((lk - lg).abs().max() / lg.abs().max()).item())
        agree.append((lk.argmax(-1) == lg.argmax(-1)).float().mean().item())
        check(bool(torch.isfinite(lk).all()), f"{cfg.name}: non-finite logits")
        nxt = lk.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    worst, tol = max(errs), MODEL_TOL[cfg.name]
    check(worst <= tol, f"{cfg.name}: kernels vs gather path logits rel "
                        f"err {errs} > {tol}")
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "prompts": [len(p) for p in prompts],
           "decode_steps": steps, "logits_rel_err": errs,
           "argmax_agreement": agree, "tol": tol}
    if moe:
        # Each prompt token's row: packed (PACK_ALIGN'd segment starts) and
        # padded [2, Lmax] flattened.
        rows_k = torch.cat([torch.arange(int(qs[i]), int(qs[i]) + len(p))
                            for i, p in enumerate(prompts)]).to(dev)
        rows_g = torch.cat([torch.arange(i * Lmax, i * Lmax + len(p))
                            for i, p in enumerate(prompts)]).to(dev)
        out["routing_differs"] = [
            routing_differs(a, b, rows_k, rows_g)
            for a, b in zip(ids_k, ids_g)]
        out["prompt_tokens"] = len(rows_k)
        per_row = cfg.num_experts_per_token * cfg.num_layers
        rows = {"kernels": T + 2 * steps, "gather": 2 * Lmax + 2 * steps}
        sums = {"kernels": int(torch.stack(loads_k).sum()),
                "gather": int(torch.stack(loads_g).sum())}
        for path in rows:
            check(sums[path] == rows[path] * per_row,
                  f"{cfg.name}: {path} path expert load {sums[path]} != "
                  f"{rows[path]} rows x k x layers")
        out.update(expert_load_sum=sums, routed_rows=rows)
    return out


def model_phase(torch):
    """llama-3-1b at full width: packed prefill (K2) + decode steps (K1)
    against the gather path on the same weights, prompts and tokens."""
    from dynamo_tpu_torch.models import weights
    from dynamo_tpu_torch.models.config import get_config

    dev = torch.device("cuda")
    cfg = get_config("llama-3-1b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = weights.init_params(cfg, gen, dev)
    return {"phase": "model", **compare_paths(torch, cfg, state, state)}


def model_moe_phase(torch, kernels):
    """mixtral-8x7b at full width and 2 layers, random weights: the kernel
    path (K2, K1, K3) against the gather path with the dense MoE oracle,
    with bf16 experts and then int8 experts (the oracle running on the
    dequantised weights).  Returns the two phase lines and the int8 run's
    K3 launches (the int8 variant is on no serve path)."""
    from dynamo_tpu_torch.models import weights
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.ops.cuda import (
        dequantize_moe_params, quantize_moe_params)
    from dynamo_tpu_torch.ops.moe import moe_dense, moe_grouped

    dev = torch.device("cuda")
    cfg = get_config("mixtral-8x7b").replace(num_layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = weights.init_params(cfg, gen, dev)
    kernels.reset_launch_counts()
    bf16 = compare_paths(torch, cfg, state, state)
    bf16_launches = kernels.launch_counts()
    # The MoE block alone on identical inputs (a 224-token prefill's rows):
    # the grouped kernel path against the dense oracle, no routing flips.
    x = torch.randn(1, 224, cfg.hidden_size, generator=gen,
                    device=dev).to(cfg.dtype)
    got, load_g = moe_grouped(cfg, state["layers"][0]["moe"], x)
    want, load_d = moe_dense(cfg, state["layers"][0]["moe"], x)
    check(torch.equal(load_g, load_d), "model_moe: block loads differ")
    block = closeness(torch, "moe_grouped", got[0], want[0])
    quant = [quantize_moe_params(layer["moe"]) for layer in state["layers"]]
    kstate = {**state, "layers": [{**layer, "moe": q} for layer, q in
                                  zip(state["layers"], quant)]}
    pstate = {**state, "layers": [
        {**layer, "moe": dequantize_moe_params(q, cfg.dtype)}
        for layer, q in zip(state["layers"], quant)]}
    kernels.reset_launch_counts()
    int8 = compare_paths(torch, cfg, kstate, pstate)
    int8_launches = kernels.launch_counts()
    for name, launched in (("bf16", bf16_launches), ("int8", int8_launches)):
        check(all(v > 0 for v in launched.values()),
              f"model_moe {name}: a kernel never launched: {launched}")
    return ({"phase": "model_moe", "experts": "bf16", **bf16,
             "launches": bf16_launches,
             "block_vs_dense": {"tokens": 224, "equal": bool(torch.equal(
                 got, want)), **block}},
            {"phase": "model_moe", "experts": "int8", **int8,
             "launches": int8_launches})


def _http(url: str, body=None, timeout: float = 600.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def _chat(base: str, i: int, stream: bool, max_tokens: int) -> dict:
    body = {"model": "m", "max_tokens": max_tokens, "temperature": 0,
            "stream": stream,
            "messages": [{"role": "user",
                          "content": f"Request {i}: say something about "
                                     f"paged attention on a GPU."}]}
    if stream:
        body["stream_options"] = {"include_usage": True}
    t0 = time.monotonic()
    raw = _http(base + "/v1/chat/completions", body)
    wall = time.monotonic() - t0
    if not stream:
        resp = json.loads(raw)
        return {"stream": False, "wall_s": wall,
                "tokens": resp["usage"]["completion_tokens"],
                "finish": resp["choices"][0]["finish_reason"], "done": True}
    lines = [ln for ln in raw.split("\n") if ln.startswith("data: ")]
    done = bool(lines) and lines[-1].strip() == "data: [DONE]"
    chunks = [json.loads(ln[6:]) for ln in lines if ln.strip() != "data: [DONE]"]
    usage = [c["usage"] for c in chunks if c.get("usage")]
    finish = [ch["finish_reason"] for c in chunks for ch in c["choices"]
              if ch.get("finish_reason")]
    return {"stream": True, "wall_s": wall, "done": done,
            "tokens": usage[-1]["completion_tokens"] if usage else 0,
            "finish": finish[-1] if finish else None}


def serve_phase(model: str, args=(), path_kernels=(), n_requests: int = 8,
                max_tokens: int = 64, ready_s: float = 300):
    """`python -m dynamo_tpu_torch.frontend --model <model> <args>` as a
    subprocess: after a warm-up request and a stats reset (launch counts,
    engine counters and expert load together), `n_requests` concurrent
    greedy chats, half streaming; every kernel of `path_kernels` must have
    launched in that window."""
    OUT_DIR.mkdir(exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    log_path = OUT_DIR / f"chip_smoke_server_{model}.log"
    log = open(log_path, "w")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--model",
         model, "--model-name", "m", "--http-port", str(port), *args],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise SmokeError(f"server exited rc {proc.returncode}: "
                                 + log_path.read_text()[-2000:])
            try:
                if json.loads(_http(base + "/health", timeout=5))["status"] == "ready":
                    break
            except OSError:
                pass
            check(time.monotonic() - t0 < ready_s,
                  f"server not ready in {ready_s} s")
            time.sleep(0.5)
        startup_s = time.monotonic() - t0
        _chat(base, -1, False, 4)  # warm-up: cuBLAS handles, allocator
        _http(base + "/debug/stats/reset", {})
        t1 = time.monotonic()
        with ThreadPoolExecutor(n_requests) as pool:
            results = list(pool.map(
                lambda i: _chat(base, i, i % 2 == 0, max_tokens),
                range(n_requests)))
        wall = time.monotonic() - t1
        stats = json.loads(_http(base + "/debug/stats"))
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    for r in results:
        check(r["done"], f"request without [DONE]/response: {r}")
        check(r["tokens"] == max_tokens or (r["finish"] == "stop"
                                            and r["tokens"] > 0),
              f"request returned {r['tokens']} tokens ({r['finish']})")
    launches = stats["kernels"]
    check(all(launches[k] > 0 for k in path_kernels),
          f"a {model} path kernel never launched: {launches}")
    reqs = stats["requests"]
    check(len(reqs) == n_requests, f"server timed {len(reqs)} requests")
    ttfts = [r["ttft_s"] for r in reqs]
    itl_n = sum(r["itl_n"] for r in reqs)
    out_tokens = sum(r["tokens"] for r in results)
    return {"phase": "serve", "model": model, "args": list(args),
            "startup_s": startup_s, "requests": n_requests,
            "streaming": sum(r["stream"] for r in results),
            "max_tokens": max_tokens, "output_tokens": out_tokens,
            "wall_s": wall, "output_tok_s": out_tokens / wall,
            "ttft_mean_s": statistics.mean(ttfts),
            "ttft_max_s": max(ttfts),
            "itl_mean_s": (sum(r["itl_sum_s"] for r in reqs) / itl_n
                           if itl_n else None),
            "launches": launches, "counters": stats["counters"],
            "moe_mode": stats["moe_mode"], "expert_load": stats["expert_load"]}


def serve_moe_phase():
    """mixtral-8x7b, 16 of 32 layers, through K1, K2 and K3; the expert
    load must count k assignments per model row per layer, none dropped."""
    from dynamo_tpu_torch.models.config import get_config

    cfg = get_config("mixtral-8x7b")
    out = serve_phase("mixtral-8x7b", ("--num-layers", str(MOE_LAYERS)),
                      ("paged_decode_attention", "paged_prefill_attention",
                       "moe_grouped"), ready_s=600)
    check(out["moe_mode"] == "grouped", f"serve_moe ran {out['moe_mode']}")
    load = out["expert_load"]
    rows = out["counters"]["model_rows"]
    want = rows * cfg.num_experts_per_token * MOE_LAYERS
    check(len(load) == cfg.num_experts + 1 and sum(load[:-1]) == want
          and load[-1] == 0,
          f"serve_moe expert load {load} != {rows} rows x k x layers, 0 dropped")
    out.update(phase="serve_moe", layers=MOE_LAYERS, routed_assignments=want)
    return out


def summary_entry(k: dict, name: str, launches: int, **extra) -> dict:
    src, replaces = SOURCES[k["name"].replace("_int8", "")]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "shape": k["shape"], **extra}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU only", file=sys.stderr)
        return 2
    try:
        from dynamo_tpu_torch.ops import cuda as kernels
        from dynamo_tpu_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        kind = torch.cuda.get_device_name(0)
        emit({"phase": "device", "name": kind,
              "count": torch.cuda.device_count(), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        phase = "build"
        t0 = time.monotonic()
        times = build.build_all()
        emit({"phase": "build", "seconds": times,
              "wall_s": time.monotonic() - t0})
        phase = "kernel_list"
        emit({"phase": "kernel_list", "names": list(kernels.KERNELS)})
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        attn = {}
        for d in (64, 128):
            for key, fn in (("paged_decode_attention", decode_phase),
                            ("paged_prefill_attention", prefill_phase)):
                phase = f"{key}_d{d}"
                attn[key, d] = fn(torch, gen, d)
                emit({"phase": phase, **attn[key, d]})
        phase = "moe_grouped"
        moe = moe_kernel_phases(torch, gen)
        for k in moe:
            emit({"phase": k["name"], **k})
        torch.cuda.empty_cache()
        phase = "model"
        emit(model_phase(torch))
        torch.cuda.empty_cache()
        phase = "model_moe"
        moe_bf16, moe_int8 = model_moe_phase(torch, kernels)
        emit(moe_bf16)
        emit(moe_int8)
        torch.cuda.empty_cache()
        phase = "serve"
        serve = serve_phase("llama-3-1b", (), ("paged_decode_attention",
                                               "paged_prefill_attention"))
        emit(serve)
        phase = "serve_moe"
        serve_moe = serve_moe_phase()
        emit(serve_moe)
    except Exception as e:  # every failure ends the run without an ok line
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        return 1
    print(smi, flush=True)
    # K1/K2: launches on the serve path of their geometry (llama-3-1b at
    # D 64, mixtral-8x7b at D 128).  K3 bf16: launches of serve_moe; K3
    # int8 (on no serve path): launches of model_moe's int8 run.
    summary = []
    for (key, d), k in attn.items():
        run = serve if d == 64 else serve_moe
        summary.append(summary_entry(
            k, key if d == 64 else f"{key}_d{d}", run["launches"][key],
            launches_from=run["phase"]))
    for k in moe:
        prefill = k["shape"]["tokens"] > 64
        name = k["name"] + ("_prefill" if prefill else "")
        if k["name"] == "moe_grouped":
            launches, frm = serve_moe["launches"]["moe_grouped"], "serve_moe"
        else:
            launches, frm = moe_int8["launches"]["moe_grouped"], "model_moe int8"
        summary.append(summary_entry(k, name, launches, launches_from=frm))
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
