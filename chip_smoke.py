#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dynamo_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (a failed phase exits non-zero and prints no
`ok` line):

1. device   — the card's name, count, torch/CUDA versions, and the
   rank -> card map an `--sp 4` ring gets on this machine.
2. build    — nvcc builds every kernel source, one process each, at once.
3. sass     — for each library whose products run on the tensor cores
   (paged_prefill, ring_flash, moe_grouped on wgmma; paged_decode on
   mma.sync): its SASS's HGMMA (wgmma), HMMA (mma.sync) and FFMA counts,
   and ptxas's registers, spill bytes and static shared memory per kernel
   instantiation; it fails if both tensor-core counts are 0, or if a wgmma
   library has no HGMMA.
4. kernel_list — the kernels of the main paths.
5. one line per kernel and geometry, held against its plain PyTorch
   version at a main path's shapes, with its time (CUDA events), the plain
   version's, a one-call PyTorch yardstick where one exists
   (scaled_dot_product_attention on the gathered context for K1/K2; the
   port never calls it) and the least time the card could take (bytes
   over 3.35 TB/s, operations over 989 TFLOP/s bf16 — NVIDIA's H100 SXM
   data sheet), and for K2/K4 the effective TFLOP/s (the function's flops
   over the kernel's time):
   - paged decode / prefill attention (K1 / K2) at llama-3-1b's geometry
     (Hq 32, Hkv 8, D 64, block 64) and at mixtral-8x7b's (D 128), over a
     bf16 cache and over an int8 cache with its f32 scales (the `_int8`
     phases: the same K/V quantized, the bound counted from int8 and
     scale bytes, SDPA on the dequantized gathered context); K1 at batch
     64, context 512 and at the served batch of 8, context 256 (the `_b8`
     phases); K1's times are CUDA-graph replays (the card's time: at
     batch 8 an eager loop measures the host's enqueue), its eager time
     beside them; K1 also at head geometries no served preset has
     (`WIDE_DECODE`: D 80 and D 96, and 32 and 24 query heads a kv head
     at D 128), bf16 and int8, at batch 64, context 512;
   - the grouped expert FFN (K3), bf16 and int8 weights, at mixtral-8x7b
     width (E 8, top-2, H 4096, F 14336) with serve_moe's decode bucket (8
     tokens), 64 tokens and prefill (512 tokens) row counts routed by the
     port's own MoE routing, each line with the kernel's group width;
   - the ring attention flash fold (K4), bf16 and int8 blocks, D 64 and
     D 128 at Hq 32 / Hkv 8: the whole ring of 4 ranks on card 0 (and a
     second line over 4 distinct cards where the machine has them) at
     T 512 (T_loc 128, the served shape) and T 8192 (T_loc 2048), against
     the plain ring and against the port's causal_attention on the
     unsharded sequence; timed as a whole (4 ranks x 4 hops, copies
     included) and as one fold launch; the yardstick is one causal
     scaled_dot_product_attention call on the whole sequence.  The bound
     counts what the function must move (q, out, every visiting block);
     the f32 state that one launch per hop stores and reloads is printed
     beside it as `state_bytes`.
6. model    — llama-3-1b at full width, random weights: packed prefill and
   decode steps through the kernels against the gather path.
7. model_int8 — the same over an int8 KV cache (K2 and K1 int8 against
   the gather path's dequantizing read), fed the bf16 run's tokens; how far
   its logits are from the bf16-cache run is printed for information.
8. model_moe — mixtral-8x7b at full width and 2 layers, random weights:
   packed prefill (K2 + K3) and decode steps (K1 + K3) against the gather
   path with the dense MoE oracle, once with bf16 experts and once with
   int8 experts (the oracle on the dequantised weights).
8b. model_spec — llama-3-1b at full width and depth in process: `serve`'s
   8 prompts and 4 repetitive ones, 64 greedy tokens each, through an
   engine with speculative decode (K 3) and one without, on the same
   weights: the ids must match up to a split at a near tie
   (`argmax_gap` against the gather path's logits); the spec run must
   draft, accept no more than it drafted and launch K2.  Acceptance and
   the tokens a row gains per forward are reported.
9. serve    — `python -m dynamo_tpu_torch.frontend --model llama-3-1b` as a
   subprocess; launch counts zeroed, then concurrent streaming and unary
   greedy chat requests over HTTP; each must return its tokens and the
   streams their `[DONE]`; K1 and K2 must have launched.  /v1/embeddings
   answers (see `embeddings`).  Then two lone
   greedy chats, one at a time, whose text the next phase must match, and
   serve_disagg's two long chats, each twice: the second time its sealed
   blocks come from the prefix cache and only its last partial block
   prefills, as on a disagg decode worker, whose text must match it;
   last, the chat that `fleet` drains mid-decode, undrained: its greedy
   reference.
10. serve_distributed — the same model on two `python -m
   dynamo_tpu_torch.worker` processes sharing the card, behind frontend A
   (`--serve-control-plane --router-mode kv`) and frontend B
   (`--control-plane` A's, `--router-mode round_robin`): the lone chats
   through A must give `serve`'s text; chats on two 640-byte system
   prompts, one at a time, must each land on the worker that holds their
   prompt (its prefix-hit tokens grow by the prompt's whole blocks, the
   other's stay); then a concurrent wave of 8 chats (4 on each prompt)
   through A and the same through B, where every request returns its
   tokens and both workers launch K1 and K2.  The waves' tok/s, TTFT and
   ITL are printed beside `serve`'s.
   Fleet prefix sharing: with P's home kept busy by a long chat, the next
   P chat goes to the other worker with a donor hint, which must pull the
   home's blocks over cuda_ipc (no host-staged block) and take them as
   prefix hits; any kv-wave chat sent off its prompt's home must too.
   Then /v1/embeddings through A must give `serve`'s rows bit for bit,
   and /clear_kv_blocks through A must clear both workers' inactive
   blocks (a count each), empty A's KV index of both and leave the next
   sticky chat no prefix hit.
10a. serve_observed — llama-3-1b on one worker behind frontend A with
   every observability plane on (traces at rate 1, the request ledger, a
   TTFT objective, the flight recorder, the stall watchdog, the device
   profiler): `serve`'s wave; /metrics on both carries the JAX surfaces'
   families (with the drain and QoS ones), counts the wave's 8
   requests and TTFTs, and the device profiler's registry and drift
   ratios (kv_decode <= 1.25, window_time printed, nothing paged); each
   chat's spans chain across both processes (http → router.select →
   rpc.client → rpc.server → engine.queue_wait / engine.ttft); each
   chat's ledger covers its TTFT within JAX's coverage bounds; a 500 ms
   device capture during a second wave: busy share, top ten kernels (K1
   and K2 among what ran) and the five longest idle gaps with the host op
   spanning each; the flight recorder's ring and a SIGUSR2 dump hold the
   wave; the wave's engine counters equal those of the same stack with
   every plane off, and in process the steady window's counters are
   byte-identical with every plane on and off.  The wave's tok/s, TTFT
   and ITL beside the planes-off stack's and `serve`'s.
10b. embeddings — `serve`'s /v1/embeddings rows (strings and token lists,
   float and base64) against the plain forward's last hidden state in
   process (EMBED_TOL).
10c. serve_spec — one worker with `--spec-decode 3` behind frontend A:
   `serve`'s wave and a repetitive wave (tok/s, TTFT, ITL and the
   worker's acceptance beside `serve`'s); each must take spec steps and
   launch K2; `serve`'s lone logprobs chats on it take the plain step and
   give `serve`'s ids and logprobs bit for bit.
11. block_copy — the KV data plane's copies at llama-3-1b geometry for one
   offer batch of 8 blocks: the batched extract and inject (bf16 and int8
   cache; CUDA-event times beside the bytes' bound, the round trip
   byte-exact), and a pull from another process (`--kv-holder`) over
   cuda_ipc and over the host-staged plane, byte-exact, host-clock times.
12. serve_disagg — llama-3-1b disaggregated: a `--role prefill` and a
   `--role decode --max-local-prefill 512` worker sharing the card behind
   frontend A; two long chats (~1,600 prompt tokens) one at a time must
   give `serve`'s text, then a wave of 4 long and 4 short chats.  On the
   decode worker every long chat prefilled remotely with no fallback, the
   onboarded tokens are its sealed blocks x 64, every pull rode cuda_ipc,
   some blocks streamed before prefill-done, K1 and K2 launched; the
   prefill worker launched K2 and no K1.
13. serve_int8 — the same with `--kv-quant int8` and a shared system
   prompt of 10 blocks, which a warm-up chat puts in the prefix cache:
   only the int8 bodies of K1 and K2 may launch, and the prefix cache
   must serve every request the blocks of the prefix the 8 prompts share.
14. serve_moe — the same against `--model mixtral-8x7b --num-layers 16`
   (one card cannot hold its 32 layers): K1, K2 and K3 must have
   launched and the expert load must count every routed row.
15. model_sp — llama-3-1b at full width and depth: a 480-token and a
   512-token prompt through the sequence-parallel prefill step (4 ranks
   on card 0, K4) against the packed prefill step (K2), over a bf16 and
   an int8 cache: logits, greedy tokens, the written cache rows, the K4
   launch count, then two decode steps (K1) from each cache.
16. serve_sp — `--model llama-3-1b --sp 4` as a subprocess: long chats
   (400-500 prompt tokens, no shared first block) one at a time while
   nothing decodes, which must all prefill through the ring kernel with
   16 layers x 4 ranks x 4 hops fold launches a dispatch and the modeled
   ring bytes of the reference's formula; then the mixed wave of `serve`
   plus two long chats (K1, K2 and K4 all launch); then the same lone
   long chats on an `--sp 4 --kv-quant int8` server, which must take K4's
   int8 body with the int8 payload's ring bytes.  The long chats' TTFT is
   printed beside that of the same chats on an `--sp 1` server.
17. qos      — a frontend and one llama-3-1b worker of 24 pages: a wave of
   best-effort chats (`x-dynamo-priority: 0`) fills the pages, then
   interactive chats arrive; they must be admitted before every
   best-effort chat still queued, preempting at least one
   (`dynamo_qos_preemptions_total`); every chat returns its tokens; a
   preempted chat's greedy ids equal its lone run's (a split only at a
   near tie).  TTFT by class.
18. planner_profile — the SLA profiler (`dynamo_tpu_torch.planner.profiler`)
   sweeps llama-3-1b on ISL 128 / 512, context 256 / 1024 and kv 0.2 /
   0.6 into `smoke_out/sla_profile.json`: JAX's schema, every time finite
   and positive, K1 and K2 launched; the SLA planner's targets from it.
19. fleet    — `python -m dynamo_tpu_torch.launcher` on a graph of a
   standalone control plane (`--store file:`), a kv-routed frontend, the
   metrics aggregator and the load planner spawning llama-3-1b workers:
   a wave makes the planner add a second worker, which takes a long
   greedy chat; the aggregator shows both; the planner's scale-down
   drains the chat's worker mid-decode (or, where the chat is on the
   other worker, the control-plane command does); the chat finishes
   through the peer with its sealed KV pulled over cuda_ipc, its greedy
   ids equal `serve`'s (a split only at a near tie) and each id is the
   plain model's greedy choice given the ids before it, up to a near
   tie; a clean drain, one replica left, no chat lost; SIGTERM tears the
   graph down in reverse order.
20. tiers   — the KV tiers in process (after `block_copy`): llama-3-1b
   on `InferenceEngine`s of 64 usable pages (G1), bf16 then int8; a wave
   of 8 distinct 1,024-token prompts (16 sealed blocks each, 128 blocks,
   G1 twice over), one at a time; then each of the first 4 prompts from
   the lower tier it sits in and again from G1.  Legs: G2 of 192 blocks
   (384 MiB pinned in bf16), G2 of 32 with G3 of 192 (the first prompts
   spill to disk), and G4: a G1-only engine whose `remote_fetch_fn`
   pulls from the G2 leg's engine through its manager's `export_block`.
   Checked: the first prompt's blocks read below G1, and back in G1
   after its onboard, equal their bytes before the offload (back in G1
   but for the prompt's last token, which a full hit prefills again);
   an onboarded prompt answers token for token as its G1 hit does (and
   as the peer, for G4); prefix hits, offloaded, onboarded and
   remote-fetched blocks reach what the sizing implies; K1 and K2
   launch, only their int8 bodies in the int8 legs.  Printed with the
   card's name and power limit: TTFT medians (cold, G1, G2, G3, G4),
   offload and onboard GB/s (CUDA events on their streams) beside a
   plain pinned `copy_` of 16 blocks each way, the engine thread's host
   ms an evicted block and the pinned allocation's seconds.
21. qos (its tier leg, run after `tiers`) — in process, llama-3-1b with
   64 pages and a G2 of 64: a burn sheds a decoding best-effort request
   for a standard one; its sealed blocks demote into G2 (and leave G1),
   its resumption onboards them, and its answer equals the unpressured
   run's (a split only at a near tie).
22. router_service — two llama-3-1b workers, `python -m
   dynamo_tpu_torch.router_service` (`m-routed`) and frontend B
   (round_robin): `serve`'s lone chats through the service equal
   `serve`'s; a second chat on one system prompt lands on the first's
   worker; the service counts the streams; a wave through an in-process
   consumer wrapped in a `StreamRecorder` (TTFT and ITL from raw
   arrivals) beside the same wave's ledger and timings at frontend B.
23. ingress — `--input batch` over 8 prompts against llama-3-1b writes
   `serve`'s answers to the same completions; `--out echo` returns the
   prompt; `--out mocker` answers and its process launches no kernel.
24. checkpoint — the seed-0 llama-3-1b preset written as an HF-layout
   checkpoint under `smoke_out/checkpoint/` (bf16, two shards and their
   index, config.json, tokenizer_config.json with a chat template and
   eos, and a Llama-3-style tokenizer.json built here: the Split regex,
   2000 byte-level BPE merges learnt from this script's own text,
   Llama-3's special tokens at their ids), read back in process
   (bit-equal to the preset on the card; load seconds and GB/s) and
   served by `python -m dynamo_tpu_torch.frontend --model <dir>`:
   `serve`'s wave (K1 and K2 launched; TTFT / ITL beside `serve`'s), two
   lone chats whose ids must equal an in-process engine's on the preset
   given the same prompt ids (a split only at a near tie), text round
   trips through the port's tokenizer.
25. tools_responses — inside 24's serve: /v1/responses unary and
   streaming (events, text and usage equal to the same turn as a chat),
   a chat with tools and a forced tool_choice (one call, finish
   `tool_calls`), tool_choice "none" (the plain chat's content).
26. multimodal — a `--role encode` worker, a worker serving 24's
   checkpoint and frontend A: two image chats and a repeat of the first;
   each answer the argmax (a near tie allowed) of a teacher-forced
   gather-path forward given the stub tower's embeddings; the two images
   answer differently, the repeat equally; no prefix hit; every
   embedding crossed the device plane (CUDA IPC: frontend A's plane
   tallies); K2 and K1 launched on the worker.
27. gguf — llama-3-1b at full width as a GGUF (F16 embedding, F32 norms,
   Q4_K / Q8_0 / Q6_K layers, random blocks with bounded f16 scales),
   loaded and dequantized on the card; every tensor of the state
   bit-equal to the numpy dequant taken through the same unpermute,
   transpose and cast; then `compare_paths` through K2 and K1 against
   the gather path.

Then the card's `nvidia-smi` name/power-limit line, the kernels summary
`{"kernels": [...]}` and, last, `{"ok": true, "device": {...}}`.
It needs CUDA and the repository around it.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import time
import traceback
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

SCRIPT = Path(__file__).resolve()
ROOT = SCRIPT.parent
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
RING_ATOL, RING_ROW_TOL = 5e-4, 6e-3
# The int8 attention bodies dequantize into the same bf16 operands as
# their plain versions (kv_cache.dequantize_rows), so they keep the bf16
# bodies' limits.
ATOL = {"paged_decode_attention": 3e-3, "paged_prefill_attention": 8e-3,
        "paged_decode_attention_int8": 3e-3,
        "paged_prefill_attention_int8": 8e-3,
        "moe_grouped": 4e-3, "moe_grouped_int8": 4e-3,
        # The fold kernel and the plain ring run the same f32 arithmetic
        # and differ in the order of their sums (64-key tiles against the
        # whole block) and in expf against torch.exp; the output rounds to
        # bf16 once, so every error read so far sits inside RTOL * |plain|
        # (ATOL needed 1.4e-7) and the row error is at most 2.9e-3.
        # Against causal_attention the probabilities also round to bf16 on
        # one side only (ATOL needed 4.1e-3, row error 5.2e-3).
        "ring_flash_attention": RING_ATOL, "ring_flash_attention_int8": RING_ATOL,
        "ring_vs_causal": 8e-3}
# Limits about twice the largest reading on an H100 80GB HBM3 at these
# shapes and at those of tests/test_torch_cuda.py.
ROW_TOL = {"paged_decode_attention": 1e-2, "paged_prefill_attention": 1e-2,
           "paged_decode_attention_int8": 1e-2,
           "paged_prefill_attention_int8": 1e-2,
           "moe_grouped": 4e-3, "moe_grouped_int8": 4e-3,
           "ring_flash_attention": RING_ROW_TOL,
           "ring_flash_attention_int8": RING_ROW_TOL, "ring_vs_causal": 1e-2}
# Relative logits error, kernel path vs gather path.  The MoE model's is
# larger: the two attention paths differ in the last bf16 bit, and a
# router whose 2nd and 3rd expert logits nearly tie then picks another
# expert for that token (model_moe's `routing_differs`: 2 of 217 prompt
# tokens in layer 0 and 1 in layer 1 on an H100 80GB HBM3, 0.067 at the
# prefill step), while on identical inputs the grouped kernel and the
# dense oracle agree (`block_vs_dense`).
# Over an int8 cache each path writes its own cache from K/V that differ
# in the last bf16 bit, so a few rows quantize one step apart; the limit
# stays the bf16 cache's.  Random weights leave near ties at the top of a
# 128k vocabulary, so the two paths' greedy tokens may differ, but only
# where the reference's logit for the kernel path's token is within the
# same limit of its maximum (`argmax_gap`, relative to max |logit|).
MODEL_TOL = {"llama-3-1b": 5e-2, "mixtral-8x7b": 1.5e-1}
SEED = 0                       # also the server's weight seed (EngineConfig)
SYSTEM_BLOCKS = 10             # serve_int8's shared system prompt, in blocks
BS, HQ, HKV = 64, 32, 8        # attention geometry of both models, block 64
MOE_LAYERS = 16                # mixtral-8x7b depth served on one 80 GB card
SP = 4                         # ring ranks of the sp phases
RING_SHAPES = ((1, 512), (1, 8192))   # (B, T): T_loc 128 (served), 2048
LONG_CHATS = 4                 # serve_sp's first wave
# Libraries whose products run on the tensor cores: the sass phase fails
# if their SASS holds no HGMMA (wgmma) or HMMA (mma.sync) instruction, and
# if one of WGMMA_LIBS holds no HGMMA.
TENSOR_CORE_LIBS = ("paged_prefill", "ring_flash", "moe_grouped",
                    "paged_decode")
WGMMA_LIBS = ("paged_prefill", "ring_flash", "moe_grouped")
# K1's shapes: (batch, context): the table's B 64 and the served decode
# bucket of 8 chats.
DECODE_SHAPES = ((64, 512), (8, 256))
# K1 at head geometries no served preset has (tag, Hq, Hkv, D), at the
# table's B 64, context 512: Phi-2's D 80, Phi-3-mini's D 96, and 32 and
# 24 query heads a kv head (two query tiles, the second one partial).
WIDE_DECODE = (("d80", 32, 8, 80), ("d96", 32, 4, 96),
               ("d128_g32", 32, 1, 128), ("d128_g24", 24, 1, 128))
MOE_TOKENS = (8, 64, 512)      # K3: serve_moe's decode bucket, 64, prefill
# Each kernel's source and the TPU kernel it replaces.
SOURCES = {
    "paged_decode_attention": ("dynamo_tpu_torch/csrc/paged_decode.cu",
                               "dynamo_tpu/ops/pallas/paged_attention.py:258"),
    "paged_prefill_attention": ("dynamo_tpu_torch/csrc/paged_prefill.cu",
                                "dynamo_tpu/ops/pallas/paged_prefill.py:227"),
    "moe_grouped": ("dynamo_tpu_torch/csrc/moe_grouped.cu",
                    "dynamo_tpu/ops/pallas/moe_grouped.py:141"),
    "ring_flash_attention": ("dynamo_tpu_torch/csrc/ring_flash.cu",
                             "dynamo_tpu/ops/pallas/ring_attention.py:350"),
}


class SmokeError(Exception):
    pass


T_START = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's carries the run's seconds so far (t_s)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.monotonic() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def bound(nbytes: float, flops: float):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / BF16_FLOPS_PER_S * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


def tflops(flops: float, ms: float) -> float:
    """Effective rate: the function's flops over the measured time."""
    return flops / (ms * 1e-3) / 1e12


def closeness(torch, name: str, out, ref, limits: str = "") -> dict:
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
    limits = limits or name
    reading = {"max_abs_err": diff.max().item(), "atol_needed": need,
               "atol": ATOL[limits], "rtol": RTOL, "row_rel_err": row,
               "row_tol": ROW_TOL[limits]}
    check(not bool((e_norm[~live] > 0).any()),
          f"{name}: rows the plain version zeroes are not zero")
    check(need <= ATOL[limits] and row <= ROW_TOL[limits],
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


def graph_ms(torch, fn, samples: int = 25, per_sample: int = 10) -> float:
    """time_ms of `per_sample` calls captured once in a CUDA graph and
    replayed: the card's time for them, without the host's time to enqueue
    them (which sets an eager loop of a kernel of a few microseconds)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()                                  # warm the side stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(per_sample):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    return time_ms(torch, graph.replay, samples, 1) / per_sample


def sdpa_inputs(torch, kvc, q, kc, vc, block_tables, seq_lens, q_pos,
                scales=None):
    """Dense [R, Hq, *, D] tensors of each row's gathered context (bf16,
    dequantized from an int8 cache given with its `scales`) plus its
    boolean mask, for torch's scaled_dot_product_attention."""
    R, P = block_tables.shape
    C = P * BS
    hkv = kc.shape[1] // q.shape[-1]
    ctx = torch.arange(C, device=q.device).expand(R, C)
    slots = kvc.slots_for_positions(block_tables, ctx, BS)
    if scales is None:
        k, v = kvc.gather_kv(kc, vc, slots, hkv)               # [R, C, Hkv, D]
    else:
        k, v = kvc.gather_kv_quant(kc, vc, *scales, slots, hkv)
    g = q.shape[1] // hkv
    k = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    mask = (ctx[:, None, None, :] < seq_lens[:, None, None, None].long()) & (
        ctx[:, None, None, :] <= q_pos[:, None, :, None])
    return k, v, mask


def cache_operands(torch, kvc, kc, vc, quant: bool, hkv: int = HKV):
    """(K, V, {k_scale, v_scale}) as the kernel takes them: the bf16
    buffers, or their int8 quantization with its [S, Hkv] scales; and the
    K+V bytes one context token costs."""
    if not quant:
        return kc, vc, {}, 2 * kc.shape[1] * 2
    kq, ks = kvc.quantize_kv_rows(kc, hkv)
    vq, vs = kvc.quantize_kv_rows(vc, hkv)
    return kq, vq, {"k_scale": ks, "v_scale": vs}, 2 * (kc.shape[1] + 4 * hkv)


def decode_inputs(torch, gen, D, quant=False, B=64, ctx=512, hq=HQ,
                  hkv=HKV):
    """K1's operands at batch B, context ctx, hq query and hkv kv heads: q,
    the cache (bf16, or int8 with its scales in `sc`), a table of shuffled
    pages and ragged seq_lens; `token_bytes` is one cached token's K/V
    bytes."""
    from dynamo_tpu_torch.engine import kv_cache as kvc

    dev = torch.device("cuda")
    P = ctx // BS
    nblocks = 1 + B * P + 64
    S = nblocks * BS
    kc = torch.randn(S, hkv * D, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(S, hkv * D, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(B, hq, D, generator=gen, device=dev).to(torch.bfloat16)
    # Shuffled, non-contiguous pages; a few ragged and empty rows (at
    # batch 8 like a served bucket: a padding row, chats of 1-256 tokens).
    perm = torch.randperm(nblocks - 1, generator=gen, device=dev)[: B * P] + 1
    bt = perm.reshape(B, P).to(torch.int32)
    lens = [ctx] * B
    ragged = ((1, 0), (2, 1), (3, 63), (4, 65), (5, 300), (6, 0), (7, 129))
    if B == 8:
        ragged = ((1, 0), (2, 1), (3, 63), (4, 65), (5, 200), (6, 129),
                  (7, 219))
    for i, n in ragged:
        lens[i] = n
    for i, n in enumerate(lens):
        bt[i, -(-n // BS):] = 0  # unallocated entries are the null block
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kc, vc, sc, token_bytes = cache_operands(torch, kvc, kc, vc, quant, hkv)
    return {"q": q, "kc": kc, "vc": vc, "bt": bt, "sl": sl, "sc": sc,
            "lens": lens, "token_bytes": token_bytes}


def decode_phase(torch, gen, D, quant=False, B=64, ctx=512, hq=HQ, hkv=HKV):
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.ops.cuda import (
        paged_decode_attention, paged_decode_attention_plain)

    a = decode_inputs(torch, gen, D, quant, B, ctx, hq, hkv)
    q, kc, vc, bt, sl, sc = (a[n] for n in ("q", "kc", "vc", "bt", "sl", "sc"))
    lens, token_bytes = a["lens"], a["token_bytes"]
    scale = D ** -0.5
    name = "paged_decode_attention" + ("_int8" if quant else "")

    def kern():
        return paged_decode_attention(q, kc, vc, bt, sl, block_size=BS, **sc)

    def plain():
        return paged_decode_attention_plain(q, kc, vc, bt, sl, block_size=BS,
                                            **sc)

    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    check(out[1].abs().max().item() == 0.0, f"{name}: seq_len 0 row not zero")
    reading = closeness(torch, name, out, ref)
    # K1 runs for a few microseconds at the served batch, under the host's
    # time to enqueue a call: its time is taken from a CUDA graph's replay;
    # eager_ms is the same calls enqueued one by one.
    k_ms = graph_ms(torch, kern)
    eager_ms = time_ms(torch, kern)
    p_ms = time_ms(torch, plain, samples=5, per_sample=2)
    k4, v4, mask = sdpa_inputs(torch, kvc, q, kc, vc, bt, sl,
                               (sl.long() - 1)[:, None],
                               tuple(sc.values()) or None)
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask, scale=scale))
    tokens = sum(lens)
    pages = sum(-(-n // BS) for n in lens)
    nbytes = (q.numel() * 2 + tokens * token_bytes + pages * 4 + B * 4
              + out.numel() * 2)
    flops = 4 * hq * D * tokens
    b_ms, b_by = bound(nbytes, flops)
    return {"name": name,
            "shape": {"B": B, "ctx": ctx, "block": BS, "Hq": hq, "Hkv": hkv,
                      "D": D, "cache": "int8" if quant else "bf16",
                      "seq_lens": lens[:8]},
            **reading, "kernel_ms": k_ms, "eager_ms": eager_ms,
            "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}


def prefill_phase(torch, gen, D, quant=False):
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
    name = "paged_prefill_attention" + ("_int8" if quant else "")
    kc, vc, sc, token_bytes = cache_operands(torch, kvc, kc, vc, quant)

    def kern():
        return paged_prefill_attention(q, kc, vc, bt, sl_t, qs_t, ql_t,
                                       block_size=BS, **sc)

    def plain():
        return paged_prefill_attention_plain(q, kc, vc, bt, sl_t, qs_t, ql_t,
                                             block_size=BS, **sc)

    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    reading = closeness(torch, name, out, ref)
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
                               sl_t[:n_real], q_pos,
                               tuple(sc.values()) or None)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask,
                                         scale=D ** -0.5))
    kv_tokens = sum(sl)
    visible = sum(sum(pre + i + 1 for i in range(n))
                  for n, pre in zip(lens, prefix))
    pages = sum(-(-s // BS) for s in sl)
    nbytes = (q.numel() * 2 + kv_tokens * token_bytes + pages * 4
              + 3 * R * 4 + out.numel() * 2)
    flops = 4 * HQ * D * visible
    b_ms, b_by = bound(nbytes, flops)
    return {"name": name,
            "shape": {"T": T, "segments": lens, "cached_prefix": prefix,
                      "block": BS, "Hq": HQ, "Hkv": HKV, "D": D,
                      "cache": "int8" if quant else "bf16"},
            **reading, "kernel_ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, "tflops": tflops(flops, k_ms)}


def moe_inputs(torch, gen, p, n_tokens):
    """K3's operands at mixtral-8x7b width: n_tokens tokens routed by the
    port's own MoE routing (router_topk + expert_tiles) over the weights
    `p`, gathered into expert-sorted 64-row tiles."""
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.ops.moe import expert_tiles, router_topk

    dev = torch.device("cuda")
    cfg = get_config("mixtral-8x7b")
    E, k, H = cfg.num_experts, cfg.num_experts_per_token, cfg.hidden_size
    x = torch.randn(n_tokens, H, generator=gen, device=dev).to(torch.bfloat16)
    ids, _ = router_topk(cfg, p, x)
    order, dest, S_pad, te, tr, counts = expert_tiles(ids.reshape(-1), E, 64)
    token_of = torch.arange(n_tokens, device=dev).repeat_interleave(k)
    x_pad = torch.zeros(S_pad, H, dtype=torch.bfloat16, device=dev)
    x_pad[dest] = x[token_of[order]]
    scales = {n: p.get(n) for n in ("w_gate_scale", "w_up_scale",
                                    "w_down_scale")}
    return {"args": (x_pad, te, p["w_gate"], p["w_up"], p["w_down"]),
            "tile_rows": tr, "scales": scales, "dest": dest,
            "counts": counts}


def moe_phase(torch, gen, p, name, n_tokens):
    """K3 at mixtral-8x7b width over `moe_inputs`, so the tiles are ragged
    and padding rows and dead tiles exist, against the plain version."""
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.ops.cuda import (
        grouped_expert_ffn, grouped_expert_ffn_plain)
    from dynamo_tpu_torch.ops.cuda.moe_grouped import moe_group_tiles

    dev = torch.device("cuda")
    cfg = get_config("mixtral-8x7b")
    E, k = cfg.num_experts, cfg.num_experts_per_token
    H, Fi = cfg.hidden_size, cfg.intermediate_size
    a = moe_inputs(torch, gen, p, n_tokens)
    args, tr, scales = a["args"], a["tile_rows"], a["scales"]
    dest, counts = a["dest"], a["counts"]
    S_pad = args[0].shape[0]

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
    group = moe_group_tiles(S_pad // 64, E)
    return {"name": name,
            "shape": {"tokens": n_tokens, "assignments": S, "S_pad": S_pad,
                      "E": E, "k": k, "H": H, "F": Fi, "block_rows": 64,
                      "live_experts": n_live,
                      "tile_rows": tr.tolist()},
            "group_tiles": group,
            **reading, "kernel_ms": k_ms, "plain_ms": p_ms,
            "library_ms": None,
            "library_note": "no single PyTorch call computes a ragged "
                            "grouped SwiGLU",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops}


def moe_weights(torch, gen):
    """One mixtral-8x7b layer's router and experts, random (fan-in scaled
    bf16), and the same experts quantized to int8: (bf16, int8)."""
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
    return p, quantize_moe_params(p)


def moe_kernel_phases(torch, gen):
    """K3, bf16 and int8 weights, at MOE_TOKENS row counts."""
    p, q = moe_weights(torch, gen)
    out = []
    for name, weights in (("moe_grouped", p), ("moe_grouped_int8", q)):
        for n_tokens in MOE_TOKENS:
            out.append(moe_phase(torch, gen, weights, name, n_tokens))
    return out


def ring_phase(torch, gen, D, quant=False, devices=None):
    """K4 at Hq 32 / Hkv 8: the whole ring of SP ranks (all on card 0, or
    on `devices`) through the fold kernel, against the plain ring and
    against causal_attention on the unsharded sequence, at each of
    RING_SHAPES; one dict per shape."""
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.ops.attention import causal_attention
    from dynamo_tpu_torch.ops.cuda import ring_flash_attention, ring_flash_fold
    from dynamo_tpu_torch.ops.ring_attention import ring_causal_attention
    from dynamo_tpu_torch.parallel import SpRing

    dev = torch.device("cuda", 0)
    one_card = devices is None
    devices = [dev] * SP if one_card else list(devices)
    ring = SpRing(devices)
    name = "ring_flash_attention" + ("_int8" if quant else "")
    G = HQ // HKV
    scale = D ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for B, T in RING_SHAPES:
        t_loc = T // SP
        q = torch.randn(B, T, HQ, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, T, HKV, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, T, HKV, D, generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.arange(T, dtype=torch.int32, device=dev).repeat(B, 1)
        scales = {}
        kd, vd = k, v                      # what the references attend
        if quant:
            kq, ks = kvc.quantize_kv_rows(k.reshape(B * T, HKV * D), HKV)
            vq, vs = kvc.quantize_kv_rows(v.reshape(B * T, HKV * D), HKV)
            k, v = kq.reshape(B, T, HKV, D), vq.reshape(B, T, HKV, D)
            scales = {"k_scale": ks.reshape(B, T, HKV),
                      "v_scale": vs.reshape(B, T, HKV)}
            kd = kvc.dequantize_rows(k, scales["k_scale"])
            vd = kvc.dequantize_rows(v, scales["v_scale"])

        def cut(x):
            return [c.contiguous().to(devices[r])
                    for r, c in enumerate(x.chunk(SP, dim=1))]

        qs, ks_, vs_, ps = cut(q), cut(k), cut(v), cut(pos)
        sc = {n: cut(t) for n, t in scales.items()}

        def kern():
            ring.fork()
            res = ring_flash_attention(ring, qs, ks_, vs_, ps, **sc)
            ring.join()
            return res

        def plain():
            return ring_causal_attention(qs, ks_, vs_, ps, **sc)

        got = torch.cat([o.to(dev) for o in kern()], dim=1)
        ref = torch.cat([o.to(dev) for o in plain()], dim=1)
        torch.cuda.synchronize()
        reading = closeness(torch, name, got, ref)
        # The unsharded sequence, one kv head at a time (the whole score
        # tensor at T 8192 would not fit beside the rest).
        full = torch.cat([causal_attention(
            q[:, :, h * G:(h + 1) * G], kd[:, :, h:h + 1], vd[:, :, h:h + 1])
            for h in range(HKV)], dim=2)
        vs_causal = closeness(torch, name, got, full, limits="ring_vs_causal")
        del full, ref
        long = T > 1024
        k_ms = time_ms(torch, kern, samples=5 if long else 25,
                       per_sample=2 if long else 10)
        p_ms = time_ms(torch, plain, samples=3 if long else 5, per_sample=2)
        # One fold launch: rank 1's queries over rank 0's block, every
        # pair unmasked.
        fold_ms = None
        if one_card:
            q1 = (qs[1].float() * scale).contiguous()
            st = (torch.empty(B, HQ, t_loc, device=dev),
                  torch.empty(B, HQ, t_loc, device=dev),
                  torch.empty(B, t_loc, HQ, D, device=dev))
            o1 = torch.empty_like(qs[1])
            sc0 = {n: t[0] for n, t in sc.items()}
            fold_ms = time_ms(torch, lambda: ring_flash_fold(
                st, q1, ps[1], ks_[0], vs_[0], ps[0], o1, first=True,
                last=False, **sc0), samples=10 if long else 25)
        q4 = q.transpose(1, 2)
        k4 = kd.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        v4 = vd.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        lib_ms = time_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True,
                                             scale=scale))
        del k4, v4
        # Only unmasked query-key pairs count, so a kernel that skips
        # masked tiles can never read over its bound.
        flops = 4 * B * HQ * D * (T * (T + 1) // 2)
        item = 1 if quant else 2
        block = B * t_loc * (2 * HKV * D * item
                             + (2 * HKV * 4 if quant else 0) + 4)
        # What the function must move: q read and out written once, every
        # block read by every rank.  The f32 state that one launch per hop
        # stores and reloads is this design's own traffic, not the
        # function's: it is printed beside the bound, not counted in it.
        nbytes = 2 * q.numel() * 2 + SP * SP * block
        state = B * t_loc * HQ * D * 4 + 2 * B * HQ * t_loc * 4
        state_bytes = SP * 2 * (SP - 1) * state
        b_ms, b_by = bound(nbytes, flops)
        # The unmasked fold does every pair of its two shards.
        fold_flops = 4 * B * HQ * D * t_loc * t_loc
        out.append({"name": name,
                    "shape": {"B": B, "T": T, "sp": SP, "t_loc": t_loc,
                              "Hq": HQ, "Hkv": HKV, "D": D,
                              "blocks": "int8" if quant else "bf16",
                              "ranks_on": [str(d) for d in devices]},
                    **reading, "vs_causal_attention": vs_causal,
                    "kernel_ms": k_ms, "fold_ms": fold_ms, "plain_ms": p_ms,
                    "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "bytes": nbytes, "state_bytes": state_bytes,
                    "flops": flops, "tflops": tflops(flops, k_ms),
                    "fold_flops": fold_flops,
                    "fold_tflops": fold_ms and tflops(fold_flops, fold_ms)})
        torch.cuda.empty_cache()
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


def compare_paths(torch, cfg, kstate, pstate, kv_quant="none", feed=None,
                  keep=None):
    """A packed prefill of two prompts through K2 (and K3 for a MoE
    model), then 4 greedy decode steps through K1 (and K3), against the
    gather path (and the dense MoE oracle) on `pstate`, each path on its
    own cache of mode `kv_quant`, fed the same tokens: the kernel path's
    greedy ones, or `feed` (a list of [2] token lists, one per step).
    Returns the per-step logits relative errors, argmax agreements and
    the fed tokens, and for a MoE model each path's expert-load sum
    beside the token rows it routed; `keep` collects the kernel path's
    logits of every step."""
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.models import llama

    dev = torch.device("cuda")
    moe = cfg.is_moe
    prompts = [list(range(3, 3 + 77)), list(range(100, 100 + 140))]
    ccfg = kvc.KvCacheConfig.for_model(cfg, num_blocks=16, block_size=BS,
                                       kv_quant=kv_quant)
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
    errs, agree, gaps = [], [], []

    def compare(lk, lg):
        errs.append(((lk - lg).abs().max() / lg.abs().max()).item())
        pick = lk.argmax(-1)
        agree.append((pick == lg.argmax(-1)).float().mean().item())
        gap = lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]
        gaps.append((gap.max() / lg.abs().max()).item())

    compare(logits_k, logits_g)
    if keep is not None:
        keep.append(logits_k)
    # Decode: both caches fed the kernel path's greedy tokens (or `feed`).
    step_k = llama.make_forward_step(cfg, BS, use_decode_kernel=True,
                                     moe_mode="grouped", with_expert_load=moe)
    cur = lens.clone().to(dev)
    nxt = logits_k.argmax(-1).to(torch.int32)
    zero = torch.zeros(2, dtype=torch.int32, device=dev)
    steps = 4
    fed = []
    for i in range(steps):
        if feed is not None:
            nxt = torch.tensor(feed[i], dtype=torch.int32, device=dev)
        fed.append(nxt.tolist())
        cur = cur + 1
        res = step_k(kstate, cache_k, nxt[:, None], (cur - 1)[:, None], cur,
                     bt, zero)
        lk = res[0]
        loads_k += res[2:]
        res = gather(pstate, cache_g, nxt[:, None], (cur - 1)[:, None], cur,
                     bt, zero)
        lg = res[0]
        loads_g += res[2:]
        compare(lk, lg)
        check(bool(torch.isfinite(lk).all()), f"{cfg.name}: non-finite logits")
        if keep is not None:
            keep.append(lk)
        nxt = lk.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    worst, tol = max(errs), MODEL_TOL[cfg.name]
    check(worst <= tol, f"{cfg.name} ({kv_quant} cache): kernels vs gather "
                        f"path logits rel err {errs} > {tol}")
    check(max(gaps) <= tol, f"{cfg.name} ({kv_quant} cache): greedy tokens "
                            f"differ beyond a near tie: argmax gap {gaps} > {tol}")
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "kv_quant": kv_quant,
           "prompts": [len(p) for p in prompts],
           "decode_steps": steps, "logits_rel_err": errs,
           "argmax_agreement": agree, "argmax_gap": gaps, "tol": tol,
           "fed_tokens": fed}
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
    against the gather path on the same weights, prompts and tokens, over
    a bf16 cache and then over an int8 cache (K2 and K1 int8 against
    kv_cache.gather_kv_quant), the int8 run fed the bf16 run's tokens so
    that its logits can be set beside the bf16 run's."""
    from dynamo_tpu_torch.models import weights
    from dynamo_tpu_torch.models.config import get_config

    dev = torch.device("cuda")
    cfg = get_config("llama-3-1b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = weights.init_params(cfg, gen, dev)
    bf16_logits, int8_logits = [], []
    bf16 = compare_paths(torch, cfg, state, state, keep=bf16_logits)
    int8 = compare_paths(torch, cfg, state, state, kv_quant="int8",
                         feed=bf16["fed_tokens"], keep=int8_logits)
    int8["vs_bf16_cache"] = {
        "logits_rel_err": [((a - b).abs().max() / b.abs().max()).item()
                           for a, b in zip(int8_logits, bf16_logits)],
        "argmax_agreement": [(a.argmax(-1) == b.argmax(-1)).float().mean().item()
                             for a, b in zip(int8_logits, bf16_logits)]}
    return {"phase": "model", **bf16}, {"phase": "model_int8", **int8}


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
    path = ("paged_decode_attention", "paged_prefill_attention", "moe_grouped")
    for name, launched in (("bf16", bf16_launches), ("int8", int8_launches)):
        check(all(launched[k] > 0 for k in path),
              f"model_moe {name}: a kernel never launched: {launched}")
    return ({"phase": "model_moe", "experts": "bf16", **bf16,
             "launches": bf16_launches,
             "block_vs_dense": {"tokens": 224, "equal": bool(torch.equal(
                 got, want)), **block}},
            {"phase": "model_moe", "experts": "int8", **int8,
             "launches": int8_launches})


def model_sp_phase(torch, kernels, state, kv_quant="none"):
    """llama-3-1b, full width and depth: a 480-token and a 512-token
    prompt in one batch through the sequence-parallel prefill step (SP
    ranks spread over the visible cards as `--sp` spreads them — all on
    card 0 of a one-card machine — the ring through K4) against the
    packed prefill step
    (K2) on the same weights and prompts, each on its own cache of mode
    `kv_quant`; then two greedy decode steps (K1) from each cache, both
    fed the sp path's tokens.

    Checked: logits relative error and the greedy tokens' argmax gap
    within MODEL_TOL; K4's fold launches = layers x SP ranks x SP hops;
    the cache rows of the real tokens.  Layer 0's rows see identical
    inputs on both paths (only the projection's batch shape differs): a
    bf16 cache must agree within one bf16 unit of each head row's largest
    value, an int8 cache within one int8 step, and the rows where any
    value is a step off are counted (`rows_one_step_off`).  Deeper
    layers inherit the two attention kernels' rounding; their rows'
    largest difference relative to the layer's largest value is printed
    and held to MODEL_TOL."""
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.parallel import (
        SpRing, default_sp_devices, make_sp_prefill_step)

    dev = torch.device("cuda", 0)
    cfg = get_config("llama-3-1b")
    quant = kv_quant == "int8"
    body = "ring_flash_attention" + ("_int8" if quant else "")
    g = torch.Generator().manual_seed(SEED)
    lens = [480, 512]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g,
                             dtype=torch.int32) for n in lens]
    ccfg = kvc.KvCacheConfig.for_model(cfg, num_blocks=32, block_size=BS,
                                       kv_quant=kv_quant)
    cache_s, cache_p = kvc.init_cache(ccfg, dev), kvc.init_cache(ccfg, dev)
    P, T, R = 8, 512, 8
    pad = 128 * BS
    pages = torch.arange(1, 1 + 2 * P, dtype=torch.int32).reshape(2, P)
    # The ring: padded [2, 512] rows.
    tok2 = torch.zeros(2, T, dtype=torch.int32)
    pos2 = torch.full((2, T), pad, dtype=torch.int32)
    for i, p in enumerate(prompts):
        tok2[i, : len(p)] = p
        pos2[i, : len(p)] = torch.arange(len(p))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    ring = SpRing(default_sp_devices(SP, dev))
    sp_step = make_sp_prefill_step(cfg, BS, ring, kv_quant=quant,
                                   use_kernel=True)
    kernels.reset_launch_counts()
    logits_s, _ = sp_step(state, cache_s, tok2.to(dev), pos2.to(dev),
                          lens_t.to(dev), pages.to(dev), (lens_t - 1).to(dev))
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    want_launches = cfg.num_layers * SP * SP
    check(launched[body] == want_launches and sum(launched.values())
          == want_launches,
          f"model_sp ({kv_quant}): launches {launched}, expected "
          f"{want_launches} of {body} alone")
    # The packed plane: both prompts on one flat axis.
    Tp = sum(lens)
    tokens = torch.cat(prompts)
    positions = torch.cat([torch.arange(n, dtype=torch.int32) for n in lens])
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32)
                     for i, n in enumerate(lens)])
    bt8 = torch.zeros(R, P, dtype=torch.int32)
    bt8[:2] = pages
    qs, ql, sl, smp = (torch.zeros(R, dtype=torch.int32) for _ in range(4))
    qs[1] = lens[0]
    ql[:2] = sl[:2] = lens_t
    smp[0], smp[1] = lens[0] - 1, Tp - 1
    packed = llama.make_packed_prefill_step(cfg, BS)
    logits_p = packed(state, cache_p, *(t.to(dev) for t in (
        tokens, positions, seg, bt8, qs, ql, sl, smp)))[0][:2]
    errs, gaps, agree = [], [], []

    def compare(ls, lp):
        errs.append(((ls - lp).abs().max() / lp.abs().max()).item())
        pick = ls.argmax(-1)
        agree.append((pick == lp.argmax(-1)).float().mean().item())
        gap = lp.max(-1).values - lp.gather(-1, pick[:, None])[:, 0]
        gaps.append((gap.max() / lp.abs().max()).item())

    compare(logits_s, logits_p)
    # The written rows of the real tokens.
    real = torch.cat([kvc.slots_for_positions(
        pages[i:i + 1].to(dev), torch.arange(n, device=dev)[None], BS)[0]
        for i, n in enumerate(lens)])
    rows = {}
    layer_err = []
    for i in range(cfg.num_layers):
        worst = 0.0
        for kv in ("k", "v"):
            a, b = cache_s[kv][i][real], cache_p[kv][i][real]
            if quant:
                sa = cache_s[kv + "_scale"][i][real]
                sb = cache_p[kv + "_scale"][i][real]
                da = kvc.dequantize_rows(a.reshape(len(real), HKV, -1), sa)
                db = kvc.dequantize_rows(b.reshape(len(real), HKV, -1), sb)
            else:
                da, db = a.reshape(len(real), HKV, -1), b.reshape(len(real), HKV, -1)
            worst = max(worst, ((da.float() - db.float()).abs().max()
                                / db.float().abs().max()).item())
            if i:
                continue
            if quant:
                step = (a.int() - b.int()).abs()
                check(int(step.max()) <= 1, f"model_sp int8: layer 0 {kv} "
                      f"rows differ by {int(step.max())} int8 steps")
                check(bool(((sa - sb).abs() <= RTOL * sb.abs()).all()),
                      f"model_sp int8: layer 0 {kv} scales differ")
                rows[kv] = int((step.amax(dim=1) > 0).sum())
            else:
                top = db.float().abs().amax(dim=-1, keepdim=True)
                off = (da.float() - db.float()).abs()
                check(bool((off <= RTOL * top).all()),
                      f"model_sp bf16: layer 0 {kv} rows differ by more "
                      "than one bf16 unit of the row's largest value")
                rows[kv] = int((off.amax(dim=(1, 2)) > 0).sum())
        layer_err.append(worst)
    # Two decode steps through K1 from each cache.
    step_k = llama.make_forward_step(cfg, BS, use_decode_kernel=True)
    bt = pages.to(dev)
    cur = lens_t.to(dev)
    nxt = logits_s.argmax(-1).to(torch.int32)
    zero = torch.zeros(2, dtype=torch.int32, device=dev)
    for _ in range(2):
        cur = cur + 1
        ls = step_k(state, cache_s, nxt[:, None], (cur - 1)[:, None], cur,
                    bt, zero)[0]
        lp = step_k(state, cache_p, nxt[:, None], (cur - 1)[:, None], cur,
                    bt, zero)[0]
        check(bool(torch.isfinite(ls).all()), "model_sp: non-finite logits")
        compare(ls, lp)
        nxt = ls.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    tol = MODEL_TOL[cfg.name]
    check(max(errs) <= tol, f"model_sp ({kv_quant}): ring vs packed logits "
                            f"rel err {errs} > {tol}")
    check(max(gaps) <= tol, f"model_sp ({kv_quant}): greedy tokens differ "
                            f"beyond a near tie: argmax gap {gaps} > {tol}")
    check(max(layer_err) <= tol, f"model_sp ({kv_quant}): cache rows differ "
                                 f"by {max(layer_err)} of the layer's max")
    return {"phase": "model_sp", "model": cfg.name, "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "kv_quant": kv_quant, "sp": SP,
            "ranks_on": ring.describe(), "prompts": lens,
            "logits_rel_err": errs, "argmax_agreement": agree,
            "argmax_gap": gaps, "tol": tol, "launches": launched,
            "expected_fold_launches": want_launches,
            "layer0_rows_one_step_off": rows, "real_rows": len(real),
            "cache_rel_err_by_layer": layer_err, "decode_steps": 2}


def model_sp_phases(torch, kernels):
    """model_sp over a bf16 cache and over an int8 cache, on one set of
    weights."""
    from dynamo_tpu_torch.models import weights
    from dynamo_tpu_torch.models.config import get_config

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = weights.init_params(get_config("llama-3-1b"), gen, dev)
    return [model_sp_phase(torch, kernels, state, kv_quant)
            for kv_quant in ("none", "int8")]


def _http(url: str, body=None, timeout: float = 600.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


USER_TURN = "Request {i}: say something about paged attention on a GPU."


def chat_body(i: int, stream: bool, max_tokens: int, system=None,
              user=USER_TURN) -> dict:
    messages = [{"role": "user", "content": user.format(i=i)}]
    if system is not None:
        messages.insert(0, {"role": "system", "content": system})
    body = {"model": "m", "max_tokens": max_tokens, "temperature": 0,
            "stream": stream, "messages": messages}
    if stream:
        body["stream_options"] = {"include_usage": True}
    return body


def _chat(base: str, body: dict) -> dict:
    stream = body["stream"]
    t0 = time.monotonic()
    raw = _http(base + "/v1/chat/completions", body)
    wall = time.monotonic() - t0
    if not stream:
        resp = json.loads(raw)
        out = {"stream": False, "wall_s": wall, "rid": resp.get("id"),
               "tokens": resp["usage"]["completion_tokens"],
               "finish": resp["choices"][0]["finish_reason"], "done": True,
               "text": resp["choices"][0]["message"]["content"]}
        lp = resp["choices"][0].get("logprobs")
        if lp:   # a `traced` body: each token's id and logprob
            out["token_ids"] = [int(e["token"].removeprefix("token_id:"))
                                for e in lp["content"]]
            out["logprobs"] = [e["logprob"] for e in lp["content"]]
        return out
    lines = [ln for ln in raw.split("\n") if ln.startswith("data: ")]
    done = bool(lines) and lines[-1].strip() == "data: [DONE]"
    chunks = [json.loads(ln[6:]) for ln in lines if ln.strip() != "data: [DONE]"]
    usage = [c["usage"] for c in chunks if c.get("usage")]
    finish = [ch["finish_reason"] for c in chunks for ch in c["choices"]
              if ch.get("finish_reason")]
    return {"stream": True, "wall_s": wall, "done": done,
            "tokens": usage[-1]["completion_tokens"] if usage else 0,
            "finish": finish[-1] if finish else None}


def traced(body: dict) -> dict:
    """`body` asking for each token's id and logprob, so that two answers
    can be held token for token: the byte tokenizer spells no id above
    255, so a random-weight model's text says next to nothing."""
    return {**body, "logprobs": True, "return_tokens_as_token_ids": True}


def answer(r: dict) -> dict:
    return {k: r[k] for k in ("text", "token_ids", "logprobs")}


def leading_equal(a: list, b: list) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


@contextlib.contextmanager
def server(model: str, args=(), tag: str = "", ready_s: float = 300):
    """`python -m dynamo_tpu_torch.frontend --model <model> <args>` as a
    subprocess, stopped on exit; yields (base url, seconds to ready)."""
    OUT_DIR.mkdir(exist_ok=True)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    log_path = OUT_DIR / f"chip_smoke_server_{Path(model).name}{tag}.log"
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
        yield base, time.monotonic() - t0
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()


def chat_wave(base: str, bodies: list) -> list:
    """The chats of `bodies`, all sent at once."""
    with ThreadPoolExecutor(len(bodies)) as pool:
        return list(pool.map(lambda b: _chat(base, b), bodies))


def check_results(results: list, max_tokens: int) -> None:
    for r in results:
        check(r["done"], f"request without [DONE]/response: {r}")
        check(r["tokens"] == max_tokens or (r["finish"] == "stop"
                                            and r["tokens"] > 0),
              f"request returned {r['tokens']} tokens ({r['finish']})")


def serve_phase(model: str, args=(), path_kernels=(), n_requests: int = 8,
                max_tokens: int = 64, ready_s: float = 300, system=None,
                user=USER_TURN, tag="", lone_bodies=(), during=None):
    """`python -m dynamo_tpu_torch.frontend --model <model> <args>` as a
    subprocess: after a warm-up request and a stats reset (launch counts,
    engine counters, expert load and prefix hit/miss tokens together),
    `n_requests` concurrent greedy chats, half streaming, each with the
    `system` prompt when one is given and user turn `user` (the warm-up's
    is number -1); every kernel of `path_kernels` must have launched in
    that window.  Then the unary `traced` `lone_bodies`, one at a time,
    whose answers (text, token ids, logprobs) and server-side TTFTs the
    result carries (`lone_answers`, `lone_ttft_s`); then `during(base)`,
    whose result it carries as `during`."""
    with server(model, args, tag, ready_s) as (base, startup_s):
        # Warm-up: cuBLAS handles, the allocator, and the system prompt's
        # blocks into the prefix cache.
        _chat(base, chat_body(-1, False, 4, system, user))
        _http(base + "/debug/stats/reset", {})
        t1 = time.monotonic()
        results = chat_wave(base, [chat_body(i, i % 2 == 0, max_tokens,
                                             system, user)
                                   for i in range(n_requests)])
        wall = time.monotonic() - t1
        stats = json.loads(_http(base + "/debug/stats"))
        lone = [answer(_chat(base, b)) for b in lone_bodies]
        timed = json.loads(_http(base + "/debug/stats"))["requests"]
        lone_ttft = [r["ttft_s"] for r in timed[len(timed) - len(lone):]]
        extra = during(base) if during is not None else None
    check_results(results, max_tokens)
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
            "kv_quant": stats["kv_quant"], "prefix_cache": stats["prefix_cache"],
            "moe_mode": stats["moe_mode"], "expert_load": stats["expert_load"],
            "mixed_prefill": stats["mixed_prefill"],
            "lone_answers": lone, "lone_ttft_s": lone_ttft, "during": extra}


def serve_int8_phase():
    """llama-3-1b with `--kv-quant int8`: 8 chats sharing a system prompt
    of SYSTEM_BLOCKS blocks of byte tokens, put in the prefix cache by the
    warm-up.  Only the int8 bodies of K1 and K2 may launch, and every
    request must be served from the cache the full blocks of the token
    prefix S the 8 prompts share (worked out with the port's own
    preprocessor): prefix_hit_tokens >= 8 * 64 * (S // 64)."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    line = "You are a careful assistant for GPU kernel engineers. "
    system = (line * (SYSTEM_BLOCKS * BS // len(line) + 1))[: SYSTEM_BLOCKS * BS]
    # User turns that differ at their first byte: the 8 prompts share
    # exactly the prefix they share with the warm-up's.
    user = "{i}: say something about paged attention on a GPU."
    n, max_tokens = 8, 64
    pre = OpenAIPreprocessor(ByteTokenizer())
    prompts = [pre.preprocess_chat(ChatCompletionRequest.from_dict(
        chat_body(i, False, max_tokens, system, user)), str(i)).token_ids
        for i in range(n)]
    shared = 0
    while all(len(p) > shared and p[shared] == prompts[0][shared]
              for p in prompts):
        shared += 1
    want = n * BS * (shared // BS)
    out = serve_phase("llama-3-1b", ("--kv-quant", "int8"),
                      ("paged_decode_attention_int8",
                       "paged_prefill_attention_int8"),
                      n_requests=n, max_tokens=max_tokens, system=system,
                      user=user, tag="_int8")
    launches = out["launches"]
    check(out["kv_quant"] == "int8", f"serve_int8 ran kv_quant {out['kv_quant']}")
    check(launches["paged_decode_attention"] == 0
          and launches["paged_prefill_attention"] == 0,
          f"serve_int8: a bf16 attention body launched: {launches}")
    hit = out["prefix_cache"]["hit_tokens"]
    check(hit >= want, f"serve_int8: prefix_hit_tokens {hit} < {want} "
                       f"(8 x 64 x floor({shared} / 64))")
    out.update(phase="serve_int8", system_tokens=len(system),
               prompt_tokens=[len(p) for p in prompts],
               shared_prefix_tokens=shared, min_hit_tokens=want)
    return out


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


LONG_TURN = "{i:02d}: " + "Explain ring attention over sequence shards. " * 12


def long_chat(i: int, stream: bool, max_tokens: int, chars: int) -> dict:
    """A chat whose user turn is `chars` bytes and starts with its number,
    so no two of them share their first block."""
    return chat_body(i, stream, max_tokens, user=LONG_TURN[:chars + 4])


def serve_sp_phase():
    """llama-3-1b behind `--sp 4` (the ranks share the card when the
    machine has fewer than 4).  First LONG_CHATS long chats, one at a
    time, so each is a whole prompt prefilled while nothing decodes: each
    must take the ring through K4 (sp_prefill_count, ring_kernel_prefills
    and sp_prefill_dispatches all LONG_CHATS; fold launches = 16 layers x
    SP ranks x SP hops a dispatch; modeled ring bytes = prompt tokens x
    ring_payload_bytes_per_token x (SP - 1) // SP, the prompt tokens
    worked out here with the port's own preprocessor).  Then the mixed
    wave: the 8 short chats of `serve` and two more long ones, all at
    once; K1 and K2 must launch, and the ring counters must still agree
    with each other.  The same lone long chats then go to an
    `--sp 4 --kv-quant int8` server, where they must take K4's int8 body
    with the int8 payload's modeled bytes.  The long chats' server-side
    TTFT is set beside that of the same chats, sent the same way, on an
    `--sp 1` server."""
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models.config import get_config

    cfg = get_config("llama-3-1b")
    chars = [310 + 25 * i for i in range(LONG_CHATS)]
    longs = [long_chat(i, False, 8, c) for i, c in enumerate(chars)]
    pre = OpenAIPreprocessor(ByteTokenizer())
    prompt_tokens = [len(pre.preprocess_chat(
        ChatCompletionRequest.from_dict(b), str(i)).token_ids)
        for i, b in enumerate(longs)]
    check(all(400 <= n <= 500 for n in prompt_tokens),
          f"serve_sp: long prompts of {prompt_tokens} tokens, wanted 400-500")
    per_dispatch = cfg.num_layers * SP * SP
    max_tokens = 64

    def first_wave(base):
        # Warm-up of both planes, then one window of counts.
        _chat(base, chat_body(-1, False, 4))
        _chat(base, long_chat(97, False, 4, 350))
        _http(base + "/debug/stats/reset", {})
        res = [_chat(base, b) for b in longs]
        check_results(res, 8)
        return json.loads(_http(base + "/debug/stats"))

    def check_first_wave(stats, kv_quant):
        """The lone long chats of one server: each took the ring through
        the K4 body of the cache's mode, and nothing else prefilled."""
        quant = kv_quant == "int8"
        sfx = "_int8" if quant else ""
        body, other = (f"ring_flash_attention{s}" for s in
                       (("_int8", "") if quant else ("", "_int8")))
        what = f"serve_sp ({kv_quant} cache)"
        c, k = stats["counters"], stats["kernels"]
        check(stats["sp"] == SP and len(stats["sp_devices"]) == SP
              and stats["kv_quant"] == kv_quant,
              f"{what}: server reports sp {stats['sp']} on "
              f"{stats['sp_devices']}, kv_quant {stats['kv_quant']}")
        check(c["sp_prefill_count"] == c["ring_kernel_prefills"]
              == c["sp_prefill_dispatches"] == LONG_CHATS,
              f"{what}: {LONG_CHATS} lone long chats, counters {c}")
        check(k[body] == per_dispatch * LONG_CHATS and k[other] == 0,
              f"{what}: K4 launched {k[body]} {body} folds, expected "
              f"{per_dispatch} x {LONG_CHATS}, and {k[other]} of the other "
              "body")
        payload = kvc.KvCacheConfig.for_model(
            cfg, num_blocks=2, block_size=BS,
            kv_quant=kv_quant).ring_payload_bytes_per_token
        want = sum(prompt_tokens) * payload * (SP - 1) // SP
        check(c["ring_exchange_bytes_modeled"] == want,
              f"{what}: modeled ring bytes "
              f"{c['ring_exchange_bytes_modeled']} != {want}")
        k1_body, k2_body = (f"paged_{n}_attention{sfx}"
                            for n in ("decode", "prefill"))
        check(k[k1_body] > 0 and k[k2_body] == 0,
              f"{what} first wave: K1 must decode and K2 stay idle: {k}")
        return {"kv_quant": kv_quant, "counters": c, "launches": k,
                "fold_launches_per_dispatch": per_dispatch,
                "expected_fold_launches": per_dispatch * LONG_CHATS,
                "ring_payload_bytes_per_token": payload,
                "expected_ring_bytes": want,
                "ttft_s": [r["ttft_s"] for r in stats["requests"]]}

    with server("llama-3-1b", ("--sp", str(SP)), "_sp") as (base, startup_s):
        stats1 = first_wave(base)
        mixed = ([chat_body(i, i % 2 == 0, max_tokens) for i in range(8)]
                 + [long_chat(50 + i, i % 2 == 0, max_tokens, 360)
                    for i in range(2)])
        t1 = time.monotonic()
        results = chat_wave(base, mixed)
        wall = time.monotonic() - t1
        stats2 = json.loads(_http(base + "/debug/stats"))
    check_results(results, max_tokens)
    wave1 = check_first_wave(stats1, "none")
    k1 = stats1["kernels"]
    # The same lone long chats over an int8 cache: the int8 rows and
    # scales ride the ring through K4's int8 body.
    with server("llama-3-1b", ("--sp", str(SP), "--kv-quant", "int8"),
                "_sp_int8") as (base, _):
        wave1_int8 = check_first_wave(first_wave(base), "int8")
    c2, k2 = stats2["counters"], stats2["kernels"]
    check(c2["sp_prefill_count"] >= LONG_CHATS
          and c2["ring_kernel_prefills"] == c2["sp_prefill_count"],
          f"serve_sp: ring counters disagree: {c2}")
    check(k2["ring_flash_attention"] == per_dispatch * c2["sp_prefill_dispatches"],
          f"serve_sp: K4 launched {k2['ring_flash_attention']} folds over "
          f"{c2['sp_prefill_dispatches']} dispatches")
    check(k2["paged_prefill_attention"] > 0 and k2["paged_decode_attention"]
          > k1["paged_decode_attention"],
          f"serve_sp mixed wave: the short prompts must take K2: {k2}")
    with server("llama-3-1b", ("--sp", "1"), "_sp1") as (base, _):
        stats_1 = first_wave(base)
    check(stats_1["counters"]["sp_prefill_count"] == 0
          and stats_1["kernels"]["ring_flash_attention"] == 0,
          "serve_sp: the --sp 1 server took the ring")
    ttft_1 = [r["ttft_s"] for r in stats_1["requests"]]
    out_tokens = sum(r["tokens"] for r in results)
    return {"phase": "serve_sp", "model": "llama-3-1b", "args": ["--sp", str(SP)],
            "startup_s": startup_s, "sp_devices": stats1["sp_devices"],
            "long_prompt_tokens": prompt_tokens,
            "first_wave": wave1, "first_wave_int8": wave1_int8,
            "mixed_wave": {"requests": len(mixed), "output_tokens": out_tokens,
                           "wall_s": wall, "output_tok_s": out_tokens / wall,
                           "counters": c2, "launches": k2},
            "ttft_long_s": {"sp4": wave1["ttft_s"],
                            "sp4_int8": wave1_int8["ttft_s"], "sp1": ttft_1,
                            "prefill_kernel_sp1": "paged_prefill_attention",
                            "launches_sp1": stats_1["kernels"]},
            "launches": {**k2, "ring_flash_attention_int8":
                         wave1_int8["launches"]["ring_flash_attention_int8"]}}


LONE_TURN = "Lone {i}: what does a paged KV cache hold?"
SYSTEM_LINES = {   # P is serve_int8's system prompt; Q another of its length
    "P": "You are a careful assistant for GPU kernel engineers. ",
    "Q": "You answer questions about distributed LLM serving briefly. "}
STICKY_TURN = "{i}: say something about paged attention on a GPU."
# The kv router costs each worker by the larger of its own accounting and
# the load the worker last published (`--metrics-interval`, 1 s): a
# snapshot taken while the previous chat ran still shows that chat's
# blocks as busy, and can send the next chat on the same prompt
# elsewhere.  Sequential chats wait this long, so a fresh idle snapshot
# is what the router reads.
METRICS_SETTLE_S = 1.5


def system_prompt(line: str) -> str:
    return (line * (SYSTEM_BLOCKS * BS // len(line) + 1))[: SYSTEM_BLOCKS * BS]


_PORTS_GIVEN: set = set()


def _free_port() -> int:
    """A port that binds now, for a child process to bind later.  It is
    drawn below the kernel's ephemeral range, so that no socket the
    kernel numbers itself (a client's connection, a bind to port 0)
    takes it in between, and never twice in one run."""
    import random

    try:
        hi = int(Path("/proc/sys/net/ipv4/ip_local_port_range")
                 .read_text().split()[0])
    except (OSError, ValueError, IndexError):
        hi = 16000      # no range to read: below the common defaults
    lo = max(1024, hi - 8192)
    for _ in range(1000 if hi - lo >= 1024 else 0):
        port = random.randrange(lo, hi)
        if port in _PORTS_GIVEN:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        _PORTS_GIVEN.add(port)
        return port
    with socket.socket() as s:     # no room below the range: any port
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def distributed_stack(workers=(("worker0", ()), ("worker1", ())),
                      frontend_b: bool = True, tag: str = "distributed",
                      ready_s: float = 300, frontend_args=(),
                      cp_port: Optional[int] = None, extra=(),
                      models=("m",)):
    """Frontend A (`--serve-control-plane --router-mode kv` and
    `frontend_args`; its control plane on `cp_port` when given), one
    `dynamo_tpu_torch.worker` process per entry of `workers` ((log tag,
    extra flags)) for llama-3-1b on the card (512 blocks of 64, a status
    port each), the `extra` processes ((module, log tag, args)) and, with
    `frontend_b`, frontend B (`--control-plane` A's, `--router-mode
    round_robin`), all stopped on exit, ready once the frontends list
    `models`; yields (A's url, B's url or None, the workers' status urls,
    seconds to ready).  Logs go to
    `smoke_out/chip_smoke_<tag>_<log tag>.log`."""
    OUT_DIR.mkdir(exist_ok=True)
    procs = []

    def log_path(name):
        return OUT_DIR / f"chip_smoke_{tag}_{name}.log"

    def spawn(module, name, *args):
        log = open(log_path(name), "w")
        procs.append((name, log, subprocess.Popen(
            [sys.executable, "-m", module, *args], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT)))

    def wait(url, ready):
        while True:
            for name, log, proc in procs:
                if proc.poll() is not None:
                    raise SmokeError(f"{name} exited rc {proc.returncode}: "
                                     + log_path(name).read_text()[-2000:])
            try:
                if ready(json.loads(_http(url, timeout=5))):
                    return
            except OSError:
                pass
            check(time.monotonic() - t0 < ready_s,
                  f"{tag} stack not ready in {ready_s} s ({url})")
            time.sleep(0.5)

    cp = cp_port or _free_port()
    ports = [_free_port() for _ in range(2 + len(workers))]
    a = f"http://127.0.0.1:{ports[0]}"
    b = f"http://127.0.0.1:{ports[1]}" if frontend_b else None
    status = [f"http://127.0.0.1:{p}" for p in ports[2:]]
    t0 = time.monotonic()
    try:
        spawn("dynamo_tpu_torch.frontend", "frontend_a", "--serve-control-plane",
              "--control-plane-port", str(cp), "--router-mode", "kv",
              "--http-port", str(ports[0]), *frontend_args)
        wait(a + "/health", lambda r: "status" in r)
        for (name, extra_args), port in zip(workers, ports[2:]):
            spawn("dynamo_tpu_torch.worker", name, "--control-plane",
                  f"127.0.0.1:{cp}", "--model", "llama-3-1b", "--model-name",
                  "m", "--num-blocks", "512", "--block-size", str(BS),
                  "--health-port", str(port), *extra_args)
        for module, name, args in extra:
            spawn(module, name, *args)
        if frontend_b:
            spawn("dynamo_tpu_torch.frontend", "frontend_b", "--control-plane",
                  f"127.0.0.1:{cp}", "--router-mode", "round_robin",
                  "--http-port", str(ports[1]))
        for w in status:
            wait(w + "/health", lambda r: r["status"] == "ready")
        for f in (a, b) if frontend_b else (a,):
            wait(f + "/v1/models",
                 lambda r: sorted(m["id"] for m in r["data"])
                 == sorted(models))
        time.sleep(1.0)    # the routers' instance watches see the workers
        yield a, b, status, time.monotonic() - t0
    finally:
        for name, log, proc in reversed(procs):
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()


def admitted(st: dict) -> int:
    """Prompt tokens a worker has admitted since its stats reset."""
    return st["prefix_cache"]["hit_tokens"] + st["prefix_cache"]["miss_tokens"]


def no_reprefill(ps: dict) -> bool:
    """Every hinted chat's admission found the blocks its pull left
    resident: none was prefilled again."""
    return (ps["reprefilled_tokens"] == 0
            and ps["hinted_hit_tokens"] >= ps["pulled_tokens"])


def donor_pull(a, workers, home, body, wstats, reset) -> dict:
    """Fleet prefix sharing, made to happen: a long P chat (256 tokens)
    keeps P's home busy.  The kv router counts the decode blocks of a
    chat it routed until that chat ends, so once the home has admitted
    the busy chat the next P chat goes to the other worker with a donor
    hint naming the home.  That worker must pull the home's P blocks
    over cuda_ipc (no host-staged block, no fallback) and its admission
    must find every pulled block (`no_reprefill`).  The one way left to
    miss: the busy chat's 256 tokens end before the probe is routed."""
    other = 1 - home
    reset(*workers)
    with ThreadPoolExecutor(1) as pool:
        busy = pool.submit(_chat, a, body("P", 90, max_tokens=256))
        t0 = time.monotonic()
        while True:                     # routed and admitted on the home
            st = wstats(workers)
            check(admitted(st[other]) == 0,
                  "serve_distributed: the busy P chat went off its home")
            if admitted(st[home]):
                break
            check(time.monotonic() - t0 < 60,
                  "serve_distributed: the busy P chat was not admitted")
            time.sleep(0.01)
        _chat(a, body("P", 91))
        st = wstats(workers)
        busy.result()
    ps, tp = st[other]["prefix_share"], st[other]["transfer_plane"]
    check(ps["remote_hits"] == 1 and ps["fallbacks"] == 0
          and ps["pulled_blocks"] > 0
          and ps["device_pulled_blocks"] == ps["pulled_blocks"]
          and tp["transport"] == "cuda_ipc"
          and "host" not in st[other]["plane_counts"],
          f"serve_distributed: the chat sent off P's home did not pull its "
          f"blocks over cuda_ipc: {ps}, {st[other]['plane_counts']}, "
          f"{tp['transport']}")
    check(ps["hinted_admissions"] == 1 and no_reprefill(ps),
          f"serve_distributed: worker {other} prefilled the pulled blocks "
          f"again: {ps}")
    return {"home": home, "puller": other, "prefix_share": ps,
            "hit_tokens": st[other]["prefix_cache"]["hit_tokens"],
            "plane_counts": st[other]["plane_counts"]}


def serve_distributed_phase(serve: dict, serve_embed):
    """llama-3-1b on two workers sharing the card behind the control plane
    (`distributed_stack`).  Checks, in order:
    - parity: the lone greedy chats `serve` answered, sent one at a time
      through A (kv), give the single-process server's token ids and
      logprobs, bit for bit;
    - stickiness: one warm-up chat on each of two 640-byte system prompts
      P and Q finds each prompt's home worker; after a stats reset, chats
      on P, Q, P, Q, one at a time, must each land on its prompt's home:
      that worker's prefix-hit tokens grow by the whole blocks the chat
      shares with the warm-up, the other's do not move (each chat is sent
      once the workers have published their idle load);
    - a concurrent wave of 8 greedy chats of 64 tokens, half streaming,
      four on P and four on Q, through A (kv) and then through B
      (round_robin): every request returns its tokens and both workers
      launch K1 and K2 in each wave;
    - fleet prefix sharing (`donor_pull`): with P's home kept busy, a P
      chat goes to the other worker with a donor hint; that worker pulls
      the home's blocks over cuda_ipc and its admission finds every one.
      In the kv wave too, a chat the router sends off its prompt's home
      carries a donor hint, and every such pull must ride cuda_ipc (no
      host-staged block, no fallback); each hinted chat's admission,
      counted chat by chat on its worker, finds the blocks its pull left
      resident;
    - embeddings: /v1/embeddings through A gives the rows `serve`'s
      server gave (`serve_embed`, `embed_requests`), bit for bit;
    - the KV clear (`kv_clear`): /clear_kv_blocks through A empties both
      workers' pools and A's index, and the next sticky chat hits nothing.
    The waves' output tok/s, TTFT and ITL (frontend side), each worker's
    prefix hit rate, prefix-share pulls and launches, and the stack's
    startup seconds are returned beside `serve`'s; the kv / round_robin
    difference is printed, not held."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    pre = OpenAIPreprocessor(ByteTokenizer())
    systems = {k: system_prompt(v) for k, v in SYSTEM_LINES.items()}

    def body(name, i, stream=False, max_tokens=8):
        return chat_body(i, stream, max_tokens, systems[name], STICKY_TURN)

    def tokens(b):
        return pre.preprocess_chat(ChatCompletionRequest.from_dict(b),
                                   "x").token_ids

    def shared_blocks(name, i):
        x, y = tokens(body(name, -1)), tokens(body(name, i))
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        return n // BS

    def wstats(workers):
        return [json.loads(_http(w + "/debug/stats")) for w in workers]

    def hits(workers):
        return [st["prefix_cache"]["hit_tokens"] for st in wstats(workers)]

    def reset(*urls):
        for u in urls:
            _http(u + "/debug/stats/reset", {})

    def wave(base, workers, first):
        reset(base, *workers)
        bodies = [body("PQ"[i % 2], first + i, i % 2 == 0, 64)
                  for i in range(8)]
        t1 = time.monotonic()
        results = chat_wave(base, bodies)
        wall = time.monotonic() - t1
        reqs = json.loads(_http(base + "/debug/stats"))["requests"]
        per_worker = wstats(workers)
        check_results(results, 64)
        for j, st in enumerate(per_worker):
            k = st["kernels"]
            check(k["paged_decode_attention"] > 0
                  and k["paged_prefill_attention"] > 0,
                  f"serve_distributed: worker {j} launched no K1 or K2 in "
                  f"the wave through {base}: {k}")
        ttfts = [r["ttft_s"] for r in reqs]
        itl_n = sum(r["itl_n"] for r in reqs)
        out_tokens = sum(r["tokens"] for r in results)
        return {"requests": len(results), "output_tokens": out_tokens,
                "wall_s": wall, "output_tok_s": out_tokens / wall,
                "ttft_mean_s": statistics.mean(ttfts), "ttft_max_s": max(ttfts),
                "ttft_s": ttfts,
                "itl_mean_s": (sum(r["itl_sum_s"] for r in reqs) / itl_n
                               if itl_n else None),
                "workers": [{"prefix_hit_rate": st["prefix_cache"]["hit_rate"],
                             "prefix_hit_tokens": st["prefix_cache"]["hit_tokens"],
                             "prefill_dispatches":
                                 st["counters"]["prefill_dispatches"],
                             "prefix_share": st["prefix_share"],
                             "mixed_prefill": st["mixed_prefill"],
                             "plane_counts": st["plane_counts"],
                             "transport": st["transfer_plane"]["transport"],
                             "launches": st["kernels"]}
                            for st in per_worker]}

    lone = [traced(chat_body(i, False, 64, user=LONE_TURN)) for i in range(2)]
    want = serve["lone_answers"][:len(lone)]
    check(len(want) == len(lone),
          "serve_distributed: serve answered no lone chats")
    with distributed_stack() as (a, b, workers, startup_s):
        got = [answer(_chat(a, x)) for x in lone]
        check(got == want,
              f"serve_distributed: lone chats through the workers gave "
              f"{got!r}, the single-process server {want!r}")
        home = {}
        for name in "PQ":
            reset(*workers)
            _chat(a, body(name, -1))
            misses = [st["prefix_cache"]["miss_tokens"] for st in wstats(workers)]
            check(sorted(m > 0 for m in misses) == [False, True],
                  f"serve_distributed: warm-up {name} prefilled on {misses}")
            home[name] = misses.index(max(misses))
            time.sleep(METRICS_SETTLE_S)
        reset(*workers)
        sticky = []
        for i, name in enumerate("PQPQ"):
            before = hits(workers)
            _chat(a, body(name, i))
            grew = [x - y for x, y in zip(hits(workers), before)]
            want = [0, 0]
            want[home[name]] = BS * shared_blocks(name, i)
            check(grew == want,
                  f"serve_distributed: chat {i} on {name} (home worker "
                  f"{home[name]}) grew prefix hits by {grew}, want {want}")
            sticky.append({"system": name, "worker": home[name],
                           "hit_tokens": grew[home[name]]})
            time.sleep(METRICS_SETTLE_S)
        donor = donor_pull(a, workers, home["P"], body, wstats, reset)
        kv = wave(a, workers, 10)
        for j, w in enumerate(kv["workers"]):
            ps = w["prefix_share"]
            check(ps["fallbacks"] == 0 and "host" not in w["plane_counts"],
                  f"serve_distributed: worker {j}'s donor pulls fell back "
                  f"or rode the host: {ps}, {w['plane_counts']}")
            check(no_reprefill(ps),
                  f"serve_distributed: a hinted chat on worker {j} "
                  f"prefilled blocks its pull left resident: {ps}")
            if ps["pulled_blocks"]:
                check(w["transport"] == "cuda_ipc"
                      and ps["device_pulled_blocks"] == ps["pulled_blocks"],
                      f"serve_distributed: worker {j} pulled donor blocks "
                      f"off cuda_ipc: {ps} ({w['transport']})")
        rr = wave(b, workers, 20)
        embed = embed_requests(a)
        check((embed == serve_embed).all(),
              "serve_distributed: /v1/embeddings through the workers differs "
              "from the single-process server's rows")
        clear = kv_clear(a, workers, body("P", 99))
    return {"phase": "serve_distributed", "model": "llama-3-1b",
            "embeddings_equal_serve": True, "kv_clear": clear,
            "workers": 2, "startup_s": startup_s, "lone_answers_equal": True,
            "home_worker": home, "sticky": sticky,
            "system_prompt_blocks": SYSTEM_BLOCKS,
            "wave_kv": kv, "wave_round_robin": rr,
            "prefix_share_pulls": [w["prefix_share"]["remote_hits"]
                                   for w in kv["workers"]],
            "donor_pull": donor,
            "serve": {k: serve[k] for k in ("startup_s", "output_tok_s",
                                            "ttft_mean_s", "ttft_max_s",
                                            "itl_mean_s")}}


# -- speculative decode, embeddings and the KV clear --------------------------

SPEC_K = 3                     # draft tokens of model_spec and serve_spec
# Chats that quote themselves, where prompt-lookup drafts land (code,
# extraction and agent loops re-echo their inputs).
REPEAT_TURN = ("{i}: repeat this line: "
               + "the cache keeps keys and values per block; " * 6)
# /v1/embeddings inputs: two strings and two token lists.
EMBED_TEXTS = ("Embed: what does a paged KV cache hold?",
               "Embed: ring attention passes key and value blocks around "
               "the shards. " * 3)
EMBED_TOKENS = ([11, 12, 13, 14, 15, 16, 17, 18], list(range(300, 460)))
# A server's embedding rows against the in-process plain forward of the
# same weights, padded as the engine's embed step pads (one row, the
# prefill bucket, the page bucket): max |server - plain| / max |plain|.
# The same products in two processes; the limit allows bf16 products
# that round elsewhere (the unpadded forward's distance, which does, is
# printed beside it: 1.7e-2 on an H100 80GB HBM3).
EMBED_TOL = 2e-2


def chat_tokens(body: dict) -> list:
    """The token ids the port's preprocessor makes of a chat body."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    pre = OpenAIPreprocessor(ByteTokenizer())
    return pre.preprocess_chat(ChatCompletionRequest.from_dict(body),
                               "x").token_ids


def embed_inputs() -> list:
    """EMBED_TEXTS tokenized as the server does, then EMBED_TOKENS."""
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    return [tok.encode(t) for t in EMBED_TEXTS] + [list(t) for t in EMBED_TOKENS]


def plain_forward(torch, cfg, state, token_lists, hidden: bool,
                  pad: bool = False):
    """The gather path's last-position logits ([n, V] f32) or, with
    `hidden`, its final-norm hidden state ([n, H] f32) of each token list,
    one row a call on a fresh cache; with `pad`, each row padded as the
    engine's embed step pads it (the servers' SchedulerConfig buckets,
    pad positions on the null block)."""
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.models import llama

    dev = torch.device("cuda")
    sched = SchedulerConfig(block_size=BS)
    step = llama.make_forward_step(cfg, BS, return_hidden=hidden)
    rows = []
    for toks in token_lists:
        L, P = len(toks), -(-len(toks) // BS)
        T, W = ((sched.bucket_for_prefill(L), sched.bucket_for_pages(P))
                if pad else (L, P))
        cache = kvc.init_cache(kvc.KvCacheConfig.for_model(
            cfg, num_blocks=P + 1, block_size=BS), dev)
        pad_pos = sched.max_pages_per_seq * BS

        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=dev)

        out, _ = step(state, cache, i32([toks + [0] * (T - L)]),
                      i32([list(range(L)) + [pad_pos] * (T - L)]), i32([L]),
                      i32([list(range(1, P + 1)) + [0] * (W - P)]),
                      i32([L - 1]))
        rows.append(out[0].float())
    return torch.stack(rows)


def model_spec_phase(torch, kernels):
    """llama-3-1b at full width and depth, seed-0 weights, greedy, in
    process: `serve`'s 8 chat prompts and 4 repetitive ones (REPEAT_TURN),
    64 tokens each, through an engine with speculative_tokens=SPEC_K and
    one without (windows through K1), on the same weights.  The token ids
    must match, a split allowed only at a near tie: at the first
    differing position both runs' tokens lie within MODEL_TOL of the top
    of the gather path's logits (`argmax_gap`).  The spec run must draft,
    accept no more than it drafted and launch K2; its acceptance rate and
    the decode tokens a row gains per forward it takes part in are
    reported.  Also returns the plain
    forward's embedding rows of `embed_inputs()` for the servers'
    /v1/embeddings answers: padded as the engine pads, and unpadded."""
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.models import weights
    from dynamo_tpu_torch.models.config import get_config

    dev = torch.device("cuda")
    cfg = get_config("llama-3-1b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = weights.init_params(cfg, gen, dev)
    prompts = {f"serve{i}": chat_tokens(chat_body(i, False, 64))
               for i in range(8)}
    prompts.update({f"repeat{i}": chat_tokens(
        chat_body(i, False, 64, user=REPEAT_TURN)) for i in range(4)})
    runs = {}
    for k in (0, SPEC_K):
        core = EngineCore(EngineConfig(model=cfg, num_blocks=256,
                                       device="cuda", speculative_tokens=k),
                          params=state)
        core.add_request("warm", chat_tokens(chat_body(-1, False, 4)),
                         SamplingParams(max_tokens=4))
        while core.has_work:
            core.step()
        st = core.metrics.spec_decode_stats
        st0 = (st.num_drafts, st.num_accepted_tokens) if st else (0, 0)
        before = core.counters.as_dict()
        kernels.reset_launch_counts()
        out = {}
        t0 = time.monotonic()
        for rid, p in prompts.items():
            core.add_request(rid, p, SamplingParams(max_tokens=64))
        while core.has_work:
            for d in core.step():
                out.setdefault(d.request_id, []).extend(d.token_ids)
        torch.cuda.synchronize()
        runs[k] = {"tokens": out, "wall_s": time.monotonic() - t0,
                   "counters": {n: v - before[n]
                                for n, v in core.counters.as_dict().items()},
                   "launches": kernels.launch_counts(),
                   "drafted": (st.num_drafts - st0[0]) if st else 0,
                   "accepted": (st.num_accepted_tokens - st0[1]) if st else 0,
                   "per_pos": list(st.num_accepted_tokens_per_pos) if st else []}
        del core
        torch.cuda.empty_cache()
    tol = MODEL_TOL[cfg.name]
    splits, agree = {}, 0
    for rid, p in prompts.items():
        a, b = runs[0]["tokens"][rid], runs[SPEC_K]["tokens"][rid]
        check(len(a) == len(b) == 64,
              f"model_spec: {rid} gave {len(a)} / {len(b)} tokens")
        n = leading_equal(a, b)
        agree += n
        if n < len(a):
            lg = plain_forward(torch, cfg, state, [p + a[:n]], False)[0]
            gaps = [((lg.max() - lg[t]) / lg.abs().max()).item()
                    for t in (a[n], b[n])]
            check(max(gaps) <= tol,
                  f"model_spec: {rid} split at token {n} beyond a near tie: "
                  f"argmax gaps {gaps} > {tol}")
            splits[rid] = {"at": n, "argmax_gap": gaps}
    spec, plain = runs[SPEC_K], runs[0]
    c = spec["counters"]
    check(c["spec_dispatches"] > 0 and c["window_dispatches"] == 0,
          f"model_spec: the spec engine took no spec step: {c}")
    check(0 < spec["drafted"] and spec["accepted"] <= spec["drafted"],
          f"model_spec: drafted {spec['drafted']}, accepted "
          f"{spec['accepted']}")
    check(spec["launches"]["paged_prefill_attention"] > 0,
          f"model_spec: K2 never launched: {spec['launches']}")
    # A row gains 1 + its accepted drafts from each forward it is in.
    decode_tokens = sum(len(t) - 1 for t in spec["tokens"].values())
    embed_ref = [plain_forward(torch, cfg, state, embed_inputs(), True, pad)
                 .cpu().numpy() for pad in (True, False)]
    out = {"phase": "model_spec", "model": cfg.name, "k": SPEC_K,
           "requests": len(prompts), "max_tokens": 64,
           "tokens_equal_before_split": agree,
           "tokens_compared": 64 * len(prompts), "splits": splits,
           "tol": tol, "drafted": spec["drafted"],
           "accepted": spec["accepted"],
           "accepted_per_pos": spec["per_pos"],
           "acceptance_rate": spec["accepted"] / spec["drafted"],
           "decode_tokens": decode_tokens,
           "tokens_per_forward": decode_tokens / (decode_tokens
                                                  - spec["accepted"]),
           "counters": c, "launches": spec["launches"],
           "wall_s": spec["wall_s"], "plain_wall_s": plain["wall_s"],
           "plain_counters": plain["counters"]}
    return out, embed_ref


def embed_requests(base: str):
    """POST /v1/embeddings at `base`: EMBED_TEXTS as a string list, in
    float and in base64 (the same floats), the first text alone (the same
    row) and EMBED_TOKENS as token lists; [4, H] f32 rows in
    `embed_inputs()` order, finite and 2048 wide."""
    import base64

    import numpy as np

    def post(inp, fmt="float"):
        resp = json.loads(_http(base + "/v1/embeddings", {
            "model": "m", "input": inp, "encoding_format": fmt}))
        rows = []
        for d in sorted(resp["data"], key=lambda d: d["index"]):
            e = d["embedding"]
            rows.append(np.frombuffer(base64.b64decode(e), "<f4")
                        if isinstance(e, str) else np.asarray(e, np.float32))
        return np.stack(rows)

    texts = post(list(EMBED_TEXTS))
    check(np.array_equal(texts, post(list(EMBED_TEXTS), "base64")),
          f"embeddings at {base}: base64 rows differ from float rows")
    check(np.array_equal(post(EMBED_TEXTS[0])[0], texts[0]),
          f"embeddings at {base}: a lone string differs from its row")
    rows = np.concatenate([texts, post([list(t) for t in EMBED_TOKENS])])
    check(rows.shape == (4, 2048) and np.isfinite(rows).all(),
          f"embeddings at {base}: shape {rows.shape} or non-finite rows")
    return rows


def embed_error(rows, ref) -> float:
    """max |rows - ref| / max |ref|."""
    import numpy as np

    return float(np.abs(rows - ref).max() / np.abs(ref).max())


def kv_clear(a: str, workers: list, sticky_body) -> dict:
    """POST /clear_kv_blocks through frontend A after the waves: every
    worker held inactive blocks before and holds none after, the cleared
    count is their sum, frontend A's index empties of both workers (their
    REMOVED events), and the next sticky chat finds no prefix hit."""
    def wstats():
        return [json.loads(_http(w + "/debug/stats")) for w in workers]

    def index_blocks():
        idx = json.loads(_http(a + "/debug/stats"))["kv_index"]["m"]
        return sum(idx.values()), len(idx)

    inactive = [st["prefix_cache"]["pool"]["g1_inactive"] for st in wstats()]
    held, holders = index_blocks()
    check(all(n > 0 for n in inactive) and holders == len(workers),
          f"kv clear: before it, inactive blocks {inactive}, frontend index "
          f"{held} blocks over {holders} workers")
    t0 = time.monotonic()
    cleared = json.loads(_http(a + "/clear_kv_blocks", {}))
    check(cleared["m"]["status"] == "ok"
          and cleared["m"]["cleared"] == sum(inactive),
          f"kv clear: {cleared}, inactive blocks before {inactive}")
    while index_blocks()[0]:
        check(time.monotonic() - t0 < 10,
              f"kv clear: frontend A still indexes {index_blocks()}")
        time.sleep(0.05)
    index_s = time.monotonic() - t0
    after = wstats()
    check(all(st["prefix_cache"]["pool"]["g1_inactive"] == 0 for st in after),
          "kv clear: a worker kept inactive blocks")
    hits = [st["prefix_cache"]["hit_tokens"] for st in after]
    _chat(a, sticky_body)
    grew = [st["prefix_cache"]["hit_tokens"] - h
            for st, h in zip(wstats(), hits)]
    check(grew == [0] * len(workers),
          f"kv clear: the next sticky chat still hit {grew} tokens")
    return {"cleared": cleared["m"]["cleared"], "inactive_before": inactive,
            "index_blocks_before": held, "index_empty_s": index_s,
            "sticky_hit_tokens_after": grew}


def serve_spec_phase(serve: dict) -> dict:
    """llama-3-1b on one worker with `--spec-decode SPEC_K` behind frontend
    A (`distributed_stack`): `serve`'s wave of 8 chats, then the same
    wave on REPEAT_TURN, each with stats reset just before it: every chat
    returns its tokens, the worker takes spec steps (drafted > 0, accepted
    <= drafted) and launches K2.  Then `serve`'s lone `traced` chats
    (logprobs) on the same worker must take the plain step (no spec step,
    K1 launched) and give `serve`'s ids and logprobs bit for bit.  Each
    wave's tok/s, TTFT, ITL (frontend side) and the worker's acceptance
    rate are reported beside `serve`'s."""
    def wstats(w):
        return json.loads(_http(w + "/debug/stats"))

    def reset(*urls):
        for u in urls:
            _http(u + "/debug/stats/reset", {})

    out = {"phase": "serve_spec", "model": "llama-3-1b", "k": SPEC_K}
    with distributed_stack(workers=(("worker", ("--spec-decode",
                                                str(SPEC_K))),),
                           frontend_b=False, tag="spec") as (
            a, _, (w,), startup_s):
        out["startup_s"] = startup_s
        _chat(a, chat_body(-1, False, 4))          # warm-up
        for name, user in (("serve", USER_TURN), ("repetitive", REPEAT_TURN)):
            reset(a, w)
            t1 = time.monotonic()
            results = chat_wave(a, [chat_body(i, i % 2 == 0, 64, user=user)
                                    for i in range(8)])
            wall = time.monotonic() - t1
            reqs = json.loads(_http(a + "/debug/stats"))["requests"]
            st = wstats(w)
            check_results(results, 64)
            sd, c = st["spec_decode"], st["counters"]
            check(c["spec_dispatches"] > 0
                  and 0 < sd["num_drafts"]
                  and sd["num_accepted_tokens"] <= sd["num_drafts"]
                  and st["kernels"]["paged_prefill_attention"] > 0,
                  f"serve_spec: {name} wave: {sd}, {c}, {st['kernels']}")
            ttfts = [r["ttft_s"] for r in reqs]
            itl_n = sum(r["itl_n"] for r in reqs)
            out_tokens = sum(r["tokens"] for r in results)
            out[f"wave_{name}"] = {
                "requests": len(results), "output_tokens": out_tokens,
                "wall_s": wall, "output_tok_s": out_tokens / wall,
                "ttft_mean_s": statistics.mean(ttfts),
                "ttft_max_s": max(ttfts),
                "itl_mean_s": (sum(r["itl_sum_s"] for r in reqs) / itl_n
                               if itl_n else None),
                "acceptance_rate": sd["acceptance_rate"],
                "drafted": sd["num_drafts"],
                "accepted": sd["num_accepted_tokens"],
                "accepted_per_pos": sd["num_accepted_tokens_per_pos"],
                "spec_dispatches": c["spec_dispatches"],
                "single_step_dispatches": c["single_step_dispatches"],
                "launches": st["kernels"]}
        reset(w)
        lone = [traced(chat_body(i, False, 64, user=LONE_TURN))
                for i in range(2)]
        got = [answer(_chat(a, x)) for x in lone]
        st = wstats(w)
    want = serve["lone_answers"][:len(lone)]
    check(got == want, f"serve_spec: logprobs chats gave {got!r}, the "
                       f"single-process server {want!r}")
    check(st["counters"]["spec_dispatches"] == 0
          and st["kernels"]["paged_decode_attention"] > 0,
          f"serve_spec: logprobs chats took a spec step or no K1: "
          f"{st['counters']}, {st['kernels']}")
    out["lone_answers_equal"] = True
    out["serve"] = {k: serve[k] for k in ("output_tok_s", "ttft_mean_s",
                                          "ttft_max_s", "itl_mean_s")}
    return out


# -- observability -----------------------------------------------------------

OBSERVED_DIR = OUT_DIR / "observed"   # flight dumps and device captures
SLO_TTFT_S = 5.0               # serve_observed's TTFT objective
CAPTURE_MS = 500               # serve_observed's device capture
STEADY_STEPS = 8               # steps of the planes on/off counter window
# Every plane on, with the JAX package's flags: traces at rate 1, the
# request ledger, a TTFT objective, the flight recorder (dumps under
# OBSERVED_DIR); the worker adds the device profiler and the stall
# watchdog.
OBSERVED_FRONTEND = ("--trace", "--trace-sample", "1.0",
                     "--request-ledger", "on",
                     "--slo-ttft-p99", str(SLO_TTFT_S),
                     "--flight-recorder", "on",
                     "--flight-dump-dir", str(OBSERVED_DIR))
OBSERVED_WORKER = OBSERVED_FRONTEND + ("--device-profiler", "on",
                                       "--watchdog-stall-s", "10")
# The same stack with every plane off (the recorder, the ledger and the
# device profiler are on by default, as in the JAX package).
PLANES_OFF_FRONTEND = ("--flight-recorder", "off", "--request-ledger", "off")
PLANES_OFF_WORKER = PLANES_OFF_FRONTEND + ("--device-profiler", "off",
                                           "--watchdog-stall-s", "0")
# The /metrics families of the JAX package's surfaces: the frontend
# (HttpService with the KV router's and migration's series, an SLO
# objective) and a dense model's worker (its StatusServer registry and
# worker_metrics_text, device profiler on).  tests/
# test_torch_observability.py holds these lists against the JAX modules.
JAX_FRONTEND_FAMILIES = (
    "dynamo_frontend_inflight_requests", "dynamo_frontend_input_sequence_tokens",
    "dynamo_frontend_inter_token_latency_seconds",
    "dynamo_frontend_output_sequence_tokens", "dynamo_frontend_queued_requests",
    "dynamo_frontend_request_duration_seconds",
    "dynamo_frontend_requests_total",
    "dynamo_frontend_time_to_first_token_seconds",
    "dynamo_goodput_good_tokens_total", "dynamo_goodput_tokens_total",
    "dynamo_kv_transfer_overlap", "dynamo_migrations_total",
    "dynamo_request_kv_transfer_seconds", "dynamo_request_outcomes_total",
    "dynamo_request_phase_seconds", "dynamo_request_queue_wait_seconds",
    "dynamo_request_tpot_seconds", "dynamo_request_ttft_seconds",
    "dynamo_router_remote_prefix_routes_total", "dynamo_slo_burn_rate",
    "dynamo_slo_compliant", "dynamo_slo_state")
JAX_WORKER_FAMILIES = (
    "dynamo_engine_last_step_age_seconds", "dynamo_engine_stalled",
    "dynamo_engine_stalls_total", "dynamo_hbm_limit_bytes",
    "dynamo_hbm_used_bytes", "dynamo_kv_bytes_per_block",
    "dynamo_kv_effective_bytes_per_token", "dynamo_kv_evictions_total",
    "dynamo_kv_pool_active_blocks", "dynamo_kv_pool_capacity_blocks",
    "dynamo_kv_pool_free_blocks", "dynamo_kv_pool_reusable_blocks",
    "dynamo_kv_prefix_cache_hits_tokens", "dynamo_kv_prefix_cache_misses_tokens",
    "dynamo_kv_transfer_overlap", "dynamo_kv_transfer_plane_total",
    "dynamo_modeled_vs_measured_ratio", "dynamo_prefix_remote_fallbacks_total",
    "dynamo_prefix_remote_hits_total", "dynamo_prefix_remote_pulled_blocks_total",
    "dynamo_program_bytes_accessed", "dynamo_program_flops",
    "dynamo_program_registry_size", "dynamo_qos_demoted_blocks_total",
    "dynamo_qos_preemptions_total", "dynamo_request_kv_transfer_seconds",
    "dynamo_request_outcomes_total", "dynamo_request_queue_wait_seconds",
    "dynamo_request_tpot_seconds", "dynamo_request_ttft_seconds",
    "dynamo_requests_migrated_in_total", "dynamo_requests_migrated_total",
    "dynamo_slo_burn_rate", "dynamo_slo_compliant", "dynamo_slo_state",
    "dynamo_spec_decode_acceptance_rate",
    "dynamo_spec_decode_accepted_tokens_total",
    "dynamo_spec_decode_drafted_tokens_total",
    "dynamo_worker_draining", "dynamo_worker_engine_decode_tokens_emitted",
    "dynamo_worker_engine_h2d_uploads", "dynamo_worker_engine_host_syncs",
    "dynamo_worker_engine_kv_read_bytes_modeled",
    "dynamo_worker_engine_packed_prefill_dispatches",
    "dynamo_worker_engine_prefill_dispatches",
    "dynamo_worker_engine_ring_exchange_bytes_modeled",
    "dynamo_worker_engine_ring_kernel_prefills",
    "dynamo_worker_engine_single_step_dispatches",
    "dynamo_worker_engine_spec_dispatches",
    "dynamo_worker_engine_window_dispatches",
    "dynamo_worker_engine_window_syncs",
    "dynamo_worker_engine_xla_cache_misses",
    "dynamo_worker_kv_active_blocks", "dynamo_worker_kv_prefix_cache_hit_rate",
    "dynamo_worker_kv_usage", "dynamo_worker_request_active_slots",
    "dynamo_worker_requests_waiting")
def metric_families(text: str) -> set:
    """The family names of a Prometheus text exposition: each `# TYPE`
    line's, and each sample's (a histogram's `_bucket` / `_sum` /
    `_count` samples count as their family)."""
    lines = text.splitlines()
    hist = {ln.split()[2] for ln in lines
            if ln.startswith("# TYPE ") and ln.endswith(" histogram")}
    names = set()
    for ln in lines:
        if ln.startswith("# TYPE "):
            names.add(ln.split()[2])
        elif ln and not ln.startswith("#"):
            name = ln.split("{")[0].split(" ")[0]
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in hist:
                    name = name[:-len(suffix)]
            names.add(name)
    return names


def metric_value(text: str, sample: str) -> Optional[float]:
    """The value of one sample (`name` or `name{labels}`), None if absent."""
    for ln in text.splitlines():
        if ln.startswith(sample + " "):
            return float(ln.rsplit(" ", 1)[1])
    return None


def _get_json(url: str, timeout: float = 600.0):
    """(HTTP status, JSON body), an error status's body included."""
    try:
        return 200, json.loads(_http(url, timeout=timeout))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def stack_wave(a: str, w: str) -> dict:
    """`serve`'s wave of 8 chats through frontend `a`, stats of frontend
    and worker `w` reset just before it: the results, the frontend's
    request timings, the worker's stats and the wave's tok/s, TTFT and
    ITL (frontend side)."""
    for u in (a, w):
        _http(u + "/debug/stats/reset", {})
    t1 = time.monotonic()
    results = chat_wave(a, [chat_body(i, i % 2 == 0, 64) for i in range(8)])
    wall = time.monotonic() - t1
    check_results(results, 64)
    reqs = json.loads(_http(a + "/debug/stats"))["requests"]
    check(len(reqs) == 8, f"serve_observed: frontend timed {len(reqs)}")
    ttfts = [r["ttft_s"] for r in reqs]
    itl_n = sum(r["itl_n"] for r in reqs)
    out_tokens = sum(r["tokens"] for r in results)
    return {"reqs": reqs, "worker": json.loads(_http(w + "/debug/stats")),
            "summary": {
                "output_tokens": out_tokens, "wall_s": wall,
                "output_tok_s": out_tokens / wall,
                "ttft_mean_s": statistics.mean(ttfts),
                "ttft_max_s": max(ttfts),
                "itl_mean_s": (sum(r["itl_sum_s"] for r in reqs) / itl_n
                               if itl_n else None)}}


def trace_chain(ftraces: dict, wtraces: dict, rid: str) -> dict:
    """One chat's spans across the frontend's and the worker's trace
    rings: http.chat (the root) with router.select and rpc.client:* under
    it, then on the worker rpc.server:* under rpc.client:* and
    engine.queue_wait / engine.ttft under rpc.server:*.  Returns the
    chain's span names, or raises naming the broken link."""
    def spans(payload):
        for t in payload["traces"]:
            if t["trace_id"] == rid:
                return t["spans"]
        raise SmokeError(f"serve_observed: no trace {rid} on "
                         f"{payload['service']}")

    def one(sp, prefix):
        got = [x for x in sp if x["name"].startswith(prefix)]
        check(len(got) == 1, f"serve_observed: {rid} has {len(got)} "
                             f"{prefix} spans")
        return got[0]

    fs, ws = spans(ftraces), spans(wtraces)
    root = one(fs, "http.chat")
    sel, client = one(fs, "router.select"), one(fs, "rpc.client:")
    server = one(ws, "rpc.server:")
    queue, ttft = one(ws, "engine.queue_wait"), one(ws, "engine.ttft")
    check(root["parent_id"] is None
          and sel["parent_id"] == client["parent_id"] == root["span_id"]
          and server["parent_id"] == client["span_id"]
          and queue["parent_id"] == ttft["parent_id"] == server["span_id"],
          f"serve_observed: {rid}'s parent links break: "
          f"{[(x['name'], x['span_id'], x['parent_id']) for x in fs + ws]}")
    return {"frontend": sorted(x["name"] for x in fs),
            "worker": sorted(x["name"] for x in ws)}


def planes_counters(torch) -> dict:
    """In process, llama-3-1b at full width and depth (seed-0 weights):
    `serve`'s 8 prompts, 256 greedy tokens each, to a steady decode window
    (every prompt prefilled, the window pipeline full), then STEADY_STEPS
    steps, once with every plane off and once with every plane on
    (tracing at rate 1 with each request bound to a root span, the flight
    recorder, the request ledger, the device profiler with its window
    events).  The counters' deltas over the steady steps must be
    byte-identical, and the on run must have recorded."""
    from dynamo_tpu_torch.engine.engine import (
        WINDOW_PIPELINE_DEPTH, EngineConfig, EngineCore)
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import RequestState
    from dynamo_tpu_torch.models import weights
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.runtime import (
        device_profiler, flight_recorder, ledger, tracing)

    dev = torch.device("cuda")
    cfg = get_config("llama-3-1b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = weights.init_params(cfg, gen, dev)
    runs = {}
    for on in (False, True):
        tracer = tracing.configure(enabled=on, sampling=1.0)
        tracer.reset()
        recorder = flight_recorder.configure(enabled=on)
        recorder.reset()
        prof = device_profiler.configure(enabled=on)
        prof.reset()
        ledger.set_enabled(on)
        core = EngineCore(EngineConfig(model=cfg, num_blocks=256,
                                       device="cuda"), params=state)
        roots = []
        for i in range(8):
            rid = f"planes{i}"
            roots.append(tracer.start_span("http.chat", trace_id=rid))
            tracer.bind(rid, roots[-1].ctx)
            core.add_request(rid, chat_tokens(chat_body(i, False, 256)),
                             SamplingParams(max_tokens=256))
        steps = 0
        while not (len(core._inflight) == WINDOW_PIPELINE_DEPTH
                   and all(r.state is RequestState.DECODE
                           for r in core.scheduler.running)
                   and not core._pending_batches):
            core.step()
            steps += 1
            check(steps < 500, "planes_counters: no steady window")
        before = core.counters.as_dict()
        for _ in range(STEADY_STEPS):
            core.step()
        delta = {k: v - before[k] for k, v in core.counters.as_dict().items()}
        for root in roots:
            root.end()
        runs[on] = {"delta": delta,
                    "flight_events": recorder.events_written,
                    "spans": tracer.spans_recorded,
                    "programs": prof.registry.size(),
                    "ledger_timings": len(core._ledger_timings),
                    "window_device_s": core.counters.window_device_s_ewma}
        del core
        torch.cuda.empty_cache()
    tracing.configure(enabled=False)
    flight_recorder.configure(enabled=False)
    device_profiler.configure(enabled=False)
    ledger.set_enabled(True)
    off, on = runs[False], runs[True]
    check(on["delta"] == off["delta"] and off["delta"]["window_dispatches"]
          == STEADY_STEPS,
          f"planes_counters: steady-window deltas differ with the planes "
          f"on: {on['delta']} vs off {off['delta']}")
    check(on["flight_events"] > 0 and on["spans"] > 0 and on["programs"] > 0
          and on["ledger_timings"] == 8 and on["window_device_s"] is not None
          and off["flight_events"] == off["spans"] == off["programs"] == 0,
          f"planes_counters: the planes did not record as switched: {runs}")
    return {"delta": off["delta"], "byte_identical": True,
            "on": {k: v for k, v in on.items() if k != "delta"}}


def serve_observed_phase(torch, serve: dict) -> dict:
    """llama-3-1b on one worker behind frontend A (`distributed_stack`)
    with every plane on (OBSERVED_FRONTEND, OBSERVED_WORKER).  After a
    warm-up chat (and a 50 ms capture, CUPTI's first use), `serve`'s wave
    of 8 chats, then:
    - /metrics on both: every family of the JAX surfaces (the drain and
      QoS ones too); requests and TTFT observations grew by the wave's
      8 (frontend and worker); `dynamo_program_registry_size` > 0;
      `dynamo_modeled_vs_measured_ratio{series="kv_decode"}` <= 1.25,
      `window_time` printed, no series paged; no stall; HBM polled;
    - /debug/traces: each chat's span chain across both processes
      (`trace_chain`);
    - /debug/requests: each chat's ledger covers its TTFT within JAX's
      coverage bounds;
    - /debug/deviceprofile?ms=CAPTURE_MS on the worker while a second wave
      runs: the trace's busy share, top ten kernels and five longest idle
      gaps (device_profiler.summarize_trace); K1 and K2 among its kernels;
    - the counters: the worker's wave counters equal to those of the
      same stack with every plane off (its wave run first, PLANES_OFF_*),
      printed beside `serve`'s, and `planes_counters` (in process, after
      the stacks stop): the steady window byte-identical with the planes
      on and off;
    - the flight recorder: /debug/flightrecorder holds the wave's events,
      and SIGUSR2 dumps them to OBSERVED_DIR.
    The wave's tok/s, TTFT and ITL are printed beside the planes-off
    stack's and `serve`'s."""
    from dynamo_tpu_torch.runtime import device_profiler, ledger

    OBSERVED_DIR.mkdir(parents=True, exist_ok=True)
    out = {"phase": "serve_observed", "model": "llama-3-1b"}
    with distributed_stack(workers=(("worker", PLANES_OFF_WORKER),),
                           frontend_b=False, tag="observed_off",
                           frontend_args=PLANES_OFF_FRONTEND) as (
            a, _, (w,), _):
        _chat(a, chat_body(-1, False, 4))          # warm-up, as serve's
        off = stack_wave(a, w)
    with distributed_stack(workers=(("worker", OBSERVED_WORKER),),
                           frontend_b=False, tag="observed",
                           frontend_args=OBSERVED_FRONTEND) as (
            a, _, (w,), startup_s):
        out["startup_s"] = startup_s
        _chat(a, chat_body(-1, False, 4))          # warm-up, as serve's
        # The profiler's first start initializes CUPTI: a short capture
        # now (of an idle card, so its `ok` is false) keeps that out of
        # the measured one.
        _get_json(w + "/debug/deviceprofile?ms=50")
        fm0, wm0 = _http(a + "/metrics"), _http(w + "/metrics")
        on = stack_wave(a, w)
        reqs, st = on["reqs"], on["worker"]
        fm, wm = _http(a + "/metrics"), _http(w + "/metrics")
        ftraces = json.loads(_http(a + "/debug/traces?n=256"))
        wtraces = json.loads(_http(w + "/debug/traces?n=256"))
        ledgers = json.loads(_http(a + "/debug/requests?n=64"))
        slo = json.loads(_http(a + "/debug/slo"))
        _, prof_state = _get_json(w + "/debug/deviceprofile")
        flight = json.loads(_http(w + "/debug/flightrecorder?n=4096"))
        # A second wave under a device capture.
        with ThreadPoolExecutor(1) as pool:
            cap = pool.submit(_get_json, w + f"/debug/deviceprofile?ms="
                                            f"{CAPTURE_MS}")
            time.sleep(0.2)
            check_results(chat_wave(a, [chat_body(i, i % 2 == 0, 64)
                                        for i in range(8)]), 64)
            code, capture = cap.result()
        # The flight recorder dumped on demand: SIGUSR2 to the worker.
        dump = OBSERVED_DIR / f"flight_{flight['service']}_{flight['pid']}.jsonl"
        os.kill(flight["pid"], signal.SIGUSR2)
        t0 = time.monotonic()
        while not (dump.exists() and '"reason": "sigusr2"' in dump.read_text()):
            check(time.monotonic() - t0 < 30,
                  f"serve_observed: no SIGUSR2 dump at {dump}")
            time.sleep(0.2)
    rids = [r["request_id"] for r in reqs]

    # /metrics
    missing = {}
    for side, text, want in (("frontend", fm, JAX_FRONTEND_FAMILIES),
                             ("worker", wm, JAX_WORKER_FAMILIES)):
        have = metric_families(text)
        missing[side] = sorted(set(want) - have)
        check(not missing[side],
              f"serve_observed: {side} /metrics lacks {missing[side]}")
    grew = {}
    for side, t0_, t1_, sample in (
            ("frontend_requests", fm0, fm,
             'dynamo_frontend_requests_total{model="m"}'),
            ("frontend_ttft", fm0, fm,
             'dynamo_frontend_time_to_first_token_seconds_count{model="m"}'),
            ("frontend_request_ttft", fm0, fm,
             'dynamo_request_ttft_seconds_count{model="m"}'),
            ("worker_request_ttft", wm0, wm, "dynamo_request_ttft_seconds_count"),
            ("worker_outcomes_ok", wm0, wm,
             'dynamo_request_outcomes_total{status="ok"}')):
        grew[side] = (metric_value(t1_, sample) or 0) - (
            metric_value(t0_, sample) or 0)
    check(all(v == 8 for v in grew.values()),
          f"serve_observed: /metrics counted {grew} for the wave of 8")
    registry_size = metric_value(wm, "dynamo_program_registry_size")
    ratios = {s_: metric_value(wm, 'dynamo_modeled_vs_measured_ratio'
                                   f'{{series="{s_}"}}')
              for s_ in ("kv_decode", "window_time")}
    check(registry_size and registry_size > 0,
          f"serve_observed: program registry size {registry_size}")
    check(ratios["kv_decode"] is not None
          and ratios["kv_decode"] <= device_profiler.DEFAULT_BAND_HI,
          f"serve_observed: kv_decode ratio {ratios}")
    states = {k: v["state"] for k, v in prof_state["drift"].items()}
    check(ratios["window_time"] is not None
          and "page" not in states.values(),
          f"serve_observed: drift {ratios}, states {states}")
    check(metric_value(wm, "dynamo_engine_stalls_total") == 0,
          "serve_observed: the watchdog counted a stall")
    hbm = metric_value(wm, 'dynamo_hbm_used_bytes{device="0",kind="gpu"}')
    check(hbm is not None and hbm > 0, f"serve_observed: HBM used {hbm}")

    # /debug/traces
    chains = [trace_chain(ftraces, wtraces, rid) for rid in rids]

    # /debug/requests
    by_rid = {e["request_id"]: e for e in ledgers["slowest"]}
    coverage = []
    for rid in rids:
        e = by_rid.get(rid)
        check(e is not None and e["ttft_s"], f"serve_observed: no ledger "
                                             f"for {rid}")
        covered = sum(x["dur"] for x in e["stamps"]
                      if x["phase"] in ledger.TTFT_PHASES)
        coverage.append(covered / e["ttft_s"])
    check(all(ledger.COVERAGE_FLOOR <= c <= ledger.COVERAGE_CEIL
              for c in coverage),
          f"serve_observed: ledger TTFT coverage {coverage} outside "
          f"[{ledger.COVERAGE_FLOOR}, {ledger.COVERAGE_CEIL}]")

    # /debug/deviceprofile
    check(code == 200 and capture["ok"] and capture["device_events"] > 0,
          f"serve_observed: device capture: {capture}")
    with open(capture["trace"]) as f:
        summary = device_profiler.summarize_trace(json.load(f))
    names = summary.pop("kernel_names")
    ran = {k: any(k in n for n in names)
           for k in ("paged_decode_kernel", "paged_prefill_kernel")}
    check(all(ran.values()), f"serve_observed: the capture lacks K1/K2: "
                             f"{ran}; kernels {names[:40]}")

    # The flight recorder
    kinds = {e["kind"] for e in flight["events"]}
    check(flight["enabled"] and {"window", "prefill_packed"} <= kinds,
          f"serve_observed: flight events {sorted(kinds)}")
    dumped = [json.loads(ln) for ln in dump.read_text().splitlines()]
    headers = [d for d in dumped if d.get("flight_dump")]
    check(any(h["reason"] == "sigusr2" for h in headers)
          and any(d.get("kind") == "window" for d in dumped),
          f"serve_observed: the SIGUSR2 dump holds {len(dumped)} lines")

    worker_counters = st["counters"]

    def differ(other):
        return {k: (worker_counters[k], other.get(k))
                for k in worker_counters if worker_counters[k] != other.get(k)}

    check(not differ(off["worker"]["counters"]),
          f"serve_observed: the wave's counters differ with the planes on: "
          f"{differ(off['worker']['counters'])}")

    out.update({
        "wave": {**on["summary"], "launches": st["kernels"]},
        "wave_planes_off": {**off["summary"],
                            "launches": off["worker"]["kernels"]},
        "serve": {k: serve[k] for k in ("output_tok_s", "ttft_mean_s",
                                        "ttft_max_s", "itl_mean_s")},
        "metrics": {"missing": missing, "grew": grew,
                    "program_registry_size": registry_size,
                    "modeled_vs_measured": ratios, "drift_states": states,
                    "hbm_used_bytes": hbm},
        "traces": {"chats": len(chains), "chain": chains[0]},
        "ledger_ttft_coverage": coverage,
        "ledger_dominant_phase": ledgers["dominant_phase"],
        "slo": {"state": slo["state"], "objectives": slo["objectives"]},
        "capture": {"ms": capture["ms"], "trace": capture["trace"],
                    "k1_k2_ran": ran, **summary},
        "flight": {"events": len(flight["events"]), "kinds": sorted(kinds),
                   "sigusr2_dump": str(dump), "dump_lines": len(dumped)},
        "counters": {"worker_wave": worker_counters,
                     "equal_serve": not differ(serve["counters"]),
                     "differ_from_serve": differ(serve["counters"]),
                     "equal_planes_off": not differ(
                         off["worker"]["counters"]),
                     "differ_from_planes_off": differ(
                         off["worker"]["counters"])},
    })
    out["planes"] = planes_counters(torch)
    return out


# -- the KV data plane -------------------------------------------------------

OFFER_BLOCKS = 8               # blocks one device offer/pull round moves
DISAGG_THRESHOLD = 512         # the decode worker's --max-local-prefill
DISAGG_TURN = "{i:02d}: " + (
    "Explain how a prefill worker hands its KV cache to a decode worker. "
    * 23)


def disagg_chat(i: int, stream: bool, max_tokens: int = 64) -> dict:
    """A long chat (~1,600 prompt tokens: four 512-token prefill chunks)
    whose first block is its own, so no two of them share a block."""
    return chat_body(i, stream, max_tokens, user=DISAGG_TURN)


def ipc_blocks(torch, quant: bool, n: int, seed: int = 7):
    """n wire blocks of llama-3-1b (16 layers, 64 tokens, 8 kv heads of
    64: 2 MiB bf16, or packed int8 with its scales), from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n, 2, 16, BS, HKV * 64 + (4 * HKV if quant else 0))
    if quant:
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def kv_holder(quant: bool, n: int = OFFER_BLOCKS,
              ttl_s: Optional[float] = None) -> int:
    """`chip_smoke.py --kv-holder bf16|int8 [N [TTL_S]]`: a process that
    serves N blocks (`ipc_blocks`, hashed as the prompt 0..N*64-1) on the
    device plane (kv_offer / kv_pulled) and the host-staged one
    (kv_blocks) until it is killed, and reports its staging on
    `holder_stats` ({"expire": true} first retires expired offers);
    prints its address.  `block_copy` and tests/test_torch_cuda.py pull
    from it."""
    import asyncio

    import torch

    from dynamo_tpu_torch.llm.block_manager import device_transfer as dt
    from dynamo_tpu_torch.llm.block_manager.transfer import (
        KV_BLOCKS_ENDPOINT, make_kv_blocks_handler, sealed_hashes)
    from dynamo_tpu_torch.runtime.rpc import RpcServer

    data = ipc_blocks(torch, quant, n)
    hashes = sealed_hashes(list(range(n * BS)), BS)

    class Source:
        """An engine's export: a fresh staging tensor per offer."""

        async def export_blocks_device(self, want):
            idx = [i for i, h in enumerate(hashes) if h in want]
            return dict(zip([hashes[i] for i in idx],
                            data[idx].clone().unbind(0)))

        async def export_blocks(self, want):
            blocks = await self.export_blocks_device(want)
            host = torch.stack(list(blocks.values())).cpu()
            return dict(zip(blocks, host.unbind(0)))

    async def main():
        plane = dt.KvTransferPlane(
            Source(), device=torch.device("cuda"),
            offer_ttl_s=dt.OFFER_TTL_S if ttl_s is None else ttl_s)
        plane.start()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()

        async def holder_stats(payload):
            if payload.get("expire"):
                plane.expire_offers()
            torch.cuda.synchronize()
            yield {"extra_bytes": torch.cuda.memory_allocated() - base,
                   "outstanding": len(plane._outstanding),
                   **{k: v for k, v in plane.stats().items()
                      if k != "transport"}}

        rpc = RpcServer()
        rpc.register(dt.KV_OFFER_ENDPOINT, plane.make_offer_handler())
        rpc.register(dt.KV_PULLED_ENDPOINT, plane.make_pulled_handler())
        rpc.register(KV_BLOCKS_ENDPOINT, make_kv_blocks_handler(Source()))
        rpc.register("holder_stats", holder_stats)
        print(await rpc.start(), flush=True)
        await asyncio.Event().wait()

    asyncio.run(main())
    return 0


@contextlib.contextmanager
def kv_holder_proc(quant: bool, n: int = OFFER_BLOCKS,
                   ttl_s: Optional[float] = None):
    """`kv_holder` in a process of its own, killed on exit; yields its
    RPC address."""
    args = [sys.executable, str(Path(__file__).resolve()), "--kv-holder",
            "int8" if quant else "bf16", str(n)]
    if ttl_s is not None:
        args.append(str(ttl_s))
    proc = subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE,
                            text=True)
    try:
        address = proc.stdout.readline().strip()
        check(bool(address), "the kv holder process did not start")
        yield address
    finally:
        proc.kill()
        proc.wait(timeout=30)


def block_copy_phase(torch) -> dict:
    """The data plane's copies at llama-3-1b's geometry, for one offer
    batch of OFFER_BLOCKS blocks:
    - `extract_blocks` / `inject_blocks` on a bf16 and an int8 cache (one
      index_select / index_copy_ a layer and K/V): CUDA-event time, the
      bytes' bound (each block read once and written once), and the
      round trip byte-exact;
    - a pull from another process (`--kv-holder`): the device plane over
      cuda_ipc (offer RPC, IPC map, device copy; synchronised) and the
      host-staged plane (kv_blocks frames, pageable copies), each round
      byte-equal to the holder's blocks; host-clock medians of 10 rounds
      after 2 warm-ups; after the last ack the holder keeps no staging
      (its allocated memory is back where it started)."""
    import asyncio

    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.llm.block_manager import device_transfer as dt
    from dynamo_tpu_torch.llm.block_manager.transfer import (
        fetch_blocks, sealed_hashes)
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.runtime.rpc import RpcClient

    cfg = get_config("llama-3-1b")
    copies = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for quant in ("none", "int8"):
        cc = kvc.KvCacheConfig.for_model(cfg, num_blocks=4 * OFFER_BLOCKS,
                                         block_size=BS, kv_quant=quant)
        cache = kvc.init_cache(cc, "cuda")
        for bufs in cache.values():
            for t in bufs:
                if t.dtype == torch.int8:
                    t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                          device="cuda", dtype=torch.int8))
                else:
                    t.copy_(torch.rand(t.shape, generator=gen,
                                       device="cuda").to(t.dtype))
        src = torch.arange(1, 1 + OFFER_BLOCKS, device="cuda")
        dst = src + OFFER_BLOCKS
        data = kvc.extract_blocks(cache, src, BS)
        kvc.inject_blocks(cache, dst, data, BS)
        again = kvc.extract_blocks(cache, dst, BS)
        check(torch.equal(again.view(torch.uint8), data.view(torch.uint8)),
              f"block_copy: inject(extract) is not byte-exact ({quant})")
        nbytes = data.numel() * data.element_size()
        b_ms, _ = bound(2 * nbytes, 0)
        copies[quant] = {
            "blocks": OFFER_BLOCKS, "block_bytes": nbytes // OFFER_BLOCKS,
            "extract_ms": time_ms(torch, lambda: kvc.extract_blocks(
                cache, src, BS)),
            "inject_ms": time_ms(torch, lambda: kvc.inject_blocks(
                cache, dst, data, BS)),
            "bound_ms": b_ms}
        del cache, data, again
    torch.cuda.empty_cache()

    pulls = {}
    hashes = sealed_hashes(list(range(OFFER_BLOCKS * BS)), BS)
    for quant in (False, True):
        want = ipc_blocks(torch, quant, OFFER_BLOCKS)

        async def measure(address):
            plane = dt.KvTransferPlane(device=torch.device("cuda"))
            plane.start()
            rpc = RpcClient(address)
            dev, host = [], []
            try:
                for _ in range(12):
                    t0 = time.perf_counter()
                    blocks, refusal = await dt.pull_blocks_device(
                        plane, rpc, hashes)
                    torch.cuda.synchronize()
                    dev.append((time.perf_counter() - t0) * 1e3)
                    check(refusal is None,
                          f"block_copy: the holder refused ({refusal})")
                    got = torch.stack([blocks[h] for h in hashes])
                    check(torch.equal(got.view(torch.uint8),
                                      want.view(torch.uint8)),
                          "block_copy: cuda_ipc pull is not byte-exact")
                    t0 = time.perf_counter()
                    blocks = await fetch_blocks(rpc, hashes)
                    host.append((time.perf_counter() - t0) * 1e3)
                    got = torch.stack([blocks[h] for h in hashes])
                    check(torch.equal(got.view(torch.uint8),
                                      want.cpu().view(torch.uint8)),
                          "block_copy: host-staged pull is not byte-exact")
                for _ in range(200):          # the last release and ack
                    held = [m async for m in rpc.call("holder_stats", {})][-1]
                    if held["outstanding"] == 0 and not plane._mapped:
                        break
                    await asyncio.sleep(0.01)
                return dev[2:], host[2:], plane.transport_kind, held
            finally:
                await rpc.close()

        with kv_holder_proc(quant) as address:
            dev, host, kind, held = asyncio.run(
                asyncio.wait_for(measure(address), 120))
        check(kind == "cuda_ipc", f"block_copy: the device plane ran {kind}")
        check(held["outstanding"] == 0 and held["extra_bytes"] == 0,
              f"block_copy: the holder kept staging after the acks: {held}")
        pulls["int8" if quant else "none"] = {
            "blocks": OFFER_BLOCKS, "transport": kind,
            "device_round_ms": statistics.median(dev),
            "device_ms_per_block": statistics.median(dev) / OFFER_BLOCKS,
            "host_round_ms": statistics.median(host),
            "host_ms_per_block": statistics.median(host) / OFFER_BLOCKS,
            "holder_offers": held["offers"],
            "holder_staged_bytes_high_water": held["staged_bytes_high_water"]}
    return {"phase": "block_copy", "copies": copies, "pulls": pulls}


def serve_disagg_phase(serve: dict) -> dict:
    """llama-3-1b disaggregated on one card: frontend A (kv), a `--role
    prefill` worker and a `--role decode --max-local-prefill 512` worker
    (bf16, 512 blocks of 64 each).  After a warm-up (one long chat, one
    short one) and a stats reset on both workers:
    - lone: `serve`'s two long chats (~1,600 prompt tokens, 64 output
      tokens, greedy, `traced`) one at a time; their token ids and
      logprobs must equal, bit for bit, the one-process server's when it
      answered them from its prefix cache (their second time there).
      The decode worker prefills only the last partial block against the
      onboarded blocks, so that is the same computation, and any wrong
      onboarded byte moves a logprob.  A cold answer prefills the tail
      inside a 131-token chunk, whose bf16 products round otherwise, and
      random weights leave near ties that such rounding flips: how many
      leading tokens agree with the cold answer is reported, not held;
    - a wave of 4 long and 4 short (`serve`'s) chats at once, half
      streaming, every request returning its tokens.
    After each, on the decode worker: `remote_prefills` = the long chats,
    `local_fallbacks` 0, `tokens_onboarded` = their sealed blocks x 64,
    every pull on the device plane over cuda_ipc (no host-staged one),
    K1 and K2 launched; `overlap_ratio` > 0 for at least one long chat
    (streamed before prefill-done); on the prefill worker: K2 launched
    and K1 never (its one token comes from the prefill logits).  Returns
    the wave's TTFT (long and short apart), ITL and output tok/s, the
    lone chats' TTFT beside `serve`'s, the eager and done pull counts and
    the staged-offer high-water marks."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    pre = OpenAIPreprocessor(ByteTokenizer())

    def ntok(b):
        return len(pre.preprocess_chat(ChatCompletionRequest.from_dict(b),
                                       "x").token_ids)

    def stats(url):
        return json.loads(_http(url + "/debug/stats"))

    def reset(*urls):
        for u in urls:
            _http(u + "/debug/stats/reset", {})

    def check_run(what, dst, pst, long_bodies):
        d, tp = dst["disagg"], dst["transfer_plane"]
        sealed = sum(ntok(b) // BS for b in long_bodies)
        check(d["remote_prefills"] == len(long_bodies)
              and d["local_fallbacks"] == 0,
              f"serve_disagg {what}: {d['remote_prefills']} remote prefills, "
              f"{d['local_fallbacks']} local fallbacks for "
              f"{len(long_bodies)} long chats")
        check(d["tokens_onboarded"] == sealed * BS,
              f"serve_disagg {what}: onboarded {d['tokens_onboarded']} "
              f"tokens, want {sealed} sealed blocks x {BS}")
        check(tp["transport"] == "cuda_ipc"
              and set(dst["plane_counts"]) == {"device"}
              and tp["pulled_blocks"] >= sealed,
              f"serve_disagg {what}: pulls off cuda_ipc: "
              f"{dst['plane_counts']}, {tp}")
        for name, st, k1 in (("decode", dst, True), ("prefill", pst, False)):
            k = st["kernels"]
            check(k["paged_prefill_attention"] > 0
                  and (k["paged_decode_attention"] > 0) == k1,
                  f"serve_disagg {what}: the {name} worker's launches {k}")
        return {"remote_prefills": d["remote_prefills"],
                "tokens_onboarded": d["tokens_onboarded"],
                "sealed_blocks": sealed,
                "eager_pulls": d["eager_pulls"], "done_pulls": d["done_pulls"],
                "eager_blocks_before_done": d["eager_blocks_before_done"],
                "eager_blocks_after_done": d["eager_blocks_after_done"],
                "overlap_ratios": d["overlap_ratios"],
                "plane_counts": dst["plane_counts"],
                "pulled_blocks": tp["pulled_blocks"],
                "pulled_bytes": tp["pulled_bytes"],
                "prefill_offers": pst["transfer_plane"]["offers"],
                "staged_offers_high_water":
                    pst["transfer_plane"]["outstanding_high_water"],
                "staged_bytes_high_water":
                    pst["transfer_plane"]["staged_bytes_high_water"],
                "launches": {"decode": dst["kernels"],
                             "prefill": pst["kernels"]}}

    lone = [traced(disagg_chat(i, False)) for i in range(2)]
    check(len(serve["lone_answers"]) >= 6,
          "serve_disagg: serve answered no long lone chats")
    cold, warm = serve["lone_answers"][2:4], serve["lone_answers"][4:6]
    workers = (("prefill", ("--role", "prefill")),
               ("decode", ("--role", "decode", "--max-local-prefill",
                           str(DISAGG_THRESHOLD))))
    with distributed_stack(workers, frontend_b=False, tag="disagg") as (
            a, _, (pw, dw), startup_s):
        _chat(a, disagg_chat(-1, False, 4))
        _chat(a, chat_body(-1, False, 4))
        reset(a, pw, dw)
        got = [answer(_chat(a, b)) for b in lone]
        check(got == warm,
              f"serve_disagg: the long chats gave {got!r}, the "
              f"one-process server from its prefix cache {warm!r}")
        lone_ttft = [r["ttft_s"] for r in stats(a)["requests"]]
        lone_run = check_run("lone", stats(dw), stats(pw), lone)
        reset(a, pw, dw)
        bodies = ([disagg_chat(10 + i, i % 2 == 0) for i in range(4)]
                  + [chat_body(30 + i, i % 2 == 0, 64) for i in range(4)])
        t1 = time.monotonic()
        results = chat_wave(a, bodies)
        wall = time.monotonic() - t1
        reqs = stats(a)["requests"]
        wave_run = check_run("wave", stats(dw), stats(pw), bodies[:4])
    check_results(results, 64)
    check(max(lone_run["overlap_ratios"] + wave_run["overlap_ratios"]) > 0,
          "serve_disagg: no long chat streamed a block before prefill-done")
    long_t = [r["ttft_s"] for r in reqs if r["prompt_tokens"] > DISAGG_THRESHOLD]
    short_t = [r["ttft_s"] for r in reqs
               if r["prompt_tokens"] <= DISAGG_THRESHOLD]
    itl_n = sum(r["itl_n"] for r in reqs)
    out_tokens = sum(r["tokens"] for r in results)
    return {"phase": "serve_disagg", "model": "llama-3-1b",
            "threshold": DISAGG_THRESHOLD, "startup_s": startup_s,
            "lone_answers_equal": True,
            "lone_leading_tokens_equal_cold": [
                leading_equal(g["token_ids"], c["token_ids"])
                for g, c in zip(got, cold)],
            "long_prompt_tokens": [ntok(b) for b in lone + bodies[:4]],
            "lone": dict(lone_run, ttft_s=lone_ttft,
                         serve_ttft_cold_s=serve["lone_ttft_s"][2:4],
                         serve_ttft_warm_s=serve["lone_ttft_s"][4:6]),
            "wave": dict(wave_run, requests=len(results),
                         output_tokens=out_tokens, wall_s=wall,
                         output_tok_s=out_tokens / wall,
                         ttft_long_s=long_t, ttft_short_s=short_t,
                         ttft_long_mean_s=statistics.mean(long_t),
                         ttft_short_mean_s=statistics.mean(short_t),
                         itl_mean_s=(sum(r["itl_sum_s"] for r in reqs)
                                     / itl_n if itl_n else None))}


# -- the fleet's control loop: qos, planner_profile, fleet -------------------

QOS_BLOCKS = 24                # the qos worker's KV pages (23 usable)
QOS_BE, QOS_IA = 14, 2         # best-effort (class 0), interactive (class 2)
QOS_BE_TOKENS, QOS_IA_TOKENS = 192, 64
QOS_TURN = "QoS {i}: say something about paged attention on a GPU, please."
# An interactive chat needs ~8 of the 23 pages at admission: more than a
# best-effort wave ever leaves free, so it must preempt.
QOS_IA_TURN = "Interactive {i}: " + "what does a paged KV cache hold? " * 12
QOS_RERUNS = 3                 # preempted chats held against a lone run
QOS_RACE_S = 0.5               # an engine step's slack around an arrival
PROFILE_GRID = {"isl": (128, 512), "context": (256, 1024), "kv": (0.2, 0.6)}
FLEET_MODEL = ("--model", "llama-3-1b")   # what the planner's workers serve
FLEET_BLOCKS = 128             # each fleet worker's KV pages
FLEET_WAVE = 16                # chats of the scale-up wave
FLEET_CHARS = 550              # user-turn bytes of the fleet's chats
FLEET_WAVE_TOKENS = 128        # each scale-up wave chat's answer
# The chat drained mid-decode: ~45 s of decode, well past the planner's
# scale-down (a few 5 s intervals after the scale-up wave ends; drains
# came after 657-1317 tokens on an H100 80GB HBM3).
FLEET_LONG_ID, FLEET_LONG_TOKENS = 1000, 2560
# The planner's scale-down mark: the survivor's KV use under 0.6.  The
# long chat's ~50 pages of 128 stay below it, so its growth never vetoes
# the scale-down it waits for (at the default 0.3 it would from ~1,800
# tokens on).
FLEET_KV_LOW = 0.6
FLEET_METRICS_S = 0.5          # the workers' load-metrics interval
FLEET_DIR = OUT_DIR / "fleet"  # launcher, worker and control-plane files


def stream_chat(base: str, body: dict, headers=None) -> dict:
    """One streamed `traced` chat: its response id, token ids and wall
    time.  (The frontend sends a chunk only with text, and a random
    model's ids above 255 spell none, so the ids come late: time from the
    frontend's own timings, not from the chunks.)"""
    body = {**traced(body), "stream": True,
            "stream_options": {"include_usage": True}}
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.monotonic()
    ids, rid, finish, usage, done = [], None, None, None, False
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                done = True
                continue
            chunk = json.loads(line[6:])
            rid = chunk.get("id") or rid
            usage = chunk.get("usage") or usage
            for ch in chunk["choices"]:
                ids += [int(e["token"].removeprefix("token_id:"))
                        for e in (ch.get("logprobs") or {}).get("content")
                        or []]
                finish = ch.get("finish_reason") or finish
    return {"rid": rid, "ids": ids, "done": done, "finish": finish,
            "tokens": usage["completion_tokens"] if usage else 0,
            "wall_s": time.monotonic() - t0}


def greedy_split(torch, state, prompt: list, got: list, want: list,
                 what: str) -> Optional[dict]:
    """`got` must equal `want` token for token, a split allowed only at a
    near tie: at the first differing position both tokens lie within
    MODEL_TOL of the top of the gather path's logits (`argmax_gap`)."""
    from dynamo_tpu_torch.models.config import get_config

    check(len(got) == len(want), f"{what}: {len(got)} tokens, "
                                 f"{len(want)} in the reference")
    n = leading_equal(got, want)
    if n == len(want):
        return None
    cfg = get_config("llama-3-1b")
    lg = plain_forward(torch, cfg, state, [prompt + want[:n]], False)[0]
    gaps = [((lg.max() - lg[t]) / lg.abs().max()).item()
            for t in (got[n], want[n])]
    check(max(gaps) <= MODEL_TOL[cfg.name],
          f"{what}: split at token {n} beyond a near tie: argmax gaps "
          f"{gaps} > {MODEL_TOL[cfg.name]}")
    return {"at": n, "argmax_gap": gaps}


def forced_gaps(torch, cfg, state, prompt: list, ids: list,
                start: int, embeds=None) -> list:
    """The argmax gap (as `greedy_split` reads one) of each of
    `ids[start:]` under the gather path's logits at its position, given
    the prompt and the ids before it: one teacher-forced forward of the
    whole sequence, so that no earlier split hides a later token.
    `embeds` ([n, H] float32): the prompt's first n positions take them
    in place of the token lookup (the multimodal prefill)."""
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.models import llama

    dev = state["final_norm"].device
    toks = prompt + ids[:-1]
    L, P = len(toks), -(-len(toks) // BS)
    cache = kvc.init_cache(kvc.KvCacheConfig.for_model(
        cfg, num_blocks=P + 1, block_size=BS), dev)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    mm = {}
    if embeds is not None:
        inp = torch.zeros(1, L, cfg.hidden_size, device=dev)
        inp[0, :len(embeds)] = torch.as_tensor(embeds, device=dev)
        mask = torch.zeros(1, L, dtype=torch.bool, device=dev)
        mask[0, :len(embeds)] = True
        mm = {"input_embeds": inp, "embed_mask": mask}
    logits, _ = llama.make_forward_step(cfg, BS)(
        state, cache, i32([toks]), i32([list(range(L))]), i32([L]),
        i32([list(range(1, P + 1))]), **mm)
    lg = logits[0, len(prompt) - 1 + start:].float()  # row j: ids[start+j]
    picked = lg.gather(1, torch.tensor(ids[start:], device=dev)[:, None])
    gaps = (lg.max(1).values - picked[:, 0]) / lg.abs().max(1).values
    return gaps.tolist()


def llama_state(torch):
    """llama-3-1b's seed-0 weights on the card, as the servers draw them."""
    from dynamo_tpu_torch.models import weights
    from dynamo_tpu_torch.models.config import get_config

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    return weights.init_params(get_config("llama-3-1b"), gen,
                               torch.device("cuda"))


def qos_phase(torch) -> dict:
    """QoS admission and preemption on the card: a frontend and one
    llama-3-1b worker of QOS_BLOCKS pages (`distributed_stack`), so the
    class travels the header → annotation → RPC → scheduler path and the
    worker's /metrics carries `dynamo_qos_preemptions_total`.  A wave of
    QOS_BE best-effort chats (`x-dynamo-priority: 0`) fills the pages and
    queues; one second in, QOS_IA interactive chats (class 2) arrive.
    Checked: every interactive chat is admitted (the worker's flight
    recorder `admit` events) before every best-effort chat that was still
    unadmitted QOS_RACE_S after the interactives were sent; at least one
    QoS preemption; every chat returns its full token count; each
    QoS-preempted chat's greedy ids equal the same chat's on the then
    unpressured stack (a split only at a near tie; the first QOS_RERUNS
    of them).  TTFT by class."""
    t_phase = time.monotonic()
    be = [chat_body(i, True, QOS_BE_TOKENS, user=QOS_TURN)
          for i in range(QOS_BE)]
    ia = [chat_body(i, True, QOS_IA_TOKENS, user=QOS_IA_TURN)
          for i in range(QOS_IA)]
    with distributed_stack(
            workers=(("worker", ("--num-blocks", str(QOS_BLOCKS),
                                 "--flight-recorder", "on")),),
            frontend_b=False, tag="qos") as (a, _, (w,), startup_s):
        _chat(a, chat_body(-1, False, 4, user=QOS_TURN))
        _http(w + "/debug/stats/reset", {})
        with ThreadPoolExecutor(QOS_BE + QOS_IA) as pool:
            futs = [pool.submit(stream_chat, a, b, {"x-dynamo-priority": "0"})
                    for b in be]
            time.sleep(1.0)
            t_send = time.time()
            futs += [pool.submit(stream_chat, a, b,
                                 {"x-dynamo-priority": "interactive"})
                     for b in ia]
            res = [f.result() for f in futs]
        stats = json.loads(_http(w + "/debug/stats"))
        ttft = {t["request_id"]: t["ttft_s"]
                for t in json.loads(_http(a + "/debug/stats"))["requests"]}
        metrics = _http(w + "/metrics")
        events = json.loads(_http(w + "/debug/flightrecorder?n=4000"))["events"]
        preempted = [e["rid"] for e in events if e["kind"] == "qos_preempt"]
        alone = {}
        for rid in list(dict.fromkeys(preempted))[:QOS_RERUNS]:
            i = [r["rid"] for r in res].index(rid)
            alone[rid] = stream_chat(a, (be + ia)[i],
                                     {"x-dynamo-priority": "0"})
    be_res, ia_res = res[:QOS_BE], res[QOS_BE:]
    for r, n in [(r, QOS_BE_TOKENS) for r in be_res] + [
            (r, QOS_IA_TOKENS) for r in ia_res]:
        check(r["done"] and r["tokens"] == n == len(r["ids"])
              and r["finish"] == "length",
              f"qos: a chat returned {r['tokens']} of {n} tokens "
              f"({r['finish']})")
    n_preempt = metric_value(metrics, "dynamo_qos_preemptions_total")
    check(n_preempt is not None and n_preempt >= 1,
          f"qos: dynamo_qos_preemptions_total {n_preempt}")
    check(metric_value(metrics, "dynamo_qos_demoted_blocks_total") == 0,
          "qos: blocks demoted without a host tier")
    admits = [(e["ts"], e["rid"]) for e in events if e["kind"] == "admit"]
    first = {}
    for ts, rid in admits:
        first.setdefault(rid, ts)
    be_ids = {r["rid"] for r in be_res}
    ia_first = [first.get(r["rid"]) for r in ia_res]
    check(all(t is not None for t in ia_first),
          f"qos: an interactive chat has no admit event: {ia_first}")
    queued = {rid: ts for rid, ts in first.items()
              if rid in be_ids and ts > t_send + QOS_RACE_S}
    check(bool(queued), "qos: no best-effort chat was still queued when "
                        "the interactive chats arrived")
    check(max(ia_first) < min(queued.values()),
          f"qos: a queued best-effort chat was admitted before an "
          f"interactive one: interactive at {ia_first}, best-effort at "
          f"{sorted(queued.values())}")
    check(bool(preempted), "qos: no qos_preempt event in the flight ring")
    state = llama_state(torch)
    splits = {}
    for rid, ref in alone.items():
        i = [r["rid"] for r in res].index(rid)
        splits[rid] = greedy_split(torch, state, chat_tokens((be + ia)[i]),
                                   res[i]["ids"], ref["ids"],
                                   f"qos: preempted chat {rid}")
    del state
    torch.cuda.empty_cache()
    return {"phase": "qos", "startup_s": startup_s, "blocks": QOS_BLOCKS,
            "best_effort": QOS_BE, "interactive": QOS_IA,
            "qos_preemptions": n_preempt,
            "preempted": len(set(preempted)),
            # The frontend's TTFT of each chat (arrival to first token).
            "ttft_s": {"interactive": [ttft[r["rid"]] for r in ia_res],
                       "best_effort": [ttft[r["rid"]] for r in be_res]},
            "ttft_mean_s": {
                "interactive": statistics.mean(ttft[r["rid"]]
                                               for r in ia_res),
                "best_effort": statistics.mean(ttft[r["rid"]]
                                               for r in be_res),
                "best_effort_queued": statistics.mean(
                    ttft[r["rid"]] for r in be_res if r["rid"] in queued)},
            "interactive_admit_after_send_s": [t - t_send for t in ia_first],
            "preempted_splits": splits, "launches": stats["kernels"],
            "wall_s": time.monotonic() - t_phase}


def planner_profile_phase(torch, kernels) -> dict:
    """The SLA profiler (`python -m dynamo_tpu_torch.planner.profiler`'s
    `main`, in process so that its launches are counted) sweeps llama-3-1b
    at full width and depth on PROFILE_GRID into `smoke_out/`: every TTFT,
    ITL and throughput finite and positive, the schema JAX's (the keys,
    the grid and the row shapes), K1 and K2 launched.  The profile then
    feeds the SLA planner's target computation once."""
    import math

    from dynamo_tpu_torch.planner import SlaObservation, SlaPlanner
    from dynamo_tpu_torch.planner import profiler

    t0 = time.monotonic()
    out = OUT_DIR / "sla_profile.json"
    g = PROFILE_GRID
    kernels.reset_launch_counts()
    profiler.main(["--model", "llama-3-1b", "--out", str(out),
                   "--isl", *map(str, g["isl"]),
                   "--context", *map(str, g["context"]),
                   "--kv", *map(str, g["kv"])])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    wall = time.monotonic() - t0
    torch.cuda.empty_cache()
    prof = json.loads(out.read_text())
    pre, dec = prof["prefill"], prof["decode"]
    check(set(prof) == {"prefill", "decode"}
          and set(pre) == {"isl", "ttft_s", "tok_s_per_chip"}
          and set(dec) == {"kv_usage", "context", "itl_s", "tok_s_per_chip"},
          f"planner_profile: not JAX's schema: {prof}")
    check(pre["isl"] == list(g["isl"]) and dec["context"] == list(g["context"])
          and dec["kv_usage"] == list(g["kv"])
          and len(pre["ttft_s"]) == len(pre["tok_s_per_chip"]) == len(g["isl"])
          and all(len(r) == len(g["kv"])
                  for r in dec["itl_s"] + dec["tok_s_per_chip"])
          and len(dec["itl_s"]) == len(dec["tok_s_per_chip"])
          == len(g["context"]),
          f"planner_profile: grid or shape off: {prof}")
    values = (pre["ttft_s"] + pre["tok_s_per_chip"] + sum(dec["itl_s"], [])
              + sum(dec["tok_s_per_chip"], []))
    check(all(math.isfinite(v) and v > 0 for v in values),
          f"planner_profile: a non-positive or non-finite value: {prof}")
    check(launches["paged_decode_attention"] > 0
          and launches["paged_prefill_attention"] > 0,
          f"planner_profile: K1 or K2 never launched: {launches}")
    # The SLA planner's targets from this profile for one interval of
    # serve-like traffic (its defaults: TTFT 0.5 s, ITL 0.05 s).
    planner = SlaPlanner(prof, observe=None, decode_connector=None)
    obs = SlaObservation(num_requests=400, avg_isl=512, avg_osl=128,
                         ttft_s=pre["ttft_s"][-1], itl_s=dec["itl_s"][0][0])
    d = planner.decide(obs)
    return {"phase": "planner_profile", "grid": g, "profile": prof,
            "wall_s": wall, "launches": launches,
            "sla_targets": {"observation": obs.__dict__,
                            "num_prefill": d.num_prefill,
                            "num_decode": d.num_decode,
                            "p_correction": d.p_correction,
                            "d_correction": d.d_correction}}


def cp_run(addr: str, fn):
    """`await fn(client)` on a fresh control-plane client of `addr`."""
    import asyncio

    from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneClient

    async def main():
        host, _, port = addr.rpartition(":")
        cli = ControlPlaneClient(host, int(port))
        await cli.start()
        try:
            return await fn(cli)
        finally:
            await cli.close()

    return asyncio.run(asyncio.wait_for(main(), 60))


def fleet_long_body() -> dict:
    """The chat that `fleet` drains mid-decode; `serve` answers it first,
    undrained, as its greedy reference."""
    return traced(long_chat(FLEET_LONG_ID, False, FLEET_LONG_TOKENS,
                            FLEET_CHARS))


def fleet_workers(cp: str) -> dict:
    """pid -> status url of every worker registered on the control plane."""
    async def get(cli):
        return await cli.get_prefix("status_endpoints/worker-both/")

    return {int(v["pid"]): "http://" + v["address"]
            for v in cp_run(cp, get).values()}


def planner_reaches(holder: int, newest: int) -> bool:
    """Whether the planner's scale-down drains the worker of spawn number
    `holder`: its connector removes the newest worker."""
    return holder == newest


def fleet_phase(torch, ref_ids: list) -> dict:
    """The fleet's control loop: `python -m dynamo_tpu_torch.launcher` on a
    graph of a control plane of its own (`control_plane_service --store
    file:`), a kv-routed frontend, the metrics aggregator and the load
    planner (`--min-replicas 1 --max-replicas 2 --kv-low FLEET_KV_LOW`),
    which spawns llama-3-1b workers of FLEET_BLOCKS pages on the card.  In
    order:
    - scale-up: waves of FLEET_WAVE chats queue on the first worker until
      the planner's second worker registers;
    - the long chat (`fleet_long_body`) goes out at once, while the last
      wave still queues on the first worker: the router sends it to the
      idle newest worker (no prompt block of it is on the first; where
      the wave has just ended, to either), and the planner, which sees
      requests waiting, cannot scale down before it is placed;
    - the chat's worker launches K1 and K2, and so does its peer (read
      once the stream resumed there); while the wave runs, the
      aggregator's /metrics carries both workers' load and scraped series
      and the frontend's exposition;
    - drain mid-decode: once the fleet idles but for the long chat, the
      planner's scale-down SIGTERMs the newest worker, the chat's.  Where
      the chat is on a worker that scale-down does not reach, the
      control-plane command `drain/instance/<id>` drains that worker, and
      waves then make the planner add a worker again, so that its
      scale-down has one to remove (`drain.via` says which trigger ran);
    - the stream completes through the peer with
      `dynamo_migrations_total{reason="drain"}`; the peer pulled the
      sealed blocks over cuda_ipc before admission (no host-staged block,
      none prefilled again); the ids equal `serve`'s undrained answer
      `ref_ids` (a split only at a near tie), and each id is the plain
      model's greedy choice given the ids before it, up to a near tie
      (`forced_gaps`), so no early split hides a token after the handoff;
    - scale-down: the connector counts a clean drain and no force kill,
      and one replica is left; no chat failed;
    - teardown: SIGTERM stops the graph in reverse order, rc 0, in time."""
    from dynamo_tpu_torch.llm.drain import drain_key_instance
    from dynamo_tpu_torch.models.config import get_config

    t_phase = time.monotonic()
    FLEET_DIR.mkdir(parents=True, exist_ok=True)
    for f in FLEET_DIR.iterdir():
        f.unlink()
    cp_port, fe_port, agg_port, pl_port = (_free_port() for _ in range(4))
    cp = f"127.0.0.1:{cp_port}"
    fe = f"http://127.0.0.1:{fe_port}"
    agg = f"http://127.0.0.1:{agg_port}"
    planner = f"http://127.0.0.1:{pl_port}"
    graph = FLEET_DIR / "graph.toml"
    worker_args = [*FLEET_MODEL, "--model-name", "m",
                   "--num-blocks", str(FLEET_BLOCKS), "--block-size",
                   str(BS), "--health-port", "0", "--metrics-interval",
                   str(FLEET_METRICS_S)]
    graph.write_text(f"""[graph]
serve_control_plane = false
control_plane = "{cp}"
log_dir = "{FLEET_DIR}"

[services.control_plane]
module = "dynamo_tpu_torch.control_plane_service"
args = ["--port", "{cp_port}", "--store", "file:{FLEET_DIR}/cp.json"]
inject_control_plane = false
restart = "always"

[services.frontend]
module = "dynamo_tpu_torch.frontend"
args = ["--http-port", "{fe_port}", "--router-mode", "kv"]

[services.metrics_aggregator]
module = "dynamo_tpu_torch.metrics_aggregator"
args = ["--http-port", "{agg_port}"]

[services.planner]
module = "dynamo_tpu_torch.planner"
args = {json.dumps(["--control-plane", cp, "--min-replicas", "1",
                    "--max-replicas", "2", "--kv-low", str(FLEET_KV_LOW),
                    "--metrics-port", str(pl_port), "--", *worker_args])}
""")
    # The planner's connector writes its workers' logs to the temp dir.
    env = dict(os.environ, TMPDIR=str(FLEET_DIR))
    log = open(OUT_DIR / "chip_smoke_fleet_launcher.log", "w")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.launcher", str(graph)],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)

    def alive():
        if launcher.poll() is not None:
            raise SmokeError(f"launcher exited rc {launcher.returncode}: "
                             + Path(log.name).read_text()[-2000:])

    def until(pred, secs, what):
        t0 = time.monotonic()
        while True:
            alive()
            try:
                got = pred()
                if got:
                    return got
            except OSError:
                pass
            check(time.monotonic() - t0 < secs, f"fleet: {what} not within "
                                                f"{secs} s")
            time.sleep(0.25)

    def pmetric(name):
        return metric_value(_http(planner + "/metrics", timeout=10), name)

    def wlogs():
        """Spawn number -> log of each worker the planner started."""
        return {int(p.stem.rsplit("_", 1)[1]): p.read_text()
                for p in FLEET_DIR.glob("dynamo_planner_worker_*.log")}

    def wave_ok(fut):
        """A wave still running or done well; its failure ends the wait."""
        if fut.done() and fut.exception() is not None:
            raise SmokeError(f"fleet: a wave failed: {fut.exception()}")
        return True

    def sustain(done):
        """Waves of FLEET_WAVE chats until `done()`; all their results."""
        results = []
        while not done():
            results += chat_wave(fe, [
                long_chat(len(results) + i, i % 2 == 0, FLEET_WAVE_TOKENS,
                          FLEET_CHARS) for i in range(FLEET_WAVE)])
        return results

    def instances():
        async def get(cli):
            return await cli.get_prefix("instances/")
        return cp_run(cp, get)

    def scale_up(pool):
        """Waves on `pool` until the planner's second live worker
        registers: the waves' future (its last wave still running) and
        the seconds from the first wave to the registration."""
        t0 = time.monotonic()
        fut = pool.submit(sustain, lambda: len(instances()) == 2)
        until(lambda: wave_ok(fut) and len(instances()) == 2, 300,
              "the planner's second worker registering")
        return fut, time.monotonic() - t0

    def launched(seq):
        """The launch counts of the worker of spawn number `seq` once it
        has launched K1 and K2, else None."""
        port = re.search(r"worker status server on :(\d+)", wlogs()[seq])
        k = json.loads(_http(f"http://127.0.0.1:{port.group(1)}"
                             "/debug/stats"))["kernels"]
        return k if (k["paged_decode_attention"] > 0
                     and k["paged_prefill_attention"] > 0) else None

    out = {"phase": "fleet"}
    try:
        t0 = time.monotonic()
        until(lambda: json.loads(_http(fe + "/v1/models", timeout=5))["data"],
              300, "the first worker serving")
        out["first_worker_s"] = time.monotonic() - t0
        long_body = fleet_long_body()
        with ThreadPoolExecutor(2) as pool:
            w1, out["scale_up_s"] = scale_up(pool)
            # At once, while the last wave still queues on the first worker.
            long_fut = pool.submit(stream_chat, fe, long_body)
            workers = until(lambda: len(fleet_workers(cp)) == 2
                            and fleet_workers(cp), 60,
                            "both workers' status endpoints")
            on = until(lambda: wave_ok(long_fut) and [
                seq for seq, text in wlogs().items()
                if f"max_tokens={FLEET_LONG_TOKENS}" in text], 60,
                "the long chat placed")
            holder, newest = on[0], max(wlogs())
            # The holder's launches once it decodes the chat (its peer's
            # are read after the stream resumed there).
            launches = {holder: until(
                lambda: wave_ok(long_fut) and launched(holder), 60,
                f"K1 and K2 launched on worker {holder}, the long chat's")}

            def agg_ok():
                text = _http(agg + "/metrics", timeout=10)
                addrs = [u.removeprefix("http://") for u in workers.values()]
                ok = (metric_value(text, "dynamo_aggregate_workers") == 2
                      and all(f'dynamo_worker_request_active_slots'
                              f'{{instance="{a}"}}' in text for a in addrs)
                      and f'instance="127.0.0.1:{fe_port}"' in text
                      and "dynamo_frontend_requests_total{" in text)
                return text if ok else None

            # Read while the wave runs, so that the planner, which sees
            # requests waiting, keeps both workers.
            agg_text = until(lambda: wave_ok(long_fut) and agg_ok(), 60,
                             "the aggregator's fleet view")
            out["aggregator"] = {
                "workers": metric_value(agg_text, "dynamo_aggregate_workers"),
                "scraped": sorted(ln[len("# scraped from "):]
                                  for ln in agg_text.splitlines()
                                  if ln.startswith("# scraped from "))}
            r1 = w1.result()
            t_idle = time.monotonic()  # the fleet idles but for the chat
            check_results(r1, FLEET_WAVE_TOKENS)
            via = "planner" if planner_reaches(holder, newest) else "command"
            if via == "command":
                iid = int(re.search(r"worker instance (\d+) serving",
                                    wlogs()[holder]).group(1))
                cp_run(cp, lambda cli: cli.put(drain_key_instance(iid),
                                               "chip_smoke"))
            t_drain, reason = until(
                lambda: wave_ok(long_fut) and (
                    (m := re.search(r"drain \((\w+)\)", wlogs()[holder]))
                    and (time.monotonic(), m.group(1))), 180,
                "the holder's drain")
            check(reason == {"planner": "sigterm",
                             "command": "control_plane"}[via],
                  f"fleet: the holder was drained by {reason}, not by the "
                  f"{via}")
            t_handed = until(
                lambda: ("drain complete" in wlogs()[holder]
                         and time.monotonic()), 120,
                "the holder's drain completing")
            long_res = long_fut.result()
        handoff = re.search(r"handing off (\S+) \((\d+) tokens emitted, "
                            r"(\d+) KV tokens offered\)", wlogs()[holder])
        check(handoff is not None
              and 0 < int(handoff.group(2)) < FLEET_LONG_TOKENS,
              "fleet: the long chat was not handed off mid-decode")
        emitted = int(handoff.group(2))
        out["drain"] = {"via": via, "holder": holder, "newest": newest,
                        "emitted_before": emitted,
                        "kv_tokens_offered": int(handoff.group(3)),
                        "after_idle_s": t_drain - t_idle,
                        "drain_s": t_handed - t_drain,
                        "stream_s": long_res["wall_s"]}
        check(long_res["done"] and long_res["finish"] == "length"
              and long_res["tokens"] == FLEET_LONG_TOKENS
              == len(long_res["ids"]),
              f"fleet: the drained stream returned {long_res['tokens']} "
              f"tokens ({long_res['finish']})")
        check("drain complete: 1 stream(s) migrated out" in wlogs()[holder],
              "fleet: the holder did not hand its stream off")
        n_drain = metric_value(_http(fe + "/metrics"),
                               'dynamo_migrations_total{reason="drain"}')
        check(n_drain is not None and n_drain >= 1,
              f"fleet: dynamo_migrations_total{{reason=\"drain\"}} {n_drain}")
        peer = [seq for seq in wlogs() if seq != holder
                and f"request {handoff.group(1)}#m1:" in wlogs()[seq]]
        check(len(peer) == 1, f"fleet: the stream resumed on {peer}")
        launches[peer[0]] = launched(peer[0])
        check(launches[peer[0]] is not None,
              f"fleet: worker {peer[0]}, the peer, launched no K1 or K2")
        out["launches"] = {str(seq): k for seq, k in launches.items()}
        pst = []
        for u in fleet_workers(cp).values():
            with contextlib.suppress(OSError):   # the holder may be gone
                pst.append(json.loads(_http(u + "/debug/stats", timeout=10)))
        moved = [x for x in pst if x["migrated_in"]["streams"] >= 1]
        check(len(moved) == 1, "fleet: no worker took the stream in with "
                               f"its KV: {[x['migrated_in'] for x in pst]}")
        st = moved[0]
        ps = st["prefix_share"]
        check(st["migrated_in"] == {"streams": 1,
                                    "blocks": ps["pulled_blocks"]}
              and ps["pulled_blocks"] >= 1 and ps["fallbacks"] == 0
              and ps["device_pulled_blocks"] == ps["pulled_blocks"]
              and st["transfer_plane"]["transport"] == "cuda_ipc"
              and "host" not in st["plane_counts"],
              f"fleet: the peer did not pull the sealed blocks over "
              f"cuda_ipc: {ps}, {st['plane_counts']}")
        check(no_reprefill(ps),
              f"fleet: the peer prefilled pulled blocks again: {ps}")
        out["kv_moved"] = {"migrated_in": st["migrated_in"],
                           "prefix_share": ps,
                           "plane_counts": st["plane_counts"]}
        # The drained stream against `serve`'s undrained answer, and each
        # of its ids against the plain model given the ids before it.
        state = llama_state(torch)
        prompt = chat_tokens(long_body)
        out["split"] = greedy_split(torch, state, prompt, long_res["ids"],
                                    ref_ids, "fleet: the drained stream")
        gaps = forced_gaps(torch, get_config("llama-3-1b"), state, prompt,
                           long_res["ids"], 0)
        del state
        torch.cuda.empty_cache()
        worst = max(range(len(gaps)), key=gaps.__getitem__)
        check(gaps[worst] <= MODEL_TOL["llama-3-1b"],
              f"fleet: the drained stream's id {worst} (the handoff after "
              f"{emitted}) is not the plain model's greedy choice: argmax "
              f"gap {gaps[worst]} > {MODEL_TOL['llama-3-1b']}")
        out["forced"] = {
            "off_argmax": sum(g > 0 for g in gaps),
            "max_gap_before_handoff": max(gaps[:emitted]),
            "max_gap_after_handoff": max(gaps[emitted:])}
        out["no_loss"] = {"scale_up_waves": len(r1), "long": 1}
        if via == "command":
            # The command left one replica, which the planner may not
            # remove: waves make it add a worker again to scale down.
            with ThreadPoolExecutor(1) as pool:
                w3, out["rescale_up_s"] = scale_up(pool)
                r3 = w3.result()
            check_results(r3, FLEET_WAVE_TOKENS)
            out["no_loss"]["rescale_waves"] = len(r3)
            t_idle = time.monotonic()
        t_down = until(lambda: pmetric('dynamo_planner_drains_total'
                                       '{outcome="clean"}') == 1
                       and pmetric("dynamo_planner_replicas") == 1
                       and time.monotonic(), 180,
                       "the planner's scale-down")
        # From the fleet idling to the newest worker's drain done.
        out["scale_down_s"] = (t_handed if via == "planner"
                               else t_down) - t_idle
        out["planner"] = {key: pmetric(name) for key, name in (
            ("decisions_up", 'dynamo_planner_decisions_total'
                             '{direction="up"}'),
            ("decisions_down", 'dynamo_planner_decisions_total'
                               '{direction="down"}'),
            ("clean_drains", 'dynamo_planner_drains_total{outcome="clean"}'),
            ("force_kills", 'dynamo_planner_drains_total'
                            '{outcome="force_kill"}'),
            ("replicas", "dynamo_planner_replicas"))}
        check(out["planner"]["force_kills"] == 0
              and out["planner"]["clean_drains"] == 1
              and out["planner"]["replicas"] == 1,
              f"fleet: the scale-down was not one clean drain to one "
              f"replica: {out['planner']}")
    finally:
        t_stop = time.monotonic()
        launcher.send_signal(signal.SIGTERM)
        try:
            rc = launcher.wait(timeout=120)
        except subprocess.TimeoutExpired:
            launcher.kill()
            launcher.wait()
            rc = None
        log.close()
    stop_s = time.monotonic() - t_stop
    text = Path(log.name).read_text()
    order = re.findall(r"launcher: stopping (\w+)\[", text)
    check(rc == 0 and stop_s < 120,
          f"fleet: the launcher's teardown rc {rc} in {stop_s:.1f} s")
    check(order == ["planner", "metrics_aggregator", "frontend",
                    "control_plane"],
          f"fleet: teardown order {order}")
    out["teardown"] = {"rc": rc, "s": stop_s, "order": order}
    out["wall_s"] = time.monotonic() - t_phase
    return out


# -- the KV tiers: G2 pinned host, G3 disk, the G4 remote hook ------------------

TIER_G1 = 65                   # the tiers engines' pages: 64 usable (G1)
TIER_PROMPTS = 8               # the wave: distinct prompts of ...
TIER_PROMPT_LEN = 1024         # ... 16 sealed blocks: 128 blocks, G1 twice
TIER_REASK = 4                 # the first prompts, asked again
TIER_TOKENS = 16               # greedy tokens an answer
TIER_LEGS = (("g2", {"host_blocks": 192}),            # 384 MiB pinned (bf16)
             ("g3", {"host_blocks": 32, "disk_blocks": 192}))
TIER_YARDSTICK_BLOCKS = 16     # the plain pinned copy_ the rates stand by
QOS_TIER_G1, QOS_TIER_G2 = 65, 64   # the qos tier leg's pages


def random_prompts(torch, seed: int, *lengths) -> list:
    """Prompts of random llama-3-1b token ids, from a seed."""
    from dynamo_tpu_torch.models.config import get_config

    gen = torch.Generator().manual_seed(seed)
    vocab = get_config("llama-3-1b").vocab_size
    return [torch.randint(1, vocab, (n,), generator=gen).tolist()
            for n in lengths]


def tier_engine(state, kv_quant: str, **tiers):
    """llama-3-1b on the card in process, TIER_G1 pages of BS, with the
    lower tiers `tiers` (EngineConfig's host_blocks / disk_blocks /
    remote_fetch_fn: no CLI flag sizes them, as in JAX)."""
    from dynamo_tpu_torch.engine.engine import (
        EngineConfig, EngineCore, InferenceEngine)
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.models.config import get_config

    return InferenceEngine(EngineCore(EngineConfig(
        model=get_config("llama-3-1b"), num_blocks=TIER_G1,
        kv_quant=kv_quant, scheduler=SchedulerConfig(block_size=BS),
        **tiers), params=state))


async def tier_ask(engine, rid: str, prompt: list) -> tuple:
    """One greedy request through `InferenceEngine.generate`: (its ids,
    its TTFT on the host clock)."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams

    t0, ttft, ids = time.monotonic(), None, []
    async for d in engine.generate(rid, prompt,
                                   SamplingParams(max_tokens=TIER_TOKENS)):
        if d.token_ids and ttft is None:
            ttft = time.monotonic() - t0
        ids += d.token_ids
    check(len(ids) == TIER_TOKENS, f"tiers: {rid} gave {len(ids)} tokens")
    return ids, ttft


def tier_where(mgr, hashes: list) -> dict:
    """How many of `hashes` each tier holds (host lookups)."""
    pools = {"g1": mgr.device, "g2": mgr.host, "g3": mgr.disk}
    return {k: sum(p is not None and p.registry.lookup(h) is not None
                   for h in hashes) for k, p in pools.items()}


def copy_rates(torch, mgr) -> dict:
    """GB/s of the manager's logged offload and onboard copies (bytes
    over CUDA-event time on their own streams)."""
    torch.cuda.synchronize()
    out = {}
    for kind in ("offload", "onboard"):
        rows = [(s.elapsed_time(e), n) for k, s, e, n in mgr.copy_log
                if k == kind]
        ms, nbytes = sum(r[0] for r in rows), sum(r[1] for r in rows)
        out[kind] = {"copies": len(rows), "bytes": nbytes, "ms": ms,
                     "gb_s": nbytes / ms / 1e6 if ms else None}
    mgr.copy_log.clear()
    return out


def pinned_yardstick(torch, block_bytes: int) -> dict:
    """A plain pinned `copy_` of TIER_YARDSTICK_BLOCKS blocks in one
    piece, each way, on a side stream: GB/s by CUDA events (median of
    10)."""
    n = TIER_YARDSTICK_BLOCKS * block_bytes
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.Stream()
    out = {}
    for kind, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        times = []
        with torch.cuda.stream(stream):
            for _ in range(11):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record(stream)
                dst.copy_(src, non_blocking=True)
                b.record(stream)
                b.synchronize()
                times.append(a.elapsed_time(b))
        ms = statistics.median(times[1:])
        out[kind] = {"bytes": n, "ms": ms, "gb_s": n / ms / 1e6}
    return out


async def tier_leg(torch, state, prompts: list, kv_quant: str, leg: str,
                   tiers: dict) -> tuple:
    """One engine with `tiers`: the wave one prompt at a time (cold TTFT;
    the first prompt's blocks exported while in G1), then each of the
    first TIER_REASK prompts twice: from the lower tier it sits in, then
    from G1.  Returns (the leg's line, the engine, stopped)."""
    from dynamo_tpu_torch.tokens import compute_block_hashes

    engine = tier_engine(state, kv_quant, **tiers)
    core = engine.core
    mgr = core.allocator.manager
    mgr.copy_log = []
    hashes = [compute_block_hashes(p, BS) for p in prompts]
    await engine.start()
    try:
        ttft = {"cold": [], "g1": [], "lower": {}}
        before = None
        for i, p in enumerate(prompts):
            ttft["cold"].append((await tier_ask(engine, f"{leg}-w{i}", p))[1])
            if i == 0:
                before = await engine.export_blocks(hashes[0])
        where = [await engine.run_in_engine(lambda h=h: tier_where(mgr, h))
                 for h in hashes[:TIER_REASK]]
        for i, w in enumerate(where):
            check(w["g1"] == 0 and w["g2"] + w["g3"] == len(hashes[i]),
                  f"tiers {leg} {kv_quant}: prompt {i} is not wholly below "
                  f"G1 after the wave: {w}")
        if leg == "g3":
            check(where[0]["g3"] == len(hashes[0]),
                  f"tiers g3 {kv_quant}: the first prompt did not spill to "
                  f"disk: {where[0]}")
        lower = await engine.export_blocks(hashes[0])
        rates_wave = copy_rates(torch, mgr)
        answers = []
        for i in range(TIER_REASK):
            tier = "g3" if where[i]["g3"] == len(hashes[i]) else "g2"
            ids_l, t_l = await tier_ask(engine, f"{leg}-l{i}", prompts[i])
            ids_g, t_g = await tier_ask(engine, f"{leg}-g{i}", prompts[i])
            check(ids_l == ids_g,
                  f"tiers {leg} {kv_quant}: prompt {i} onboarded from {tier} "
                  f"answered {ids_l}, from G1 {ids_g}")
            ttft["lower"].setdefault(tier, []).append(t_l)
            ttft["g1"].append(t_g)
            answers.append(ids_g)
            if i == 0:
                on_g1 = await engine.run_in_engine(
                    lambda: tier_where(mgr, hashes[0])["g1"])
                check(on_g1 == len(hashes[0]),
                      f"tiers {leg} {kv_quant}: the first prompt is not "
                      f"back in G1 after its onboard: {on_g1} blocks")
                back = await engine.export_blocks(hashes[0])
        # Back in G1, the last block's last row is the prompt's last
        # token, which a full hit prefills again (its KV rounded as a
        # one-token prefill rounds it): that row is left out.
        last = hashes[0][-1]
        for h in hashes[0]:
            rows = BS - 1 if h == last else BS
            for what, got, n in (("below G1", lower, BS),
                                 ("back in G1", back, rows)):
                check(torch.equal(got[h][:, :, :n].view(torch.uint8),
                                  before[h][:, :, :n].view(torch.uint8)),
                      f"tiers {leg} {kv_quant}: block {h:x} {what} differs "
                      f"from its bytes before the offload")
        rates_reask = copy_rates(torch, mgr)
        st = mgr.stats
        hit = core.scheduler.prefix_hit_tokens
        want_hit = 2 * TIER_REASK * (TIER_PROMPT_LEN - BS)
        want_off = TIER_PROMPTS * TIER_PROMPT_LEN // BS - (TIER_G1 - 1)
        want_on = TIER_REASK * TIER_PROMPT_LEN // BS
        check(hit >= want_hit and st["offloaded"] >= want_off
              and st["onboarded"] >= want_on,
              f"tiers {leg} {kv_quant}: prefix hits {hit} (want >= "
              f"{want_hit}), offloaded {st['offloaded']} (>= {want_off}), "
              f"onboarded {st['onboarded']} (>= {want_on})")
    finally:
        await engine.stop()
    return {"leg": leg, "kv_quant": kv_quant, **tiers,
            "host_alloc_s": mgr.host_alloc_s,
            "pinned_mib": (0 if mgr.host is None else
                           mgr._host_data.numel()
                           * mgr._host_data.element_size() / 2 ** 20),
            "ttft_s": ttft, "where_before_reask": where,
            "prefix_hit_tokens": hit, "stats": st,
            "offload_host_ms_per_block": (
                1e3 * mgr.offload_host_s / mgr.offload_host_blocks
                if mgr.offload_host_blocks else None),
            "backpressure_waits": mgr.backpressure_waits,
            "rates_wave": rates_wave, "rates_reask": rates_reask,
            "block_bytes": core.cache_cfg.bytes_per_block}, engine, answers


async def tier_g4_leg(torch, state, prompts: list, kv_quant: str, peer,
                      want: list) -> dict:
    """A G1-only engine whose `remote_fetch_fn` pulls from `peer` (the g2
    leg's engine, stopped; its blocks in its G1 and G2) through its
    manager's `export_block`: each of the first TIER_REASK prompts onboards
    from G4, then hits G1, and both answers equal the peer's."""
    from dynamo_tpu_torch.tokens import compute_block_hashes

    fetched = []
    pm = peer.core.allocator.manager

    def fetch(h):
        fetched.append(h)
        return pm.export_block(h)

    engine = tier_engine(state, kv_quant, remote_fetch_fn=fetch)
    mgr = engine.core.allocator.manager
    await engine.start()
    try:
        ttft = {"g4": [], "g1": []}
        for i in range(TIER_REASK):
            ids_r, t_r = await tier_ask(engine, f"g4-r{i}", prompts[i])
            ids_g, t_g = await tier_ask(engine, f"g4-g{i}", prompts[i])
            check(ids_r == ids_g == want[i],
                  f"tiers g4 {kv_quant}: prompt {i} from G4 {ids_r}, from G1 "
                  f"{ids_g}, the peer's {want[i]}")
            ttft["g4"].append(t_r)
            ttft["g1"].append(t_g)
        n = TIER_REASK * TIER_PROMPT_LEN // BS
        got = mgr.remote_fetched_blocks
        check(got >= n and mgr.onboarded_blocks >= n,
              f"tiers g4 {kv_quant}: remote_fetched {got}, onboarded "
              f"{mgr.onboarded_blocks} (want >= {n})")
        check(fetched[:len(compute_block_hashes(prompts[0], BS))]
              == compute_block_hashes(prompts[0], BS),
              f"tiers g4 {kv_quant}: the first fetches are not the first "
              f"prompt's blocks in order")
    finally:
        await engine.stop()
    return {"leg": "g4", "kv_quant": kv_quant, "ttft_s": ttft,
            "remote_fetched": got, "stats": mgr.stats}


def tiers_phase(torch, kernels, state) -> dict:
    """The KV tiers on the card, bf16 then int8 (`tier_leg`, `tier_g4_leg`):
    the bytes of a block that went down and came back equal the bytes it
    had; an onboarded prompt answers as a G1 hit does; the counts reach
    what the sizing implies; K1 and K2 launch, only their int8 bodies in
    the int8 legs.  Offload and onboard GB/s beside a plain pinned copy_,
    the engine thread's host ms an evicted block, the pinned allocation's
    seconds and TTFT medians by tier."""
    import asyncio

    t_phase = time.monotonic()
    prompts = random_prompts(torch, SEED + 12,
                             *[TIER_PROMPT_LEN] * TIER_PROMPTS)
    out = {"phase": "tiers", "model": "llama-3-1b", "g1_blocks": TIER_G1 - 1,
           "prompts": TIER_PROMPTS, "prompt_tokens": TIER_PROMPT_LEN,
           "reasked": TIER_REASK, "legs": [], "launches": {}}
    for kv_quant in ("none", "int8"):
        kernels.reset_launch_counts()
        peer, answers = None, None
        for leg, tiers in TIER_LEGS:
            line, engine, ids = asyncio.run(tier_leg(
                torch, state, prompts, kv_quant, leg, tiers))
            out["legs"].append(line)
            if leg == "g2":
                peer, answers = engine, ids
        out["legs"].append(asyncio.run(tier_g4_leg(
            torch, state, prompts, kv_quant, peer, answers)))
        peer.core.allocator.manager.close()
        del peer
        launches = kernels.launch_counts()
        body = "_int8" if kv_quant == "int8" else ""
        other = "" if kv_quant == "int8" else "_int8"
        for k in ("paged_decode_attention", "paged_prefill_attention"):
            check(launches[k + body] > 0 and launches[k + other] == 0,
                  f"tiers {kv_quant}: K1/K2 launches {launches}")
        out["launches"][kv_quant] = launches
        torch.cuda.empty_cache()
    out["yardstick"] = pinned_yardstick(torch, out["legs"][0]["block_bytes"])
    by_tier = {"cold": [], "g1": [], "g2": [], "g3": [], "g4": []}
    for line in out["legs"]:
        t = line["ttft_s"]
        if line["leg"] == "g4":
            by_tier["g4"] += t["g4"]
            by_tier["g1"] += t["g1"]
            continue
        by_tier["cold"] += t["cold"]
        by_tier["g1"] += t["g1"]
        for tier, xs in t["lower"].items():
            by_tier[tier] += xs
    out["ttft_median_s"] = {k: statistics.median(v) if v else None
                            for k, v in by_tier.items()}
    out["wall_s"] = time.monotonic() - t_phase
    return out


def qos_tier_leg(torch, state) -> dict:
    """QoS demotion that moves blocks, in process on the card: llama-3-1b
    with QOS_TIER_G1 pages and a G2 of QOS_TIER_G2.  A best-effort request
    decodes; a burn (`qos_pressure_fn`) and a standard request arrive, so
    the scheduler sheds the best-effort one: its sealed blocks demote into
    G2 and leave G1.  When the burn clears it resumes by onboarding them,
    and its answer equals the same request's with no pressure (a split
    only at a near tie)."""
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.models.config import get_config

    be_prompt, std_prompt = random_prompts(torch, SEED + 13, 640, 200)
    n_be, n_std = 192, 16

    def core():
        return EngineCore(EngineConfig(
            model=get_config("llama-3-1b"), num_blocks=QOS_TIER_G1,
            host_blocks=QOS_TIER_G2, scheduler=SchedulerConfig(block_size=BS)),
            params=state)

    def pump(c, got, stop, steps=4000):
        for _ in range(steps):
            for d in c.step():
                got.setdefault(d.request_id, []).extend(d.token_ids)
            if stop():
                return
        raise SmokeError(f"qos tier leg: no progress ({ {k: len(v) for k, v in got.items()} })")

    ref = core()
    ref.add_request("be", list(be_prompt), SamplingParams(max_tokens=n_be),
                    priority=0)
    want = {}
    pump(ref, want, lambda: not ref._requests)
    ref.allocator.manager.close()
    del ref
    c = core()
    mgr = c.allocator.manager
    pressure = [0.0]
    c.scheduler.qos_pressure_fn = lambda: pressure[0]
    c.add_request("be", list(be_prompt), SamplingParams(max_tokens=n_be),
                  priority=0)
    got = {"be": [], "std": []}
    pump(c, got, lambda: len(got["be"]) >= 8)
    pressure[0] = 2.0
    c.add_request("std", list(std_prompt), SamplingParams(max_tokens=n_std),
                  priority=1)
    pump(c, got, lambda: len(got["std"]) >= n_std)
    from dynamo_tpu_torch.tokens import compute_block_hashes

    sealed = compute_block_hashes(be_prompt, BS)
    where = tier_where(mgr, sealed)
    demoted, preempts = c.qos_demoted_blocks, c.scheduler.qos_preemptions
    check(preempts >= 1 and demoted > 0,
          f"qos tier leg: {preempts} QoS preemptions, {demoted} demoted")
    check(where["g2"] >= min(demoted, len(sealed)),
          f"qos tier leg: the demoted blocks are not in G2: {where}")
    onboarded = mgr.onboarded_blocks
    pressure[0] = 0.0
    pump(c, got, lambda: not c._requests)
    resumed = mgr.onboarded_blocks - onboarded
    check(resumed > 0, "qos tier leg: the resumption onboarded nothing")
    split = greedy_split(torch, state, be_prompt, got["be"], want["be"],
                         "qos tier leg: the preempted answer")
    stats = mgr.stats
    mgr.close()
    return {"host_blocks": QOS_TIER_G2, "g1_blocks": QOS_TIER_G1 - 1,
            "qos_preemptions": preempts, "qos_demoted_blocks": demoted,
            "where_after_demotion": where, "onboarded_on_resume": resumed,
            "answer_split": split, "stats": stats}


# -- the standalone router service and the frontend's other ingress -----------

BATCH_TURN = "Batch {i}: what does a paged KV cache hold?"
BATCH_PROMPTS, BATCH_TOKENS = 8, 32


def batch_jobs() -> list:
    return [{"prompt": BATCH_TURN.format(i=i), "max_tokens": BATCH_TOKENS}
            for i in range(BATCH_PROMPTS)]


def batch_reference(base: str) -> list:
    """`batch_jobs()` as one concurrent wave of /v1/completions at `base`:
    (text, completion tokens) of each."""
    def one(job):
        r = json.loads(_http(base + "/v1/completions", {
            "model": "m", "prompt": job["prompt"], "temperature": 0,
            "max_tokens": job["max_tokens"]}))
        return [r["choices"][0]["text"], r["usage"]["completion_tokens"]]

    with ThreadPoolExecutor(BATCH_PROMPTS) as pool:
        return list(pool.map(one, batch_jobs()))


def router_service_phase(serve: dict) -> dict:
    """The standalone KV router on the card: two llama-3-1b workers, a
    `python -m dynamo_tpu_torch.router_service` registering `m-routed`,
    and frontend B (round_robin), which reaches the workers through the
    service by asking for `m-routed` (`distributed_stack`).  `serve`'s
    lone chats through it give `serve`'s ids and logprobs bit for bit;
    two chats on one system prompt, one at a time, land on the same
    worker (its prefix-hit tokens grow by the prompt's blocks, the
    other's do not); the service's /metrics counts the streams.  Then a
    wave of 8 chats through an in-process round-robin consumer of
    `m-routed` (the frontend's client, wrapped in a `StreamRecorder`: TTFT
    and ITL from raw arrivals) and a wave of 8 other chats of the same
    shape through frontend B, whose request ledger and timings stand
    beside them."""
    import asyncio

    from dynamo_tpu_torch.llm.discovery import ModelWatcher
    from dynamo_tpu_torch.llm.perf import StreamRecorder
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.service import ModelManager
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneClient
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    t_phase = time.monotonic()
    cp, mport = _free_port(), _free_port()
    lone = [{**traced(chat_body(i, False, 64, user=LONE_TURN)),
             "model": "m-routed"} for i in range(2)]
    want = serve["lone_answers"][:len(lone)]
    system = system_prompt(SYSTEM_LINES["P"])
    bodies = [{**chat_body(i, False, 64), "model": "m-routed"}
              for i in range(8)]

    def sticky(i):
        return {**chat_body(i, False, 8, system, STICKY_TURN),
                "model": "m-routed"}

    def hits(workers):
        return [json.loads(_http(w + "/debug/stats"))["prefix_cache"]
                ["hit_tokens"] for w in workers]

    async def recorded():
        pre = OpenAIPreprocessor(ByteTokenizer())
        client = ControlPlaneClient("127.0.0.1", cp)
        await client.start()
        rt = DistributedRuntime(client)
        models = ModelManager()
        watcher = ModelWatcher(rt, models)          # round-robin
        await watcher.start()
        try:
            await watcher.wait_for_model("m-routed", timeout=60)
            rec = StreamRecorder(models.get("m-routed").client)

            async def one(i, body):
                req = pre.preprocess_chat(
                    ChatCompletionRequest.from_dict(body), f"rec-{i}")
                return [t async for d in rec.generate(req)
                        for t in d.token_ids]

            outs = await asyncio.gather(*(one(i, x)
                                          for i, x in enumerate(bodies)))
            return outs, rec.summary()
        finally:
            await watcher.stop()
            await rt.shutdown()
            await client.close()

    with distributed_stack(
            tag="router_service", cp_port=cp, models=["m", "m-routed"],
            extra=[("dynamo_tpu_torch.router_service", "router",
                    ("--control-plane", f"127.0.0.1:{cp}", "--model-name",
                     "m", "--metrics-port", str(mport)))]) as (
            a, b, workers, startup_s):
        got = [answer(_chat(b, x)) for x in lone]
        check(got == want,
              f"router_service: lone chats through the service gave {got!r}, "
              f"the single-process server {want!r}")
        _chat(b, sticky(-1))
        time.sleep(METRICS_SETTLE_S)
        h1 = hits(workers)
        _chat(b, sticky(0))
        grew = [y - x for x, y in zip(h1, hits(workers))]
        check(sorted(g > 0 for g in grew) == [False, True]
              and max(grew) >= BS * SYSTEM_BLOCKS,
              f"router_service: the second chat on one system prompt grew "
              f"prefix hits by {grew}")
        n_routed = metric_value(_http(f"http://127.0.0.1:{mport}/metrics"),
                                "dynamo_router_requests_total")
        check(n_routed == len(lone) + 2,
              f"router_service: the service counted {n_routed} streams")
        outs, summary = asyncio.run(recorded())
        check(all(len(o) == 64 for o in outs),
              f"router_service: the recorded wave gave "
              f"{[len(o) for o in outs]} tokens")
        _http(b + "/debug/stats/reset", {})
        wave = chat_wave(b, [{**chat_body(i + 10, False, 64),
                              "model": "m-routed"} for i in range(8)])
        check_results(wave, 64)
        reqs = json.loads(_http(b + "/debug/stats"))["requests"]
        rids = {r["rid"] for r in wave}
        ledger = [e for e in json.loads(_http(b + "/debug/requests?n=64"))
                  ["slowest"] if e["request_id"] in rids]
    itl_n = sum(r["itl_n"] for r in reqs)
    return {"phase": "router_service", "startup_s": startup_s,
            "lone_answers_equal": True, "sticky_hit_growth": grew,
            "routed_streams": n_routed, "recorder": summary,
            "frontend_b": {
                "ttft_p50": statistics.median(r["ttft_s"] for r in reqs),
                "itl_mean_s": (sum(r["itl_sum_s"] for r in reqs) / itl_n
                               if itl_n else None)},
            "ledger": {"requests": len(ledger),
                       "ttft_p50": (statistics.median(e["ttft_s"]
                                                      for e in ledger)
                                    if ledger else None),
                       "tpot_p50": (statistics.median(e["tpot_s"]
                                                      for e in ledger)
                                    if ledger else None)},
            "wall_s": time.monotonic() - t_phase}


def ingress_phase(serve: dict) -> dict:
    """The frontend's other ingress and backends on the card:
    `--input batch` over `batch_jobs()` against llama-3-1b writes
    `serve`'s answers to the same completions (text and token counts; the
    random model's ids above 255 spell nothing, so the text holds little);
    `--out echo` returns the prompt; `--out mocker` answers while its
    process launches no kernel (`/debug/stats` launch counts)."""
    t_phase = time.monotonic()
    OUT_DIR.mkdir(exist_ok=True)
    src = OUT_DIR / "ingress_batch.jsonl"
    dst = OUT_DIR / "ingress_batch.out.jsonl"
    src.write_text("".join(json.dumps(j) + "\n" for j in batch_jobs()))
    log = OUT_DIR / "chip_smoke_ingress_batch.log"
    t0 = time.monotonic()
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--model",
             "llama-3-1b", "--model-name", "m", "--input", "batch",
             "--batch-file", str(src), "--batch-output", str(dst)],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
            timeout=600).returncode
    batch_s = time.monotonic() - t0
    check(rc == 0, f"ingress: --input batch exited rc {rc}: "
                   + log.read_text()[-2000:])
    rows = [json.loads(x) for x in dst.read_text().splitlines()]
    summary = [json.loads(x) for x in log.read_text().splitlines()
               if x.startswith('{"requests"')][-1]
    got = [[r.get("completion"), r["completion_tokens"]] for r in rows]
    want = serve["batch_reference"]
    check(got == want, f"ingress: --input batch answered {got}, serve {want}")
    out = {"phase": "ingress", "batch": {"rows": len(rows), "seconds": batch_s,
                                         "summary": summary,
                                         "texts_with_bytes": sum(
                                             bool(g[0]) for g in got)}}
    prompt = "Echo: what does a paged KV cache hold?"
    with server("llama-3-1b", ("--out", "echo"), tag="_echo") as (base, _):
        r = json.loads(_http(base + "/v1/completions", {
            "model": "m", "prompt": prompt, "max_tokens": 256}))
        text = r["choices"][0]["text"]
        check(text == prompt, f"ingress: --out echo returned {text!r}")
    with server("llama-3-1b", ("--out", "mocker", "--speedup-ratio", "100"),
                tag="_mocker") as (base, _):
        r = _chat(base, chat_body(0, False, 16))
        check(r["tokens"] == 16, f"ingress: the mocker answered {r}")
        launches = json.loads(_http(base + "/debug/stats"))["kernels"]
        check(not any(launches.values()),
              f"ingress: the mocker's process launched kernels: {launches}")
    out["echo"] = {"returned_prompt": True}
    out["mocker"] = {"tokens": r["tokens"], "launches": launches}
    out["wall_s"] = time.monotonic() - t_phase
    return out


# ---------------------------------------------------------------------------
# GGUF writing (numpy only; tests/test_torch_gguf.py writes with it too)

GGUF_TYPE = {"F32": 0, "F16": 1, "Q8_0": 8, "Q4_K": 12, "Q5_K": 13,
             "Q6_K": 14}
# ggml block geometry: type -> (bytes, elements) a block.
GGUF_BLOCK = {8: (34, 32), 12: (144, 256), 13: (176, 256), 14: (210, 256)}
# Per-type f16 scale fields (byte offset in the block, value) of random
# blocks, chosen so the dequantized values have a std near 0.02 (about
# llama-3-1b's fan_in ** -0.5): Q8_0 d·q; Q4_K / Q5_K d·sc·q - dmin·mn
# with a mean near 0; Q6_K d·sc·(q - 32).
GGUF_SCALES = {8: ((0, 2.7e-4),), 12: ((0, 9e-5), (2, 6.7e-4)),
               13: ((0, 4.5e-5), (2, 7e-4)), 14: ((208, 1.5e-5),)}
_GGUF_U32, _GGUF_I32, _GGUF_F32, _GGUF_STR, _GGUF_ARR = 4, 5, 6, 8, 9


def _gguf_str(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(8, "little") + b


def _gguf_value(vtype: int, value) -> bytes:
    import struct

    if vtype == _GGUF_U32:
        return struct.pack("<I", value)
    if vtype == _GGUF_I32:
        return struct.pack("<i", value)
    if vtype == _GGUF_F32:
        return struct.pack("<f", value)
    if vtype == _GGUF_STR:
        return _gguf_str(value)
    etype, items = value
    return (struct.pack("<IQ", etype, len(items))
            + b"".join(_gguf_value(etype, v) for v in items))


def gguf_random_blocks(np, rng, ggml_type: int, n: int) -> bytes:
    """`n` elements of random quantized blocks whose f16 scales are
    bounded (GGUF_SCALES, each scaled by a factor in [0.5, 1.5))."""
    bb, be = GGUF_BLOCK[ggml_type]
    rec = rng.integers(0, 256, size=(n // be, bb), dtype=np.uint8)
    for off, base in GGUF_SCALES[ggml_type]:
        d = (base * rng.uniform(0.5, 1.5, size=(len(rec), 1))
             ).astype("<f2")
        rec[:, off:off + 2] = d.view(np.uint8)
    return rec.tobytes()


def gguf_blob(np, rng, ggml_type: int, arr=None, n: int = 0) -> bytes:
    """A tensor's data: F32 / F16 from `arr`, Q8_0 quantized from `arr`
    (ggml's round-to-nearest with an f16 absmax scale), or `n` elements of
    random K-quant / Q8_0 blocks when `arr` is None."""
    if ggml_type == 0:
        return np.asarray(arr, "<f4").tobytes()
    if ggml_type == 1:
        return np.asarray(arr, "<f2").tobytes()
    if arr is None:
        return gguf_random_blocks(np, rng, ggml_type, n)
    if ggml_type != 8:
        raise ValueError(f"no quantizer for ggml type {ggml_type}")
    flat = np.asarray(arr, np.float32).reshape(-1, 32)
    d = (np.abs(flat).max(axis=1) / 127.0).astype("<f2")
    q = np.round(flat / np.maximum(d.astype(np.float32)[:, None], 1e-12))
    rec = np.empty((len(flat), 34), np.uint8)
    rec[:, 0:2] = d[:, None].view(np.uint8)
    rec[:, 2:] = q.astype(np.int8).view(np.uint8)
    return rec.tobytes()


def write_gguf(path, metadata, tensors, alignment: int = 32) -> int:
    """A GGUF v3 file.  `metadata`: (key, value type, value) triples
    (u32 4, i32 5, f32 6, str 8, array 9 as (element type, items));
    `tensors`: (name, dims in ggml order — fastest first —, ggml type,
    data bytes).  Returns the bytes written."""
    import struct

    with open(path, "wb") as f:
        f.write(b"GGUF" + struct.pack("<IQQ", 3, len(tensors),
                                      len(metadata)))
        for key, vtype, value in metadata:
            f.write(_gguf_str(key) + struct.pack("<I", vtype)
                    + _gguf_value(vtype, value))
        offset = 0
        for name, dims, gtype, blob in tensors:
            f.write(_gguf_str(name) + struct.pack("<I", len(dims))
                    + struct.pack(f"<{len(dims)}Q", *dims)
                    + struct.pack("<IQ", gtype, offset))
            offset += len(blob) + (-len(blob)) % alignment
        f.write(b"\0" * ((-f.tell()) % alignment))
        for _, _, _, blob in tensors:
            f.write(blob)
            f.write(b"\0" * ((-len(blob)) % alignment))
        return f.tell()


def gguf_llama_metadata(cfg, tokens=None) -> list:
    """llama-arch metadata of a ModelConfig (config_from_gguf's keys)."""
    md = [("general.architecture", _GGUF_STR, "llama"),
          ("general.name", _GGUF_STR, cfg.name),
          ("llama.embedding_length", _GGUF_U32, cfg.hidden_size),
          ("llama.block_count", _GGUF_U32, cfg.num_layers),
          ("llama.attention.head_count", _GGUF_U32, cfg.num_heads),
          ("llama.attention.head_count_kv", _GGUF_U32, cfg.num_kv_heads),
          ("llama.attention.key_length", _GGUF_U32, cfg.head_dim),
          ("llama.feed_forward_length", _GGUF_U32, cfg.intermediate_size),
          ("llama.context_length", _GGUF_U32, cfg.max_context),
          ("llama.rope.freq_base", _GGUF_F32, cfg.rope_theta),
          ("llama.attention.layer_norm_rms_epsilon", _GGUF_F32,
           cfg.rms_norm_eps),
          ("llama.vocab_size", _GGUF_U32, cfg.vocab_size)]
    if tokens:
        md += [("tokenizer.ggml.model", _GGUF_STR, "llama"),
               ("tokenizer.ggml.tokens", _GGUF_ARR, (_GGUF_STR, tokens)),
               ("tokenizer.ggml.bos_token_id", _GGUF_U32, 1),
               ("tokenizer.ggml.eos_token_id", _GGUF_U32, 2)]
    return md


# ---------------------------------------------------------------------------
# Checkpoints, the tokenizer, tools and Responses, multimodal

CKPT_DIR = OUT_DIR / "checkpoint"          # gitignored with smoke_out/
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")
LLAMA3_SPECIALS = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                   128002: "<|reserved_special_token_0|>",
                   128003: "<|reserved_special_token_1|>",
                   128004: "<|finetune_right_pad_id|>",
                   128005: "<|reserved_special_token_2|>",
                   128006: "<|start_header_id|>", 128007: "<|end_header_id|>",
                   128008: "<|eom_id|>", 128009: "<|eot_id|>",
                   128010: "<|python_tag|>"}
BPE_MERGES = 2000              # merges learnt from this script's text
CKPT_TEMPLATE = (
    "<|begin_of_text|>"
    "{% if tools %}<|start_header_id|>system<|end_header_id|>\n\n"
    "Call a tool with a JSON object {\"name\": ..., \"arguments\": ...}:\n"
    "{{ tools | tojson }}<|eot_id|>{% endif %}"
    "{% for message in messages %}<|start_header_id|>{{ message.role }}"
    "<|end_header_id|>\n\n{{ message.content }}<|eot_id|>{% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|>assistant"
    "<|end_header_id|>\n\n{% endif %}")
CKPT_TURN = "Checkpoint {i}: what does a tokenizer.json hold? Ünïcödé ½ 日本."
CKPT_TOKENS = 32               # greedy tokens of the checkpoint's lone chats
MM_TOKENS = 16                 # greedy tokens of an image chat
MM_IMAGES = ("img://smoke/cat.png", "img://smoke/dog.png")
GGUF_LAYER_TYPES = {"attn_q": 12, "attn_k": 8, "attn_v": 14,
                    "attn_output": 8, "ffn_gate": 12, "ffn_up": 14,
                    "ffn_down": 8}     # Q4_K, Q8_0, Q6_K


def train_bpe(words: dict, n_merges: int) -> list:
    """Byte-level BPE merges learnt from `words` ({byte-level word:
    count}): each round merges the most frequent adjacent pair (ties to
    the smaller pair), counts kept up to date word by word and the
    candidates in a heap of (-count, pair) whose stale entries are
    skipped."""
    import heapq

    seqs = [list(w) for w in words]
    freq = list(words.values())
    pairs: dict = {}
    where: dict = {}
    for i, seq in enumerate(seqs):
        for a, b in zip(seq, seq[1:]):
            pairs[a, b] = pairs.get((a, b), 0) + freq[i]
            where.setdefault((a, b), set()).add(i)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while len(merges) < n_merges and heap:
        c, best = heapq.heappop(heap)
        if pairs.get(best) != -c:
            continue                   # stale: the count has moved
        if -c < 2:
            break
        merges.append(best)
        a, b = best
        changed = set()
        for i in where.pop(best, ()):
            seq, f = seqs[i], freq[i]
            for x, y in zip(seq, seq[1:]):
                pairs[x, y] -= f
                changed.add((x, y))
            out, j = [], 0
            while j < len(seq):
                if j + 1 < len(seq) and seq[j] == a and seq[j + 1] == b:
                    out.append(a + b)
                    j += 2
                else:
                    out.append(seq[j])
                    j += 1
            seqs[i] = out
            for x, y in zip(out, out[1:]):
                pairs[x, y] = pairs.get((x, y), 0) + f
                where.setdefault((x, y), set()).add(i)
                changed.add((x, y))
        for p in changed:
            if pairs.get(p, 0) > 0:
                heapq.heappush(heap, (-pairs[p], p))
            else:
                pairs.pop(p, None)
        pairs.pop(best, None)
    return merges


def llama3_tokenizer_json() -> str:
    """A Llama-3-style tokenizer.json: the Split regex and byte-level
    pre-tokenizer, merges learnt from this script's own text (so the
    file changes with the code only, never with the documents), BPE
    with ignore_merges, the ByteLevel decoder and Llama-3's special
    tokens at their ids."""
    from dynamo_tpu_torch.llm import tokenizer_json as tj

    enc, _ = tj.byte_alphabet()
    split = tj._compile(LLAMA3_PATTERN)
    words: dict = {}
    for m in split.finditer(SCRIPT.read_text(encoding="utf-8")):
        w = "".join(enc[x] for x in m.group().encode("utf-8"))
        words[w] = words.get(w, 0) + 1
    merges = train_bpe(words, BPE_MERGES)
    vocab = {enc[b]: b for b in range(256)}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    # Entries no merge reaches fill the vocabulary to Llama-3's 128000,
    # so the special tokens take their Llama-3 ids (`tokenizers` numbers
    # added tokens after the model's vocabulary).
    n_learnt = len(vocab)
    for i in range(n_learnt, min(LLAMA3_SPECIALS)):
        vocab[f"<unused_{i}>"] = i
    return json.dumps({
        "version": "1.0",
        "added_tokens": [{"id": i, "content": c, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, c in LLAMA3_SPECIALS.items()],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "ByteLevel", "add_prefix_space": True,
                           "trim_offsets": False, "use_regex": True},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [[a, b] for a, b in merges]}},
        ensure_ascii=False)


def write_safetensors(torch, path, tensors: dict) -> int:
    """`tensors` (name -> CPU tensor) as one .safetensors file, in the
    format's own layout (the machine has no `safetensors` package)."""
    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}
    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * ((-len(raw)) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().tobytes())
    return 8 + len(raw) + off


def write_checkpoint(torch, state, out) -> dict:
    """The seed-0 llama-3-1b state as an HF-layout checkpoint in `out`:
    bf16, two shards and their index, config.json, tokenizer_config.json
    (chat template, eos) and the tokenizer.json built here."""
    from dynamo_tpu_torch.models.config import get_config

    cfg = get_config("llama-3-1b")
    out.mkdir(parents=True, exist_ok=True)
    for old in out.iterdir():
        old.unlink()
    t0 = time.monotonic()
    tok_json = llama3_tokenizer_json()
    tok_s = time.monotonic() - t0
    (out / "tokenizer.json").write_text(tok_json, encoding="utf-8")
    (out / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": CKPT_TEMPLATE, "eos_token": "<|eot_id|>",
         "bos_token": "<|begin_of_text|>"}))
    (out / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_context,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": True, "torch_dtype": "bfloat16"}))
    half = cfg.num_layers // 2
    shards = [{"model.embed_tokens.weight": state["embed"]},
              {"model.norm.weight": state["final_norm"]}]
    hf = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
          "wv": "self_attn.v_proj", "wo": "self_attn.o_proj"}
    for i, layer in enumerate(state["layers"]):
        shard = shards[i >= half]
        p = f"model.layers.{i}."
        for ours, name in hf.items():
            shard[p + name + ".weight"] = layer["attn"][ours].t()
        for ours in ("gate", "up", "down"):
            shard[p + f"mlp.{ours}_proj.weight"] = layer["mlp"]["w_" + ours].t()
        shard[p + "input_layernorm.weight"] = layer["attn_norm"]
        shard[p + "post_attention_layernorm.weight"] = layer["mlp_norm"]
    t0 = time.monotonic()
    nbytes, weight_map = 0, {}
    for j, shard in enumerate(shards):
        fname = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
        nbytes += write_safetensors(torch, out / fname, {
            k: v.contiguous().cpu() for k, v in shard.items()})
        weight_map.update({k: fname for k in shard})
    (out / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": nbytes}, "weight_map": weight_map}))
    return {"bytes": nbytes, "write_s": time.monotonic() - t0,
            "tokenizer_build_s": tok_s, "merges": BPE_MERGES,
            "tokenizer_json_bytes": len(tok_json.encode())}


def ckpt_preprocessor():
    """The checkpoint's tokenizer and template in process, as a server
    of the checkpoint builds them (llm/model_card.py)."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
    from dynamo_tpu_torch.models.loader import read_tokenizer_config

    template, eos = read_tokenizer_config(str(CKPT_DIR))
    tok = HFTokenizer(str(CKPT_DIR / "tokenizer.json"), eos_token=eos)
    return OpenAIPreprocessor(tok, chat_template=template)


def engine_answers(torch, state, pres: list) -> list:
    """Greedy ids of each preprocessed request through an in-process
    engine on `state` (the preset's weights), one at a time."""
    import asyncio

    from dynamo_tpu_torch.engine.engine import (
        EngineConfig, EngineCore, InferenceEngine)
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.models.config import get_config

    async def run():
        engine = InferenceEngine(EngineCore(EngineConfig(
            model=get_config("llama-3-1b"), num_blocks=64,
            scheduler=SchedulerConfig(block_size=BS)), params=state))
        await engine.start()
        out = []
        try:
            for pre in pres:
                ids = []
                async for d in engine.generate(pre.request_id, pre.token_ids,
                                               pre.sampling):
                    ids += d.token_ids
                out.append(ids)
        finally:
            await engine.stop()
        return out

    return asyncio.run(run())


def sse_events(raw: str) -> list:
    """A named-event SSE stream as (event, data) pairs."""
    out = []
    for block in raw.strip().split("\n\n"):
        ev = data = None
        for line in block.split("\n"):
            if line.startswith("event: "):
                ev = line[7:]
            elif line.startswith("data: "):
                data = json.loads(line[6:])
        out.append((ev, data))
    return out


TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "The weather in a city",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}}}}},
    {"type": "function", "function": {"name": "get_time"}}]


def tools_responses(base: str) -> dict:
    """/v1/responses unary and streaming, a chat with tools and a forced
    tool_choice, and one with tool_choice "none", against the checkpoint
    serve; each checked against the same turn as a plain chat."""
    chat = {"model": "m", "temperature": 0, "max_tokens": 16,
            "messages": [{"role": "user", "content": "Hello, checkpoint."}]}
    plain = json.loads(_http(base + "/v1/chat/completions", chat))
    want_text = plain["choices"][0]["message"]["content"]
    resp = json.loads(_http(base + "/v1/responses", {
        "model": "m", "input": "Hello, checkpoint.", "temperature": 0,
        "max_output_tokens": 16}))
    check(resp["object"] == "response" and resp["status"] in (
        "completed", "incomplete"), f"responses: {resp}")
    text = "".join(c["text"] for o in resp["output"] for c in o["content"])
    check(text == want_text and resp["usage"]["output_tokens"]
          == plain["usage"]["completion_tokens"]
          and resp["usage"]["input_tokens"]
          == plain["usage"]["prompt_tokens"],
          f"responses: {resp} differs from the chat {plain}")
    events = sse_events(_http(base + "/v1/responses", {
        "model": "m", "input": "Hello, checkpoint.", "temperature": 0,
        "max_output_tokens": 16, "stream": True}))
    names = [e for e, _ in events]
    check(names[0] == "response.created" and names[-1] == "response.completed"
          and set(names[1:-1]) <= {"response.output_text.delta"},
          f"responses stream events {names}")
    streamed = "".join(d["delta"] for e, d in events
                       if e == "response.output_text.delta")
    final = events[-1][1]["response"]
    check(streamed == text and final["usage"] == resp["usage"],
          f"responses stream {streamed!r} / {final} vs unary {resp}")
    forced = json.loads(_http(base + "/v1/chat/completions", {
        **chat, "tools": TOOLS,
        "tool_choice": {"type": "function",
                        "function": {"name": "get_weather"}}}))
    choice = forced["choices"][0]
    calls = choice["message"].get("tool_calls") or []
    check(choice["finish_reason"] == "tool_calls" and len(calls) == 1
          and calls[0]["function"]["name"] == "get_weather"
          and calls[0]["id"].startswith("call_"),
          f"forced tool_choice gave {choice}")
    none = json.loads(_http(base + "/v1/chat/completions", {
        **chat, "tools": TOOLS, "tool_choice": "none"}))
    msg = none["choices"][0]["message"]
    check("tool_calls" not in msg and msg["content"] == want_text
          and none["choices"][0]["finish_reason"] in ("stop", "length"),
          f"tool_choice none gave {none} (plain chat: {want_text!r})")
    return {"responses_tokens": resp["usage"]["output_tokens"],
            "responses_status": resp["status"],
            "stream_events": len(events),
            "forced_call": calls[0]["function"],
            "none_content_equals_plain": True}


def state_leaves(tree, prefix: str = "") -> dict:
    """A state's tensors by path ("layers.3.attn.wq")."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(state_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def checkpoint_phase(torch) -> dict:
    """The seed-0 llama-3-1b preset written as an HF checkpoint (bf16,
    two shards + index, config, tokenizer_config, a Llama-3-style
    tokenizer.json built here), loaded back in process (bit-equal to the
    preset on the card; load seconds and GB/s, the files in the page
    cache) and served with `python -m dynamo_tpu_torch.frontend --model
    <dir>`: the wave of `serve`, two lone chats whose ids must equal an
    in-process preset engine's on the same prompt ids (a split only at a
    near tie), text round trips through the port's tokenizer, K1 and K2
    launched; /v1/responses and tool calls answer (`tools_responses`)."""
    from dynamo_tpu_torch.models.loader import load_params
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest

    t_phase = time.monotonic()
    state = llama_state(torch)
    written = write_checkpoint(torch, state, CKPT_DIR)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, loaded = load_params(str(CKPT_DIR), device="cuda")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    a, b = state_leaves(state), state_leaves(loaded)
    check(a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a),
        "checkpoint: the loaded tensors differ from the preset's")
    del loaded
    torch.cuda.empty_cache()
    pre = ckpt_preprocessor()
    texts = [CKPT_TURN.format(i=i) for i in range(4)] + [
        USER_TURN.format(i=0), SCRIPT.read_text(encoding="utf-8")[:2000]]
    for t in texts:
        ids = pre.tokenizer.encode(t)
        check(pre.tokenizer.decode(ids) == t,
              f"checkpoint tokenizer: {t[:40]!r} does not round-trip")
    chars_per_token = sum(len(t) for t in texts) / sum(
        len(pre.tokenizer.encode(t)) for t in texts)
    lone = [traced(chat_body(i, False, CKPT_TOKENS, user=CKPT_TURN))
            for i in range(2)]
    serve = serve_phase(str(CKPT_DIR), (), ("paged_decode_attention",
                                            "paged_prefill_attention"),
                        user=CKPT_TURN, tag="_checkpoint",
                        lone_bodies=lone, during=tools_responses)
    tools = serve.pop("during")
    pres = [pre.preprocess_chat(ChatCompletionRequest.from_dict(b), f"ck{i}")
            for i, b in enumerate(lone)]
    want = engine_answers(torch, state, pres)
    splits = [greedy_split(torch, state, p.token_ids, got["token_ids"], w,
                           f"checkpoint lone chat {i}")
              for i, (p, got, w) in enumerate(zip(pres, serve["lone_answers"],
                                                  want))]
    log = (OUT_DIR / "chip_smoke_server_checkpoint_checkpoint.log").read_text()
    m = re.search(r"loaded \S+ in ([0-9.]+) s", log)
    del state
    torch.cuda.empty_cache()
    return {**serve, "phase": "checkpoint", "written": written,
            "load_s": load_s, "load_gb_s": written["bytes"] / load_s / 1e9,
            "server_load_s": float(m.group(1)) if m else None,
            "prompt_tokens": [len(p.token_ids) for p in pres],
            "chars_per_token": chars_per_token, "lone_splits": splits,
            "tools_responses": tools,
            "wall_s": time.monotonic() - t_phase}


def write_llama_gguf(torch, path) -> dict:
    """llama-3-1b at full width as a GGUF: an F16 token embedding drawn
    on the card (std 0.02), F32 norms near 1, and per layer random
    Q4_K / Q8_0 / Q6_K blocks with bounded f16 scales
    (GGUF_LAYER_TYPES)."""
    import numpy as np

    from dynamo_tpu_torch.models.config import get_config

    cfg = get_config("llama-3-1b")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    emb = (torch.randn(V, H, generator=gen, device="cuda") * 0.02).half()
    tensors = [("token_embd.weight", [H, V], 1,
                emb.cpu().numpy().tobytes()),
               ("output_norm.weight", [H], 0,
                gguf_blob(np, rng, 0, rng.uniform(0.8, 1.2, H)))]
    dims = {"attn_q": (H, cfg.q_size), "attn_k": (H, cfg.kv_size),
            "attn_v": (H, cfg.kv_size), "attn_output": (cfg.q_size, H),
            "ffn_gate": (H, F), "ffn_up": (H, F), "ffn_down": (F, H)}
    for i in range(cfg.num_layers):
        p = f"blk.{i}."
        for norm in ("attn_norm", "ffn_norm"):
            tensors.append((p + norm + ".weight", [H], 0, gguf_blob(
                np, rng, 0, rng.uniform(0.8, 1.2, H))))
        for t, gtype in GGUF_LAYER_TYPES.items():
            n_in, n_out = dims[t]
            tensors.append((p + t + ".weight", [n_in, n_out], gtype,
                            gguf_random_blocks(np, rng, gtype, n_in * n_out)))
    nbytes = write_gguf(path, gguf_llama_metadata(cfg), tensors)
    return {"bytes": nbytes, "tensors": len(tensors)}


def gguf_phase(torch, kernels) -> dict:
    """A full-width llama-3-1b GGUF (F16, Q8_0, Q4_K, Q6_K) loaded on the
    card (dequantized there with torch ops): every tensor of the state
    held bit for bit against JAX's numpy dequant (the plain oracle)
    taken through the same unpermute / transpose / cast, then
    `compare_paths`' packed prefill and greedy decode steps through K2
    and K1 against the gather path."""
    import numpy as np

    from dynamo_tpu_torch.models import gguf

    t_phase = time.monotonic()
    path = OUT_DIR / "llama-3-1b.gguf"
    OUT_DIR.mkdir(exist_ok=True)
    t0 = time.monotonic()
    written = write_llama_gguf(torch, str(path))
    write_s = time.monotonic() - t0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    cfg, state, _ = gguf.load_gguf(str(path), device="cuda")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    check(cfg.name == "llama-3-1b" and cfg.tie_embeddings
          and cfg.hidden_size == 2048, f"gguf: config {cfg}")
    g = gguf.GgufFile(str(path))
    t0 = time.monotonic()
    # (gguf name, the state's tensor, heads to unpermute, linear)
    todo = [("token_embd.weight", state["embed"], 0, False),
            ("output_norm.weight", state["final_norm"], 0, False)]
    names = {"attn_q": ("attn", "wq"), "attn_k": ("attn", "wk"),
             "attn_v": ("attn", "wv"), "attn_output": ("attn", "wo"),
             "ffn_gate": ("mlp", "w_gate"), "ffn_up": ("mlp", "w_up"),
             "ffn_down": ("mlp", "w_down")}
    for i, layer in enumerate(state["layers"]):
        p = f"blk.{i}."
        todo.append((p + "attn_norm.weight", layer["attn_norm"], 0, False))
        todo.append((p + "ffn_norm.weight", layer["mlp_norm"], 0, False))
        for t, (part, key) in names.items():
            heads = (cfg.num_heads if t == "attn_q" else
                     cfg.num_kv_heads if t == "attn_k" else 0)
            todo.append((p + t + ".weight", layer[part][key], heads, True))

    def plain(item):
        name, _, heads, linear = item
        ref = g.tensor(name)                          # numpy, [out, in]
        if heads:
            ref = gguf._unpermute(ref, heads)
        return np.ascontiguousarray(ref.T if linear else ref)

    held, worst = 0, 0.0
    with ThreadPoolExecutor(8) as pool:    # numpy drops the GIL here
        for start in range(0, len(todo), 16):
            chunk = todo[start:start + 16]
            for (name, got, _, _), ref in zip(chunk, pool.map(plain, chunk)):
                ref = torch.from_numpy(ref).cuda().to(got.dtype)
                err = (got.float() - ref.float()).abs().max().item()
                worst = max(worst, err)
                check(torch.equal(got, ref), f"gguf: {name} differs from "
                      f"the numpy dequant (max abs err {err})")
                held += 1
    hold_s = time.monotonic() - t0
    check(held == written["tensors"], f"gguf: held {held} of "
                                      f"{written['tensors']} tensors")
    kernels.reset_launch_counts()
    paths = compare_paths(torch, cfg, state, state)
    launches = kernels.launch_counts()
    check(launches["paged_decode_attention"] > 0
          and launches["paged_prefill_attention"] > 0,
          f"gguf: K1 / K2 did not launch: {launches}")
    del state
    path.unlink()
    torch.cuda.empty_cache()
    return {"phase": "gguf", "written": written, "write_s": write_s,
            "load_s": load_s, "load_gb_s": written["bytes"] / load_s / 1e9,
            "types": {"token_embd": "F16", "norms": "F32",
                      **{t: {8: "Q8_0", 12: "Q4_K", 14: "Q6_K"}[v]
                         for t, v in GGUF_LAYER_TYPES.items()}},
            "tensors_held": held, "max_abs_err_vs_numpy": worst,
            "hold_s": hold_s, "paths": paths, "launches": launches,
            "wall_s": time.monotonic() - t_phase}


def mm_body(url: str, text: str = "Describe the image.") -> dict:
    return traced({"model": "m", "temperature": 0, "max_tokens": MM_TOKENS,
                   "stream": False, "messages": [{"role": "user", "content": [
                       {"type": "image_url", "image_url": {"url": url}},
                       {"type": "text", "text": text}]}]})


def multimodal_phase(torch) -> dict:
    """A `--role encode` worker, an LLM worker serving the checkpoint
    (`--model <dir>`: its hf_inline card gives frontend A the
    tokenizer and template) and frontend A: image chats whose greedy ids
    must each be the argmax (a near tie allowed) of a teacher-forced
    gather-path forward given the same embeddings (the stub tower's, in
    process); two images answer differently; the repeated image hits no
    prefix block; the embeddings crossed the device plane (frontend A's
    plane tallies); K2 ran the embeddings prefill and K1 the decode."""
    from dynamo_tpu_torch.llm.multimodal import PLACEHOLDER_TOKEN, StubVisionEncoder
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.models.config import get_config

    t_phase = time.monotonic()
    cp = _free_port()
    ckpt = str(CKPT_DIR)
    with distributed_stack(
            workers=(("llm", ("--model", ckpt)),), frontend_b=False,
            tag="multimodal", cp_port=cp,
            extra=(("dynamo_tpu_torch.worker", "encode",
                    ("--control-plane", f"127.0.0.1:{cp}", "--role",
                     "encode", "--model", ckpt)),)) as (a, _, ws, startup):
        enc_log = OUT_DIR / "chip_smoke_multimodal_encode.log"
        t0 = time.monotonic()
        while "encode worker instance" not in enc_log.read_text():
            check(time.monotonic() - t0 < 120, "the encode worker never "
                                               "served")
            time.sleep(0.5)
        w = ws[0]
        _chat(a, chat_body(-1, False, 4))          # warm-up, no image
        _http(w + "/debug/stats/reset", {})
        t0 = time.monotonic()
        results = [_chat(a, mm_body(u)) for u in MM_IMAGES + MM_IMAGES[:1]]
        wall = time.monotonic() - t0
        wstats = json.loads(_http(w + "/debug/stats"))
        fstats = json.loads(_http(a + "/debug/stats"))
    ids = [r["token_ids"] for r in results]
    check(ids[0] != ids[1], "multimodal: two images gave the same answer")
    check(ids[2] == ids[0], "multimodal: the repeated image answered "
                            "differently")
    check(wstats["prefix_cache"]["hit_tokens"] == 0,
          f"multimodal: an image prompt hit the prefix cache: "
          f"{wstats['prefix_cache']}")
    planes = fstats.get("plane_counts", {})
    check(planes == {"device": {"mm_embeds": len(results)}},
          f"multimodal: embeddings did not all cross the device plane: "
          f"{planes}")
    launches = wstats["kernels"]
    check(launches["paged_prefill_attention"] > 0
          and launches["paged_decode_attention"] > 0,
          f"multimodal: K1 / K2 did not launch: {launches}")
    pre = ckpt_preprocessor()
    cfg = get_config("llama-3-1b")
    enc = StubVisionEncoder(cfg.hidden_size)
    state = llama_state(torch)
    gaps = []
    for url, got in zip(MM_IMAGES, ids):
        body = mm_body(url)
        p = pre.preprocess_chat(ChatCompletionRequest.from_dict(body), "mm")
        emb = enc.encode(url)
        prompt = [PLACEHOLDER_TOKEN] * len(emb) + list(p.token_ids)
        g = forced_gaps(torch, cfg, state, prompt, got, 0, embeds=emb)
        check(max(g) <= MODEL_TOL[cfg.name],
              f"multimodal: {url}'s ids are not the reference's greedy "
              f"ids (argmax gaps {g})")
        gaps.append(max(g))
    del state
    torch.cuda.empty_cache()
    ttfts = [r["ttft_s"] for r in fstats["requests"]][-len(results):]
    return {"phase": "multimodal", "startup_s": startup,
            "images": len(results), "tokens": [len(x) for x in ids],
            "wall_s_chats": wall, "ttft_s": ttfts,
            "max_argmax_gap": gaps, "tol": MODEL_TOL[cfg.name],
            "plane_counts": planes, "launches": launches,
            "prefix_cache": wstats["prefix_cache"],
            "wall_s": time.monotonic() - t_phase}


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
        from dynamo_tpu_torch.parallel import default_sp_devices

        emit({"phase": "device", "name": kind,
              "count": torch.cuda.device_count(), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              # rank -> card of an `--sp 4` ring on this machine
              "sp_ranks": [str(d) for d in default_sp_devices(
                  SP, torch.device("cuda", 0))]})
        phase = "build"
        t0 = time.monotonic()
        times = build.build_all()
        emit({"phase": "build", "seconds": times,
              "wall_s": time.monotonic() - t0})
        phase = "sass"
        for name in TENSOR_CORE_LIBS:
            counts = build.sass_counts(name)
            emit({"phase": "sass", "library": name, **counts,
                  "ptxas": build.ptxas_report(name)})
            check(counts["HGMMA"] + counts["HMMA"] > 0,
                  f"{name}: no tensor-core instruction in its SASS")
            check(name not in WGMMA_LIBS or counts["HGMMA"] > 0,
                  f"{name}: no wgmma (HGMMA) instruction in its SASS")
        phase = "kernel_list"
        emit({"phase": "kernel_list", "names": list(kernels.KERNELS)})
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        attn = {}
        for quant in (False, True):
            for d in (64, 128):
                key = "paged_decode_attention" + ("_int8" if quant else "")
                for B, ctx in DECODE_SHAPES:
                    phase = f"{key}_d{d}" + ("" if B == 64 else f"_b{B}")
                    attn[key, d, B] = decode_phase(torch, gen, d, quant, B, ctx)
                    emit({"phase": phase, **attn[key, d, B]})
                key = "paged_prefill_attention" + ("_int8" if quant else "")
                phase = f"{key}_d{d}"
                attn[key, d, None] = prefill_phase(torch, gen, d, quant)
                emit({"phase": phase, **attn[key, d, None]})
        wide = {}
        for quant in (False, True):
            key = "paged_decode_attention" + ("_int8" if quant else "")
            for tag, hq, hkv, d in WIDE_DECODE:
                phase = f"{key}_{tag}"
                wide[key, tag] = decode_phase(torch, gen, d, quant,
                                              *DECODE_SHAPES[0], hq, hkv)
                emit({"phase": phase, **wide[key, tag]})
        ring = {}
        for quant in (False, True):
            for d in (64, 128):
                key = "ring_flash_attention" + ("_int8" if quant else "")
                phase = f"{key}_d{d}"
                ring[key, d] = ring_phase(torch, gen, d, quant)
                emit({"phase": phase, "shapes": ring[key, d]})
                # The same ring with every rank on a card of its own.
                n_cards = torch.cuda.device_count()
                if n_cards >= SP:
                    cards = [torch.device("cuda", i) for i in range(SP)]
                    emit({"phase": phase + "_cards",
                          "shapes": ring_phase(torch, gen, d, quant, cards)})
                else:
                    emit({"phase": phase + "_cards", "ran": False,
                          "reason": f"needs {SP} cards, this machine has "
                                    f"{n_cards}: the ranks shared card 0"})
        phase = "moe_grouped"
        moe = moe_kernel_phases(torch, gen)
        for k in moe:
            emit({"phase": k["name"], **k})
        torch.cuda.empty_cache()
        phase = "model"
        for line in model_phase(torch):
            emit(line)
        torch.cuda.empty_cache()
        phase = "model_sp"
        model_sp = model_sp_phases(torch, kernels)
        for line in model_sp:
            emit(line)
        torch.cuda.empty_cache()
        phase = "model_moe"
        moe_bf16, moe_int8 = model_moe_phase(torch, kernels)
        emit(moe_bf16)
        emit(moe_int8)
        torch.cuda.empty_cache()
        phase = "model_spec"
        model_spec, embed_ref = model_spec_phase(torch, kernels)
        emit(model_spec)
        torch.cuda.empty_cache()
        phase = "serve"
        serve = serve_phase("llama-3-1b", (), ("paged_decode_attention",
                                               "paged_prefill_attention"),
                            lone_bodies=[traced(b) for b in (
                                [chat_body(i, False, 64, user=LONE_TURN)
                                 for i in range(2)]
                                + [disagg_chat(i, False)
                                   for i in (0, 1, 0, 1)]
                                + [fleet_long_body()])],
                            during=lambda base: (embed_requests(base),
                                                 batch_reference(base)))
        serve_embed, serve["batch_reference"] = serve.pop("during")
        emit(serve)
        phase = "serve_distributed"
        dist = serve_distributed_phase(serve, serve_embed)
        emit(dist)
        phase = "serve_observed"
        observed = serve_observed_phase(torch, serve)
        emit(observed)
        ow, oc = observed["wave"], observed["capture"]
        print(f"serve_observed on {'; '.join(smi.splitlines())}: "
              + "; ".join(
                  f"{name}: {x['output_tok_s']:.1f} tok/s, TTFT mean "
                  f"{x['ttft_mean_s']:.4f} s max {x['ttft_max_s']:.4f} s, "
                  f"ITL mean {x['itl_mean_s']:.5f} s"
                  for name, x in (
                      ("frontend + one worker, every plane on", ow),
                      ("the same, every plane off",
                       observed["wave_planes_off"]),
                      ("serve (one process)", serve)))
              + "; modeled/measured "
              f"{observed['metrics']['modeled_vs_measured']}; ledger TTFT "
              f"coverage {[round(c, 3) for c in observed['ledger_ttft_coverage']]}"
              f"; wave counters equal serve's: "
              f"{observed['counters']['equal_serve']}, the planes-off "
              f"stack's: {observed['counters']['equal_planes_off']}; "
              f"steady window "
              f"byte-identical planes on/off: "
              f"{observed['planes']['byte_identical']}", flush=True)
        print(f"device capture ({oc['ms']} ms, a wave of 8 on one worker): "
              f"busy share {oc['busy_share']:.4f} of {oc['window_us']:.0f} "
              f"us; top kernels "
              + "; ".join(f"{k['name'][:60]} x{k['count']} "
                          f"{k['total_us']:.1f} us" for k in oc["kernels"])
              + "; longest idle gaps "
              + "; ".join(f"{g['gap_us']:.1f} us at {g['at_us']:.0f} us "
                          f"(spanned by {(g['host_event'] or {}).get('name')}"
                          f", next host event "
                          f"{(g['host_next'] or {}).get('name')})"
                          for g in oc["gaps"])
              + f"; events by category {oc['categories']}", flush=True)
        phase = "embeddings"
        err = embed_error(serve_embed, embed_ref[0])
        check(err <= EMBED_TOL, f"embeddings differ from the plain forward: "
                                f"rel err {err} > {EMBED_TOL}")
        emit({"phase": "embeddings", "inputs": [len(t) for t in embed_inputs()],
              "hidden": int(serve_embed.shape[1]),
              "serve_rel_err_vs_plain": err, "tol": EMBED_TOL,
              "serve_rel_err_vs_unpadded_plain": embed_error(serve_embed,
                                                             embed_ref[1]),
              "serve_distributed_equal_serve": dist["embeddings_equal_serve"]})
        phase = "serve_spec"
        serve_spec = serve_spec_phase(serve)
        emit(serve_spec)
        print(f"serve_spec (--spec-decode {SPEC_K}) on "
              f"{'; '.join(smi.splitlines())}: "
              + "; ".join(
                  f"{n} wave {w['output_tok_s']:.1f} tok/s, TTFT mean "
                  f"{w['ttft_mean_s']:.4f} s max {w['ttft_max_s']:.4f} s, ITL "
                  f"mean {w['itl_mean_s']:.5f} s, acceptance "
                  f"{w['acceptance_rate']:.3f}"
                  for n, w in (("serve", serve_spec["wave_serve"]),
                               ("repetitive",
                                serve_spec["wave_repetitive"])))
              + f"; serve (no spec) {serve['output_tok_s']:.1f} tok/s, TTFT "
              f"mean {serve['ttft_mean_s']:.4f} s, ITL mean "
              f"{serve['itl_mean_s']:.5f} s; model_spec acceptance "
              f"{model_spec['acceptance_rate']:.3f}, "
              f"{model_spec['tokens_per_forward']:.3f} tokens a forward",
              flush=True)
        waves = "; ".join(
            f"{mode}: {w['output_tok_s']:.1f} tok/s, TTFT mean "
            f"{w['ttft_mean_s']:.4f} s max {w['ttft_max_s']:.4f} s, ITL mean "
            f"{w['itl_mean_s']:.5f} s, worker prefix hit rates "
            f"{[round(x['prefix_hit_rate'], 3) for x in w['workers']]}"
            for mode, w in (("kv", dist["wave_kv"]),
                            ("round_robin", dist["wave_round_robin"])))
        print(f"serve_distributed on {'; '.join(smi.splitlines())}: two "
              f"workers (startup {dist['startup_s']:.1f} s) {waves}; one "
              f"process (serve): {serve['output_tok_s']:.1f} tok/s, TTFT "
              f"mean {serve['ttft_mean_s']:.4f} s, ITL mean "
              f"{serve['itl_mean_s']:.5f} s", flush=True)
        print(f"serve_distributed prefix-share pulls by worker (kv wave): "
              f"{dist['prefix_share_pulls']}; donor pull: "
              f"{dist['donor_pull']}", flush=True)
        torch.cuda.empty_cache()
        phase = "block_copy"
        block_copy = block_copy_phase(torch)
        emit(block_copy)
        phase = "tiers"
        state = llama_state(torch)
        tiers = tiers_phase(torch, kernels, state)
        emit(tiers)
        rates = {leg: [(x["kv_quant"], round(x["rates_wave"]["offload"]
                                            ["gb_s"] or 0, 2),
                        round(x["rates_reask"]["onboard"]["gb_s"] or 0, 2))
                       for x in tiers["legs"] if x["leg"] == leg]
                 for leg in ("g2", "g3")}
        y = tiers["yardstick"]
        print(f"tiers on {'; '.join(smi.splitlines())}: TTFT medians "
              + ", ".join(f"{k} {v:.4f} s" for k, v in
                          tiers["ttft_median_s"].items() if v is not None)
              + f"; (kv_quant, offload GB/s, onboard GB/s) by leg {rates};"
              f" pinned copy_ of {TIER_YARDSTICK_BLOCKS} blocks d2h "
              f"{y['d2h']['gb_s']:.2f} GB/s, h2d {y['h2d']['gb_s']:.2f} GB/s;"
              f" engine-thread host ms an evicted block "
              + ", ".join(f"{x['leg']}/{x['kv_quant']} "
                          f"{x['offload_host_ms_per_block']:.4f}"
                          for x in tiers["legs"]
                          if x.get("offload_host_ms_per_block"))
              + "; pinned allocation "
              + ", ".join(f"{x['pinned_mib']:.0f} MiB "
                          f"{x['host_alloc_s']:.4f} s"
                          for x in tiers["legs"] if x.get("pinned_mib"))
              + f"; {tiers['wall_s']:.1f} s", flush=True)
        phase = "qos_tier"
        qos_tier = qos_tier_leg(torch, state)
        del state
        torch.cuda.empty_cache()
        phase = "serve_disagg"
        disagg = serve_disagg_phase(serve)
        emit(disagg)
        w = disagg["wave"]
        print(f"serve_disagg on {'; '.join(smi.splitlines())}: prefill + "
              f"decode worker (startup {disagg['startup_s']:.1f} s); wave of "
              f"4 long + 4 short chats: {w['output_tok_s']:.1f} tok/s, TTFT "
              f"long mean {w['ttft_long_mean_s']:.4f} s, short mean "
              f"{w['ttft_short_mean_s']:.4f} s, ITL mean "
              f"{w['itl_mean_s']:.5f} s, overlap {w['overlap_ratios']}, "
              f"eager / done pulls {w['eager_pulls']} / {w['done_pulls']}, "
              f"staged high-water {w['staged_offers_high_water']} offers "
              f"{w['staged_bytes_high_water']} bytes; lone long chats TTFT "
              f"{disagg['lone']['ttft_s']} s, one process "
              f"{disagg['lone']['serve_ttft_cold_s']} s (cold) "
              f"{disagg['lone']['serve_ttft_warm_s']} s (prefix cache); "
              f"lone answers bit-equal to the prefix-cache answer, leading "
              f"tokens equal to the cold answer "
              f"{disagg['lone_leading_tokens_equal_cold']} of 64; "
              f"cuda_ipc pull "
              f"{block_copy['pulls']['none']['device_ms_per_block']:.4f} ms "
              f"a block, host-staged "
              f"{block_copy['pulls']['none']['host_ms_per_block']:.4f} ms",
              flush=True)
        phase = "serve_int8"
        serve_int8 = serve_int8_phase()
        emit(serve_int8)
        phase = "serve_moe"
        serve_moe = serve_moe_phase()
        emit(serve_moe)
        phase = "serve_sp"
        serve_sp = serve_sp_phase()
        emit(serve_sp)
        print(f"serve_sp TTFT of the long chats on "
              f"{'; '.join(smi.splitlines())}: --sp {SP} "
              f"{serve_sp['ttft_long_s']['sp4']} s, --sp {SP} --kv-quant "
              f"int8 {serve_sp['ttft_long_s']['sp4_int8']} s, --sp 1 "
              f"{serve_sp['ttft_long_s']['sp1']} s", flush=True)
        torch.cuda.empty_cache()
        phase = "qos"
        qos = qos_phase(torch)
        qos["tier_leg"] = qos_tier
        emit(qos)
        tm = qos["ttft_mean_s"]
        print(f"qos on {'; '.join(smi.splitlines())}: {QOS_BE} best-effort "
              f"+ {QOS_IA} interactive chats on {QOS_BLOCKS} pages: "
              f"{qos['qos_preemptions']:.0f} QoS preemptions; TTFT mean "
              f"interactive {tm['interactive']:.4f} s, best-effort "
              f"{tm['best_effort']:.4f} s (queued ones "
              f"{tm['best_effort_queued']:.4f} s); {qos['wall_s']:.1f} s",
              flush=True)
        phase = "planner_profile"
        profile = planner_profile_phase(torch, kernels)
        emit(profile)
        pp, t = profile["profile"], profile["sla_targets"]
        print(f"planner_profile on {'; '.join(smi.splitlines())}: TTFT "
              f"{dict(zip(pp['prefill']['isl'], pp['prefill']['ttft_s']))} s "
              f"by ISL; ITL {pp['decode']['itl_s']} s by (context "
              f"{pp['decode']['context']}) x (kv {pp['decode']['kv_usage']});"
              f" SLA targets P {t['num_prefill']} D {t['num_decode']}; "
              f"{profile['wall_s']:.1f} s", flush=True)
        phase = "fleet"
        fleet = fleet_phase(torch, serve["lone_answers"][6]["token_ids"])
        emit(fleet)
        print(f"fleet on {'; '.join(smi.splitlines())}: first worker "
              f"{fleet['first_worker_s']:.1f} s, scale-up "
              f"{fleet['scale_up_s']:.1f} s, scale-down "
              f"{fleet['scale_down_s']:.1f} s, drain by the "
              f"{fleet['drain']['via']} {fleet['drain']['drain_s']:.2f} s "
              f"after {fleet['drain']['emitted_before']} tokens, teardown "
              f"{fleet['teardown']['s']:.1f} s; {fleet['wall_s']:.1f} s",
              flush=True)
        phase = "router_service"
        routed = router_service_phase(serve)
        emit(routed)
        rs = routed["recorder"]
        print(f"router_service on {'; '.join(smi.splitlines())}: startup "
              f"{routed['startup_s']:.1f} s; recorder (raw arrivals, 8 chats"
              f" through the service) TTFT p50 {rs['ttft_p50']:.4f} s p95 "
              f"{rs['ttft_p95']:.4f} s, ITL p50 {rs['itl_p50']:.5f} s p95 "
              f"{rs['itl_p95']:.5f} s, {rs['tok_s']:.1f} tok/s; frontend B "
              f"ledger TTFT p50 {routed['ledger']['ttft_p50']} s, TPOT p50 "
              f"{routed['ledger']['tpot_p50']} s; frontend B timings TTFT "
              f"p50 {routed['frontend_b']['ttft_p50']:.4f} s, ITL mean "
              f"{routed['frontend_b']['itl_mean_s']} s", flush=True)
        phase = "ingress"
        ingress = ingress_phase(serve)
        emit(ingress)
        torch.cuda.empty_cache()
        phase = "checkpoint"
        ckpt = checkpoint_phase(torch)
        emit(ckpt)
        print(f"checkpoint on {'; '.join(smi.splitlines())}: "
              f"{ckpt['written']['bytes'] / 1e9:.3f} GB of bf16 in 2 shards "
              f"loaded in {ckpt['load_s']:.3f} s in process "
              f"({ckpt['load_gb_s']:.2f} GB/s, files in the page cache), "
              f"{ckpt['server_load_s']} s in the server; its wave "
              f"{ckpt['output_tok_s']:.1f} tok/s, TTFT mean "
              f"{ckpt['ttft_mean_s']:.4f} s, ITL mean "
              f"{ckpt['itl_mean_s']:.5f} s; serve (preset, byte tokenizer) "
              f"{serve['output_tok_s']:.1f} tok/s, TTFT mean "
              f"{serve['ttft_mean_s']:.4f} s, ITL mean "
              f"{serve['itl_mean_s']:.5f} s; tokenizer "
              f"{ckpt['chars_per_token']:.2f} chars a token, built in "
              f"{ckpt['written']['tokenizer_build_s']:.2f} s; "
              f"{ckpt['wall_s']:.1f} s", flush=True)
        phase = "multimodal"
        mmr = multimodal_phase(torch)
        emit(mmr)
        # The checkpoint's last reader has run: its 2.5 GB leave the
        # checkout before the GGUF's 1.3 GB are written.
        shutil.rmtree(CKPT_DIR)
        print(f"multimodal on {'; '.join(smi.splitlines())}: encode worker "
              f"+ checkpoint worker + frontend (startup "
              f"{mmr['startup_s']:.1f} s); image chats TTFT "
              f"{[round(t, 4) for t in mmr['ttft_s']]} s (64 image rows "
              f"over the device plane, {mmr['plane_counts']}); "
              f"{mmr['wall_s']:.1f} s", flush=True)
        phase = "gguf"
        gg = gguf_phase(torch, kernels)
        emit(gg)
        print(f"gguf on {'; '.join(smi.splitlines())}: "
              f"{gg['written']['bytes'] / 1e9:.3f} GB loaded and dequantized "
              f"on the card in {gg['load_s']:.3f} s "
              f"({gg['load_gb_s']:.2f} GB/s); {gg['tensors_held']} tensors "
              f"bit-equal to the numpy dequant ({gg['hold_s']:.1f} s); "
              f"{gg['wall_s']:.1f} s", flush=True)
    except Exception as e:  # every failure ends the run without an ok line
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        # The same on stderr, last, where a caller that keeps only the
        # end of stderr still reads which phase failed and why.
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed: {type(e).__name__}: "
              f"{str(e)[-3000:]}", file=sys.stderr, flush=True)
        return 1
    print(smi, flush=True)
    # K1/K2 bf16: launches on the serve path of their geometry (llama-3-1b
    # at D 64, mixtral-8x7b at D 128).  K1/K2 int8: launches of serve_int8
    # (llama-3-1b, D 64; no served model pairs D 128 with an int8 cache, so
    # the D 128 rows give the same body's count at D 64).  K3 bf16:
    # launches of serve_moe; K3 int8 (on no serve path): launches of
    # model_moe's int8 run.
    summary = []
    for (key, d, B), k in attn.items():
        run = serve_int8 if key.endswith("_int8") else (
            serve if d == 64 else serve_moe)
        extra = {"tflops": k["tflops"]} if "tflops" in k else {}
        if run is serve:
            # The same bodies' launches on serve_distributed's two workers
            # in its kv wave, and on serve_disagg's prefill and decode
            # workers in its wave (counts zeroed just before each).
            extra["launches_serve_distributed"] = sum(
                w["launches"][key] for w in dist["wave_kv"]["workers"])
            extra["launches_serve_disagg"] = sum(
                k[key] for k in disagg["wave"]["launches"].values())
            # The fleet's control loop: the qos worker's wave, the SLA
            # profiler's sweep and both fleet workers.
            extra["launches_qos"] = qos["launches"][key]
            extra["launches_planner_profile"] = profile["launches"][key]
            extra["launches_fleet"] = sum(
                k[key] for k in fleet["launches"].values())
        if d == 64:
            # The KV tiers' in-process engines (llama-3-1b, D 64).
            extra["launches_tiers"] = tiers["launches"][
                "int8" if key.endswith("_int8") else "none"][key]
        if run is serve:
            # Checkpoint serve's wave, the multimodal worker's image
            # chats and the GGUF model's in-process steps.
            extra["launches_checkpoint"] = ckpt["launches"][key]
            extra["launches_multimodal"] = mmr["launches"][key]
            extra["launches_gguf"] = gg["launches"][key]
        if "eager_ms" in k:
            extra["eager_ms"] = k["eager_ms"]
        name = (key + ("" if d == 64 else f"_d{d}")
                + ("" if B in (None, DECODE_SHAPES[0][0]) else f"_b{B}"))
        summary.append(summary_entry(
            k, name, run["launches"][key], launches_from=run["phase"],
            **extra))
    # K1 at the geometries no served model has: the same bodies' launches
    # on serve (bf16) and serve_int8 (int8), as the D 128 int8 rows.
    for (key, tag), k in wide.items():
        run = serve_int8 if key.endswith("_int8") else serve
        summary.append(summary_entry(
            k, f"{key}_{tag}", run["launches"][key],
            launches_from=run["phase"], eager_ms=k["eager_ms"]))
    for k in moe:
        tokens = k["shape"]["tokens"]
        name = k["name"] + ("_prefill" if tokens > 64 else
                            "" if tokens == 64 else f"_t{tokens}")
        if k["name"] == "moe_grouped":
            launches, frm = serve_moe["launches"]["moe_grouped"], "serve_moe"
        else:
            launches, frm = moe_int8["launches"]["moe_grouped"], "model_moe int8"
        summary.append(summary_entry(k, name, launches, launches_from=frm,
                                     group_tiles=k["group_tiles"]))
    # K4: launches of serve_sp, the bf16 body from its `--sp 4` server and
    # the int8 body from its `--sp 4 --kv-quant int8` server (llama-3-1b,
    # D 64, T_loc 128; the other shapes give the same body's count).
    for (key, d), shapes in ring.items():
        for k in shapes:
            name = key + ("" if d == 64 else f"_d{d}") + (
                "" if k["shape"]["T"] == RING_SHAPES[0][1]
                else f"_t{k['shape']['T']}")
            summary.append(summary_entry(
                k, name, serve_sp["launches"][key], launches_from="serve_sp",
                fold_ms=k["fold_ms"], state_bytes=k["state_bytes"],
                tflops=k["tflops"], fold_tflops=k["fold_tflops"]))
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kv-holder"]:
        sys.exit(kv_holder(sys.argv[2] == "int8", *[
            cast(a) for cast, a in zip((int, float), sys.argv[3:5])]))
    sys.exit(main())
