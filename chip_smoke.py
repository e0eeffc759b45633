#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dynamo_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (a failed phase exits non-zero and prints no
`ok` line):

1. device   — the card's name, count, torch/CUDA versions.
2. build    — nvcc builds every kernel source, one process each, at once.
3. kernel_list — the kernels of the main path.
4. one line per kernel, held against its plain PyTorch version at the main
   path's shapes (llama-3-1b: Hq 32, Hkv 8, D 64, block 64), with its time
   (CUDA events), the plain version's, scaled_dot_product_attention's on
   the gathered context (a yardstick only; the port never calls it), and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 989 TFLOP/s bf16 — NVIDIA's H100 SXM data sheet).
5. model    — llama-3-1b at full width, random weights: packed prefill and
   decode steps through the kernels against the gather path.
6. serve    — `python -m dynamo_tpu_torch.frontend --model llama-3-1b` as a
   subprocess; launch counts zeroed, then concurrent streaming and unary
   greedy chat requests over HTTP; each must return its tokens and the
   streams their `[DONE]`; both kernels must have launched.

Then the card's `nvidia-smi` name/power-limit line, the kernels summary
`{"kernels": [...]}` and, last, `{"ok": true, "device": {...}}`.
It needs CUDA and the repository around it.
"""

from __future__ import annotations

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
RTOL = 2.0 ** -7
ATOL = {"paged_decode_attention": 3e-3, "paged_prefill_attention": 8e-3}
# Limits about twice the largest reading on an H100 80GB HBM3 at these
# shapes and at those of tests/test_torch_cuda.py.
ROW_TOL = {"paged_decode_attention": 1e-2, "paged_prefill_attention": 1e-2}
MODEL_TOL = 5e-2               # relative logits error, kernels vs gather path
SEED = 0                       # also the server's weight seed (EngineConfig)
BS, HQ, HKV, D = 64, 32, 8, 64  # llama-3-1b attention geometry, block 64


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


def decode_phase(torch, gen):
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


def prefill_phase(torch, gen):
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


def model_phase(torch):
    """llama-3-1b at full width: packed prefill (K2) + decode steps (K1)
    against the gather path on the same weights, prompts and tokens."""
    from dynamo_tpu_torch.engine import kv_cache as kvc
    from dynamo_tpu_torch.models import llama, weights
    from dynamo_tpu_torch.models.config import get_config

    dev = torch.device("cuda")
    cfg = get_config("llama-3-1b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = weights.init_params(cfg, gen, dev)
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
    packed = llama.make_packed_prefill_step(cfg, BS)
    logits_k, _ = packed(state, cache_k, *(t.to(dev) for t in (
        tokens, positions, seg, bt8, qs, ql, sl, smp)))
    logits_k = logits_k[:2]
    # Gather path: the padded [2, Lmax] prefill through the forward step.
    Lmax = max(len(p) for p in prompts)
    tok2 = torch.zeros(2, Lmax, dtype=torch.int32)
    pos2 = torch.full((2, Lmax), 128 * BS, dtype=torch.int32)
    for i, p in enumerate(prompts):
        tok2[i, : len(p)] = torch.tensor(p)
        pos2[i, : len(p)] = torch.arange(len(p))
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    gather = llama.make_forward_step(cfg, BS, use_decode_kernel=False)
    logits_g, _ = gather(state, cache_g, tok2.to(dev), pos2.to(dev),
                         lens.to(dev), bt, (lens - 1).to(dev))
    errs = [((logits_k - logits_g).abs().max() / logits_g.abs().max()).item()]
    agree = [(logits_k.argmax(-1) == logits_g.argmax(-1)).float().mean().item()]
    # Decode: both caches fed the kernel path's greedy tokens.
    step_k = llama.make_forward_step(cfg, BS, use_decode_kernel=True)
    cur = lens.clone().to(dev)
    nxt = logits_k.argmax(-1).to(torch.int32)
    zero = torch.zeros(2, dtype=torch.int32, device=dev)
    for _ in range(4):
        cur = cur + 1
        lk, _ = step_k(state, cache_k, nxt[:, None], (cur - 1)[:, None], cur,
                       bt, zero)
        lg, _ = gather(state, cache_g, nxt[:, None], (cur - 1)[:, None], cur,
                       bt, zero)
        errs.append(((lk - lg).abs().max() / lg.abs().max()).item())
        agree.append((lk.argmax(-1) == lg.argmax(-1)).float().mean().item())
        check(bool(torch.isfinite(lk).all()), "model: non-finite logits")
        nxt = lk.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    worst = max(errs)
    check(worst <= MODEL_TOL,
          f"model: kernels vs gather path logits rel err {worst} > {MODEL_TOL}")
    return {"phase": "model", "model": cfg.name, "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "prompts": [len(p) for p in prompts],
            "decode_steps": 4, "logits_rel_err": errs,
            "argmax_agreement": agree, "tol": MODEL_TOL}


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


def serve_phase(n_requests: int = 8, max_tokens: int = 64):
    OUT_DIR.mkdir(exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    log_path = OUT_DIR / "chip_smoke_server.log"
    log = open(log_path, "w")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--model",
         "llama-3-1b", "--model-name", "m", "--http-port", str(port)],
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
            check(time.monotonic() - t0 < 300, "server not ready in 300 s")
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
    check(all(v > 0 for v in launches.values()),
          f"a main-path kernel never launched: {launches}")
    reqs = stats["requests"]
    check(len(reqs) == n_requests, f"server timed {len(reqs)} requests")
    ttfts = [r["ttft_s"] for r in reqs]
    itl_n = sum(r["itl_n"] for r in reqs)
    out_tokens = sum(r["tokens"] for r in results)
    return {"phase": "serve", "model": "llama-3-1b", "startup_s": startup_s,
            "requests": n_requests, "streaming": sum(r["stream"] for r in results),
            "max_tokens": max_tokens, "output_tokens": out_tokens,
            "wall_s": wall, "output_tok_s": out_tokens / wall,
            "ttft_mean_s": statistics.mean(ttfts),
            "ttft_max_s": max(ttfts),
            "itl_mean_s": (sum(r["itl_sum_s"] for r in reqs) / itl_n
                           if itl_n else None),
            "launches": launches, "counters": stats["counters"]}


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
        name = torch.cuda.get_device_name(0)
        emit({"phase": "device", "name": name,
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
        phase = "paged_decode_attention"
        dec = decode_phase(torch, gen)
        emit({"phase": phase, **dec})
        phase = "paged_prefill_attention"
        pre = prefill_phase(torch, gen)
        emit({"phase": phase, **pre})
        phase = "model"
        emit(model_phase(torch))
        torch.cuda.empty_cache()
        phase = "serve"
        serve = serve_phase()
        emit(serve)
    except Exception as e:  # every failure ends the run without an ok line
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        return 1
    print(smi, flush=True)
    sources = {"paged_decode_attention": (
                   "dynamo_tpu_torch/csrc/paged_decode.cu",
                   "dynamo_tpu/ops/pallas/paged_attention.py:258"),
               "paged_prefill_attention": (
                   "dynamo_tpu_torch/csrc/paged_prefill.cu",
                   "dynamo_tpu/ops/pallas/paged_prefill.py:227")}
    summary = []
    for k in (dec, pre):
        src, replaces = sources[k["name"]]
        summary.append({
            "name": k["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": serve["launches"][k["name"]],
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
