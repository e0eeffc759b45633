"""Paged decode attention: the CUDA kernel's wrapper and its plain version
(port of `dynamo_tpu/ops/pallas/paged_attention.py`).

`paged_decode_attention` launches `csrc/paged_decode.cu` for CUDA tensors
and runs `paged_decode_attention_plain` for CPU tensors; there is no other
fallback.  Numerics follow the TPU kernel: the query is scaled in f32 and
rounded to the cache dtype (to q's dtype over an int8 cache), products
accumulate in f32, softmax runs in f32 and the probabilities round to V's
dtype for the second product.  A row with `seq_len == 0` reads nothing
and returns zeros.

An int8 cache comes with its `k_scale` / `v_scale` buffers ([S, Hkv] f32,
kv_cache.init_cache); pages dequantize as `kv_cache.dequantize_rows` does,
into q's dtype, and the launch counts as `launches_int8`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.ops.attention import paged_attention


def paged_decode_attention_plain(
    q: torch.Tensor,             # [B, Hq, D]
    k_cache: torch.Tensor,       # [S, F = Hkv * D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32
    seq_lens: torch.Tensor,      # [B] int32
    *,
    block_size: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [S, Hkv] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather each row's pages, attend the single query at position
    seq_len - 1 over them; [B, Hq, D] in q's dtype."""
    quant = check_quant_args(k_cache, k_scale, v_scale)
    B, Hq, D = q.shape
    Hkv = k_cache.shape[1] // D
    if scale is None:
        scale = D ** -0.5
    P = block_tables.shape[1]
    C = P * block_size
    ctx_pos = torch.arange(C, device=q.device).expand(B, C)
    slots = kvc.slots_for_positions(block_tables, ctx_pos, block_size)
    k_ctx, v_ctx, q_scaled = gather_context(q, k_cache, v_cache, k_scale,
                                            v_scale, slots, Hkv, scale, quant)
    seq_lens = seq_lens.long()
    out = paged_attention(q_scaled[:, None], k_ctx, v_ctx,
                          (seq_lens - 1)[:, None], ctx_pos, seq_lens,
                          scale=1.0, soft_cap=soft_cap)[:, 0]
    out = torch.where((seq_lens > 0)[:, None, None], out.float(),
                      torch.zeros((), device=q.device))
    return out.to(q.dtype)


def check_quant_args(k_cache: torch.Tensor, k_scale, v_scale) -> bool:
    """True for an int8 cache given with both scale buffers, False for an
    unquantized cache given with neither; raises otherwise."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if quant and k_cache.dtype != torch.int8:
        raise ValueError(f"scales imply an int8 cache; got {k_cache.dtype}")
    if not quant and k_cache.dtype == torch.int8:
        raise ValueError("an int8 cache needs its k_scale and v_scale")
    return quant


def gather_context(q, k_cache, v_cache, k_scale, v_scale, slots, Hkv,
                   scale, quant):
    """The plain versions' operands: the gathered [B, C, Hkv, D] context
    (dequantized into q's dtype over an int8 cache) and the scaled query
    rounded to the context's dtype, as the kernels round it."""
    if quant:
        k_ctx, v_ctx = kvc.gather_kv_quant(k_cache, v_cache, k_scale, v_scale,
                                           slots, Hkv, out_dtype=q.dtype)
    else:
        k_ctx, v_ctx = kvc.gather_kv(k_cache, v_cache, slots, Hkv)
    return k_ctx, v_ctx, (q.float() * scale).to(k_ctx.dtype)


# Head dims the kernel is built for (csrc/paged_decode.cu's launch switch).
KERNEL_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)


def check_decode_geometry(Hq: int, Hkv: int, D: int) -> None:
    """Raise ValueError for a head geometry the decode kernel does not
    take: D outside KERNEL_HEAD_DIMS or Hq not a multiple of Hkv.  Any
    number of query heads a kv head is taken (16-row query tiles, a CTA
    for each 64)."""
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"bad geometry: {Hq} query heads over {Hkv} kv "
                         "heads")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D}: the decode kernel is built for "
                         f"{KERNEL_HEAD_DIMS}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_decode_attention(
    q: torch.Tensor,             # [B, Hq, D] decode queries
    k_cache: torch.Tensor,       # [S, F = Hkv * D] one layer's keys
    v_cache: torch.Tensor,       # [S, F]
    block_tables: torch.Tensor,  # [B, P] int32 page ids
    seq_lens: torch.Tensor,      # [B] int32 valid context length
    *,
    block_size: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [S, Hkv] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode-step attention over the paged cache; [B, Hq, D].

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (bf16 query; bf16 or int8 cache, int8 with its scales; D one of
    KERNEL_HEAD_DIMS, check_decode_geometry) or raise."""
    quant = check_quant_args(k_cache, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, block_tables, seq_lens,
            block_size=block_size, scale=scale, soft_cap=soft_cap,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    dev = q.device
    _check(q, "q", torch.bfloat16, 3, dev)
    check_cache(k_cache, v_cache, k_scale, v_scale, q.shape[2], dev)
    _check(block_tables, "block_tables", torch.int32, 2, dev)
    _check(seq_lens, "seq_lens", torch.int32, 1, dev)
    B, Hq, D = q.shape
    S, F = k_cache.shape
    if Hq % (F // D):
        raise ValueError(f"bad geometry: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    if block_tables.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("block_tables / seq_lens rows must match q")
    if S % block_size:
        raise ValueError(f"cache slots {S} not a multiple of block_size")
    Hkv = F // D
    check_decode_geometry(Hq, Hkv, D)
    lib = _lib()
    if q.data_ptr() % 16:
        raise ValueError("q and the cache must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    if scale is None:
        scale = D ** -0.5
    tail = (block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, block_tables.shape[1], block_size, float(scale),
            float(soft_cap or 0.0), torch.cuda.current_stream(dev).cuda_stream)
    if quant:
        err = lib.dtt_paged_decode_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), *tail)
    else:
        err = lib.dtt_paged_decode_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {err}")
    if quant:
        paged_decode_attention.launches_int8 += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_int8 = 0


def check_cache(k_cache, v_cache, k_scale, v_scale, D: int,
                device: torch.device) -> None:
    """The kernels' cache contract: bf16 K/V with D % 8 == 0, or int8 K/V
    with D % 16 == 0 and f32 [S, Hkv] scales (16-byte row vectors either
    way); contiguous, 16-byte aligned, on `device`."""
    quant = k_scale is not None
    dtype, vec = (torch.int8, 16) if quant else (torch.bfloat16, 8)
    _check(k_cache, "k_cache", dtype, 2, device)
    _check(v_cache, "v_cache", dtype, 2, device)
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    S, F = k_cache.shape
    if D % vec or F % D:
        raise ValueError(f"bad geometry: cache {tuple(k_cache.shape)}, head "
                         f"dim {D} (needs D % {vec} == 0 for a {dtype} "
                         "cache)")
    if quant:
        _check(k_scale, "k_scale", torch.float32, 2, device)
        _check(v_scale, "v_scale", torch.float32, 2, device)
        if (tuple(k_scale.shape) != (S, F // D)
                or v_scale.shape != k_scale.shape):
            raise ValueError(f"scales must be [{S}, {F // D}], got "
                             f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    for t in (k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("q and the cache must be 16-byte aligned")


def _lib() -> ctypes.CDLL:
    from dynamo_tpu_torch.ops.cuda import build

    lib = build.load("paged_decode")
    fn = lib.dtt_paged_decode_bf16
    if fn.argtypes is None:
        tail = ([ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + tail
        lib.dtt_paged_decode_int8.restype = ctypes.c_int
        lib.dtt_paged_decode_int8.argtypes = [ctypes.c_void_p] * 8 + tail
    return lib
