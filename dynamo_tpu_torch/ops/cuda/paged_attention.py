"""Paged decode attention: the CUDA kernel's wrapper and its plain version
(port of `dynamo_tpu/ops/pallas/paged_attention.py`).

`paged_decode_attention` launches `csrc/paged_decode.cu` for CUDA tensors
and runs `paged_decode_attention_plain` for CPU tensors; there is no other
fallback.  Numerics follow the TPU kernel: the query is scaled in f32 and
rounded to the cache dtype, products accumulate in f32, softmax runs in
f32 and the probabilities round to V's dtype for the second product.  A
row with `seq_len == 0` reads nothing and returns zeros.
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
) -> torch.Tensor:
    """Gather each row's pages, attend the single query at position
    seq_len - 1 over them; [B, Hq, D] in q's dtype."""
    B, Hq, D = q.shape
    Hkv = k_cache.shape[1] // D
    if scale is None:
        scale = D ** -0.5
    P = block_tables.shape[1]
    C = P * block_size
    ctx_pos = torch.arange(C, device=q.device).expand(B, C)
    slots = kvc.slots_for_positions(block_tables, ctx_pos, block_size)
    k_ctx, v_ctx = kvc.gather_kv(k_cache, v_cache, slots, Hkv)
    q_scaled = (q.float() * scale).to(k_cache.dtype)
    seq_lens = seq_lens.long()
    out = paged_attention(q_scaled[:, None], k_ctx, v_ctx,
                          (seq_lens - 1)[:, None], ctx_pos, seq_lens,
                          scale=1.0, soft_cap=soft_cap)[:, 0]
    out = torch.where((seq_lens > 0)[:, None, None], out.float(),
                      torch.zeros((), device=q.device))
    return out.to(q.dtype)


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
) -> torch.Tensor:
    """Decode-step attention over the paged cache; [B, Hq, D].

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (bf16 query and cache, D % 8 == 0, G * D within the kernel's output
    budget) or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, block_tables, seq_lens,
            block_size=block_size, scale=scale, soft_cap=soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    dev = q.device
    _check(q, "q", torch.bfloat16, 3, dev)
    _check(k_cache, "k_cache", torch.bfloat16, 2, dev)
    _check(v_cache, "v_cache", torch.bfloat16, 2, dev)
    _check(block_tables, "block_tables", torch.int32, 2, dev)
    _check(seq_lens, "seq_lens", torch.int32, 1, dev)
    B, Hq, D = q.shape
    S, F = k_cache.shape
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    if D % 8 or F % D or Hq % (F // D):
        raise ValueError(f"bad geometry: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} (needs D % 8 == 0)")
    if block_tables.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("block_tables / seq_lens rows must match q")
    if S % block_size:
        raise ValueError(f"cache slots {S} not a multiple of block_size")
    Hkv = F // D
    lib = _lib()
    if (Hq // Hkv) * D > lib.dtt_paged_decode_max_out():
        raise ValueError(f"G * D = {(Hq // Hkv) * D} exceeds the decode "
                         "kernel's per-CTA output budget")
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("q and the cache must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    if scale is None:
        scale = D ** -0.5
    err = lib.dtt_paged_decode_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, D, block_tables.shape[1], block_size, float(scale),
        float(soft_cap or 0.0), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _lib() -> ctypes.CDLL:
    from dynamo_tpu_torch.ops.cuda import build

    lib = build.load("paged_decode")
    fn = lib.dtt_paged_decode_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.dtt_paged_decode_max_out.restype = ctypes.c_int
        lib.dtt_paged_decode_max_out.argtypes = []
    return lib
