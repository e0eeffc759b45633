"""Packed ragged paged prefill attention: the CUDA kernel's wrapper and its
plain version (port of `dynamo_tpu/ops/pallas/paged_prefill.py`).

Several sequences' prefill chunks ride one flat `[T]` query axis.  Segment
r owns packed rows `[q_starts[r], q_starts[r] + q_lens[r])` at absolute
positions `[seq_lens[r] - q_lens[r], seq_lens[r])`, and each query sees
its own block table's slots where `kv_pos < seq_len AND kv_pos <= q_pos`.
The chunk's K/V must already be written to the pool.  Rows no segment
owns come back zero.  `paged_prefill_attention` launches
`csrc/paged_prefill.cu` for CUDA tensors and runs the plain version for
CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.ops.attention import paged_attention
from dynamo_tpu_torch.ops.cuda.paged_attention import _check

# Packed-axis alignment the engine's packing honours: T and every
# segment start are multiples of this (the TPU kernel's sublane contract,
# kept so both packages build the same packs).
PACK_ALIGN = 8


def paged_prefill_attention_plain(
    q: torch.Tensor,             # [T, Hq, D]
    k_cache: torch.Tensor,       # [S, F]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [R, P]
    seq_lens: torch.Tensor,      # [R]
    q_starts: torch.Tensor,      # [R]
    q_lens: torch.Tensor,        # [R]
    *,
    block_size: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Per segment: gather its table's pages and attend its rows with the
    position mask.  Reads the segment descriptors on the host."""
    T, Hq, D = q.shape
    Hkv = k_cache.shape[1] // D
    if scale is None:
        scale = D ** -0.5
    P = block_tables.shape[1]
    C = P * block_size
    q_scaled = (q.float() * scale).to(k_cache.dtype)
    out = torch.zeros_like(q)
    ctx_pos = torch.arange(C, device=q.device)[None]
    for r, (sl, qs, ql) in enumerate(zip(seq_lens.tolist(), q_starts.tolist(),
                                         q_lens.tolist())):
        if ql <= 0:
            continue
        slots = kvc.slots_for_positions(block_tables[r:r + 1], ctx_pos,
                                        block_size)
        k_ctx, v_ctx = kvc.gather_kv(k_cache, v_cache, slots, Hkv)
        q_pos = torch.arange(sl - ql, sl, device=q.device)[None]
        o = paged_attention(q_scaled[None, qs:qs + ql], k_ctx, v_ctx, q_pos,
                            ctx_pos, torch.tensor([sl], device=q.device),
                            scale=1.0, soft_cap=soft_cap)
        out[qs:qs + ql] = o[0].to(q.dtype)
    return out


def paged_prefill_attention(
    q: torch.Tensor,             # [T, Hq, D] packed chunk queries
    k_cache: torch.Tensor,       # [S, F = Hkv * D] one layer's pool keys
    v_cache: torch.Tensor,       # [S, F]
    block_tables: torch.Tensor,  # [R, P] int32 page ids per segment
    seq_lens: torch.Tensor,      # [R] int32 context AFTER this chunk
    q_starts: torch.Tensor,      # [R] int32 packed row of each segment
    q_lens: torch.Tensor,        # [R] int32 query rows (0 = pad segment)
    *,
    block_size: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Packed ragged prefill attention over the paged pool; [T, Hq, D].

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (bf16, D in {32, 64, 128}, Hq / Hkv dividing the kernel's 64 query
    rows per CTA, T % PACK_ALIGN == 0) or raise."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_cache, v_cache, block_tables, seq_lens, q_starts, q_lens,
            block_size=block_size, scale=scale, soft_cap=soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged prefill kernel for device {q.device}")
    dev = q.device
    _check(q, "q", torch.bfloat16, 3, dev)
    _check(k_cache, "k_cache", torch.bfloat16, 2, dev)
    _check(v_cache, "v_cache", torch.bfloat16, 2, dev)
    _check(block_tables, "block_tables", torch.int32, 2, dev)
    for name, t in (("seq_lens", seq_lens), ("q_starts", q_starts),
                    ("q_lens", q_lens)):
        _check(t, name, torch.int32, 1, dev)
    T, Hq, D = q.shape
    S, F = k_cache.shape
    R = block_tables.shape[0]
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    if D not in (32, 64, 128) or F % D or Hq % (F // D):
        raise ValueError(f"bad geometry: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} (kernel takes D in "
                         "32/64/128)")
    if T % PACK_ALIGN:
        raise ValueError(f"packed token axis T={T} must be a multiple of "
                         f"{PACK_ALIGN}")
    if R == 0 or any(t.shape[0] != R for t in (seq_lens, q_starts, q_lens)):
        raise ValueError("need R >= 1 segments with matching descriptors")
    if S % block_size:
        raise ValueError(f"cache slots {S} not a multiple of block_size")
    Hkv = F // D
    lib = _lib()
    if lib.dtt_paged_prefill_rows() % (Hq // Hkv):
        raise ValueError(f"GQA group {Hq // Hkv} must divide the prefill "
                         f"kernel's {lib.dtt_paged_prefill_rows()} rows")
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("q and the cache must be 16-byte aligned")
    out = torch.empty_like(q)
    if T == 0:
        return out
    if scale is None:
        scale = D ** -0.5
    err = lib.dtt_paged_prefill_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), q_starts.data_ptr(),
        q_lens.data_ptr(), out.data_ptr(), T, R, Hq, Hkv, D,
        block_tables.shape[1], block_size, float(scale),
        float(soft_cap or 0.0), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_prefill kernel launch failed: CUDA error {err}")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def _lib() -> ctypes.CDLL:
    from dynamo_tpu_torch.ops.cuda import build

    lib = build.load("paged_prefill")
    fn = lib.dtt_paged_prefill_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.dtt_paged_prefill_rows.restype = ctypes.c_int
        lib.dtt_paged_prefill_rows.argtypes = []
    return lib
