"""Ring attention through the CUDA flash-fold kernel: the kernel's wrapper,
the ring that drives it, and the geometry rule (port of
`dynamo_tpu/ops/pallas/ring_attention.py:ring_flash_attention`).

The TPU kernel is one program per sequence shard that lives through all
sp hops and pulls each next K/V block from its neighbour from inside the
kernel.  On a CUDA card the hop loop is on the host side of the launch:

- `ring_flash_fold` is ONE launch of `csrc/ring_flash.cu`: one rank folds
  one visiting block into its online-softmax state `(m, l, acc)`, which
  lives in device memory between the launches.  The first hop's launch
  starts the state, the last hop's writes the normalised output.
- `ring_flash_attention` runs the ring over an `SpRing`
  (parallel/mesh.py): for every hop and rank it first queues, on the
  rank's copy stream, the copy of the block the rank holds into its right
  neighbour's other slot, and then the fold of that block on the rank's
  compute stream, so the next hop's block travels while this one is
  folded.  No step waits on the host.

The plain version is `ops/ring_attention.py` (`ring_fold`, `ring_finish`,
`ring_causal_attention`): the wrapper uses it for CPU tensors, where the
same ring loop still runs its slot rotation, and for nothing else.  For
CUDA tensors the wrapper launches the kernel or raises.  Which shapes the
kernel takes is `ring_geometry_ok` / `ring_kernel_supported`, ONE rule
read by the model's dispatch (models/llama._sp_ring_attention), by the
engine's `ring_kernel_prefills` counter and by chip_smoke.py.  int8
blocks come with their `[B, T_loc, Hkv]` f32 scales, and their launches
count as `launches_int8`.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from dynamo_tpu_torch.ops.cuda.paged_attention import _check
from dynamo_tpu_torch.ops.ring_attention import (
    RingState,
    ring_finish,
    ring_fold,
    ring_init,
)

# Query rows (token x head of one kv group) a CTA of the kernel holds.
FOLD_ROWS = 64
HEAD_DIMS = (32, 64, 128)


def ring_geometry_ok(num_heads: int, num_kv_heads: int, head_dim: int) -> bool:
    """The kernel's own geometry rule: a head width it is compiled for
    (16-byte loads of int8 rows need D % 16 == 0) and a GQA group whose
    query heads fill a CTA's rows evenly."""
    if head_dim not in HEAD_DIMS or num_kv_heads < 1:
        return False
    if num_heads % num_kv_heads:
        return False
    return FOLD_ROWS % (num_heads // num_kv_heads) == 0


def ring_kernel_supported(num_heads: int, num_kv_heads: int, head_dim: int,
                          t_local: int, device: torch.device,
                          dtype: torch.dtype) -> bool:
    """THE kernel-or-plain-ring rule, shared by the model's dispatch, the
    engine's counter and the smoke run: the kernel runs bf16 models on a
    card at a geometry that `ring_geometry_ok` passes."""
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and t_local >= 1
            and ring_geometry_ok(num_heads, num_kv_heads, head_dim))


def ring_flash_fold(
    state: RingState,         # (m, l [B, Hq, Tq], acc [B, Tq, Hq, D]) f32
    q_scaled: torch.Tensor,   # [B, Tq, Hq, D] f32, already times the scale
    q_pos: torch.Tensor,      # [B, Tq] int32
    k: torch.Tensor,          # [B, Tk, Hkv, D] bf16, or int8 with scales
    v: torch.Tensor,
    kv_pos: torch.Tensor,     # [B, Tk] int32
    out: torch.Tensor,        # [B, Tq, Hq, D] bf16, written when `last`
    *,
    first: bool,              # start the state instead of reading it
    last: bool,               # write `out` instead of storing the state
    soft_cap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # [B, Tk, Hkv] f32
    v_scale: Optional[torch.Tensor] = None,
) -> None:
    """Fold one visiting block into `state`, in place.  After a `last`
    fold the state's contents are undefined and `out` holds the result.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (bf16 out, D in 32/64/128, Hq / Hkv dividing 64) or raise."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if quant != (k.dtype == torch.int8):
        raise ValueError("int8 blocks and scales come together")
    if q_scaled.device.type == "cpu":
        old = ring_init(q_scaled) if first else state
        new = ring_fold(old, q_scaled, q_pos, k, v, kv_pos, soft_cap,
                        k_scale, v_scale, dequant_dtype=out.dtype)
        if last:
            out.copy_(ring_finish(new, out.dtype))
        else:
            for dst, src in zip(state, new):
                dst.copy_(src)
        return
    dev = q_scaled.device
    if dev.type != "cuda":
        raise ValueError(f"no ring fold kernel for device {dev}")
    _check(q_scaled, "q_scaled", torch.float32, 4, dev)
    B, Tq, Hq, D = q_scaled.shape
    kv_dtype = torch.int8 if quant else torch.bfloat16
    _check(k, "k", kv_dtype, 4, dev)
    _check(v, "v", kv_dtype, 4, dev)
    Tk, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Tk, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"bad block shapes: q {tuple(q_scaled.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not ring_geometry_ok(Hq, Hkv, D):
        raise ValueError(f"ring fold kernel geometry rejected: Hq={Hq}, "
                         f"Hkv={Hkv}, D={D} (needs D in {HEAD_DIMS}, Hq / Hkv "
                         f"dividing {FOLD_ROWS}); take the plain ring "
                         "(ops/ring_attention.ring_causal_attention)")
    _check(q_pos, "q_pos", torch.int32, 2, dev)
    _check(kv_pos, "kv_pos", torch.int32, 2, dev)
    _check(out, "out", torch.bfloat16, 4, dev)
    m, l, acc = state
    _check(m, "m", torch.float32, 3, dev)
    _check(l, "l", torch.float32, 3, dev)
    _check(acc, "acc", torch.float32, 4, dev)
    if (q_pos.shape != (B, Tq) or kv_pos.shape != (B, Tk)
            or m.shape != (B, Hq, Tq) or l.shape != m.shape
            or acc.shape != q_scaled.shape or out.shape != q_scaled.shape):
        raise ValueError("positions, state and out do not match q and k")
    if quant:
        _check(k_scale, "k_scale", torch.float32, 3, dev)
        _check(v_scale, "v_scale", torch.float32, 3, dev)
        if k_scale.shape != (B, Tk, Hkv) or v_scale.shape != k_scale.shape:
            raise ValueError("scales must be [B, Tk, Hkv]")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tail = (kv_pos.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                out.data_ptr(), B, Tq, Tk, Hq, Hkv, D, float(soft_cap or 0.0),
                int(first), int(last), stream)
        if quant:
            err = lib.dtt_ring_fold_int8(
                q_scaled.data_ptr(), q_pos.data_ptr(), k.data_ptr(),
                v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), *tail)
        else:
            err = lib.dtt_ring_fold_bf16(
                q_scaled.data_ptr(), q_pos.data_ptr(), k.data_ptr(),
                v.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"ring fold kernel launch failed: CUDA error {err}")
    if quant:
        ring_flash_attention.launches_int8 += 1
    else:
        ring_flash_attention.launches += 1


def ring_flash_attention(
    ring,                                # parallel.mesh.SpRing
    q: Sequence[torch.Tensor],           # per rank [B, T_loc, Hq, D]
    k: Sequence[torch.Tensor],           # per rank [B, T_loc, Hkv, D]
    v: Sequence[torch.Tensor],
    q_positions: Sequence[torch.Tensor],  # per rank [B, T_loc]
    kv_positions: Optional[Sequence[torch.Tensor]] = None,
    *,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    k_scale: Optional[Sequence[torch.Tensor]] = None,  # [B, T_loc, Hkv] f32
    v_scale: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Causal attention over the ring's sequence shards: rank r's tensors
    lie on `ring.devices[r]` and were made on its compute stream; the
    outputs come back the same way, `[B, T_loc, Hq, D]` in q's dtype.
    `launches` / `launches_int8` count the fold launches (sp per rank)."""
    sp = ring.sp
    if not (len(q) == len(k) == len(v) == len(q_positions) == sp):
        raise ValueError(f"need one shard per rank ({sp})")
    quant = k_scale is not None
    if kv_positions is None:
        kv_positions = q_positions
    if scale is None:
        scale = q[0].shape[-1] ** -0.5
    q_scaled, q_pos, blocks, states, outs, ready = [], [], [], [], [], []
    for r in range(sp):
        with ring.on(r):
            q_scaled.append((q[r].float() * scale).contiguous())
            q_pos.append(q_positions[r].to(torch.int32).contiguous())
            blk = (k[r].contiguous(), v[r].contiguous(),
                   kv_positions[r].to(torch.int32).contiguous())
            if quant:
                blk += (k_scale[r].contiguous(), v_scale[r].contiguous())
            blocks.append(blk)
            B, T, Hq, D = q[r].shape
            dev = q[r].device
            states.append((
                torch.empty((B, Hq, T), dtype=torch.float32, device=dev),
                torch.empty((B, Hq, T), dtype=torch.float32, device=dev),
                torch.empty((B, T, Hq, D), dtype=torch.float32, device=dev)))
            outs.append(torch.empty_like(q[r]))
        ready.append(ring.mark(r))
        if ring.cuda and sp > 1:
            for t in blk:  # read by the rank's copy stream at hop 0
                t.record_stream(ring.copy_streams[r])
    like = blocks[0]
    for hop in range(sp):
        for r in range(sp):
            if hop == 0:
                blk, arrived = blocks[r], ready[r]
            else:
                blk, arrived = ring.received(r, hop, like)
            if hop + 1 < sp:
                # Ship the next hop's block before the fold is queued.
                ring.send(r, hop, blk, arrived, like)
            with ring.on(r):
                if ring.cuda and hop > 0:
                    ring.stream(r).wait_event(arrived)
                ring_flash_fold(
                    states[r], q_scaled[r], q_pos[r], blk[0], blk[1], blk[2],
                    outs[r], first=hop == 0, last=hop == sp - 1,
                    soft_cap=soft_cap,
                    k_scale=blk[3] if quant else None,
                    v_scale=blk[4] if quant else None)
            ring.folded(r, hop, like)
    return outs


ring_flash_attention.launches = 0
ring_flash_attention.launches_int8 = 0


def _lib() -> ctypes.CDLL:
    from dynamo_tpu_torch.ops.cuda import build

    lib = build.load("ring_flash")
    fn = lib.dtt_ring_fold_bf16
    if fn.argtypes is None:
        tail = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + tail
        lib.dtt_ring_fold_int8.restype = ctypes.c_int
        lib.dtt_ring_fold_int8.argtypes = [ctypes.c_void_p] * 6 + tail
        lib.dtt_ring_fold_rows.restype = ctypes.c_int
        lib.dtt_ring_fold_rows.argtypes = []
        if lib.dtt_ring_fold_rows() != FOLD_ROWS:
            raise RuntimeError("ring_flash.cu and its wrapper disagree on "
                               "the CTA's query rows")
    return lib
