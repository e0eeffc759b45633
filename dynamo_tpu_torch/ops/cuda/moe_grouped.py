"""Grouped MoE expert FFN: the CUDA kernel's wrapper, its plain version and
the int8 expert-weight helpers (port of
`dynamo_tpu/ops/pallas/moe_grouped.py`).

`grouped_expert_ffn` launches `csrc/moe_grouped.cu` for CUDA tensors and
runs `grouped_expert_ffn_plain` for CPU tensors; there is no other
fallback.  The kernel groups up to `moe_group_tiles` consecutive tiles of
one expert so that their weights stream once.  Row tile t of `x_pad` runs
expert `tile_expert[t]`'s SwiGLU MLP with the TPU kernel's numerics: f32
accumulation, h and u rounded to x's dtype, the activation rounded before
the down product.  `tile_rows[t]` (live rows of tile t, 0 past the last
expert span) lets the kernel skip dead rows and tiles; those rows come
back as zeros, which is what the zero padding rows compute anyway.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

DEFAULT_BLOCK_ROWS = 64
# The kernel's tile: 64 rows by 64 output columns (csrc/moe_grouped.cu
# kBM / kBN, checked against the library when it is loaded).
KERNEL_ROWS = 64
KERNEL_COLS = 64
# Most tiles of one expert a CTA of the kernel takes at once (one
# warpgroup a tile, sharing each weight stage): the kernel's kWG choices.
GROUP_TILES = (1, 4)


def moe_group_tiles(n_tiles: int, num_experts: int) -> int:
    """The kernel's group width for a call, a pure function of its shapes:
    1 while the tiles average at most two an expert (decode-size calls, one
    partial tile an expert), else 4 (four warpgroups, a tile each), so that
    an expert's weights cross HBM once per 256 rows."""
    return GROUP_TILES[0] if n_tiles <= 2 * num_experts else GROUP_TILES[1]


def moe_grouped_geometry_ok(hidden: int, intermediate: int,
                            dtype: torch.dtype = torch.bfloat16,
                            block_rows: int = DEFAULT_BLOCK_ROWS) -> bool:
    """The CUDA kernel's eligibility rule, shared by every auto-selection
    site: bf16 activations, 64-row tiles, and H and F multiples of the
    kernel's 64-column blocks."""
    return (dtype == torch.bfloat16 and block_rows == KERNEL_ROWS
            and hidden % KERNEL_COLS == 0 and intermediate % KERNEL_COLS == 0)


def _expert_weight(w: torch.Tensor, scale: Optional[torch.Tensor], e: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Expert e's weight in f32 for the plain products; int8 weights are
    dequantised as `dequantize_moe_params` does (rounded to `dtype`)."""
    if scale is None:
        return w[e].float()
    return (w[e].float() * scale[e][None, :]).to(dtype).float()


def _check_scales(w_gate, scales) -> bool:
    quant = scales[0] is not None
    if any((s is not None) != quant for s in scales):
        raise ValueError("pass all three weight scales or none")
    if quant and w_gate.dtype != torch.int8:
        raise ValueError(f"scales imply int8 weights; got {w_gate.dtype}")
    return quant


def grouped_expert_ffn_plain(
    x_pad: torch.Tensor,         # [S_pad, H]
    tile_expert: torch.Tensor,   # [S_pad // block_rows] int32
    w_gate: torch.Tensor,        # [E, H, F]
    w_up: torch.Tensor,          # [E, H, F]
    w_down: torch.Tensor,        # [E, F, H]
    *,
    tile_rows: Optional[torch.Tensor] = None,
    w_gate_scale: Optional[torch.Tensor] = None,
    w_up_scale: Optional[torch.Tensor] = None,
    w_down_scale: Optional[torch.Tensor] = None,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """A loop over row tiles of plain f32 matrix products; [S_pad, H] in
    x's dtype.  Rows at or past `tile_rows[t]` are zeros (every row when
    tile_rows is None)."""
    scales = (w_gate_scale, w_up_scale, w_down_scale)
    _check_scales(w_gate, scales)
    S_pad, _ = x_pad.shape
    if S_pad % block_rows:
        raise ValueError(f"S_pad={S_pad} must be a block_rows={block_rows} multiple")
    dt = x_pad.dtype
    n_tiles = S_pad // block_rows
    experts = tile_expert.tolist()
    rows = (tile_rows.tolist() if tile_rows is not None
            else [block_rows] * n_tiles)
    out = torch.zeros_like(x_pad)
    held = (None, None)  # (expert, its f32 weights): tiles of one expert reuse them
    for t in range(n_tiles):
        n = min(int(rows[t]), block_rows)
        if n <= 0:
            continue
        e = int(experts[t])
        if held[0] != e:
            held = (e, [_expert_weight(w, s, e, dt) for w, s in
                        zip((w_gate, w_up, w_down), scales)])
        wg, wu, wd = held[1]
        r0 = t * block_rows
        x = x_pad[r0: r0 + n].float()
        h = (x @ wg).to(dt)
        u = (x @ wu).to(dt)
        act = F.silu(h) * u
        out[r0: r0 + n] = (act.float() @ wd).to(dt)
    return out


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def grouped_expert_ffn(
    x_pad: torch.Tensor,         # [S_pad, H] expert-sorted, group-padded rows
    tile_expert: torch.Tensor,   # [S_pad // block_rows] int32 tile -> expert
    w_gate: torch.Tensor,        # [E, H, F] (bf16, or int8 with scales)
    w_up: torch.Tensor,          # [E, H, F]
    w_down: torch.Tensor,        # [E, F, H]
    *,
    tile_rows: Optional[torch.Tensor] = None,     # [n_tiles] int32 live rows
    w_gate_scale: Optional[torch.Tensor] = None,  # [E, F] f32 (int8 weights)
    w_up_scale: Optional[torch.Tensor] = None,    # [E, F] f32
    w_down_scale: Optional[torch.Tensor] = None,  # [E, H] f32
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """Ragged grouped expert FFN; [S_pad, H] in x's dtype.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (bf16 x, bf16 or int8 weights, `moe_grouped_geometry_ok`) or raise."""
    kw = dict(tile_rows=tile_rows, w_gate_scale=w_gate_scale,
              w_up_scale=w_up_scale, w_down_scale=w_down_scale,
              block_rows=block_rows)
    if x_pad.device.type == "cpu":
        return grouped_expert_ffn_plain(x_pad, tile_expert, w_gate, w_up,
                                        w_down, **kw)
    if x_pad.device.type != "cuda":
        raise ValueError(f"no grouped MoE kernel for device {x_pad.device}")
    quant = _check_scales(w_gate, (w_gate_scale, w_up_scale, w_down_scale))
    dev = x_pad.device
    S_pad, H = x_pad.shape
    E, _, Fi = w_gate.shape
    if S_pad % block_rows:
        raise ValueError(f"S_pad={S_pad} must be a block_rows={block_rows} multiple")
    if not moe_grouped_geometry_ok(H, Fi, x_pad.dtype, block_rows):
        raise ValueError(
            f"the grouped MoE kernel needs bf16 x, block_rows == "
            f"{KERNEL_ROWS} and H, F multiples of {KERNEL_COLS}; got "
            f"{x_pad.dtype}, block_rows={block_rows}, H={H}, F={Fi} (use "
            "moe_mode='dense' for this geometry)")
    n_tiles = S_pad // block_rows
    if tile_rows is None:
        tile_rows = torch.full((n_tiles,), block_rows, dtype=torch.int32,
                               device=dev)
    wdt = torch.int8 if quant else torch.bfloat16
    _check(x_pad, "x_pad", torch.bfloat16, (S_pad, H), dev)
    _check(tile_expert, "tile_expert", torch.int32, (n_tiles,), dev)
    _check(tile_rows, "tile_rows", torch.int32, (n_tiles,), dev)
    _check(w_gate, "w_gate", wdt, (E, H, Fi), dev)
    _check(w_up, "w_up", wdt, (E, H, Fi), dev)
    _check(w_down, "w_down", wdt, (E, Fi, H), dev)
    if quant:
        _check(w_gate_scale, "w_gate_scale", torch.float32, (E, Fi), dev)
        _check(w_up_scale, "w_up_scale", torch.float32, (E, Fi), dev)
        _check(w_down_scale, "w_down_scale", torch.float32, (E, H), dev)
    lib = _lib()
    out = torch.empty_like(x_pad)
    if n_tiles == 0:
        return out
    act = torch.empty((S_pad, Fi), dtype=torch.bfloat16, device=dev)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    err = lib.dtt_moe_grouped(
        x_pad.data_ptr(), tile_expert.data_ptr(), tile_rows.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        ptr(w_gate_scale), ptr(w_up_scale), ptr(w_down_scale),
        act.data_ptr(), out.data_ptr(), n_tiles, H, Fi, int(quant),
        moe_group_tiles(n_tiles, E), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"moe_grouped kernel launch failed: CUDA error {err}")
    grouped_expert_ffn.launches += 1
    return out


grouped_expert_ffn.launches = 0


def _lib() -> ctypes.CDLL:
    from dynamo_tpu_torch.ops.cuda import build

    lib = build.load("moe_grouped")
    fn = lib.dtt_moe_grouped
    if fn.argtypes is None:
        # Both return a plain int, ctypes' default.
        if (lib.dtt_moe_grouped_rows(), lib.dtt_moe_grouped_cols()) != (
                KERNEL_ROWS, KERNEL_COLS):
            raise RuntimeError(
                "moe_grouped library tile does not match the wrapper")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    return lib


# -- int8 expert weights (static structure branch, as in the JAX package) --


def moe_params_quantized(p_moe: dict) -> bool:
    """Quantized expert params carry sibling `*_scale` entries."""
    return "w_gate_scale" in p_moe


def quantize_moe_params(p_moe: dict) -> dict:
    """int8-quantize the expert weights per expert and output column
    (absmax over the contraction dim), keeping the router as it is.
    Returns a new dict with int8 `w_gate`/`w_up`/`w_down` and f32
    `*_scale` siblings ([E, out])."""
    out = {"router": p_moe["router"]}
    for name in ("w_gate", "w_up", "w_down"):
        w = p_moe[name].float()                                  # [E, in, out]
        scale = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-8)
        out[name] = torch.round(w / scale[:, None, :]).to(torch.int8)
        out[name + "_scale"] = scale
    return out


def dequantize_moe_params(p_moe: dict, dtype: torch.dtype) -> dict:
    """The inverse (the oracle path): f32 value times its column scale,
    rounded to `dtype` — what the kernel does in its shared tiles."""
    out = {"router": p_moe["router"]}
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = (p_moe[name].float()
                     * p_moe[name + "_scale"][:, None, :]).to(dtype)
    return out
