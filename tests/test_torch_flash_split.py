"""A CPU model of the ring fold kernel's split arithmetic
(`dynamo_tpu_torch/csrc/ring_flash.cu` on `csrc/flash_tile.cuh`).

The kernel runs both products of the fold on the bf16 tensor cores with
f32 accumulation.  Its contract is f32 (q arrives scaled in f32, the
plain version widens K/V to f32), but K and V are exactly bf16, so it
splits each f32 operand x into bf16 halves hi = bf16(x), lo = bf16(x -
hi) and multiplies both: Q.K^T = Q_hi.K^T + Q_lo.K^T, P.V = P_hi.V +
P_lo.V.  `kernel_fold` below repeats that arithmetic in plain torch: the
halves, f32 sums, 64-key tiles with the online softmax between them, and
the output rounded to bf16 once.  The tests hold it, over a ring of 4
shards, against the port's plain ring (`ops/ring_attention.py`) and
against the JAX package's `ring_causal_attention` (XLA on the CPU, one
shard: the same function) with the limits `chip_smoke.py` holds the
kernel to on the card (RING_ATOL + RTOL * |x| per element, RING_ROW_TOL
per output row), so the tolerance is fixed before the card sees it.  A
single bf16 pass misses those limits at D 128, and at D 64 (scale 1/8, a
power of two) the lo half of a bf16 q is exactly zero, which is why the
kernel runs QK^T once there.

Inputs are numpy-seeded bf16 values at `tiny-test` widths and at Hq 32 /
Hkv 8 with D 64 and 128, bf16 and int8 blocks, soft cap on and off; row
1 is a shorter prompt padded at a pad position with one query at
position -1, which sees no key (the junk-but-finite row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RING_ATOL, RING_ROW_TOL, RTOL
from dynamo_tpu.ops.ring_attention import (
    ring_causal_attention as jax_ring_causal_attention,
)
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.ops.ring_attention import NEG, ring_causal_attention

KEYS = 64        # keys of a kernel tile
SP = 4
PAD = 8192       # a pad position: past every real key
WIDTHS = {"tiny-test": (8, 4, 16), "llama-3-1b": (32, 8, 64),
          "mixtral-8x7b": (32, 8, 128)}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def kernel_fold(state, q_scaled, q_pos, k, v, kv_pos, soft_cap=None,
                k_scale=None, v_scale=None, split=True):
    """One launch of the fold kernel in plain torch: the state `(m, l,
    acc)` as `ops/ring_attention.ring_fold` keeps it, folded over the
    visiting block in 64-key tiles with bf16 operands and f32 sums; with
    `split` both products also take their lo halves."""
    m, l, acc = state
    B, T, Hq, D = q_scaled.shape
    C, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if k_scale is not None:          # round_bf16(q8 * scale), as the kernel
        k = kvc.dequantize_rows(k, k_scale)
        v = kvc.dequantize_rows(v, v_scale)
    kf, vf = k.float(), v.float()
    q_hi = _bf16(q_scaled)
    q_lo = _bf16(q_scaled - q_hi)
    q_hi, q_lo = (x.reshape(B, T, Hkv, G, D) for x in (q_hi, q_lo))
    m = m.reshape(B, Hkv, G, T, 1)
    l = l.reshape(B, Hkv, G, T, 1)
    acc = acc.reshape(B, T, Hkv, G, D)
    for t0 in range(0, C, KEYS):
        kt, vt = kf[:, t0:t0 + KEYS], vf[:, t0:t0 + KEYS]
        s = torch.einsum("btkgd,bckd->bkgtc", q_hi, kt)
        if split:
            s = s + torch.einsum("btkgd,bckd->bkgtc", q_lo, kt)
        if soft_cap is not None:
            s = soft_cap * torch.tanh(s / soft_cap)
        mask = kv_pos[:, None, t0:t0 + KEYS] <= q_pos[:, :, None]
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        p_hi = _bf16(p)
        pv = torch.einsum("bkgtc,bckd->btkgd", p_hi, vt)
        if split:
            pv = pv + torch.einsum("bkgtc,bckd->btkgd", _bf16(p - p_hi), vt)
        acc = acc * alpha.permute(0, 3, 1, 2, 4) + pv
        m = m_new
    return (m.reshape(B, Hq, T), l.reshape(B, Hq, T), acc.reshape(B, T, Hq, D))


def kernel_ring(q, k, v, q_pos, kv_pos, soft_cap=None, k_scale=None,
                v_scale=None, split=True):
    """The ring of `ops/cuda/ring_attention.ring_flash_attention` over SP
    shards of the whole sequence, each hop one `kernel_fold`; [B, T, Hq,
    D] bf16."""
    D = q.shape[-1]

    def cut(x):
        return None if x is None else list(x.chunk(SP, dim=1))

    qs, ks, vs, qp, kp = (cut(x) for x in (q, k, v, q_pos, kv_pos))
    kss, vss = cut(k_scale), cut(v_scale)
    outs = []
    for r in range(SP):
        q_scaled = qs[r].float() * D ** -0.5
        B, T, Hq, _ = q_scaled.shape
        st = (torch.full((B, Hq, T), NEG), torch.zeros(B, Hq, T),
              torch.zeros(B, T, Hq, D))
        for hop in range(SP):
            j = (r - hop) % SP          # the block rank r holds at this hop
            st = kernel_fold(st, q_scaled, qp[r], ks[j], vs[j], kp[j],
                             soft_cap, kss and kss[j], vss and vss[j], split)
        _, l, acc = st
        outs.append(acc / torch.clamp_min(l, 1e-30).permute(0, 2, 1)[..., None])
    return torch.cat(outs, dim=1).to(torch.bfloat16)


def _inputs(width, T, int8, seed):
    Hq, Hkv, D = WIDTHS[width]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, T, h, D)).astype(
        np.float32)).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    kv_pos = torch.arange(T, dtype=torch.int32).repeat(2, 1)
    kv_pos[1, T - T // 3:] = PAD
    q_pos = kv_pos.clone()
    q_pos[1, 5] = -1
    scales = {}
    if int8:
        (k, ks), (v, vs) = (kvc.quantize_kv_rows(x.reshape(2 * T, Hkv * D), Hkv)
                            for x in (k, v))
        k, v = k.reshape(2, T, Hkv, D), v.reshape(2, T, Hkv, D)
        scales = {"k_scale": ks.reshape(2, T, Hkv),
                  "v_scale": vs.reshape(2, T, Hkv)}
    return q, k, v, q_pos, kv_pos, scales


def _plain_ring(q, k, v, q_pos, kv_pos, soft_cap, scales):
    def cut(x):
        return [c.contiguous() for c in x.chunk(SP, dim=1)]

    sc = {n: cut(t) for n, t in scales.items()}
    return torch.cat(ring_causal_attention(cut(q), cut(k), cut(v), cut(q_pos),
                                           cut(kv_pos), soft_cap=soft_cap,
                                           **sc), dim=1)


def _jax_ring(q, k, v, q_pos, kv_pos, soft_cap, scales):
    j = {n: jnp.asarray(t.numpy()) for n, t in scales.items()}
    kv = [jnp.asarray(x.numpy()) if x.dtype == torch.int8
          else jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (k, v)]
    out = jax_ring_causal_attention(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16), *kv,
        jnp.asarray(q_pos.numpy()), jnp.asarray(kv_pos.numpy()),
        soft_cap=soft_cap, **j)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _readings(out, ref):
    """The smallest atol that passes under RTOL, and the largest row error
    relative to the reference row (chip_smoke.closeness's two checks)."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    need = ((o - r).abs() - RTOL * r.abs()).max().clamp(min=0).item()
    r_norm, e_norm = r.norm(dim=1), (o - r).norm(dim=1)
    return need, (e_norm / r_norm).max().item()


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("width,T", [("tiny-test", 256), ("llama-3-1b", 512),
                                     ("mixtral-8x7b", 512)])
def test_split_fold_meets_the_ring_limits(width, T, int8, cap):
    q, k, v, q_pos, kv_pos, scales = _inputs(width, T, int8, seed=T + int8)
    got = kernel_ring(q, k, v, q_pos, kv_pos, cap, **scales)
    assert torch.isfinite(got.float()).all()
    for ref in (_plain_ring(q, k, v, q_pos, kv_pos, cap, scales),
                _jax_ring(q, k, v, q_pos, kv_pos, cap, scales)):
        need, row = _readings(got, ref)
        assert need <= RING_ATOL and row <= RING_ROW_TOL, (need, row)


@pytest.mark.parametrize("int8", [False, True])
def test_one_bf16_pass_misses_the_limits_at_d128(int8):
    """The same fold with bf16 Q and P and no lo halves: the split is what
    keeps the kernel inside its limits."""
    q, k, v, q_pos, kv_pos, scales = _inputs("mixtral-8x7b", 512, int8, seed=7)
    got = kernel_ring(q, k, v, q_pos, kv_pos, None, split=False, **scales)
    need, row = _readings(got, _plain_ring(q, k, v, q_pos, kv_pos, None, scales))
    assert need > RING_ATOL or row > RING_ROW_TOL, (need, row)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_q_lo_is_zero_only_at_power_of_two_scales(width):
    """q * D^-0.5 of a bf16 q is bf16 when D^-0.5 is a power of two (D 16,
    64): Q's lo half is zero and the kernel runs QK^T once.  At D 128 it
    is not."""
    q, *_ = _inputs(width, 64, False, seed=3)
    D = q.shape[-1]
    q_scaled = q.float() * D ** -0.5
    lo = _bf16(q_scaled - _bf16(q_scaled))
    if D == 128:
        assert lo.abs().max().item() > 0
    else:
        assert lo.abs().max().item() == 0
