"""K1 at the head geometries of Phi-2 / Phi-3-mini and of many query heads
a kv head, on the CPU.

`csrc/paged_decode.cu` takes head dims 80 and 96 and any number G of
query heads a kv head: G splits into 16-row query tiles (one up to 16,
two up to 32, else four, with a CTA for each 64), and the 4 warps of a
CTA split (query tile, keys): each owns one query tile and 16 kQT keys of
every 64-key tile, which it takes as kQT slices of 16 keys with its own
online softmax; the warps of a query tile merge in f32 at the end.  The
kernel runs only on the card, so `tile_decode_model` repeats that
partition in plain torch (each probability rounded to bf16 against its
warp's running max after the slice), and the tests hold it and the
port's plain version against JAX's jnp oracle (`kv_cache.gather_kv` /
`gather_kv_quant` + `ops.attention.paged_attention`, fed the query
scaled and rounded as the kernels round it) and against JAX's
`paged_decode_attention` (Pallas, interpret mode, as
tests/test_torch_kernels.py runs it), bf16 and int8 caches, at one bf16
unit of the output (|x| < 4 here, so 2**-6), as
tests/test_torch_decode_split.py does at the older geometry.  The
wrapper's geometry gate takes these shapes and refuses what the build
has not.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_cache as jkvc
from dynamo_tpu.ops.attention import paged_attention as jax_attention
from dynamo_tpu.ops.pallas import paged_decode_attention as jax_decode
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.ops.cuda import paged_decode_attention_plain
from dynamo_tpu_torch.ops.cuda.paged_attention import (
    KERNEL_HEAD_DIMS,
    check_decode_geometry,
    gather_context,
)

TOL = 2.0 ** -6
KNEG = -1e30
TILE, WARPS, SLICE, ROWS = 64, 4, 16, 16
CTX, BS = 160, 16
LENS = [160, 0, 1, 63, 65, 100]

# (Hq, Hkv, D): Phi-2's D 80, Phi-3-mini's D 96, then G 24, 32 and 72
# (two and four query tiles, and a second CTA of four).
GEOMS = [(32, 8, 80), (32, 4, 96), (24, 1, 128), (32, 1, 128), (144, 2, 64)]


def query_tiles(G: int) -> int:
    return 1 if G <= ROWS else 2 if G <= 2 * ROWS else 4


def tile_decode_model(q_scaled, k_ctx, v_ctx, seq_lens, soft_cap=None):
    """K1's arithmetic at any G: q_scaled [B, Hq, D] (bf16), context
    [B, C, Hkv, D] (bf16); every query row goes through the kWq = 4 / kQT
    warps of its query tile, warp w taking keys (16 kQT) w + 16 j + 0..15
    of each tile for j = 0 .. kQT-1 in turn; [B, Hq, D] bf16."""
    B, Hq, _ = q_scaled.shape
    C, Hkv = k_ctx.shape[1], k_ctx.shape[2]
    G = Hq // Hkv
    qt = query_tiles(G)
    warps, own = WARPS // qt, TILE // (WARPS // qt)
    qf = q_scaled.float().reshape(B, Hkv, G, -1)
    kf = k_ctx.float().permute(0, 2, 1, 3)
    vf = v_ctx.float().permute(0, 2, 1, 3)
    k_end = seq_lens.long()
    shape = (warps, B, Hkv, G)
    m = torch.full(shape, KNEG)
    l = torch.zeros(shape)
    o = torch.zeros(shape + (qf.shape[-1],))
    for t in range(-(-int(k_end.max()) // TILE)):
        for w in range(warps):
            for js in range(qt):
                pos = t * TILE + own * w + SLICE * js + torch.arange(SLICE)
                valid = pos[None, :] < k_end[:, None]
                idx = pos.clamp(max=C - 1)
                sc = torch.einsum("bhgd,bhkd->bhgk", qf, kf[:, :, idx])
                if soft_cap:
                    sc = soft_cap * torch.tanh(sc / soft_cap)
                v4 = valid[:, None, None, :]
                sc = torch.where(v4, sc, torch.tensor(KNEG))
                m_new = torch.maximum(m[w], sc.amax(-1))
                alpha = torch.exp(m[w] - m_new)
                p = torch.where(v4, torch.exp(sc - m_new[..., None]),
                                torch.zeros(()))
                l[w] = l[w] * alpha + p.sum(-1)
                pv = torch.einsum("bhgk,bhkd->bhgd",
                                  p.to(torch.bfloat16).float(), vf[:, :, idx])
                o[w] = o[w] * alpha[..., None] + pv
                m[w] = m_new
    f = torch.exp(m - m.amax(0))
    out = (o * f[..., None]).sum(0) / torch.clamp((l * f).sum(0),
                                                  min=1e-30)[..., None]
    return out.reshape(B, Hq, -1).to(torch.bfloat16)


def _bf16_pair(arr):
    a = arr.astype(ml_dtypes.bfloat16)
    return (jnp.asarray(a),
            torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16))


def _inputs(hq, hkv, d, quant, seed=0):
    rng = np.random.default_rng(seed)
    B, P = len(LENS), CTX // BS
    nblocks = 1 + B * P
    S = nblocks * BS
    jq, tq = _bf16_pair(rng.standard_normal((B, hq, d)))
    pages = rng.permutation(nblocks - 1)[: B * P].reshape(B, P) + 1
    for i, n in enumerate(LENS):
        pages[i, -(-n // BS):] = 0
    bt, sl = pages.astype(np.int32), np.asarray(LENS, np.int32)
    if quant:
        (tk, tks), (tv, tvs) = [kvc.quantize_kv_rows(
            torch.from_numpy(rng.standard_normal((S, hkv * d))).float(), hkv)
            for _ in range(2)]
        jk, jv, jks, jvs = (jnp.asarray(t.numpy()) for t in (tk, tv, tks, tvs))
        return ((jq, jk, jv, {"k_scale": jks, "v_scale": jvs}),
                (tq, tk, tv, {"k_scale": tks, "v_scale": tvs}), bt, sl)
    jk, tk = _bf16_pair(rng.standard_normal((S, hkv * d)))
    jv, tv = _bf16_pair(rng.standard_normal((S, hkv * d)))
    return (jq, jk, jv, {}), (tq, tk, tv, {}), bt, sl


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,hkv,d", GEOMS)
def test_plain_and_tile_model_match_jax(hq, hkv, d, quant):
    soft_cap = 5.0 if d == 96 else None
    (jq, jk, jv, jsc), (tq, tk, tv, tsc), bt, sl = _inputs(hq, hkv, d, quant)
    want = np.asarray(jax_decode(jq, jk, jv, jnp.asarray(bt), jnp.asarray(sl),
                                 block_size=BS, soft_cap=soft_cap,
                                 interpret=True, **jsc)).astype(np.float32)
    # The jnp oracle: JAX's gather and attention over the whole context.
    jpos = jnp.broadcast_to(jnp.arange(CTX), (len(LENS), CTX))
    jslots = jkvc.slots_for_positions(jnp.asarray(bt), jpos, BS)
    if quant:
        jk_ctx, jv_ctx = jkvc.gather_kv_quant(
            jk, jv, jsc["k_scale"], jsc["v_scale"], jslots, hkv)
    else:
        jk_ctx, jv_ctx = jkvc.gather_kv(jk, jv, jslots, hkv)
    jq_scaled = (jq.astype(jnp.float32) * d ** -0.5).astype(jk_ctx.dtype)
    oracle = np.asarray(jax_attention(
        jq_scaled[:, None], jk_ctx, jv_ctx, jnp.asarray(sl - 1)[:, None],
        jpos, jnp.asarray(sl), scale=1.0, soft_cap=soft_cap)[:, 0]
    ).astype(np.float32)
    live = sl > 0           # the oracle leaves empty rows undefined
    bt_t, sl_t = torch.from_numpy(bt), torch.from_numpy(sl)
    plain = paged_decode_attention_plain(
        tq, tk, tv, bt_t, sl_t, block_size=BS, soft_cap=soft_cap, **tsc)
    assert plain.dtype == torch.bfloat16 and plain.shape == tq.shape
    np.testing.assert_allclose(plain.float().numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(plain.float().numpy()[live], oracle[live],
                               rtol=0, atol=TOL)
    ctx_pos = torch.arange(CTX).expand(len(LENS), CTX)
    slots = kvc.slots_for_positions(bt_t, ctx_pos, BS)
    k_ctx, v_ctx, q_scaled = gather_context(
        tq, tk, tv, tsc.get("k_scale"), tsc.get("v_scale"), slots, hkv,
        d ** -0.5, quant)
    got = tile_decode_model(q_scaled, k_ctx, v_ctx, sl_t, soft_cap).float()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy()[live], oracle[live], rtol=0,
                               atol=TOL)
    assert not got[LENS.index(0)].any()


def test_tile_partition_covers_every_key_once():
    """For each G, the (warp, slice) pairs of a query tile cover the 64
    keys of a tile exactly once."""
    for G in (1, 8, 16, 17, 24, 32, 33, 64, 72):
        qt = query_tiles(G)
        warps, own = WARPS // qt, TILE // (WARPS // qt)
        keys = sorted(own * w + SLICE * js + k for w in range(warps)
                      for js in range(qt) for k in range(SLICE))
        assert keys == list(range(TILE))
        assert warps * qt == WARPS


def test_wrapper_gate_takes_the_new_geometry():
    assert {80, 96} <= set(KERNEL_HEAD_DIMS)
    for hq, hkv, d in GEOMS + [(71, 1, 64), (8, 8, 16), (16, 2, 256)]:
        check_decode_geometry(hq, hkv, d)
    with pytest.raises(ValueError, match="head dim 112"):
        check_decode_geometry(32, 8, 112)
    with pytest.raises(ValueError, match="bad geometry"):
        check_decode_geometry(30, 4, 64)
