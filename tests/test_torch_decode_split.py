"""The arithmetic of the redesigned CUDA kernels, on the CPU.

K1 (`csrc/paged_decode.cu`) runs one CTA per (row, kv head), and inside a
CTA each of 4 warps keeps its own online softmax over 16 keys of every
64-key tile; the warps' states merge in f32 at the end.  The CUDA kernel
runs only on the card, so `warp_decode_model` below repeats that
partition and that merge in plain torch, with each probability rounded to
bf16 against its own warp's running max, and the tests hold it against
JAX's `paged_decode_attention` (Pallas, interpret mode, as
tests/test_torch_kernels.py runs it) and the port's plain version.

Tolerance: one bf16 unit in the last place of the output (|x| < 4 here,
so 2**-6), as tests/test_torch_kernels.py: both sides round the scaled
query and the probabilities to bf16, at different maxima.

Also here: the int8 widening both kernels use (a byte permute into the
mantissa of 2**23, for all 256 values), and a model of K3's grouping of
row tiles (`run_groups` in `csrc/moe_grouped.cu`: every live tile in
exactly one group) on the tiles the port's MoE routing gives.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas import paged_decode_attention as jax_decode
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops.cuda import paged_decode_attention_plain
from dynamo_tpu_torch.ops.cuda.moe_grouped import KERNEL_ROWS, moe_group_tiles
from dynamo_tpu_torch.ops.cuda.paged_attention import gather_context
from dynamo_tpu_torch.ops.moe import expert_tiles, router_topk

TOL = 2.0 ** -6
KNEG = -1e30          # the kernel's finite mask fill
TILE, WARPS = 64, 4   # keys of a tile, warps of a CTA (16 keys each)

# tiny-test's attention geometry: 160 keys a row (three 64-key tiles, the
# last partial); rows of 160 (full), 0, 1, 63, 64, 65 and 100 keys.
CFG = get_config("tiny-test")
HQ, HKV, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
CTX = 160
LENS = [160, 0, 1, 63, 64, 65, 100]


def warp_decode_model(q_scaled, k_ctx, v_ctx, seq_lens, soft_cap=None):
    """K1's arithmetic: q_scaled [B, Hq, D] (q * scale, bf16), the gathered
    context [B, C, Hkv, D] (bf16), 64-key tiles from key 0, warp w taking
    keys 16 w .. 16 w + 15 of each tile with its own running max (p
    rounded to bf16 against it for P . V, summed in f32), the warps merged
    in f32; [B, Hq, D] bf16 (zeros where seq_len is 0)."""
    B, Hq, _ = q_scaled.shape
    C, Hkv = k_ctx.shape[1], k_ctx.shape[2]
    G = Hq // Hkv
    qf = q_scaled.float().reshape(B, Hkv, G, -1)
    kf = k_ctx.float().permute(0, 2, 1, 3)             # [B, Hkv, C, D]
    vf = v_ctx.float().permute(0, 2, 1, 3)
    k_end = seq_lens.long()                            # [B]
    shape = (WARPS, B, Hkv, G)
    m = torch.full(shape, KNEG)
    l = torch.zeros(shape)
    o = torch.zeros(shape + (qf.shape[-1],))
    for t in range(-(-int(k_end.max()) // TILE)):
        for w in range(WARPS):
            pos = t * TILE + 16 * w + torch.arange(16)
            valid = pos[None, :] < k_end[:, None]           # [B, 16]
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
    ll, oo = (l * f).sum(0), (o * f[..., None]).sum(0)
    out = oo / torch.clamp(ll, min=1e-30)[..., None]
    return out.reshape(B, Hq, -1).to(torch.bfloat16)


def _bf16_pair(arr):
    a = arr.astype(ml_dtypes.bfloat16)
    return (jnp.asarray(a),
            torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16))


def _inputs(quant, BS, seed=0):
    """q, cache (bf16 or int8 + scales) as JAX and torch values, a table
    of shuffled pages of BS slots (null past each row's last page),
    seq_lens."""
    rng = np.random.default_rng(seed)
    B, P = len(LENS), CTX // BS
    nblocks = 1 + B * P
    S = nblocks * BS
    jq, tq = _bf16_pair(rng.standard_normal((B, HQ, D)))
    pages = rng.permutation(nblocks - 1)[: B * P].reshape(B, P) + 1
    for i, n in enumerate(LENS):
        pages[i, -(-n // BS):] = 0
    bt = pages.astype(np.int32)
    sl = np.asarray(LENS, np.int32)
    if quant:
        cache = []
        for _ in range(2):
            q8, s8 = kvc.quantize_kv_rows(
                torch.from_numpy(rng.standard_normal((S, HKV * D))).float(),
                HKV)
            cache.append((q8, s8))
        (tk, tks), (tv, tvs) = cache
        jk, jv, jks, jvs = (jnp.asarray(t.numpy()) for t in (tk, tv, tks, tvs))
        return ((jq, jk, jv, {"k_scale": jks, "v_scale": jvs}),
                (tq, tk, tv, {"k_scale": tks, "v_scale": tvs}), bt, sl)
    jk, tk = _bf16_pair(rng.standard_normal((S, HKV * D)))
    jv, tv = _bf16_pair(rng.standard_normal((S, HKV * D)))
    return (jq, jk, jv, {}), (tq, tk, tv, {}), bt, sl


def _model(t, bt, sl, BS, soft_cap):
    tq, tk, tv, sc = t
    bt_t, sl_t = torch.from_numpy(bt), torch.from_numpy(sl)
    ctx_pos = torch.arange(CTX).expand(len(LENS), CTX)
    slots = kvc.slots_for_positions(bt_t, ctx_pos, BS)
    k_ctx, v_ctx, q_scaled = gather_context(
        tq, tk, tv, sc.get("k_scale"), sc.get("v_scale"), slots, HKV,
        D ** -0.5, bool(sc))
    return warp_decode_model(q_scaled, k_ctx, v_ctx, sl_t, soft_cap=soft_cap)


@pytest.mark.parametrize("soft_cap", [None, 5.0])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("BS", [8, 16, 32])
def test_warp_model_matches_jax_kernel_and_plain(BS, quant, soft_cap):
    """Blocks of 8, 16 and 32 slots (a 64-key tile spans 8, 4 or 2 pages),
    bf16 and int8 caches, soft cap off and on."""
    j, t, bt, sl = _inputs(quant, BS)
    jq, jk, jv, jsc = j
    want = np.asarray(jax_decode(jq, jk, jv, jnp.asarray(bt), jnp.asarray(sl),
                                 block_size=BS, soft_cap=soft_cap,
                                 interpret=True, **jsc)).astype(np.float32)
    tq, tk, tv, tsc = t
    plain = paged_decode_attention_plain(
        tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(sl),
        block_size=BS, soft_cap=soft_cap, **tsc).float().numpy()
    got = _model(t, bt, sl, BS, soft_cap)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=0, atol=TOL)
    assert not got[LENS.index(0)].any()           # seq_len 0: exact zeros


def _byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s) on uint32 numpy arrays."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        (y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        sel = (s >> (4 * i)) & 0x7
        out |= pool[sel] << (8 * i)
    return out


def test_int8_widening_by_byte_permute_is_exact():
    """q8 ^ 0x80 placed in the low byte of 2**23's mantissa is 2**23 + 128
    + q8, so subtracting 8388736 gives q8 exactly, for all 256 values; times
    an f32 scale and rounded to bf16 it is kv_cache.dequantize_rows' value."""
    q = np.arange(-128, 128, dtype=np.int8)
    words = q.view(np.uint8).astype(np.uint32).reshape(-1, 4)
    packed = (words[:, 0] | words[:, 1] << 8 | words[:, 2] << 16
              | words[:, 3] << 24).astype(np.uint32)
    u = packed ^ np.uint32(0x80808080)
    got = np.stack([_byte_perm(u, np.full_like(u, 0x4B000000), 0x7650 + b)
                    for b in range(4)], axis=1).reshape(-1)
    f = got.view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, q.astype(np.float32))
    rng = np.random.default_rng(0)
    for scale in rng.uniform(1e-4, 1.0, 8).astype(np.float32):
        ours = (f * scale).astype(ml_dtypes.bfloat16).astype(np.float32)
        ref = kvc.dequantize_rows(
            torch.from_numpy(q.reshape(1, 1, -1)),
            torch.full((1, 1), float(scale)), torch.bfloat16)
        assert np.array_equal(ours, ref.float().numpy().reshape(-1))


def tile_groups(tile_expert, tile_rows, group_tiles: int) -> list:
    """A model of the kernel's grouping of the tiles (`run_groups`): a list
    of (lead tile, [live rows of each of the group's `group_tiles`
    tiles]).  A run is the consecutive live tiles of one expert; it is cut
    every `group_tiles` tiles from its first.  Dead tiles (0 live rows)
    belong to no group."""
    te = [int(x) for x in tile_expert]
    tr = [min(int(x), KERNEL_ROWS) for x in tile_rows]
    groups, first = [], 0
    for t, (e, r) in enumerate(zip(te, tr)):
        if r <= 0:
            continue
        if t == 0 or tr[t - 1] <= 0 or te[t - 1] != e:
            first = t
        if (t - first) % group_tiles:
            continue
        rows, same = [], True
        for w in range(group_tiles):
            tw = t + w
            same = same and tw < len(te) and te[tw] == e and tr[tw] > 0
            rows.append(tr[tw] if same else 0)
        groups.append((t, rows))
    return groups


def _routed_tiles(cfg, n_tokens, seed):
    gen = torch.Generator().manual_seed(seed)
    H, E = cfg.hidden_size, cfg.num_experts
    p = {"router": torch.randn(H, E, generator=gen) * H ** -0.5}
    x = torch.randn(n_tokens, H, generator=gen)
    ids, _ = router_topk(cfg, p, x)
    _, _, S_pad, te, tr, counts = expert_tiles(ids.reshape(-1), E, 64)
    return te.tolist(), tr.tolist(), S_pad // 64, counts.tolist()


@pytest.mark.parametrize("model,n_tokens", [
    ("tiny-moe", 5), ("tiny-moe", 40), ("tiny-moe", 300),
    ("mixtral-8x7b", 8), ("mixtral-8x7b", 64), ("mixtral-8x7b", 512)])
def test_moe_tile_groups_cover_every_live_tile_once(model, n_tokens):
    cfg = get_config(model)
    E = cfg.num_experts
    te, tr, n_tiles, counts = _routed_tiles(cfg, n_tokens, seed=n_tokens)
    width = moe_group_tiles(n_tiles, E)
    assert width == (1 if n_tiles <= 2 * E else 4)
    if model == "mixtral-8x7b":
        assert width == (4 if n_tokens == 512 else 1)
    groups = tile_groups(te, tr, width)
    covered = []
    for lead, rows in groups:
        assert len(rows) == width and rows[0] > 0
        for w, r in enumerate(rows):
            if r:
                assert te[lead + w] == te[lead] and r == tr[lead + w]
                covered.append(lead + w)
    live = [t for t in range(n_tiles) if tr[t] > 0]
    assert sorted(covered) == live and len(set(covered)) == len(covered)
    # An expert of n tiles makes ceil(n / width) groups; one with no rows
    # makes none.
    per_expert = {}
    for lead, _ in groups:
        per_expert[te[lead]] = per_expert.get(te[lead], 0) + 1
    for e, c in enumerate(counts):
        tiles = -(-c // 64)
        assert per_expert.get(e, 0) == -(-tiles // width)
