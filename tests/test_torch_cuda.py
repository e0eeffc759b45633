"""The port's CUDA kernels (paged decode and prefill attention over bf16
and int8 caches, the grouped MoE expert FFN in bf16 and int8, the ring
attention flash fold over bf16 and int8 blocks) and engine on the card.

Every test here needs an NVIDIA GPU and skips without one.  The suite's
conftest imports JAX, which the GPU machine does not have, so run this
file on the card without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel tolerance (`chip_smoke.py` holds the kernels to the same rule):
- every element: |kernel - plain| <= 3e-2 and <= ATOL + RTOL * |plain|.
  RTOL * |x| is one to two bf16 units in the last place of x; ATOL covers
  outputs near zero, where the two versions' probability roundings (the
  plain version rounds normalised probabilities, the kernel unnormalised
  ones) do not cancel as the terms do;
- every output row (one token, one head): ||kernel - plain|| <= ROW_TOL *
  ||plain||, and exact zeros where the plain row is zero.  Rounding noise
  averages out over a row; a lost or extra token does not.
"""

import os

import pytest
import torch

from dynamo_tpu_torch.ops.cuda import (
    grouped_expert_ffn,
    grouped_expert_ffn_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    quantize_moe_params,
    ring_flash_attention,
    ring_flash_fold,
)
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.ops.moe import expert_tiles
from dynamo_tpu_torch.ops.ring_attention import ring_causal_attention
from dynamo_tpu_torch.parallel import SpRing, make_sp_prefill_step

pytestmark = pytest.mark.cuda
ABS_TOL = 3e-2
RTOL = 2.0 ** -7
ATOL = 8e-3
ROW_TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _assert_close(out, ref):
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    diff = (o - r).abs()
    assert diff.max().item() <= ABS_TOL
    need = (diff - RTOL * r.abs()).max().clamp(min=0).item()
    assert need <= ATOL, f"kernel vs plain needs atol {need} > {ATOL}"
    r_norm, e_norm = r.norm(dim=1), (o - r).norm(dim=1)
    live = r_norm > 0
    assert not (e_norm[~live] > 0).any(), "rows the plain version zeroes"
    row = (e_norm[live] / r_norm[live]).max().item()
    assert row <= ROW_TOL, f"row-normalised error {row} > {ROW_TOL}"


def _rand(gen, *shape, dev):
    return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)


# D 80 and 96 (Phi-2, Phi-3-mini), and 24, 32 and 72 query heads a kv
# head (two and four query tiles, two CTAs a kv head).
WIDE_DECODE = [(32, 8, 80, 64, None), (32, 4, 96, 16, 30.0),
               (24, 1, 128, 64, None), (32, 1, 128, 64, None),
               (144, 2, 64, 64, None)]


@pytest.mark.parametrize("hq,hkv,d,bs,cap", [
    (32, 8, 64, 64, None), (32, 8, 64, 16, 30.0), (16, 16, 128, 32, None),
    (8, 2, 32, 8, None), (32, 4, 128, 64, None), (32, 8, 128, 64, None)]
    + WIDE_DECODE)
def test_decode_kernel_matches_plain(dev, hq, hkv, d, bs, cap):
    gen = torch.Generator(device=dev).manual_seed(0)
    B, P = 9, 6
    nblocks = 1 + B * P
    kc = _rand(gen, nblocks * bs, hkv * d, dev=dev)
    vc = _rand(gen, nblocks * bs, hkv * d, dev=dev)
    q = _rand(gen, B, hq, d, dev=dev)
    bt = (torch.randperm(nblocks - 1, generator=gen, device=dev)[: B * P]
          + 1).reshape(B, P).to(torch.int32)
    lens = [P * bs, 0, 1, bs - 1, bs + 1, 3 * bs, 0, 2, P * bs - 3]
    for i, n in enumerate(lens):
        bt[i, -(-n // bs):] = 0
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kc, vc, bt, sl, block_size=bs, soft_cap=cap)
    ref = paged_decode_attention_plain(q, kc, vc, bt, sl, block_size=bs,
                                       soft_cap=cap)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    _assert_close(out, ref)
    assert out[1].abs().max().item() == 0 and out[6].abs().max().item() == 0


# Packed segments (start, q_len, seq_len) and the rows no segment owns.
# "base": a cached prefix of 26 (mid-page at every block size), a
# one-token segment, alignment gaps and tail rows.  "ragged": q_len 13,
# 77, 1 and 103 (no multiple of 16), prefixes of 50, 131 and 5 that end
# mid-page, and rows a segment ends beside the next one's alignment gap.
# Table entries past a segment's last page are the null block (0).
SEGMENTS = {
    "base": ([(0, 37, 37), (40, 64, 90), (104, 1, 1), (112, 100, 100)], 216,
             [(37, 40), (212, 216)]),
    "ragged": ([(0, 13, 63), (16, 77, 77), (96, 1, 132), (104, 103, 108)], 208,
               [(13, 16), (93, 96), (97, 104), (207, 208)]),
}
# G = Hq / Hkv of 4, 1 and 8 query heads a kv head.
PREFILL_HEADS = [(32, 8, 64, 64, None), (32, 8, 64, 16, 30.0),
                 (8, 8, 128, 32, None), (8, 2, 32, 8, None),
                 (32, 8, 128, 64, None), (32, 4, 64, 64, None)]


@pytest.mark.parametrize("layout", list(SEGMENTS))
@pytest.mark.parametrize("hq,hkv,d,bs,cap", PREFILL_HEADS)
def test_prefill_kernel_matches_plain(dev, hq, hkv, d, bs, cap, layout):
    gen = torch.Generator(device=dev).manual_seed(1)
    R, P = 6, 24  # P * bs covers the longest context at every bs
    segs, T, gaps = SEGMENTS[layout]
    nblocks = 1 + R * P
    kc = _rand(gen, nblocks * bs, hkv * d, dev=dev)
    vc = _rand(gen, nblocks * bs, hkv * d, dev=dev)
    q = _rand(gen, T, hq, d, dev=dev)
    perm = torch.randperm(nblocks - 1, generator=gen, device=dev) + 1
    bt = torch.zeros(R, P, dtype=torch.int32, device=dev)
    qs, ql, sl = ([0] * R for _ in range(3))
    for i, (s, n, c) in enumerate(segs):
        qs[i], ql[i], sl[i] = s, n, c
        npg = -(-c // bs)
        bt[i, :npg] = perm[i * P: i * P + npg].to(torch.int32)
    args = [torch.tensor(x, dtype=torch.int32, device=dev) for x in (sl, qs, ql)]
    before = paged_prefill_attention.launches
    out = paged_prefill_attention(q, kc, vc, bt, *args, block_size=bs,
                                  soft_cap=cap)
    ref = paged_prefill_attention_plain(q, kc, vc, bt, *args, block_size=bs,
                                        soft_cap=cap)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == before + 1
    _assert_close(out, ref)
    for a, b in gaps:                              # rows no segment owns
        assert out[a:b].abs().max().item() == 0


def _int8_pool(gen, S, hkv, d, dev):
    """int8 K and V pools with their [S, Hkv] scales, quantized from
    random bf16 rows as the engine writes them."""
    out = {}
    for name in ("k", "v"):
        q, s = kvc.quantize_kv_rows(_rand(gen, S, hkv * d, dev=dev), hkv)
        out[name], out[name + "_scale"] = q, s
    return out


@pytest.mark.parametrize("hq,hkv,d,bs,cap", [
    (32, 8, 64, 64, None), (32, 8, 64, 16, 30.0), (8, 2, 32, 8, None),
    (32, 8, 128, 64, None)] + WIDE_DECODE)
def test_int8_decode_kernel_matches_plain(dev, hq, hkv, d, bs, cap):
    """Ragged rows over an int8 cache: empty rows, one token, a tail page
    one past a page boundary, full tables."""
    gen = torch.Generator(device=dev).manual_seed(3)
    B, P = 9, 6
    nblocks = 1 + B * P
    pool = _int8_pool(gen, nblocks * bs, hkv, d, dev)
    q = _rand(gen, B, hq, d, dev=dev)
    bt = (torch.randperm(nblocks - 1, generator=gen, device=dev)[: B * P]
          + 1).reshape(B, P).to(torch.int32)
    lens = [P * bs, 0, 1, bs - 1, bs + 1, 3 * bs, 0, 2, P * bs - 3]
    for i, n in enumerate(lens):
        bt[i, -(-n // bs):] = 0
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q, pool["k"], pool["v"], bt, sl)
    kw = dict(block_size=bs, soft_cap=cap, k_scale=pool["k_scale"],
              v_scale=pool["v_scale"])
    before = (paged_decode_attention.launches,
              paged_decode_attention.launches_int8)
    out = paged_decode_attention(*args, **kw)
    ref = paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches,
            paged_decode_attention.launches_int8) == (before[0], before[1] + 1)
    _assert_close(out, ref)
    assert out[1].abs().max().item() == 0 and out[6].abs().max().item() == 0


@pytest.mark.parametrize("layout", list(SEGMENTS))
@pytest.mark.parametrize("hq,hkv,d,bs,cap", [
    (32, 8, 64, 64, None), (32, 8, 64, 16, 30.0), (8, 2, 32, 8, None),
    (32, 8, 128, 64, None), (32, 4, 64, 64, None)])
def test_int8_prefill_kernel_matches_plain(dev, hq, hkv, d, bs, cap, layout):
    """Packed segments over an int8 pool (SEGMENTS)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    R, P = 6, 24
    segs, T, gaps = SEGMENTS[layout]
    nblocks = 1 + R * P
    pool = _int8_pool(gen, nblocks * bs, hkv, d, dev)
    q = _rand(gen, T, hq, d, dev=dev)
    perm = torch.randperm(nblocks - 1, generator=gen, device=dev) + 1
    bt = torch.zeros(R, P, dtype=torch.int32, device=dev)
    qs, ql, sl = ([0] * R for _ in range(3))
    for i, (st, n, c) in enumerate(segs):
        qs[i], ql[i], sl[i] = st, n, c
        npg = -(-c // bs)
        bt[i, :npg] = perm[i * P: i * P + npg].to(torch.int32)
    args = [q, pool["k"], pool["v"], bt] + [
        torch.tensor(x, dtype=torch.int32, device=dev) for x in (sl, qs, ql)]
    kw = dict(block_size=bs, soft_cap=cap, k_scale=pool["k_scale"],
              v_scale=pool["v_scale"])
    before = paged_prefill_attention.launches_int8
    out = paged_prefill_attention(*args, **kw)
    ref = paged_prefill_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches_int8 == before + 1
    _assert_close(out, ref)
    for a, b in gaps:
        assert out[a:b].abs().max().item() == 0


@pytest.mark.parametrize("int8", [False, True])
def test_moe_grouped_kernel_matches_plain(dev, int8):
    """Ragged tiles: 45 tokens x top-2 over 5 experts, one expert with no
    rows, tiles past the last span dead; H 128, F 192."""
    gen = torch.Generator(device=dev).manual_seed(2)
    E, H, F, N, k = 5, 128, 192, 45, 2
    probs = torch.tensor([0.5, 0.3, 0.0, 0.15, 0.05], device=dev)
    ids = torch.stack([torch.multinomial(probs, k, generator=gen)
                       for _ in range(N)])
    order, dest, S_pad, te, tr, counts = expert_tiles(ids.reshape(-1), E, 64)
    assert int(counts[2]) == 0 and int((tr == 0).sum()) > 0
    x = _rand(gen, N * k, H, dev=dev)
    x_pad = torch.zeros(S_pad, H, dtype=torch.bfloat16, device=dev)
    x_pad[dest] = x[order]
    p = {"router": None,
         "w_gate": _rand(gen, E, H, F, dev=dev) * H ** -0.5,
         "w_up": _rand(gen, E, H, F, dev=dev) * H ** -0.5,
         "w_down": _rand(gen, E, F, H, dev=dev) * F ** -0.5}
    if int8:
        p = quantize_moe_params(p)
    scales = {n: p.get(n) for n in ("w_gate_scale", "w_up_scale",
                                    "w_down_scale")}
    args = (x_pad, te, p["w_gate"], p["w_up"], p["w_down"])
    before = grouped_expert_ffn.launches
    out = grouped_expert_ffn(*args, tile_rows=tr, **scales)
    ref = grouped_expert_ffn_plain(*args, tile_rows=tr, **scales)
    torch.cuda.synchronize()
    assert grouped_expert_ffn.launches == before + 1
    live = torch.zeros(S_pad, dtype=torch.bool, device=dev)
    live[dest] = True
    assert out[~live].abs().max().item() == 0   # padding rows, dead tiles
    _assert_close(out, ref)


# Assignments per expert (8 experts).  "decode": 1-16 live rows an expert
# and one expert with none (the n16 copy of the kernel's loop); "decode32":
# up to 32 (n32); "prefill": experts over 3, 4 and 5 tiles with partial
# last tiles, one exactly full tile, experts with none, and dead tiles
# (group width 4, and a 5-tile expert cut into groups of 4 and 1).
MOE_COUNTS = {
    "decode": [1, 16, 3, 0, 8, 2, 5, 9],
    "decode32": [17, 30, 1, 0, 32, 20, 16, 2],
    "prefill": [150, 64, 0, 200, 70, 1, 0, 300],
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", list(MOE_COUNTS))
@pytest.mark.parametrize("H,F", [(128, 192), (192, 320)])
def test_moe_grouped_kernel_group_shapes(dev, int8, case, H, F):
    """Every group shape the kernel takes, against the plain version; H 192
    and F 320 give down a 128-column item with one A tile past the last
    column and int8 a 64-deep tail stage.  Padding rows and dead tiles
    must come back as exact zeros."""
    gen = torch.Generator(device=dev).manual_seed(5)
    E = 8
    counts = MOE_COUNTS[case]
    flat = torch.cat([torch.full((n,), e, dtype=torch.long)
                      for e, n in enumerate(counts)])
    flat = flat[torch.randperm(len(flat), generator=torch.Generator()
                               .manual_seed(0))].to(dev)
    order, dest, S_pad, te, tr, _ = expert_tiles(flat, E, 64)
    widest = int(tr.max())                  # the widest tile's live rows
    assert widest <= {"decode": 16, "decode32": 32, "prefill": 64}[case]
    assert int((tr == 0).sum()) > 0                    # dead tiles
    x = _rand(gen, len(flat), H, dev=dev)
    x_pad = torch.zeros(S_pad, H, dtype=torch.bfloat16, device=dev)
    x_pad[dest] = x[order]
    p = {"router": None,
         "w_gate": _rand(gen, E, H, F, dev=dev) * H ** -0.5,
         "w_up": _rand(gen, E, H, F, dev=dev) * H ** -0.5,
         "w_down": _rand(gen, E, F, H, dev=dev) * F ** -0.5}
    if int8:
        p = quantize_moe_params(p)
    scales = {n: p.get(n) for n in ("w_gate_scale", "w_up_scale",
                                    "w_down_scale")}
    args = (x_pad, te, p["w_gate"], p["w_up"], p["w_down"])
    before = grouped_expert_ffn.launches
    out = grouped_expert_ffn(*args, tile_rows=tr, **scales)
    ref = grouped_expert_ffn_plain(*args, tile_rows=tr, **scales)
    torch.cuda.synchronize()
    assert grouped_expert_ffn.launches == before + 1
    live = torch.zeros(S_pad, dtype=torch.bool, device=dev)
    live[dest] = True
    assert out[~live].abs().max().item() == 0
    _assert_close(out, ref)


@pytest.mark.parametrize("int8", [False, True])
def test_kernel_wrappers_make_no_host_sync(dev, int8):
    """K1 and K3 launch with no host sync: under sync debug mode "error" a
    synchronizing call would raise."""
    gen = torch.Generator(device=dev).manual_seed(6)
    hq, hkv, d, bs = 32, 8, 64, 64
    calls = []
    for B in (8, 64):                      # the served bucket and B 64
        P = 4
        nblocks = 1 + B * P
        if int8:
            pool = _int8_pool(gen, nblocks * bs, hkv, d, dev)
            kc, vc = pool["k"], pool["v"]
            kw = {"k_scale": pool["k_scale"], "v_scale": pool["v_scale"]}
        else:
            kc = _rand(gen, nblocks * bs, hkv * d, dev=dev)
            vc = _rand(gen, nblocks * bs, hkv * d, dev=dev)
            kw = {}
        q = _rand(gen, B, hq, d, dev=dev)
        bt = (torch.arange(B * P, device=dev) + 1).reshape(B, P).to(torch.int32)
        sl = torch.full((B,), 200, dtype=torch.int32, device=dev)
        calls.append(lambda q=q, kc=kc, vc=vc, bt=bt, sl=sl, kw=kw:
                     paged_decode_attention(q, kc, vc, bt, sl, block_size=bs,
                                            **kw))
    E, H, F = 4, 128, 192
    flat = torch.tensor([0, 1, 1, 3, 0, 3], device=dev)
    order, dest, S_pad, te, tr, _ = expert_tiles(flat, E, 64)
    w = {"router": None, "w_gate": _rand(gen, E, H, F, dev=dev),
         "w_up": _rand(gen, E, H, F, dev=dev),
         "w_down": _rand(gen, E, F, H, dev=dev)}
    if int8:
        w = quantize_moe_params(w)
    x_pad = _rand(gen, S_pad, H, dev=dev)
    sc = {n: w.get(n) for n in ("w_gate_scale", "w_up_scale", "w_down_scale")}
    calls.append(lambda: grouped_expert_ffn(x_pad, te, w["w_gate"], w["w_up"],
                                            w["w_down"], tile_rows=tr, **sc))
    for fn in calls:                       # build and load the libraries first
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,bs", [(64, 64), (128, 64), (64, 16), (64, 48)])
@pytest.mark.parametrize("B", [1, 2, 8, 64])
def test_decode_kernel_ragged_rows(dev, B, d, bs, int8, cap):
    """Rows of 0, 1, 63, 64, 65 keys and a full table (512 keys; 480 at
    block 48, which takes the kernel's division path) at batch 1, 2, 8
    and 64 over a bf16 or int8 cache, against the plain version; one call
    counts one launch."""
    gen = torch.Generator(device=dev).manual_seed(7)
    hq, hkv = 32, 8
    P = 512 // bs
    nblocks = 1 + B * P
    lens = [[0, 1, 63, 64, 65, P * bs][i % 6] for i in range(B)]
    if B == 1:
        lens = [P * bs]
    q = _rand(gen, B, hq, d, dev=dev)
    bt = (torch.randperm(nblocks - 1, generator=gen, device=dev)[: B * P]
          + 1).reshape(B, P).to(torch.int32)
    for i, n in enumerate(lens):
        bt[i, -(-n // bs):] = 0
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    if int8:
        pool = _int8_pool(gen, nblocks * bs, hkv, d, dev)
        kc, vc = pool["k"], pool["v"]
        kw = {"k_scale": pool["k_scale"], "v_scale": pool["v_scale"]}
    else:
        kc = _rand(gen, nblocks * bs, hkv * d, dev=dev)
        vc = _rand(gen, nblocks * bs, hkv * d, dev=dev)
        kw = {}
    attr = "launches_int8" if int8 else "launches"
    before = getattr(paged_decode_attention, attr)
    out = paged_decode_attention(q, kc, vc, bt, sl, block_size=bs,
                                 soft_cap=cap, **kw)
    ref = paged_decode_attention_plain(q, kc, vc, bt, sl, block_size=bs,
                                       soft_cap=cap, **kw)
    torch.cuda.synchronize()
    assert getattr(paged_decode_attention, attr) == before + 1
    _assert_close(out, ref)
    for i, n in enumerate(lens):
        if n == 0:
            assert out[i].abs().max().item() == 0


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(dev):
    q = torch.zeros(2, 8, 64, device=dev)                     # f32
    kc = torch.zeros(64, 128, dtype=torch.bfloat16, device=dev)
    bt = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    sl = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="q must be"):
        paged_decode_attention(q, kc, kc, bt, sl, block_size=64)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(qb, kc.T.contiguous().T, kc, bt, sl, block_size=64)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(qb, kc, kc, bt.long(), sl, block_size=64)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_prefill_attention(torch.zeros(12, 8, 64, dtype=torch.bfloat16,
                                            device=dev), kc, kc, bt, sl, sl,
                                sl, block_size=64)
    # int8 rows load as 16-byte vectors: D 24 is refused, as are scales of
    # the wrong shape.
    k8 = torch.zeros(64, 48, dtype=torch.int8, device=dev)
    sc = torch.ones(64, 2, device=dev)
    with pytest.raises(ValueError, match="D % 16"):
        paged_decode_attention(torch.zeros(2, 4, 24, dtype=torch.bfloat16,
                                           device=dev), k8, k8, bt, sl,
                               block_size=64, k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="scales must be"):
        paged_decode_attention(qb, torch.zeros(64, 128, dtype=torch.int8,
                                               device=dev),
                               torch.zeros(64, 128, dtype=torch.int8,
                                           device=dev), bt, sl,
                               block_size=64, k_scale=sc[:, :1].contiguous(),
                               v_scale=sc[:, :1].contiguous())
    # The decode kernel is built for D 16, 32, 64, 80, 96, 128 and 256,
    # any number of query heads a kv head.
    with pytest.raises(ValueError, match="head dim 112"):
        paged_decode_attention(torch.zeros(2, 8, 112, dtype=torch.bfloat16,
                                           device=dev),
                               torch.zeros(64, 224, dtype=torch.bfloat16,
                                           device=dev),
                               torch.zeros(64, 224, dtype=torch.bfloat16,
                                           device=dev), bt, sl, block_size=64)
    w = torch.zeros(2, 64, 96, dtype=torch.bfloat16, device=dev)
    x = torch.zeros(64, 64, dtype=torch.bfloat16, device=dev)
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiples of 64"):
        grouped_expert_ffn(x, te, w, w, w.transpose(1, 2).contiguous())


def _tiny_engine(dev, **kw):
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.models.config import get_config

    cfg = get_config("tiny-test").replace(head_dim=32, dtype=torch.bfloat16)
    return EngineCore(EngineConfig(
        model=cfg, num_blocks=64, device="cuda",
        scheduler=SchedulerConfig(max_seqs=8, block_size=8,
                                  max_pages_per_seq=16, max_prefill_chunk=32,
                                  decode_buckets=(1, 2, 4, 8),
                                  prefill_buckets=(8, 16, 32)), **kw))


def _serve(core, prompts):
    from dynamo_tpu_torch.engine.sampling import SamplingParams

    for rid, p in prompts.items():
        core.add_request(rid, p, SamplingParams(max_tokens=20))
    out = {}
    for _ in range(500):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core.has_work:
            break
    return out


def test_engine_serves_greedy_through_both_kernels(dev):
    core = _tiny_engine(dev)
    d0, p0 = paged_decode_attention.launches, paged_prefill_attention.launches
    out = _serve(core, {f"r{i}": list(range(1, n + 1))
                        for i, n in enumerate((5, 40, 17))})
    assert sorted(out) == ["r0", "r1", "r2"]
    assert all(len(t) == 20 for t in out.values())
    assert paged_decode_attention.launches > d0
    assert paged_prefill_attention.launches > p0
    assert core.counters.window_dispatches > 0


def test_spec_engine_and_embeddings_on_the_card(dev):
    """Speculative decode (K 3) on the card: repetitive prompts draft and
    accept; prefill still launches K2.  Embeddings come back finite."""
    core = _tiny_engine(dev, speculative_tokens=3)
    p0 = paged_prefill_attention.launches
    out = _serve(core, {"a": [5, 6, 7, 8] * 6, "b": [9, 1, 9, 1, 9, 1, 9]})
    assert all(len(t) == 20 for t in out.values())
    st = core.metrics.spec_decode_stats
    assert core.counters.spec_dispatches > 0 and core.counters.window_dispatches == 0
    assert 0 < st.num_drafts and st.num_accepted_tokens <= st.num_drafts
    assert paged_prefill_attention.launches > p0
    emb = core.embed_tokens([[1, 2, 3], list(range(10, 40))])
    assert emb.shape == (2, core.config.model.hidden_size)
    assert torch.isfinite(torch.from_numpy(emb)).all()
    assert core.clear_prefix_cache() > 0


def test_int8_engine_with_prefix_cache_runs_the_int8_kernels(dev):
    """tiny-test in bf16 with an int8 cache and the prefix cache on: a
    second wave over the first wave's 3-block prefix hits, and only the
    int8 bodies of K1 and K2 launch."""
    core = _tiny_engine(dev, kv_quant="int8")
    before = {n: (f.launches, f.launches_int8)
              for n, f in (("d", paged_decode_attention),
                           ("p", paged_prefill_attention))}
    shared = list(range(1, 25))
    first = _serve(core, {"a": shared + [40, 41], "b": shared + [50]})
    second = _serve(core, {"c": shared + [60, 61, 62], "d": shared[:]})
    assert all(len(t) == 20 for t in {**first, **second}.values())
    assert core.scheduler.prefix_hit_tokens == 24 + 23
    for n, f in (("d", paged_decode_attention), ("p", paged_prefill_attention)):
        assert f.launches == before[n][0]
        assert f.launches_int8 > before[n][1]


@pytest.mark.parametrize("int8", [False, True])
def test_engine_serves_moe_through_the_grouped_kernel(dev, int8):
    """tiny-moe in bf16 (H 64, F 128 pass the kernel's rule): `auto`
    resolves to the grouped kernel, with bf16 experts or quantized ones
    given through `EngineCore(params=...)` (the kernel's int8 variant);
    every request finishes, and the expert load counts k assignments per
    model row per layer, none dropped."""
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.weights import init_params

    cfg = get_config("tiny-moe").replace(head_dim=32, dtype=torch.bfloat16)
    state = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if int8:
        state = {**state, "layers": [
            {**layer, "moe": quantize_moe_params(layer["moe"])}
            for layer in state["layers"]]}
    core = EngineCore(EngineConfig(
        model=cfg, num_blocks=64, device="cuda",
        scheduler=SchedulerConfig(max_seqs=8, block_size=8,
                                  max_pages_per_seq=16, max_prefill_chunk=32,
                                  decode_buckets=(1, 2, 4, 8),
                                  prefill_buckets=(8, 16, 32))),
        params=state)
    assert core.moe_mode == "grouped"
    m0 = grouped_expert_ffn.launches
    for i, n in enumerate((5, 40, 17)):
        core.add_request(f"r{i}", list(range(1, n + 1)),
                         SamplingParams(max_tokens=20))
    out = {}
    for _ in range(500):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core.has_work:
            break
    assert all(len(out[f"r{i}"]) == 20 for i in range(3))
    assert grouped_expert_ffn.launches > m0
    load = core.snapshot_expert_load()
    assert int(load.sum()) == (core.counters.model_rows
                               * cfg.num_experts_per_token * cfg.num_layers)
    assert core.moe_dropped_tokens == 0


PAD = 8192   # a pad position: past every real key


def _ring_inputs(gen, dev, B, T, hq, hkv, d, quant):
    """Whole-sequence q, k, v and positions for the ring: row 0 is a full
    prompt; row 1 is a shorter prompt padded at the pad position, with
    one query at position -1, which sees no key at all (its state never
    leaves the mask fill: the junk-but-finite row)."""
    q = _rand(gen, B, T, hq, d, dev=dev)
    k = _rand(gen, B, T, hkv, d, dev=dev)
    v = _rand(gen, B, T, hkv, d, dev=dev)
    pos = torch.arange(T, device=dev, dtype=torch.int32).repeat(B, 1)
    if B > 1:
        real = T - T // 3
        pos[1, real:] = PAD
    q_pos = pos.clone()
    if B > 1:
        q_pos[1, 5] = -1
    scales = {}
    if quant:
        kq, ks = kvc.quantize_kv_rows(k.reshape(B * T, hkv * d), hkv)
        vq, vs = kvc.quantize_kv_rows(v.reshape(B * T, hkv * d), hkv)
        k, v = kq.reshape(B, T, hkv, d), vq.reshape(B, T, hkv, d)
        scales = {"k_scale": ks.reshape(B, T, hkv),
                  "v_scale": vs.reshape(B, T, hkv)}
    return q, k, v, q_pos, pos, scales


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,hkv,d,sp,t_loc,cap", [
    (32, 8, 64, 4, 128, None),     # the served shape
    (32, 8, 128, 4, 128, None),
    (32, 8, 64, 1, 256, None),     # one rank: plain flash attention
    (32, 8, 64, 2, 100, 30.0),     # T_loc not a multiple of the kv tile
    (8, 2, 32, 4, 72, None),
    (16, 16, 128, 2, 40, 30.0),    # no grouping; a T_loc under one tile
    (32, 4, 64, 4, 24, None),      # 8 query heads a kv head
    (32, 4, 128, 4, 13, 30.0)])    # T_loc under one k16 slice, G 8, D 128
# At sp > 1 a rank's block from a later rank is wholly masked: those
# launches skip it whole (every row already real) except on the last hop.
def test_ring_kernel_matches_plain_ring(dev, quant, hq, hkv, d, sp, t_loc, cap):
    gen = torch.Generator(device=dev).manual_seed(4)
    B, T = 2, sp * t_loc
    q, k, v, q_pos, kv_pos, scales = _ring_inputs(gen, dev, B, T, hq, hkv, d,
                                                  quant)

    def cut(x):
        return [c.contiguous() for c in x.chunk(sp, dim=1)]

    sc = {n: cut(t) for n, t in scales.items()}
    ring = SpRing([dev] * sp)
    attr = "launches_int8" if quant else "launches"
    before = getattr(ring_flash_attention, attr)
    ring.fork()
    outs = ring_flash_attention(ring, cut(q), cut(k), cut(v), cut(q_pos),
                                cut(kv_pos), soft_cap=cap, **sc)
    ring.join()
    refs = ring_causal_attention(cut(q), cut(k), cut(v), cut(q_pos),
                                 cut(kv_pos), soft_cap=cap, **sc)
    torch.cuda.synchronize()
    assert getattr(ring_flash_attention, attr) == before + sp * sp
    out, ref = torch.cat(outs, dim=1), torch.cat(refs, dim=1)
    assert torch.isfinite(out.float()).all()
    _assert_close(out, ref)
    # The row that saw no key: every key counted once, the mean of V.
    if not quant:
        want = v[1].float().mean(dim=0)                        # [Hkv, D]
        got = out[1, 5].float().reshape(hkv, hq // hkv, d)
        assert (got - want[:, None]).abs().max().item() <= 2e-2


def test_ring_fold_state_round_trip(dev):
    """Two folds through the state in device memory equal one plain ring
    of two blocks, and a second ring over the same slots (the next layer)
    is not disturbed by the first."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, q_pos, kv_pos, _ = _ring_inputs(gen, dev, 1, 256, 32, 8, 64, False)
    ring = SpRing([dev] * 2)

    def cut(x):
        return [c.contiguous() for c in x.chunk(2, dim=1)]

    ring.fork()
    first = ring_flash_attention(ring, cut(q), cut(k), cut(v), cut(q_pos))
    second = ring_flash_attention(ring, cut(q), cut(v), cut(k), cut(q_pos))
    ring.join()
    torch.cuda.synchronize()
    _assert_close(torch.cat(first, 1), torch.cat(
        ring_causal_attention(cut(q), cut(k), cut(v), cut(q_pos)), 1))
    _assert_close(torch.cat(second, 1), torch.cat(
        ring_causal_attention(cut(q), cut(v), cut(k), cut(q_pos)), 1))


def test_ring_fold_rejects_what_the_kernel_does_not_take(dev):
    B, T, hq, hkv, d = 1, 16, 8, 2, 64
    qs = torch.zeros(B, T, hq, d, device=dev)
    kb = torch.zeros(B, T, hkv, d, dtype=torch.bfloat16, device=dev)
    pos = torch.zeros(B, T, dtype=torch.int32, device=dev)
    out = torch.zeros(B, T, hq, d, dtype=torch.bfloat16, device=dev)
    st = (torch.zeros(B, hq, T, device=dev), torch.zeros(B, hq, T, device=dev),
          torch.zeros(B, T, hq, d, device=dev))
    ring_flash_fold(st, qs, pos, kb, kb, pos, out, first=True, last=True)
    with pytest.raises(ValueError, match="q_scaled must be"):
        ring_flash_fold(st, qs.bfloat16(), pos, kb, kb, pos, out, first=True,
                        last=True)
    with pytest.raises(ValueError, match="int32"):
        ring_flash_fold(st, qs, pos.long(), kb, kb, pos, out, first=True,
                        last=True)
    with pytest.raises(ValueError, match="geometry rejected"):
        ring_flash_fold(
            (st[0], st[1], torch.zeros(B, T, hq, 48, device=dev)),
            torch.zeros(B, T, hq, 48, device=dev), pos,
            torch.zeros(B, T, hkv, 48, dtype=torch.bfloat16, device=dev),
            torch.zeros(B, T, hkv, 48, dtype=torch.bfloat16, device=dev), pos,
            torch.zeros(B, T, hq, 48, dtype=torch.bfloat16, device=dev),
            first=True, last=True)
    with pytest.raises(ValueError, match="come together"):
        ring_flash_fold(st, qs, pos, kb.to(torch.int8), kb.to(torch.int8),
                        pos, out, first=True, last=True)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_sp_engine_serves_through_the_ring_kernel(dev, kv_quant):
    """tiny-test in bf16 with sp 4 on one card: prompts at or past the
    threshold prefill through the ring kernel (16 fold launches a layer),
    shorter ones through the packed plane.  Every prompt's first token is
    held against the logits of the same prefill over the plain ring: it
    is their argmax, or within a near tie of it."""
    body = ring_flash_attention
    attr = "launches_int8" if kv_quant == "int8" else "launches"
    prompts = {"a": list(range(1, 33)), "b": list(range(40, 64))}
    core = _tiny_engine(dev, kv_quant=kv_quant, sp=4, sp_prefill_threshold=16)
    before = getattr(body, attr)
    got = _serve(core, prompts)
    c = core.counters
    assert c.sp_prefill_count == 2 and c.ring_kernel_prefills == 2
    layers = core.config.model.num_layers
    assert getattr(body, attr) - before == layers * 16
    want = c.ring_exchange_bytes_modeled
    assert want == (32 + 24) * core.cache_cfg.ring_payload_bytes_per_token * 3 // 4
    assert all(len(t) == 20 for t in got.values())
    plain = make_sp_prefill_step(core.config.model, 8, core.ring,
                                 kv_quant=kv_quant == "int8", use_kernel=False)
    T = 32
    tok = torch.zeros(2, T, dtype=torch.int32)
    pos = torch.full((2, T), 16 * 8, dtype=torch.int32)
    for i, p in enumerate(prompts.values()):
        tok[i, : len(p)] = torch.tensor(p)
        pos[i, : len(p)] = torch.arange(len(p))
    lens = torch.tensor([len(p) for p in prompts.values()], dtype=torch.int32)
    pages = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    logits, _ = plain(core.params, kvc.init_cache(core.cache_cfg, dev),
                      *(t.to(dev) for t in (tok, pos, lens, pages, lens - 1)))
    torch.cuda.synchronize()
    for i, rid in enumerate(prompts):
        row = logits[i].float()
        gap = (row.max() - row[got[rid][0]]).item()
        assert gap <= 2e-2 * row.abs().max().item(), (rid, gap)
    short = _serve(core, {"c": [3, 4, 5]})
    assert len(short["c"]) == 20 and core.counters.sp_prefill_count == 2


class _SteppedClient:
    """EngineClient that steps its core on the caller's thread, so the
    KV events and metrics of every step run where the test can watch
    them."""

    def __init__(self, core):
        self.core = core

    async def generate(self, req):
        import asyncio

        self.core.add_request(req.request_id, req.token_ids, req.sampling)
        while True:
            for d in self.core.step():
                if d.request_id == req.request_id:
                    yield d
                    if d.finished:
                        return
            await asyncio.sleep(0)


def test_kv_router_sticks_a_shared_prefix_between_two_card_engines(dev):
    """Two engines on the card behind an in-process control plane and the
    KV router: the second of a shared-prefix pair lands on the first's
    worker, whose prefix-hit tokens grow by the prefix's 3 blocks (the
    other's do not move).  The KV-event emission and the metrics refresh
    run under `set_sync_debug_mode("error")`: no host sync."""
    import asyncio

    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.llm.discovery import engine_wire_handler
    from dynamo_tpu_torch.llm.kv_router.client import (
        KV_EVENTS_SUBJECT, KvRoutedEngineClient)
    from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent
    from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
    from dynamo_tpu_torch.runtime.control_plane import InProcessControlPlane
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    def no_sync(fn):
        def run(*a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    shared = list(range(1, 25))              # 3 blocks of 8

    async def main():
        cp = InProcessControlPlane()
        await cp.start()
        cores, runtimes = {}, []
        for _ in range(2):
            rt = DistributedRuntime(cp)
            events = []
            core = _tiny_engine(dev)
            core._kv_event_sink = events.append
            core._publish_completed_blocks = no_sync(
                core._publish_completed_blocks)
            core._refresh_metrics = no_sync(core._refresh_metrics)
            ep = rt.namespace("dyn").component("backend").endpoint("generate")
            inst = await ep.serve(engine_wire_handler(_SteppedClient(core)))
            cores[inst.instance_id] = (core, events)
            runtimes.append(rt)
        front = DistributedRuntime(cp)
        client = await (front.namespace("dyn").component("backend")
                        .endpoint("generate").client())
        while len(client.instance_ids()) < 2:
            await asyncio.sleep(0.01)
        kv = KvRoutedEngineClient(client, front, block_size=8)
        await kv.start()
        hits = []
        for rid, toks in (("a", shared + [40, 41]), ("b", shared + [50])):
            before = {i: c.scheduler.prefix_hit_tokens
                      for i, (c, _) in cores.items()}
            req = PreprocessedRequest(rid, "m", toks,
                                      SamplingParams(max_tokens=20))
            n = sum([len(d.token_ids) async for d in kv.generate(req)])
            assert n == 20
            hits.append({i: c.scheduler.prefix_hit_tokens - before[i]
                         for i, (c, _) in cores.items()})
            for iid, (_, events) in cores.items():
                while events:
                    await cp.publish(KV_EVENTS_SUBJECT, RouterEvent(
                        worker_id=iid, event=events.pop(0)).to_dict())
            await asyncio.sleep(0.05)        # the router indexes them
        await kv.stop()
        await client.stop()
        for rt in runtimes + [front]:
            await rt.shutdown()
        await cp.close()
        return hits, cores

    hits, cores = asyncio.run(asyncio.wait_for(main(), 120))
    assert all(n == 0 for n in hits[0].values())
    (home, n), = [(i, n) for i, n in hits[1].items() if n]
    assert n == 24
    core = cores[home][0]
    assert core.metrics.kv_stats.gpu_prefix_cache_hit_rate > 0
    assert paged_prefill_attention.launches > 0


# ---------------------------------------------------------------------------
# The KV data plane on the card: CUDA IPC between processes


async def _ask(rpc, endpoint, payload):
    return [m async for m in rpc.call(endpoint, payload)][-1]


@pytest.mark.parametrize("quant", [False, True])
def test_cuda_ipc_pull_across_processes(dev, quant):
    """A holder process (`chip_smoke.py --kv-holder`) offers 4 llama-3-1b
    blocks; this process pulls them over CUDA IPC byte for byte onto its
    card, the holder's staging is freed after kv_pulled (also when the
    ack says the offer was never mapped), an offer nobody pulls is freed
    after its TTL, and a puller on another fabric is refused and its pull
    rides the host-staged plane, counted with the reason."""
    import asyncio
    import os
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    from dynamo_tpu_torch.llm.block_manager import device_transfer as dt
    from dynamo_tpu_torch.llm.block_manager.prefix_share import PrefixFetcher
    from dynamo_tpu_torch.llm.block_manager.transfer import sealed_hashes
    from dynamo_tpu_torch.runtime.rpc import RpcClient

    n = 4
    want = chip_smoke.ipc_blocks(torch, quant, n)
    prompt = list(range(n * 64))
    hashes = sealed_hashes(prompt, 64)

    def same(a, b):
        return torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))

    async def main(address):
        rpc = RpcClient(address)
        plane = dt.KvTransferPlane(device=dev)
        plane.start()
        assert plane.transport_kind == "cuda_ipc"
        try:
            assert (await _ask(rpc, "holder_stats", {}))["extra_bytes"] == 0
            meta = await _ask(rpc, dt.KV_OFFER_ENDPOINT,
                              {"hashes": hashes[:1], "fabric": plane.fabric})
            assert meta["transport"] == "cuda_ipc"
            assert meta["pid"] != os.getpid()
            staged = (await _ask(rpc, "holder_stats", {}))["extra_bytes"]
            assert staged >= want[0].numel() * want.element_size()
            # Acked unmapped (a puller that gave up): the holder releases
            # the send itself and frees the staging.
            await _ask(rpc, dt.KV_PULLED_ENDPOINT,
                       {"uuid": meta["uuid"], "mapped": False})
            assert (await _ask(rpc, "holder_stats", {}))["extra_bytes"] == 0

            blocks, refusal = await dt.pull_blocks_device(plane, rpc, hashes)
            assert refusal is None and list(blocks) == hashes
            for i, h in enumerate(hashes):
                assert blocks[h].device.type == "cuda"
                assert same(blocks[h], want[i])
            assert plane.pulled_blocks == n
            for _ in range(500):         # the release and the ack
                st = await _ask(rpc, "holder_stats", {})
                if st["outstanding"] == 0 and not plane._mapped:
                    break
                await asyncio.sleep(0.01)
            assert st["outstanding"] == 0 and not plane._mapped
            assert st["extra_bytes"] == 0                # staging freed

            # Offered and never pulled: freed after the TTL.
            await _ask(rpc, dt.KV_OFFER_ENDPOINT,
                       {"hashes": hashes, "fabric": plane.fabric})
            assert (await _ask(rpc, "holder_stats", {}))["extra_bytes"] > 0
            await asyncio.sleep(2.5)
            st = await _ask(rpc, "holder_stats", {"expire": True})
            assert st["expired_offers"] == 1 and st["outstanding"] == 0
            assert st["extra_bytes"] == 0

            # Another card's fabric: refused, the pull goes host-staged.
            other = dt.KvTransferPlane(device=dev)
            other.start()
            other._transport.fabric = "cuda_ipc:elsewhere:GPU-0"

            class Sink:
                got = {}

                async def import_blocks(self, b):
                    self.got.update(b)
                    return len(b)

                async def resident_prefix_blocks(self, hs):
                    n = 0
                    while n < len(hs) and hs[n] in self.got:
                        n += 1
                    return n

            sink = Sink()
            dt.reset_plane_counts()
            fetcher = PrefixFetcher(sink, lambda a: rpc, 64, plane=other)
            assert await fetcher.pull(prompt, address) == n * 64
            assert fetcher.device_pulled_blocks == 0
            assert dt.plane_counts().get(("host", "transport"), 0) >= 1
            st = await _ask(rpc, "holder_stats", {})
            assert st["refused_offers"] >= 1
            for i, h in enumerate(hashes):
                assert same(sink.got[h], want[i].cpu())
        finally:
            await rpc.close()

    with chip_smoke.kv_holder_proc(quant, n, ttl_s=2.0) as address:
        asyncio.run(asyncio.wait_for(main(address), 120))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_block_extract_and_inject_on_the_card(dev, kv_quant):
    """The batched extract and inject on CUDA tensors give the CPU bytes,
    and an engine on the card imports its peer's export and continues as
    the peer does."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.tokens import compute_block_hashes

    a = _tiny_engine(dev, kv_quant=kv_quant)
    prompt = list(range(1, 28))
    a.add_request("a", prompt, SamplingParams(max_tokens=6))
    want = []
    while a._requests:
        for d in a.step():
            want.extend(d.token_ids)
    hashes = compute_block_hashes(prompt[:24], 8)
    dev_blocks = a.export_blocks_device(hashes)
    host_blocks = a.export_blocks(hashes)
    for h in hashes:
        assert dev_blocks[h].device.type == "cuda"
        assert torch.equal(dev_blocks[h].cpu().view(torch.uint8),
                           host_blocks[h].view(torch.uint8))
    cpu_cache = {k: [t.cpu() for t in v] for k, v in a.cache.items()}
    pages = torch.tensor([1, 2, 3])
    ref = kvc.extract_blocks(cpu_cache, pages, 8)
    got = kvc.extract_blocks(a.cache, pages.to(dev), 8)
    assert torch.equal(got.cpu().view(torch.uint8), ref.view(torch.uint8))
    b = _tiny_engine(dev, kv_quant=kv_quant)
    assert b.import_blocks(dev_blocks) == 3
    b.add_request("b", prompt, SamplingParams(max_tokens=6))
    out = []
    while b._requests:
        for d in b.step():
            out.extend(d.token_ids)
    assert out == want
    assert b.scheduler.prefix_hit_tokens == 24


def test_device_capture_records_the_kernels_off_the_engine_thread(dev, tmp_path):
    """The device profiler on the card: an engine stepping on its own
    thread while a capture runs on a third (as the worker's status server
    takes one) records K1 and K2 by name; each window's CUDA-event span
    lands in `window_device_s_ewma`, and the drift audit reads both
    series in band."""
    import json
    import threading

    from dynamo_tpu_torch.runtime import device_profiler

    prof = device_profiler.DeviceProfiler("card-test", enabled=True,
                                          dump_dir=str(tmp_path))
    core = _tiny_engine(dev)
    core.profiler = prof
    stop = threading.Event()

    def loop():
        i = 0
        while not stop.is_set():
            if not core.has_work:
                _add_requests(core, i)
                i += 1
            core.step()

    engine = threading.Thread(target=loop)
    engine.start()
    try:
        res = {}
        cap = threading.Thread(target=lambda: res.update(prof.capture(400)))
        cap.start()
        cap.join(timeout=120)
    finally:
        stop.set()
        engine.join(timeout=60)
    assert not engine.is_alive() and res["ok"], res
    with open(res["trace"]) as f:
        summary = device_profiler.summarize_trace(json.load(f))
    names = summary["kernel_names"]
    assert any("paged_decode_kernel" in n for n in names), names[:20]
    assert any("paged_prefill_kernel" in n for n in names), names[:20]
    assert 0 < summary["busy_share"] <= 1
    assert core.counters.window_device_s_ewma > 0
    ratios = prof.audit_engine(core)
    assert 0 < ratios["kv_decode"] <= prof.auditor.band_hi
    assert 0 < ratios["window_time"] <= prof.auditor.band_hi


def _add_requests(core, i):
    from dynamo_tpu_torch.engine.sampling import SamplingParams

    for j, n in enumerate((5, 40, 17)):
        core.add_request(f"c{i}-{j}", list(range(1, n + 1)),
                         SamplingParams(max_tokens=24))


# -- the KV tiers' copies on the card -----------------------------------------

TIER_WIRE = (2, 16, 64, 512)       # llama-3-1b's wire block: 2 MiB in bf16


def _tier_manager(dev, device_blocks, host_blocks, disk_blocks=0):
    """A tiered manager over a page array on the card (the engine's
    extract and inject reduced to index_select / index_copy_)."""
    from dynamo_tpu_torch.llm.block_manager import ManagedBlockSource, TieredConfig

    cache = torch.zeros((device_blocks, *TIER_WIRE), dtype=torch.bfloat16,
                        device=dev)

    def ids(pages):
        return torch.tensor(pages, pin_memory=True).to(dev, non_blocking=True)

    src = ManagedBlockSource(
        TieredConfig(device_blocks=device_blocks, host_blocks=host_blocks,
                     disk_blocks=disk_blocks),
        extract_fn=lambda pages: cache.index_select(0, ids(pages)),
        inject_fn=lambda pages, data: cache.index_copy_(0, ids(pages), data),
        wire_shape=TIER_WIRE, wire_dtype=torch.bfloat16, device=dev)
    return cache, src.manager


def _seal(mgr, cache, h, value):
    [page] = mgr.allocate(1)
    cache[page].fill_(value)
    mgr.register(page, h)
    mgr.release([page])
    return page


def _busy(ms=50):
    """Hold the current stream for about `ms` milliseconds, so the copies
    enqueued after it are still in flight when the host moves on."""
    torch.cuda._sleep(int(ms * 1e6))


def test_offload_reads_the_page_before_its_overwrite(dev):
    """Evict a block while the engine's stream is busy, overwrite its page
    at once, then onboard it from G2: the old bytes come back."""
    cache, mgr = _tier_manager(dev, device_blocks=3, host_blocks=4)
    _seal(mgr, cache, 11, 1.0)
    _seal(mgr, cache, 12, 2.0)
    _busy()
    pages = mgr.allocate(2)                  # evicts both into G2
    assert mgr.offloaded_blocks == 2
    for p in pages:
        cache[p].fill_(-7.0)                 # the pages' next owner writes
    mgr.release(pages)
    _busy()
    n, ids = mgr.match_and_onboard([11, 12])
    assert n == 2 and mgr.onboarded_blocks == 2
    torch.cuda.synchronize()
    assert (cache[ids[0]] == 1.0).all() and (cache[ids[1]] == 2.0).all()
    for h, v in ((11, 1.0), (12, 2.0)):
        assert (mgr.export_block(h) == v).all()
    mgr.close()


def test_g2_slot_reuse_waits_for_the_onboard_reading_it(dev):
    """One G2 slot: the onboard of h1 from it and the offload of h2 into it
    happen in one call, the onboard still in flight behind a busy stream.
    h1's page gets h1's bytes and the slot ends up holding h2's."""
    cache, mgr = _tier_manager(dev, device_blocks=3, host_blocks=1)
    p1 = _seal(mgr, cache, 1, 3.0)
    _seal(mgr, cache, 2, 5.0)
    # Make h1 the LRU head, then evict it into the slot and keep its
    # page pinned, so the next allocation must evict h2.
    mgr.device.registry.inactive.move_to_end(2)
    [held] = mgr.allocate(1)
    assert held == p1 and mgr.host.registry.lookup(1) is not None
    cache[held].fill_(-1.0)
    _busy()
    n, ids = mgr.match_and_onboard([1])
    assert n == 1
    assert mgr.host.registry.lookup(2) is not None     # h2 took the slot
    assert mgr.host.registry.lookup(1) is None
    torch.cuda.synchronize()
    assert (cache[ids[0]] == 3.0).all()
    assert (mgr.export_block(2) == 5.0).all()
    mgr.close()


def test_g3_round_trip_on_the_card(dev):
    """G2 of one slot spills to G3; the blocks come back bit-equal."""
    cache, mgr = _tier_manager(dev, device_blocks=3, host_blocks=1,
                               disk_blocks=4)
    gen = torch.Generator(device=dev).manual_seed(3)
    want = {}
    for h in (21, 22, 23, 24):
        [page] = mgr.allocate(1)
        cache[page].copy_(torch.randn(TIER_WIRE, generator=gen, device=dev))
        want[h] = cache[page].clone()
        mgr.register(page, h)
        mgr.release([page])
    assert mgr.stats["g3_resident"] == 1 and mgr.stats["g2_resident"] == 1
    n, ids = mgr.match_and_onboard([21, 22])    # both from G3 by then
    assert n == 2
    for h, page in zip((21, 22), ids):
        assert torch.equal(cache[page].view(torch.uint8),
                           want[h].view(torch.uint8))
    path = mgr._disk_file
    mgr.close()
    assert not os.path.exists(path)


def test_offload_makes_no_host_sync(dev):
    """An engine's allocation that evicts into G2 enqueues the extract and
    the copies without a synchronizing call ("error" would raise)."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams

    core = _tiny_engine(dev, host_blocks=32)
    for i in range(3):
        core.add_request(f"w{i}", list(range(100 * i + 1, 100 * i + 41)),
                         SamplingParams(max_tokens=2))
    while core._requests:
        core.step()
    src = core.allocator
    assert len(src.manager.device.registry.inactive) >= 12
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pages = src.allocate(src.free_blocks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert src.manager.offloaded_blocks >= 12
    src.release(pages)
    core.allocator.manager.close()


def test_safetensors_bf16_shards_land_on_the_card(dev, tmp_path):
    """A bf16 checkpoint in two shards (chip_smoke's writer): the reader
    hands out bf16 views of the mapped file (no host copy, no float32),
    and load_params places every tensor on the card, equal to what was
    written."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from dynamo_tpu_torch.models import loader
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.weights import init_params

    cfg = get_config("tiny-test").replace(head_dim=32, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_params(cfg, gen, dev)
    (tmp_path / "config.json").write_text(__import__("json").dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_size,
        "tie_word_embeddings": True}))
    shards = [{"model.embed_tokens.weight": state["embed"],
               "model.norm.weight": state["final_norm"]}, {}]
    for i, layer in enumerate(state["layers"]):
        p = f"model.layers.{i}."
        for ours, hf in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
            shards[1][p + f"self_attn.{hf}_proj.weight"] = \
                layer["attn"][ours].t()
        for hf in ("gate", "up", "down"):
            shards[1][p + f"mlp.{hf}_proj.weight"] = layer["mlp"]["w_" + hf].t()
        shards[0][p + "input_layernorm.weight"] = layer["attn_norm"]
        shards[0][p + "post_attention_layernorm.weight"] = layer["mlp_norm"]
    for j, shard in enumerate(shards):
        chip_smoke.write_safetensors(
            torch, tmp_path / f"m{j}.safetensors",
            {k: v.contiguous().cpu() for k, v in shard.items()})
    for path in loader.checkpoint_shards(str(tmp_path)):
        f = loader.SafetensorsFile(path)
        base = torch.frombuffer(f._map, dtype=torch.uint8).data_ptr()
        for k in f.keys():
            t = f.get(k)
            assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
            assert base <= t.data_ptr() < base + len(f._map)
        f.close()
    _, got = loader.load_params(str(tmp_path), device="cuda")
    want, got = chip_smoke.state_leaves(state), chip_smoke.state_leaves(got)
    assert want.keys() == got.keys()
    for k, b in got.items():
        assert b.device.type == "cuda" and b.dtype == torch.bfloat16
        assert torch.equal(want[k], b), k


def test_packed_prefill_with_embeddings_on_k2(dev):
    """The multimodal prefill through the packed step (K2) against the
    gather path's forward step with the same input embeddings: two
    segments, one with an embedding span, on the card."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.models.weights import init_params

    cfg = get_config("tiny-test").replace(head_dim=32, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = init_params(cfg, gen, dev)
    bs, L, n = 8, 24, 10
    toks = torch.randint(1, cfg.vocab_size, (2, L), generator=gen,
                         device=dev, dtype=torch.int32)
    toks[0, :n] = 0
    emb = torch.randn(2, L, cfg.hidden_size, generator=gen, device=dev)
    mask = torch.zeros(2, L, dtype=torch.bool, device=dev)
    mask[0, :n] = True
    pos = torch.arange(L, device=dev, dtype=torch.int32).expand(2, L)
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], device=dev, dtype=torch.int32)
    sl = torch.full((2,), L, device=dev, dtype=torch.int32)

    def cache():
        return kvc.init_cache(kvc.KvCacheConfig.for_model(
            cfg, num_blocks=8, block_size=bs), dev)

    want, _ = llama.make_forward_step(cfg, bs)(
        state, cache(), toks, pos, sl, bt, sl - 1, input_embeds=emb,
        embed_mask=mask)
    p0 = paged_prefill_attention.launches
    i32 = lambda x: torch.tensor(x, device=dev, dtype=torch.int32)  # noqa: E731
    got, _ = llama.make_packed_prefill_step(cfg, bs)(
        state, cache(), toks.reshape(-1), pos.reshape(-1),
        i32([0] * L + [1] * L), bt, i32([0, L]), i32([L, L]), sl,
        i32([L - 1, 2 * L - 1]), input_embeds=emb.reshape(2 * L, -1),
        embed_mask=mask.reshape(-1))
    assert paged_prefill_attention.launches > p0
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert err < 5e-2, err
    assert torch.equal(got.argmax(-1), want.argmax(-1))
