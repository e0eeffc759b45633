"""The port's CUDA kernels and engine on the card.

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

import pytest
import torch

from dynamo_tpu_torch.ops.cuda import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)

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


@pytest.mark.parametrize("hq,hkv,d,bs,cap", [
    (32, 8, 64, 64, None), (32, 8, 64, 16, 30.0), (16, 16, 128, 32, None),
    (8, 2, 32, 8, None), (32, 4, 128, 64, None)])
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


@pytest.mark.parametrize("hq,hkv,d,bs,cap", [
    (32, 8, 64, 64, None), (32, 8, 64, 16, 30.0), (8, 8, 128, 32, None),
    (8, 2, 32, 8, None)])
def test_prefill_kernel_matches_plain(dev, hq, hkv, d, bs, cap):
    gen = torch.Generator(device=dev).manual_seed(1)
    R, P = 6, 16  # P * bs covers the longest context at every bs
    segs = [(0, 37, 37), (40, 64, 90), (104, 1, 1), (112, 100, 100)]  # start, len, seq_len
    T = 216
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
    assert out[37:40].abs().max().item() == 0      # alignment gap rows
    assert out[212:].abs().max().item() == 0       # tail rows


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


def test_engine_serves_greedy_through_both_kernels(dev):
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.models.config import get_config

    cfg = get_config("tiny-test").replace(head_dim=32, dtype=torch.bfloat16)
    core = EngineCore(EngineConfig(
        model=cfg, num_blocks=64, device="cuda",
        scheduler=SchedulerConfig(max_seqs=8, block_size=8,
                                  max_pages_per_seq=16, max_prefill_chunk=32,
                                  decode_buckets=(1, 2, 4, 8),
                                  prefill_buckets=(8, 16, 32))))
    d0, p0 = paged_decode_attention.launches, paged_prefill_attention.launches
    for i, n in enumerate((5, 40, 17)):
        core.add_request(f"r{i}", list(range(1, n + 1)),
                         SamplingParams(max_tokens=20))
    out = {}
    for _ in range(500):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core.has_work:
            break
    assert sorted(out) == ["r0", "r1", "r2"]
    assert all(len(t) == 20 for t in out.values())
    assert paged_decode_attention.launches > d0
    assert paged_prefill_attention.launches > p0
    assert core.counters.window_dispatches > 0
