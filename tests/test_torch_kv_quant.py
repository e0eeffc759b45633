"""The port's int8 KV cache against the JAX package's, on the CPU.

- Row quantization gives the same bytes (int8 rows and f32 scales) as
  JAX's, all-zero rows and exact .5 ties included, and dequantization the
  same values.
- The in-place int8 writes and the dequantizing gather match JAX's
  functional ones.
- The int8 plain versions of the paged decode and prefill kernels match
  the Pallas kernels run in interpret mode with the scales.
- The forward, packed-prefill and decode-window steps on an int8 cache
  match JAX's (`tiny-test`, f32, through the weight bridge), and greedy
  `EngineCore` tokens equal the JAX engine's with `kv_quant="int8"`, on
  the windows and on the single step.
- The wrappers raise on scales without an int8 cache, and the reverse.

Tolerances: the quantization and the cache ops are held to exact
equality.  Attention over the dequantized operands as in
tests/test_torch_kernels.py (f32 1e-5, bf16 one output ulp, 2**-6).  The
steps' logits to 1e-4 absolute, as tests/test_torch_model.py.  The rows
the steps write come from K/V that XLA and PyTorch compute to f32
rounding, not bit for bit (summation order in the projections): their
scales agree to 1e-5 relative and their int8 values to one quantization
step (a row whose x / scale sits at a .5
tie in one framework may round the other way in the other).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_cache as jkvc
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops.pallas import paged_decode_attention as jax_decode
from dynamo_tpu.ops.pallas import paged_prefill_attention as jax_prefill
from dynamo_tpu_torch.engine import kv_cache as tkvc
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops.cuda import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

BS = 8
LOGIT_TOL = 1e-4
TOLS = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
GEOM = dict(max_seqs=8, block_size=8, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16))


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    if dtype == "bfloat16":
        a = arr.astype(ml_dtypes.bfloat16)
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return jnp.asarray(a), t
    a = arr.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _rows(rng, n, H, D):
    """Random rows plus an all-zero row, and a row whose head 0 has
    amax 127 (scale exactly 1) and exact .5 ties (both ways of even)."""
    x = rng.standard_normal((n, H * D)).astype(np.float32) * 3
    x[1] = 0.0
    x[2, :D] = 0.0
    x[2, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_rows_are_jax_bytes(dtype):
    H, D = 4, 16
    ja, tt = _pair(_rows(np.random.default_rng(0), 9, H, D), dtype)
    jq, js = jkvc.quantize_kv_rows(ja, H)
    tq, ts = tkvc.quantize_kv_rows(tt, H)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    # Ties round half to even; the all-zero row is all zeros.
    assert tq[2, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    assert not tq[1].any() and (ts[1] > 0).all()
    for out in (torch.bfloat16, torch.float32):
        jd = jkvc.dequantize_rows(jq.reshape(9, H, D), js,
                                  jnp.dtype(str(out).split(".")[-1]))
        td = tkvc.dequantize_rows(tq.reshape(9, H, D), ts, out)
        assert td.dtype == out
        np.testing.assert_array_equal(_np(td), _np(jd))


def test_int8_cache_config_and_init_match_jax():
    jc, tc = jcfg.get_config("tiny-test"), tcfg.get_config("tiny-test")
    j = jkvc.KvCacheConfig.for_model(jc, 16, BS, kv_quant="int8")
    t = tkvc.KvCacheConfig.for_model(tc, 16, BS, kv_quant="int8")
    assert t.quantized and t.store_dtype == torch.int8
    assert t.bytes_per_context_token == j.bytes_per_context_token
    assert t.bytes_per_block == j.bytes_per_block
    tb = tkvc.KvCacheConfig.for_model(tc, 16, BS)
    assert tb.bytes_per_block == jkvc.KvCacheConfig.for_model(
        jc, 16, BS).bytes_per_block
    cache = tkvc.init_cache(t, "cpu")
    jcache = jkvc.init_cache(j)
    assert sorted(cache) == sorted(jcache) == ["k", "k_scale", "v", "v_scale"]
    for key in cache:
        assert [tuple(x.shape) for x in cache[key]] == [
            a.shape for a in jcache[key]]
    assert cache["k"][0].dtype == torch.int8
    assert cache["v_scale"][0].dtype == torch.float32
    assert tkvc.cache_is_quantized(cache)
    assert not tkvc.cache_is_quantized(tkvc.init_cache(tb, "cpu"))
    with pytest.raises(ValueError, match="kv_quant"):
        tkvc.KvCacheConfig.for_model(tc, 16, BS, kv_quant="fp8")


def test_write_and_gather_quant_match_jax():
    rng = np.random.default_rng(1)
    H, D, S = 2, 16, 16 * BS
    F = H * D
    slots = np.asarray([9, 10, 30, 31, 64, 65, 127, 8], np.int32)
    k = _rows(rng, 8, H, D)
    v = rng.standard_normal((8, F)).astype(np.float32)
    j = [jnp.zeros((S, F), jnp.int8), jnp.zeros((S, F), jnp.int8),
         jnp.zeros((S, H), jnp.float32), jnp.zeros((S, H), jnp.float32)]
    t = [torch.zeros(S, F, dtype=torch.int8), torch.zeros(S, F, dtype=torch.int8),
         torch.zeros(S, H), torch.zeros(S, H)]
    j = jkvc.write_kv_quant(*j, jnp.asarray(slots), jnp.asarray(k),
                            jnp.asarray(v))
    tkvc.write_kv_quant(*t, _t(slots), _t(k), _t(v))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # Out of range: JAX drops the row, the port sends it to the null
    # block; every real block is the same on both sides.
    j2 = jkvc.write_kv_quant(*j, jnp.asarray([S + 3]), jnp.asarray(k[:1]),
                             jnp.asarray(v[:1]))
    tkvc.write_kv_quant(*t, _t([S + 3]), _t(k[:1]), _t(v[:1]))
    for a, b in zip(j2, t):
        np.testing.assert_array_equal(b.numpy()[BS:], np.asarray(a)[BS:])
    ctx = np.asarray([[8, 9, 10, 11, 300], [64, 65, 66, 30, 31]], np.int32)
    for out in (torch.float32, torch.bfloat16):
        jd = jnp.dtype(str(out).split(".")[-1])
        jk, jv = jkvc.gather_kv_quant(*j, jnp.asarray(ctx), H, out_dtype=jd)
        tk, tv = tkvc.gather_kv_quant(*t, _t(ctx), H, out_dtype=out)
        assert tk.shape == (2, 5, H, D) and tk.dtype == out
        np.testing.assert_array_equal(_np(tk), _np(jk))
        np.testing.assert_array_equal(_np(tv), _np(jv))


# Kernel geometry: GQA group 4, non-contiguous pages, ragged/full/empty rows.
HQ, HKV, D = 8, 2, 32
DECODE_TABLES = [[3, 9, 17, 2], [11, 4, 0, 0], [21, 0, 0, 0], [0, 0, 0, 0],
                 [5, 6, 7, 8]]
DECODE_LENS = [29, 9, 1, 0, 32]
PREFILL_T = 48
PREFILL_SEGS = [  # (q_start, q_len, seq_len, table): one cached prefix
    (0, 13, 13, [4, 9, 0, 0, 0, 0]),
    (16, 20, 27, [12, 3, 30, 7, 0, 0]),
    (40, 5, 5, [17, 0, 0, 0, 0, 0]),
    (0, 0, 0, [0, 0, 0, 0, 0, 0]),
]


def _int8_pool(seed):
    """An int8 pool with its scales, quantized from random rows: numpy
    arrays (int8 K, int8 V, f32 K scales, f32 V scales)."""
    rng = np.random.default_rng(seed)
    S = 32 * BS
    out = []
    for _ in range(2):
        q, s = jkvc.quantize_kv_rows(
            jnp.asarray(rng.standard_normal((S, HKV * D)), jnp.float32), HKV)
        out.append((np.asarray(q), np.asarray(s)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("soft_cap", [None, 5.0])
def test_int8_decode_plain_matches_jax_kernel(dtype, soft_cap):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng.standard_normal((len(DECODE_LENS), HQ, D)), dtype)
    pool = _int8_pool(3)
    bt = np.asarray(DECODE_TABLES, np.int32)
    sl = np.asarray(DECODE_LENS, np.int32)
    jk, jv, jks, jvs = map(jnp.asarray, pool)
    want = jax_decode(jq, jk, jv, jnp.asarray(bt), jnp.asarray(sl),
                      block_size=BS, soft_cap=soft_cap, interpret=True,
                      k_scale=jks, v_scale=jvs)
    tk, tv, tks, tvs = map(_t, pool)
    got = paged_decode_attention(tq, tk, tv, _t(bt), _t(sl), block_size=BS,
                                 soft_cap=soft_cap, k_scale=tks, v_scale=tvs)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOLS[dtype])
    assert not _np(got)[3].any()
    # The wrapper took the plain version: no kernel body launched.
    assert paged_decode_attention.launches_int8 == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("soft_cap", [None, 5.0])
def test_int8_prefill_plain_matches_jax_kernel(dtype, soft_cap):
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng.standard_normal((PREFILL_T, HQ, D)), dtype)
    pool = _int8_pool(5)
    cols = [np.asarray([s[i] for s in PREFILL_SEGS], np.int32)
            for i in range(3)]
    bt = np.asarray([s[3] for s in PREFILL_SEGS], np.int32)
    qs, ql, sl = cols
    jk, jv, jks, jvs = map(jnp.asarray, pool)
    want = jax_prefill(jq, jk, jv, jnp.asarray(bt), jnp.asarray(sl),
                       jnp.asarray(qs), jnp.asarray(ql), block_size=BS,
                       soft_cap=soft_cap, interpret=True, k_scale=jks,
                       v_scale=jvs)
    tk, tv, tks, tvs = map(_t, pool)
    got = paged_prefill_attention_plain(
        tq, tk, tv, _t(bt), _t(sl), _t(qs), _t(ql), block_size=BS,
        soft_cap=soft_cap, k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOLS[dtype])
    owned = np.zeros(PREFILL_T, bool)
    for q0, n, _, _ in PREFILL_SEGS:
        owned[q0:q0 + n] = True
    assert not _np(got)[~owned].any()


def test_wrappers_raise_on_mismatched_scales():
    q = torch.zeros(1, HQ, D)
    bf = torch.zeros(BS, HKV * D)
    i8 = torch.zeros(BS, HKV * D, dtype=torch.int8)
    sc = torch.ones(BS, HKV)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    sl = torch.ones(1, dtype=torch.int32)
    decode = (paged_decode_attention, paged_decode_attention_plain)
    for fn in decode:
        with pytest.raises(ValueError, match="scales imply an int8 cache"):
            fn(q, bf, bf, bt, sl, block_size=BS, k_scale=sc, v_scale=sc)
        with pytest.raises(ValueError, match="needs its k_scale"):
            fn(q, i8, i8, bt, sl, block_size=BS)
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            fn(q, i8, i8, bt, sl, block_size=BS, k_scale=sc)
    for fn in (paged_prefill_attention, paged_prefill_attention_plain):
        q8 = torch.zeros(8, HQ, D)
        with pytest.raises(ValueError, match="scales imply an int8 cache"):
            fn(q8, bf, bf, bt, sl, sl, sl, block_size=BS, k_scale=sc,
               v_scale=sc)
        with pytest.raises(ValueError, match="needs its k_scale"):
            fn(q8, i8, i8, bt, sl, sl, sl, block_size=BS)
    # A device without a kernel raises after the argument check.
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="no paged decode kernel"):
        paged_decode_attention(
            torch.zeros(1, HQ, D, **meta),
            torch.zeros(BS, HKV * D, dtype=torch.int8, **meta),
            torch.zeros(BS, HKV * D, dtype=torch.int8, **meta),
            torch.zeros(1, 1, dtype=torch.int32, **meta),
            torch.zeros(1, dtype=torch.int32, **meta), block_size=BS,
            k_scale=torch.zeros(BS, HKV, **meta),
            v_scale=torch.zeros(BS, HKV, **meta))


# ---------------------------------------------------------------------------
# Model steps and the engine on an int8 cache


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.get_config("tiny-test"), tcfg.get_config("tiny-test")
    params = jllama.init_params(jc, jax.random.key(11))
    return jc, tc, params, from_jax_params(jax.device_get(params), "cpu")


def _caches(jc, tc, num_blocks=16):
    jcache = jkvc.init_cache(jkvc.KvCacheConfig.for_model(
        jc, num_blocks=num_blocks, block_size=BS, kv_quant="int8"))
    tcache = tkvc.init_cache(tkvc.KvCacheConfig.for_model(
        tc, num_blocks=num_blocks, block_size=BS, kv_quant="int8"), "cpu")
    return jcache, tcache


def _assert_caches_equal(jcache, tcache, rows=slice(BS, None)):
    """Every real block (past the null block) holds the same int8 rows,
    to one quantization step, and the same scales, to f32 summation
    order."""
    for key in ("k", "v"):
        for a, b in zip(jcache[key], tcache[key]):
            diff = np.abs(b[rows].numpy().astype(np.int32)
                          - np.asarray(a)[rows].astype(np.int32))
            assert diff.max() <= 1
    for key in ("k_scale", "v_scale"):
        for a, b in zip(jcache[key], tcache[key]):
            np.testing.assert_allclose(b[rows].numpy(), np.asarray(a)[rows],
                                       rtol=1e-5, atol=0)


def _sync(jcache, tcache):
    """Copy JAX's cache into the port's, so a step's comparison starts
    from the same int8 rows and scales."""
    for key in tcache:
        for a, b in zip(jcache[key], tcache[key]):
            b.copy_(torch.from_numpy(np.array(a)))


def test_int8_forward_step_matches_jax(model):
    """Chunked prefill on the gather path, then a decode step through the
    decode kernels' int8 branches (JAX's Pallas kernel in interpret
    mode), on ragged rows and a pad row."""
    jc, tc, params, state = model
    jcache, tcache = _caches(jc, tc)
    bt = np.asarray([[3, 9, 0, 0], [5, 6, 7, 0], [0, 0, 0, 0]], np.int32)
    toks = np.asarray([[5, 6, 7, 8, 9], [1, 2, 3, 4, 0], [0] * 5], np.int32)
    pad = 128 * BS
    pos = np.asarray([[0, 1, 2, 3, 4], [0, 1, 2, 3, pad], [pad] * 5], np.int32)
    sl = np.asarray([5, 4, 0], np.int32)
    jl, jcache = jllama.make_forward_step(jc, BS)(
        params, jcache, *map(jnp.asarray, (toks, pos, sl, bt)))
    tl, tcache = tllama.make_forward_step(tc, BS)(
        state, tcache, *map(_t, (toks, pos, sl, bt)))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=0,
                               atol=LOGIT_TOL)
    _assert_caches_equal(jcache, tcache)
    _sync(jcache, tcache)
    nxt = np.asarray([[11], [12], [0]], np.int32)
    dpos = np.asarray([[5], [4], [pad]], np.int32)
    dsl = np.asarray([6, 5, 0], np.int32)
    smp = np.zeros((3,), np.int32)
    jl, jcache = jllama.make_forward_step(jc, BS, use_pallas_decode=True)(
        params, jcache, *map(jnp.asarray, (nxt, dpos, dsl, bt, smp)))
    tl, tcache = tllama.make_forward_step(tc, BS, use_decode_kernel=True)(
        state, tcache, *map(_t, (nxt, dpos, dsl, bt, smp)))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=0,
                               atol=LOGIT_TOL)
    _assert_caches_equal(jcache, tcache)


def test_int8_packed_prefill_step_matches_jax(model):
    """Two packed segments, one over a cached int8 prefix, and pad rows,
    through both packed steps (JAX kernel in interpret mode)."""
    jc, tc, params, state = model
    jcache, tcache = _caches(jc, tc)
    bt = np.asarray([[2, 3, 0], [4, 5, 6]], np.int32)
    pre = (np.asarray([[21, 22, 23, 24, 25, 26]], np.int32),
           np.arange(6, dtype=np.int32)[None], np.asarray([6], np.int32),
           bt[1:])
    _, jcache = jllama.make_forward_step(jc, BS)(
        params, jcache, *map(jnp.asarray, pre))
    tllama.make_forward_step(tc, BS)(state, tcache, *map(_t, pre))
    _assert_caches_equal(jcache, tcache)
    _sync(jcache, tcache)
    T, R, pad = 24, 4, 128 * BS
    tokens = np.zeros(T, np.int32)
    positions = np.full(T, pad, np.int32)
    seg = np.zeros(T, np.int32)
    tokens[0:7] = [1, 2, 3, 4, 5, 6, 7]
    positions[0:7] = np.arange(7)
    tokens[8:19] = np.arange(30, 41)
    positions[8:19] = np.arange(6, 17)
    seg[8:19] = 1
    bts = np.zeros((R, 3), np.int32)
    bts[:2] = bt
    args = (tokens, positions, seg, bts, np.asarray([0, 8, 0, 0], np.int32),
            np.asarray([7, 11, 0, 0], np.int32),
            np.asarray([7, 17, 0, 0], np.int32),
            np.asarray([6, 18, 0, 0], np.int32))
    jl, jcache = jllama.make_packed_prefill_step(jc, BS)(
        params, jcache, *map(jnp.asarray, args))
    tl, tcache = tllama.make_packed_prefill_step(tc, BS)(
        state, tcache, *map(_t, args))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=0,
                               atol=LOGIT_TOL)
    _assert_caches_equal(jcache, tcache)


def test_int8_decode_window_matches_jax(model):
    """A 4-step greedy window over a prefilled row and a pad row on an
    int8 cache: tokens, positions, lengths and the written rows."""
    jc, tc, params, state = model
    jcache, tcache = _caches(jc, tc)
    bt = np.asarray([[2, 3, 4], [0, 0, 0]], np.int32)
    pre = (np.asarray([[9, 8, 7, 6, 5, 4, 3]], np.int32),
           np.arange(7, dtype=np.int32)[None], np.asarray([7], np.int32),
           bt[:1])
    jl, jcache = jllama.make_forward_step(jc, BS)(
        params, jcache, *map(jnp.asarray, pre), jnp.asarray([6]))
    tllama.make_forward_step(tc, BS)(state, tcache, *map(_t, pre))
    first = int(np.argmax(np.asarray(jl)[0]))
    K, pad = 4, 128 * BS
    last = np.asarray([first, 0], np.int32)
    pos0 = np.asarray([7, pad], np.int32)
    sl0 = np.asarray([8, 0], np.int32)
    zeros_i = np.zeros(2, np.int32)
    jout = jllama.make_decode_window(jc, BS, K, use_pallas_decode=True,
                                     greedy_only=True)(
        params, jcache, *map(jnp.asarray, (last, pos0, sl0, bt)),
        jnp.zeros(2), jnp.asarray(zeros_i), jnp.ones(2),
        jnp.zeros((2, 2), jnp.uint32), jnp.asarray(zeros_i))
    tout = tllama.make_decode_window(tc, BS, K, use_decode_kernel=True,
                                     greedy_only=True)(
        state, tcache, *map(_t, (last, pos0, sl0, bt)), torch.zeros(2),
        _t(zeros_i), torch.ones(2), [None, None], [0, 0])
    np.testing.assert_array_equal(tout[1][:, 0].numpy(),
                                  np.asarray(jout[1])[:, 0])
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    # Rows 0..10 of the prefilled sequence (the window wrote 7..10).
    _assert_caches_equal(jout[0], tout[0], slice(2 * BS, 2 * BS + 11))


def _run(core, requests, max_steps=2000):
    for rid, (prompt, sp) in requests.items():
        core.add_request(rid, prompt, sp)
    toks, lps = {}, {}
    for _ in range(max_steps):
        for d in core.step():
            toks.setdefault(d.request_id, []).extend(d.token_ids)
            if d.logprobs:
                lps.setdefault(d.request_id, []).extend(d.logprobs)
        if not core._requests:
            break
    return toks, lps


def test_int8_engine_greedy_tokens_match_jax(model):
    """Greedy fleet on an int8 cache, no prefix cache on either side:
    token-identical on the windows, then with a logprob row on the
    single step (logprobs to 1e-4)."""
    jc, tc, params, state = model
    prompts = {"a": [1, 2, 3], "b": list(range(10, 31)),
               "c": [9, 8, 7, 6, 5], "d": list(range(40, 52))}
    for logprob_rows in ((), ("a",)):
        jcore = JaxEngineCore(JaxEngineConfig(
            model=jc, num_blocks=64, packed_prefill=True, kv_quant="int8",
            enable_prefix_cache=False,
            scheduler=JaxSchedulerConfig(**GEOM)), params=params)
        want = _run(jcore, {r: (p, JaxSamplingParams(
            max_tokens=12, logprobs=r in logprob_rows))
            for r, p in prompts.items()})
        core = EngineCore(EngineConfig(
            model=tc, num_blocks=64, device="cpu", kv_quant="int8",
            enable_prefix_cache=False, scheduler=SchedulerConfig(**GEOM)),
            params=state)
        assert tkvc.cache_is_quantized(core.cache)
        got = _run(core, {r: (p, SamplingParams(
            max_tokens=12, logprobs=r in logprob_rows))
            for r, p in prompts.items()})
        assert got[0] == want[0]
        assert all(len(t) == 12 for t in got[0].values())
        if logprob_rows:
            np.testing.assert_allclose(got[1]["a"], want[1]["a"], rtol=0,
                                       atol=1e-4)
            assert core.counters.single_step_dispatches > 0
        else:
            assert core.counters.window_dispatches > 0
