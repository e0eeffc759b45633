"""The port's model layers against the JAX package, through the weight
bridge: config presets, weight bridge and init, kv_cache ops, rms_norm and
rope, and the three step factories (forward, packed prefill, decode
window) on `tiny-test` and `tiny-gemma` at f32.

Tolerances: kv_cache ops move data and must match element for element;
logits agree to 1e-4 absolute (f32 end to end, only summation order and
transcendental rounding differ between XLA and PyTorch); greedy tokens
must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_cache as jkvc
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.engine import kv_cache as tkvc
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.weights import from_jax_params, init_params

LOGIT_TOL = 1e-4
BS = 8


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype is not None else t


def _cfg(name):
    return jcfg.get_config(name), tcfg.get_config(name)


@pytest.fixture(scope="module", params=["tiny-test", "tiny-gemma"])
def model(request):
    jc, tc = _cfg(request.param)
    params = jllama.init_params(jc, jax.random.key(7))
    return jc, tc, params, from_jax_params(jax.device_get(params), "cpu")


def test_presets_match_the_jax_package():
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    for name, jc in jcfg.PRESETS.items():
        tc = tcfg.PRESETS[name]
        for f in dataclasses.fields(jc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if f.name == "dtype":
                assert str(b).split(".")[-1] == jnp.dtype(a).name
            else:
                assert a == b, (name, f.name)
        assert tc.param_count() == jc.param_count()


def test_weight_bridge_is_bitwise_for_bf16():
    jc, _ = _cfg("tiny-test")
    params = jllama.init_params(jc.replace(dtype=jnp.bfloat16),
                                jax.random.key(3))
    state = from_jax_params(jax.device_get(params), "cpu")
    flat_j = jax.tree_util.tree_leaves(params)
    flat_t = jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(
            np.asarray(a).view(np.int16), b.view(torch.int16).numpy())


def test_init_params_shapes_and_std():
    jc, tc = _cfg("tiny-test")
    tc = tc.replace(tie_embeddings=False)
    ref = jax.device_get(jllama.init_params(jc.replace(tie_embeddings=False),
                                            jax.random.key(0)))
    gen = torch.Generator().manual_seed(0)
    state = init_params(tc, gen, "cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, ref)
    shapes_t = jax.tree_util.tree_map(
        lambda t: tuple(t.shape), state,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes_j == shapes_t
    w = state["layers"][0]["mlp"]["w_down"]
    assert abs(w.std().item() - tc.intermediate_size ** -0.5) < 0.1 * tc.intermediate_size ** -0.5
    assert torch.equal(state["final_norm"], torch.ones(tc.hidden_size))


def test_kv_cache_ops_match_jax_elementwise():
    rng = np.random.default_rng(0)
    B, T, P, Hkv, D = 3, 5, 4, 2, 8
    S = 16 * BS
    bt = np.asarray([[3, 9, 0, 0], [11, 4, 5, 0], [7, 0, 0, 0]], np.int32)
    pos = np.asarray([[0, 1, 2, 3, 4], [14, 15, 16, 17, 18],
                      [5, 6, 7, 999, 999]], np.int32)   # 999: past the table
    want = np.asarray(jkvc.slots_for_positions(jnp.asarray(bt),
                                               jnp.asarray(pos), BS))
    got = tkvc.slots_for_positions(_t(bt), _t(pos), BS).numpy()
    np.testing.assert_array_equal(got, want)
    # Writes: distinct slots (pad duplicates may land in any order).
    slots = want.reshape(-1)[:12]
    k = rng.standard_normal((12, Hkv * D)).astype(np.float32)
    v = rng.standard_normal((12, Hkv * D)).astype(np.float32)
    kc = rng.standard_normal((S, Hkv * D)).astype(np.float32)
    vc = rng.standard_normal((S, Hkv * D)).astype(np.float32)
    jk, jv = jkvc.write_kv(jnp.asarray(kc), jnp.asarray(vc),
                           jnp.asarray(slots), jnp.asarray(k), jnp.asarray(v))
    tk, tv = _t(kc), _t(vc)
    tkvc.write_kv(tk, tv, _t(slots), _t(k), _t(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ctx = np.broadcast_to(np.arange(P * BS, dtype=np.int32), (B, P * BS))
    cs = np.asarray(jkvc.slots_for_positions(jnp.asarray(bt),
                                             jnp.asarray(ctx), BS))
    gk, gv = jkvc.gather_kv(jk, jv, jnp.asarray(cs), Hkv)
    pk, pv = tkvc.gather_kv(tk, tv, _t(cs), Hkv)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(gk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(gv))
    cache_cfg = tkvc.KvCacheConfig.for_model(tcfg.get_config("tiny-test"),
                                             num_blocks=16, block_size=BS)
    cache = tkvc.init_cache(cache_cfg, "cpu")
    jcache = jkvc.init_cache(jkvc.KvCacheConfig.for_model(
        jcfg.get_config("tiny-test"), num_blocks=16, block_size=BS))
    assert [tuple(t.shape) for t in cache["k"]] == [a.shape for a in jcache["k"]]
    assert not any(t.any() for t in cache["k"] + cache["v"])


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 100, 3000, 5]], np.int32)
    for off in (False, True):
        np.testing.assert_allclose(
            tllama.rms_norm(_t(x), _t(w), 1e-5, off).numpy(),
            np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                       off)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tllama.rope(_t(x), _t(pos), 10_000.0).numpy(),
        np.asarray(jllama.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=0, atol=1e-5)


def _caches(jc, tc, num_blocks=16):
    jcache = jkvc.init_cache(jkvc.KvCacheConfig.for_model(
        jc, num_blocks=num_blocks, block_size=BS))
    tcache = tkvc.init_cache(tkvc.KvCacheConfig.for_model(
        tc, num_blocks=num_blocks, block_size=BS), "cpu")
    return jcache, tcache


def test_forward_step_prefill_then_decode_matches_jax(model):
    """Chunked prefill (gather path, logits at every position) and then a
    decode step (kernel branch vs JAX's Pallas branch in interpret mode)
    on two ragged rows plus a pad row."""
    jc, tc, params, state = model
    jcache, tcache = _caches(jc, tc)
    bt = np.asarray([[3, 9, 0, 0], [5, 6, 7, 0], [0, 0, 0, 0]], np.int32)
    toks = np.asarray([[5, 6, 7, 8, 9], [1, 2, 3, 4, 0], [0] * 5], np.int32)
    pad = 128 * BS
    pos = np.asarray([[0, 1, 2, 3, 4], [0, 1, 2, 3, pad], [pad] * 5], np.int32)
    sl = np.asarray([5, 4, 0], np.int32)
    jstep = jllama.make_forward_step(jc, BS)
    tstep = tllama.make_forward_step(tc, BS)
    jl, jcache = jstep(params, jcache, *map(jnp.asarray, (toks, pos, sl, bt)))
    tl, tcache = tstep(state, tcache, *map(_t, (toks, pos, sl, bt)))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=0,
                               atol=LOGIT_TOL)
    for a, b in zip(jcache["k"] + jcache["v"], tcache["k"] + tcache["v"]):
        np.testing.assert_allclose(b[BS:].numpy(), np.asarray(a)[BS:],
                                   rtol=0, atol=1e-5)
    # One decode step through the kernel branches.
    nxt = np.asarray([[11], [12], [0]], np.int32)
    dpos = np.asarray([[5], [4], [pad]], np.int32)
    dsl = np.asarray([6, 5, 0], np.int32)
    smp = np.zeros((3,), np.int32)
    jdec = jllama.make_forward_step(jc, BS, use_pallas_decode=True)
    tdec = tllama.make_forward_step(tc, BS, use_decode_kernel=True)
    jl, _ = jdec(params, jcache, *map(jnp.asarray, (nxt, dpos, dsl, bt, smp)))
    tl, _ = tdec(state, tcache, *map(_t, (nxt, dpos, dsl, bt, smp)))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=0,
                               atol=LOGIT_TOL)


def test_packed_prefill_step_matches_jax(model):
    """Two packed segments — one whose first chunk is already cached — and
    pad rows, through both packed steps (JAX kernel in interpret mode)."""
    jc, tc, params, state = model
    jcache, tcache = _caches(jc, tc)
    # Segment 1's first 6 tokens are resident: write them via a forward
    # step on both sides first.
    bt = np.asarray([[2, 3, 0], [4, 5, 6]], np.int32)
    pre_t = np.asarray([[21, 22, 23, 24, 25, 26]], np.int32)
    pre_p = np.arange(6, dtype=np.int32)[None]
    pre_s = np.asarray([6], np.int32)
    _, jcache = jllama.make_forward_step(jc, BS)(
        params, jcache, *map(jnp.asarray, (pre_t, pre_p, pre_s, bt[1:])))
    tllama.make_forward_step(tc, BS)(state, tcache,
                                     *map(_t, (pre_t, pre_p, pre_s, bt[1:])))
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
    q_starts = np.asarray([0, 8, 0, 0], np.int32)
    q_lens = np.asarray([7, 11, 0, 0], np.int32)
    seq_lens = np.asarray([7, 17, 0, 0], np.int32)
    smp = np.asarray([6, 18, 0, 0], np.int32)
    args = (tokens, positions, seg, bts, q_starts, q_lens, seq_lens, smp)
    jl, jcache = jllama.make_packed_prefill_step(jc, BS)(
        params, jcache, *map(jnp.asarray, args))
    tl, tcache = tllama.make_packed_prefill_step(tc, BS)(
        state, tcache, *map(_t, args))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=0,
                               atol=LOGIT_TOL)
    for a, b in zip(jcache["k"], tcache["k"]):
        np.testing.assert_allclose(b[BS:].numpy(), np.asarray(a)[BS:],
                                   rtol=0, atol=1e-5)


def test_decode_window_greedy_tokens_match_jax(model):
    """A 4-step greedy window over a prefilled row and a pad row: the fed
    back tokens, advanced positions and lengths must equal JAX's."""
    jc, tc, params, state = model
    jcache, tcache = _caches(jc, tc)
    bt = np.asarray([[2, 3, 4], [0, 0, 0]], np.int32)
    pre_t = np.asarray([[9, 8, 7, 6, 5, 4, 3]], np.int32)
    pre_p = np.arange(7, dtype=np.int32)[None]
    pre_s = np.asarray([7], np.int32)
    jl, jcache = jllama.make_forward_step(jc, BS)(
        params, jcache, *map(jnp.asarray, (pre_t, pre_p, pre_s, bt[:1])),
        jnp.asarray([6]))
    tllama.make_forward_step(tc, BS)(state, tcache,
                                     *map(_t, (pre_t, pre_p, pre_s, bt[:1])))
    first = int(np.argmax(np.asarray(jl)[0]))
    K, pad = 4, 128 * BS
    last = np.asarray([first, 0], np.int32)
    pos0 = np.asarray([7, pad], np.int32)
    sl0 = np.asarray([8, 0], np.int32)
    ones = np.ones(2, np.float32)
    zeros_i = np.zeros(2, np.int32)
    jrun = jllama.make_decode_window(jc, BS, K, use_pallas_decode=True,
                                     greedy_only=True)
    jout = jrun(params, jcache, *map(jnp.asarray, (last, pos0, sl0, bt)),
                jnp.zeros(2), jnp.asarray(zeros_i), jnp.asarray(ones),
                jnp.zeros((2, 2), jnp.uint32), jnp.asarray(zeros_i))
    trun = tllama.make_decode_window(tc, BS, K, use_decode_kernel=True,
                                     greedy_only=True)
    tout = trun(state, tcache, *map(_t, (last, pos0, sl0, bt)),
                torch.zeros(2), _t(zeros_i), _t(ones), [None, None], [0, 0])
    np.testing.assert_array_equal(tout[1][:, 0].numpy(),
                                  np.asarray(jout[1])[:, 0])
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert tout[4] == [K, K]


def test_bf16_weight_bridge_forward_close_to_jax():
    """The bridge at the serving dtype: bf16 weights and cache through one
    prefill of the forward step agree with JAX to bf16 resolution."""
    jc, tc = _cfg("tiny-test")
    jc, tc = jc.replace(dtype=jnp.bfloat16), tc.replace(dtype=torch.bfloat16)
    params = jllama.init_params(jc, jax.random.key(5))
    state = from_jax_params(jax.device_get(params), "cpu")
    jcache, tcache = _caches(jc, tc)
    toks = np.asarray([[5, 6, 7, 8, 9, 10]], np.int32)
    pos = np.arange(6, dtype=np.int32)[None]
    sl = np.asarray([6], np.int32)
    bt = np.asarray([[1, 2]], np.int32)
    jl, _ = jllama.make_forward_step(jc, BS)(
        params, jcache, *map(jnp.asarray, (toks, pos, sl, bt)))
    tl, _ = tllama.make_forward_step(tc, BS)(state, tcache,
                                             *map(_t, (toks, pos, sl, bt)))
    want = np.asarray(jl)
    assert want.dtype == np.float32 and jnp.dtype(ml_dtypes.bfloat16)
    np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                               atol=0.05 * np.abs(want).max())
