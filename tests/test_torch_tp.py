"""The port's tensor parallelism against the JAX package's tp mesh, on the
CPU at `tiny-test` (and `tiny-gemma`: tied embeddings, post-norms, both
soft caps) geometry.  The JAX side runs on the conftest's 8-device CPU
mesh with `use_pallas_decode=False`, the XLA oracle; the port's ranks all
lie on the CPU, where K1 and K2 take their plain versions.

1. `shard_state` at tp 2 and 4: each rank's tensor equals, bit for bit,
   the `addressable_shards` data of JAX's `shard_pytree(params,
   param_pspecs(cfg), mesh)`; a cache (model dtype and int8 with its
   scales) likewise against `cache_pspecs`; the port's spec trees are
   JAX's.  `init_params(group=)`, which cuts each piece as it is drawn,
   equals `shard_state` of the whole draw, bit for bit.
2. The packed prefill, the unified step, the fused greedy step and the
   greedy decode window at tp 2 and 4 against JAX's `make_sharded_step`
   (a padded prefill chunk, then single decode steps),
   `make_sharded_greedy_step` and `make_sharded_window`: logits within
   rtol = atol = 2e-5 (f32; the two frameworks and the rank sums add in
   other orders), greedy tokens equal, and the tp steps' logits against
   the port's meshless steps within the same tolerance.
3. `EngineCore(tp=2)` against JAX's `EngineCore(mesh=tp2)`: greedy
   tokens equal on a multi-request scenario over a model-dtype and an
   int8 cache, with speculative decode; `embed_tokens` rows within 2e-5;
   a tp 2 engine that draws its own weights serves the meshless
   engine's greedy tokens;
   `kv_shard_count`, the halved `effective_bytes_per_token` and the
   per-chip `dynamo_kv_bytes_per_block` as JAX's own test
   (tests/test_sharded_serving.py) reads them.
4. The wire block: `extract_blocks` of a tp 2 cache is byte-equal to the
   unsharded cache's, `inject_blocks` round-trips, and a model-dtype
   block into a tp 2 int8 engine is refused.
5. The refusals, each with its pointer: tp not dividing the kv heads,
   the intermediate width or the vocabulary (JAX's `validate` messages,
   the same numbers), sp x tp, pp x tp (the mesh and the worker's flags;
   pp alone builds), and `grouped` MoE on a mesh; MoE under tp and
   `--ep` build.
6. (`e2e`) a `--tp 2 --device cpu` worker behind the port's frontend
   answers a chat and shows its mesh.
"""

import json
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_cache as jkvc
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.parallel import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel import make_mesh, shard_pytree
from dynamo_tpu.parallel.sharding import PlaneSpec as JaxPlaneSpec
from dynamo_tpu.parallel.sharding import cache_pspecs as jax_cache_pspecs
from dynamo_tpu.parallel.sharding import (
    make_sharded_greedy_step,
    make_sharded_step,
    make_sharded_window,
)
from dynamo_tpu.parallel.sharding import param_pspecs as jax_param_pspecs
from dynamo_tpu.parallel.sharding import validate as jax_validate
from dynamo_tpu.runtime.metrics import KvCacheMetrics as JaxKvCacheMetrics
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxMetricsRegistry
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.weights import from_jax_params, init_params
from dynamo_tpu_torch.parallel import (
    DpGrid,
    MeshConfig,
    SpRing,
    TpGroup,
    cache_pspecs,
    param_pspecs,
    shard_state,
    validate,
)
from dynamo_tpu_torch.runtime.metrics import KvCacheMetrics, MetricsRegistry
from dynamo_tpu_torch.worker.main import build_mesh, parse_args
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 8
PAD = 128 * BLOCK       # a pad position: past every block table
TOL = dict(rtol=2e-5, atol=2e-5)
MODELS = ("tiny-test", "tiny-gemma")


def _group(tp):
    """A tp group: the rank grid of one dp row."""
    return DpGrid(["cpu"] * tp, 1)


def _mesh(tp):
    return make_mesh(JaxMeshConfig(tp=tp), jax.devices()[:tp])


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    jc = jcfg.get_config(request.param)
    params = jax_init_params(jc, jax.random.key(3))
    return (jc, tcfg.get_config(request.param), params,
            from_jax_params(jax.device_get(params), "cpu"))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _shard_rank(mesh, shard):
    """The tp coordinate of a JAX shard's device."""
    return list(mesh.devices.reshape(-1)).index(shard.device)


def _hold_shards(jax_tree, port_ranks, mesh):
    """Every leaf of the JAX sharded tree against the port's per-rank
    leaves, bit for bit."""
    jleaves, jdef = jax.tree.flatten(jax_tree)
    per_rank = [jax.tree.flatten(r)[0] for r in port_ranks]
    assert all(len(p) == len(jleaves) for p in per_rank)
    for i, leaf in enumerate(jleaves):
        for shard in leaf.addressable_shards:
            mine = _np(per_rank[_shard_rank(mesh, shard)][i])
            assert mine.shape == shard.data.shape
            assert mine.flags.c_contiguous
            np.testing.assert_array_equal(mine, np.asarray(shard.data))


# ---------------------------------------------------------------------------
# 1. The shards


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_state_equals_jax_param_shards(model, tp):
    jc, tc, params, state = model
    spec_j = jax.tree.map(tuple, jax_param_pspecs(jc),
                          is_leaf=lambda x: isinstance(x, tuple))
    assert param_pspecs(tc) == spec_j
    mesh = _mesh(tp)
    ranks = shard_state(state, param_pspecs(tc), _group(tp))
    _hold_shards(shard_pytree(params, jax_param_pspecs(jc), mesh), ranks, mesh)
    # No rank keeps a view of the whole: every leaf owns its storage.
    whole = {t.untyped_storage().data_ptr()
             for t in jax.tree.leaves(state)}
    for r in ranks:
        for t in jax.tree.leaves(r):
            assert t.untyped_storage().data_ptr() not in whole
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", MODELS)
def test_sharded_draw_equals_the_whole_draws_shards(name, tp):
    tc = tcfg.get_config(name)
    group = _group(tp)
    ranks = init_params(tc, torch.Generator().manual_seed(5), "cpu",
                        group=group)
    whole = init_params(tc, torch.Generator().manual_seed(5), "cpu")
    want = shard_state(whole, param_pspecs(tc), group)
    assert [jax.tree.structure(r) for r in ranks] == [
        jax.tree.structure(w) for w in want]
    for got_r, want_r in zip(ranks, want):
        for a, b in zip(jax.tree.leaves(got_r), jax.tree.leaves(want_r)):
            assert a.is_contiguous() and torch.equal(a, b)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_cache_shards_equal_jax_cache_shards(tp, kv_quant):
    jc, tc = jcfg.get_config("tiny-test"), tcfg.get_config("tiny-test")
    quant = kv_quant == "int8"
    assert cache_pspecs(2, kv_quant=quant) == jax.tree.map(
        tuple, jax_cache_pspecs(2, kv_quant=quant),
        is_leaf=lambda x: isinstance(x, tuple))
    rng = np.random.default_rng(tp)
    ccfg = kvc.KvCacheConfig.for_model(tc, num_blocks=6, block_size=BLOCK,
                                       kv_quant=kv_quant)
    cache = {k: [torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                  .astype(np.float32)).to(t.dtype)
                 for t in v] for k, v in kvc.init_cache(ccfg, "cpu").items()}
    host = jax.tree.map(lambda t: t.numpy(), cache)
    mesh = _mesh(tp)
    ranks = shard_state(cache, cache_pspecs(jc.num_layers, kv_quant=quant),
                        _group(tp))
    _hold_shards(shard_pytree(host, jax_cache_pspecs(jc.num_layers,
                                                      kv_quant=quant), mesh),
                 ranks, mesh)
    # The engine's own per-rank caches have the shards' geometry.
    empty = kvc.init_grid_caches(ccfg, _group(tp))
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), empty) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ranks)


# ---------------------------------------------------------------------------
# 2. The sharded steps

PROMPTS = ([5, 6, 7, 8, 9, 10, 11], list(range(30, 43)))


def _prefill_inputs():
    """Both prompts padded [2, 16] (JAX's unified step) and packed [24]
    with segment starts on multiples of 8 (the port's packed step)."""
    R, T, P = 2, 16, 3
    bts = np.asarray([[1, 2, 0], [3, 4, 5]], np.int32)
    tok2 = np.zeros((R, T), np.int32)
    pos2 = np.full((R, T), PAD, np.int32)
    for i, p in enumerate(PROMPTS):
        tok2[i, :len(p)] = p
        pos2[i, :len(p)] = np.arange(len(p))
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    Tp = 24
    tok = np.zeros(Tp, np.int32)
    pos = np.full(Tp, PAD, np.int32)
    seg = np.zeros(Tp, np.int32)
    tok[:7], pos[:7] = PROMPTS[0], np.arange(7)
    tok[8:21], pos[8:21], seg[8:21] = PROMPTS[1], np.arange(13), 1
    packed = (tok, pos, seg, bts, np.asarray([0, 8], np.int32), lens, lens,
              np.asarray([6, 20], np.int32))
    return (tok2, pos2, lens, bts, lens - 1), packed


def _jax_cache(jc, mesh, kv_quant):
    return shard_pytree(
        jkvc.init_cache(jkvc.KvCacheConfig.for_model(
            jc, num_blocks=8, block_size=BLOCK, dtype=jnp.float32,
            kv_quant=kv_quant)),
        jax_cache_pspecs(jc.num_layers, kv_quant=kv_quant == "int8"), mesh)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_sharded_steps_match_jax_sharded_steps(model, tp, kv_quant):
    jc, tc, params, state = model
    quant = kv_quant == "int8"
    mesh = _mesh(tp)
    jparams = shard_pytree(params, jax_param_pspecs(jc), mesh)
    group = _group(tp)
    ranks = shard_state(state, param_pspecs(tc), group)
    ccfg = kvc.KvCacheConfig.for_model(tc, num_blocks=8, block_size=BLOCK,
                                       kv_quant=kv_quant)
    cache = kvc.init_grid_caches(ccfg, group)
    flat = kvc.init_cache(ccfg, "cpu")
    padded, packed = _prefill_inputs()
    jstep = make_sharded_step(jc, BLOCK, mesh, JaxPlaneSpec(quant=quant))
    jcache = _jax_cache(jc, mesh, kv_quant)
    want, jcache = jstep(jparams, jcache, *map(jnp.asarray, padded))
    targs = [torch.from_numpy(x) for x in packed]
    got, cache = llama.make_packed_prefill_step(tc, BLOCK, tp=group)(
        ranks, cache, *targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref, flat = llama.make_packed_prefill_step(tc, BLOCK)(state, flat, *targs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    # Decode: the unified step's logits, then the fused greedy step's
    # tokens, fed the same tokens on every side.
    bts, lens = padded[3], padded[2].copy()
    nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
    zero = np.zeros(2, np.int32)
    step = llama.make_forward_step(tc, BLOCK, use_decode_kernel=True, tp=group)
    flat_step = llama.make_forward_step(tc, BLOCK, use_decode_kernel=True)
    greedy = make_sharded_greedy_step(jc, BLOCK, mesh, kv_quant=quant)
    for _ in range(3):
        lens = lens + 1
        args = (nxt[:, None], (lens - 1)[:, None], lens, bts, zero)
        want, jcache = jstep(jparams, jcache, *map(jnp.asarray, args))
        targs = [torch.from_numpy(x) for x in args]
        got, cache = step(ranks, cache, *targs)
        ref, flat = flat_step(state, flat, *targs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
        nxt = got.argmax(-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(nxt, np.argmax(np.asarray(want), -1))
    # The fused greedy step on a copy of JAX's cache: the tokens equal.
    lens1 = lens + 1
    args = (nxt[:, None], (lens1 - 1)[:, None], lens1, bts, zero)
    jtok, _ = greedy(jparams, jax.tree.map(jnp.copy, jcache),
                     *map(jnp.asarray, args))
    got, _ = step(ranks, [jax.tree.map(torch.clone, c) for c in cache],
                  *map(torch.from_numpy, args))
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(jtok))
    # The greedy window: K steps with the tokens fed back on the device.
    K = 4
    jrun = make_sharded_window(jc, BLOCK, mesh, K, greedy_only=True,
                               kv_quant=quant)
    jout = jrun(jparams, jcache, *map(jnp.asarray, (nxt, lens, lens1, bts)),
                jnp.zeros(2), jnp.zeros(2, jnp.int32), jnp.ones(2),
                jnp.zeros((2, 2), jnp.uint32), jnp.zeros(2, jnp.int32))
    trun = llama.make_decode_window(tc, BLOCK, K, use_decode_kernel=True,
                                    greedy_only=True, tp=group)
    tout = trun(ranks, cache, *map(torch.from_numpy, (nxt, lens, lens1, bts)),
                torch.zeros(2), torch.zeros(2, dtype=torch.int32),
                torch.ones(2), [None, None], [0, 0])
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))


def test_hidden_step_matches_meshless(model):
    """The embeddings variant (`return_hidden`) at tp 2: rank 0's
    final-norm rows equal the meshless step's."""
    jc, tc, params, state = model
    group = _group(2)
    ranks = shard_state(state, param_pspecs(tc), group)
    ccfg = kvc.KvCacheConfig.for_model(tc, num_blocks=8, block_size=BLOCK)
    padded, _ = _prefill_inputs()
    args = [torch.from_numpy(x) for x in padded]
    got, _ = llama.make_forward_step(tc, BLOCK, return_hidden=True, tp=group)(
        ranks, kvc.init_grid_caches(ccfg, group), *args)
    want, _ = llama.make_forward_step(tc, BLOCK, return_hidden=True)(
        state, kvc.init_cache(ccfg, "cpu"), *args)
    assert got.shape == (2, tc.hidden_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------------------
# 3. The engine

SCHED = dict(max_seqs=4, block_size=BLOCK, max_pages_per_seq=8,
             max_prefill_chunk=16, decode_buckets=(2, 4),
             prefill_buckets=(8, 16))
WAVE = {"a": [5, 6, 7, 8, 9, 10, 5, 6, 7, 8], "b": list(range(20, 34)),
        "c": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]}
N_OUT = 12
EMBED = [[5, 6, 7, 8], list(range(20, 31))]


def _run(core, sampling_cls):
    out = {}
    for rid, prompt in WAVE.items():
        core.add_request(rid, prompt, sampling_cls(max_tokens=N_OUT))
    for _ in range(400):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core._requests:
            break
    assert not core._requests, "engine did not finish"
    return out


@pytest.fixture(scope="module")
def tiny():
    jc = jcfg.get_config("tiny-test")
    params = jax_init_params(jc, jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def _port_core(state, **kw):
    return EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=64, device="cpu",
        enable_prefix_cache=False, scheduler=SchedulerConfig(**SCHED), **kw),
        params=state)


def _jax_core(params, mesh, **kw):
    return JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=64, mesh=mesh,
        use_pallas_decode=False, enable_prefix_cache=False,
        scheduler=JaxSchedulerConfig(**SCHED), **kw), params=params)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("spec", [0, 3])
def test_tp_engine_matches_jax_tp_engine(tiny, kv_quant, spec):
    params, state = tiny
    mesh = _mesh(2)
    jcore = _jax_core(params, mesh, kv_quant=kv_quant,
                      speculative_tokens=spec, decode_window=4)
    want = _run(jcore, JaxSamplingParams)
    core = _port_core(state, tp=2, kv_quant=kv_quant,
                      speculative_tokens=spec)
    got = _run(core, SamplingParams)
    assert got == want
    assert all(len(t) == N_OUT for t in got.values())
    if spec:
        assert core.counters.spec_dispatches > 0
    else:
        assert core.counters.window_dispatches > 0
    np.testing.assert_allclose(core.embed_tokens(EMBED),
                               jcore.embed_tokens(EMBED), **TOL)


def test_tp_engine_draws_the_meshless_weights():
    """No params: the tp engine draws the seed's weights cut into its
    ranks as they come, and serves the meshless engine's tokens."""
    got = _run(_port_core(None, tp=2), SamplingParams)
    assert got == _run(_port_core(None), SamplingParams)
    assert all(len(t) == N_OUT for t in got.values())


def test_tp_engine_per_chip_bytes_as_jax(tiny):
    """JAX's test_sharded_per_chip_modeled_bytes, on both engines."""
    params, state = tiny
    flat = _port_core(state)
    tp2 = _port_core(state, tp=2)
    jtp2 = _jax_core(params, _mesh(2))
    for core, cls in ((flat, SamplingParams), (tp2, SamplingParams),
                      (jtp2, JaxSamplingParams)):
        core.add_request("a", WAVE["a"], cls(max_tokens=N_OUT))
        for _ in range(300):
            core.step()
            if not core._requests:
                break
    assert flat.kv_shard_count == 1
    assert tp2.kv_shard_count == jtp2.kv_shard_count == 2
    b0 = flat.counters.effective_bytes_per_token
    b2 = tp2.counters.effective_bytes_per_token
    assert b2 > 0 and abs(b2 / b0 - 0.5) < 1e-6
    assert b2 == jtp2.counters.effective_bytes_per_token
    kvm = KvCacheMetrics(MetricsRegistry())
    kvm.observe_engine(tp2)
    jkvm = JaxKvCacheMetrics(JaxMetricsRegistry())
    jkvm.observe_engine(jtp2)
    got = kvm.kv_bytes_per_block.value(labels={"kv_quant": "none"})
    assert got == tp2.cache_cfg.bytes_per_block / 2
    assert got == jkvm.kv_bytes_per_block.value(labels={"kv_quant": "none"})
    # Each rank holds half of every sharded weight and of the cache.
    sharded = sum(t.numel() for r in tp2.params for t in jax.tree.leaves(r))
    norms = sum(t.numel() for k, t in _leaves(state) if k.endswith("norm"))
    assert sharded == sum(t.numel() for t in jax.tree.leaves(state)) + norms
    for r in tp2.cache:
        assert r["k"][0].shape == (64 * BLOCK, 32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v, prefix)
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# 4. The wire block


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_wire_block_is_sharding_independent(kv_quant):
    tc = tcfg.get_config("tiny-test")
    quant = kv_quant == "int8"
    ccfg = kvc.KvCacheConfig.for_model(tc, num_blocks=6, block_size=BLOCK,
                                       kv_quant=kv_quant)
    flat = kvc.init_cache(ccfg, "cpu")
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((6 * BLOCK, ccfg.feature_dim)).astype(np.float32)
    for layer in range(tc.num_layers):
        for kind in ("k", "v"):
            x = torch.from_numpy(rows * (layer + 1) * (1 if kind == "k" else -1))
            slots = torch.arange(6 * BLOCK)
            if quant:
                kvc.write_kv_quant(flat["k"][layer], flat["v"][layer],
                                   flat["k_scale"][layer],
                                   flat["v_scale"][layer], slots, x, x * 2)
            else:
                kvc.write_kv(flat["k"][layer], flat["v"][layer], slots, x,
                             x * 2)
    group = _group(2)
    sharded = shard_state(flat, cache_pspecs(tc.num_layers, kv_quant=quant),
                          group)
    pages = torch.tensor([4, 1, 3])
    want = kvc.extract_blocks(flat, pages, BLOCK)
    got = kvc.extract_blocks(sharded, pages, BLOCK)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape[1:] == ccfg.block_wire_shape
    assert torch.equal(got.view(torch.int8), want.view(torch.int8))
    # Inject into other pages of both caches: the same bytes come back,
    # and the tp cache stays the shards of the unsharded one.
    dst = torch.tensor([2, 5, 0])
    kvc.inject_blocks(sharded, dst, got, BLOCK)
    kvc.inject_blocks(flat, dst, want, BLOCK)
    assert torch.equal(kvc.extract_blocks(sharded, dst, BLOCK).view(torch.int8),
                       want.view(torch.int8))
    again = shard_state(flat, cache_pspecs(tc.num_layers, kv_quant=quant),
                        group)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(sharded)):
        assert torch.equal(a, b)


def test_tp_int8_engine_refuses_a_model_dtype_block(tiny):
    _, state = tiny
    core = _port_core(state, tp=2, kv_quant="int8")
    cfg = core.cache_cfg
    shape = (2, cfg.num_layers, cfg.block_size, cfg.feature_dim)
    with pytest.raises(ValueError, match="kv_quant"):
        core._validate_block(torch.zeros(shape))
    core._validate_block(torch.zeros(cfg.block_wire_shape, dtype=torch.int8))


# ---------------------------------------------------------------------------
# 5. The refusals


def _jax_validate_error(cfg, tp):
    with pytest.raises(ValueError) as e:
        jax_validate(cfg, _mesh(tp))
    return str(e.value)


@pytest.mark.parametrize("field,value,tp", [
    ("num_kv_heads", 4, 8),            # tiny-test: tp 8 > Hkv 4
    ("intermediate_size", 130, 4),
    ("vocab_size", 258, 4),
])
def test_validate_refuses_as_jax(field, value, tp):
    jc = jcfg.get_config("tiny-test").replace(**{field: value})
    tc = tcfg.get_config("tiny-test").replace(**{field: value})
    want = _jax_validate_error(jc, tp)
    with pytest.raises(ValueError) as e:
        validate(tc, MeshConfig(tp=tp))
    assert str(e.value) == want
    with pytest.raises(ValueError, match=f"tp={tp} must divide"):
        EngineCore(EngineConfig(model=tc, device="cpu", num_blocks=16, tp=tp,
                                scheduler=SchedulerConfig(**SCHED)))


def test_mesh_and_worker_refusals():
    assert MeshConfig(tp=2).describe() == JaxMeshConfig(tp=2).describe() == "tp2"
    # ep is ported (tests/test_torch_ep.py), and so is pp
    # (tests/test_torch_pp.py), which composes with no tp.
    assert build_mesh(parse_args(["--control-plane", "h:1", "--device", "cpu",
                                  "--ep", "2", "--tp", "2"])) == MeshConfig(
        ep=2, tp=2)
    assert MeshConfig(pp=2).describe() == "pp2"
    with pytest.raises(ValueError, match=r"pp v1 composes with no other "
                                         r"axis in-mesh \(got tp=2\)"):
        MeshConfig(pp=2, tp=2)
    assert build_mesh(parse_args(["--control-plane", "h:1", "--device",
                                  "cpu", "--pp", "2"])) == MeshConfig(pp=2)
    args = parse_args(["--control-plane", "h:1", "--device", "cpu",
                       "--pp", "2", "--tp", "2"])
    with pytest.raises(SystemExit, match="composes with no other axis"):
        build_mesh(args)
    # dp is ported (tests/test_torch_dp.py), and so are sp x dp and sp x
    # tp (tests/test_torch_sp_grid.py): the meshes and the flags build, and
    # a grid's ring prefill runs on the grid's own sp axis, not on a ring
    # of its own.
    assert build_mesh(parse_args(["--control-plane", "h:1", "--device",
                                  "cpu", "--dp", "2"])) == MeshConfig(dp=2)
    assert MeshConfig(sp=2, dp=2).describe() == JaxMeshConfig(
        sp=2, dp=2).describe() == "dp2xsp2"
    assert MeshConfig(sp=2, tp=2).describe() == JaxMeshConfig(
        sp=2, tp=2).describe() == "sp2xtp2"
    assert build_mesh(parse_args(["--control-plane", "h:1", "--device",
                                  "cpu", "--sp", "2", "--tp", "2"])) == \
        MeshConfig(sp=2, tp=2)
    with pytest.raises(ValueError, match="grid's own sp axis"):
        llama.make_forward_step(tcfg.get_config("tiny-test"), BLOCK,
                                sp_ring=SpRing([torch.device("cpu")] * 2),
                                tp=_group(2))
    assert build_mesh(parse_args(["--control-plane", "h:1", "--device", "cpu",
                                  "--tp", "2"])) == MeshConfig(tp=2)
    # MoE under tp is ported (dense over each rank's F/tp slices);
    # "grouped" on a mesh keeps JAX's refusal.
    core = EngineCore(EngineConfig(model=tcfg.get_config("tiny-moe"),
                                   device="cpu", num_blocks=16, tp=2))
    assert core.moe_mode == "dense"
    with pytest.raises(ValueError, match="meshless fast path"):
        EngineCore(EngineConfig(model=tcfg.get_config("tiny-moe"),
                                device="cpu", num_blocks=16, tp=2,
                                moe_mode="grouped"))
    group = DpGrid.for_mesh(MeshConfig(tp=3), torch.device("cpu"))
    assert group.describe() == ["cpu"] * 3 and group.cards == [torch.device("cpu")]
    with pytest.raises(ValueError, match="all be cpu or all cuda"):
        TpGroup(["cpu", "meta"])
    with pytest.raises(ValueError, match="a tp=2 step takes a list"):
        llama.make_forward_step(tcfg.get_config("tiny-test"), BLOCK,
                                tp=_group(2))({}, {}, *[torch.zeros(1, 1)] * 4)


# ---------------------------------------------------------------------------
# 6. A tp worker behind the frontend


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_for(path, pattern, deadline, proc):
    import re

    while True:
        assert proc.poll() is None, path.read_text()
        m = re.search(pattern, path.read_text())
        if m:
            return m.group(1)
        assert time.monotonic() < deadline, path.read_text()
        time.sleep(0.2)


@pytest.mark.e2e
def test_tp_worker_serves_a_chat_behind_the_frontend(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        http = s.getsockname()[1]
    fe_log, w_log = tmp_path / "frontend.log", tmp_path / "worker.log"
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.frontend",
             "--serve-control-plane", "--control-plane-port", "0",
             "--router-mode", "kv", "--http-port", str(http)],
            cwd=ROOT, stdout=open(fe_log, "w"), stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 90
        cp = _wait_for(fe_log, r"control plane on (\S+:\d+)", deadline,
                       procs[0])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.worker",
             "--control-plane", cp, "--device", "cpu", "--model",
             "tiny-test", "--model-name", "tiny-tp", "--block-size", "8",
             "--health-port", "0", "--tp", "2"],
            cwd=ROOT, stdout=open(w_log, "w"), stderr=subprocess.STDOUT))
        status = _wait_for(w_log, r"worker status server on :(\d+)",
                           deadline, procs[1])
        base = f"http://127.0.0.1:{http}"
        while not any(m["id"] == "tiny-tp"
                      for m in _get(base + "/v1/models")["data"]):
            assert time.monotonic() < deadline, w_log.read_text()
            time.sleep(0.2)
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps({
                "model": "tiny-tp", "max_tokens": 8,
                "messages": [{"role": "user", "content": "hello"}]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["usage"]["completion_tokens"] == 8
        assert body["choices"][0]["message"]["content"]
        stats = _get(f"http://127.0.0.1:{status}/debug/stats")
        assert stats["mesh"] == "tp2" and stats["kv_shard_count"] == 2
        assert stats["tp_devices"] == ["cpu", "cpu"]
        assert stats["slice"]["describe"] == "tp2"
        assert stats["slice"]["mesh"] == [1, 1, 1, 1, 2]
        assert stats["counters"]["packed_prefill_dispatches"] >= 1
        assert "tp group: 2 ranks on ['cpu', 'cpu']" in w_log.read_text()
    finally:
        for p in reversed(procs):
            p.terminate()
            p.wait(timeout=30)
