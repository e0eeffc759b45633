"""The port's data parallelism against the JAX package's dp meshes, on the
CPU at `tiny-test` (and `tiny-gemma`: tied embeddings, post-norms, both
soft caps) geometry.  The JAX side runs on the conftest's 8-device CPU
mesh with `use_pallas_decode=False`, its XLA path; the port's ranks all
lie on the CPU, where K1 and K2 take their plain versions.  The three
modes: plain dp, dp-attention ("attn", the gather path) and dp-attention
with page locality ("local", K1 / K2 per shard on shard-local tables).

1. `shard_state` over dp2, dp2xtp2 and dp4 grids in every mode: each
   rank's tensor equals, bit for bit, the `addressable_shards` data of
   JAX's `shard_pytree` with `param_pspecs(cfg, dp_attention=...)` and
   `cache_pspecs(L, dp_attention, dp_local, kv_quant)`; the spec trees
   are JAX's; the dp ranks on one device share one tensor; a grid's
   `init_params(group=)` equals `shard_state` of the whole draw.
2. `BlockAllocator(num_blocks, num_shards)` against JAX's under one
   seeded sequence of allocations and releases, and the schedulers'
   admissions with `shard_of_slot`: equal shards and pages.
3. The packed prefill (against JAX's padded sharded step), the unified
   step, the fused greedy step and the greedy window in every mode
   against JAX's `make_sharded_step` / `make_sharded_greedy_step` /
   `make_sharded_window`: f32 logits within rtol = atol = 2e-5, greedy
   tokens equal.
4. `EngineCore` at dp2xtp2 in every mode against JAX's `EngineCore(mesh=
   ...)` on `test_sharded_serving.py`'s scenario, over a model-dtype and
   an int8 cache, one case with speculative decode; `kv_shard_count`,
   `kv_traffic_shards` and `dynamo_kv_bytes_per_block` as JAX reads them.
5. The wire block of every layout is byte-equal to the unsharded
   cache's, and inject round-trips (a cross-place grid writes both of
   its copies).
6. The refusals, JAX's messages where JAX has them, the roadmap's
   pointer where the port queues the combination.
7. The pad-write trap: under dp-local a pad row's write, rebased past a
   shard, lands in the shard's junk row, never on the shard's first
   page, which is a live page of another request.
8. (`e2e`) a `--dp 2` and a `--tp 2 --dp 2 --dp-attention` worker answer
   a chat behind the port's frontend.
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
from dynamo_tpu.engine.scheduler import BlockAllocator as JaxBlockAllocator
from dynamo_tpu.engine.scheduler import FinishReason as JaxFinishReason
from dynamo_tpu.engine.scheduler import Request as JaxRequest
from dynamo_tpu.engine.scheduler import Scheduler as JaxScheduler
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.parallel import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel import make_mesh, shard_pytree
from dynamo_tpu.parallel.sharding import PlaneSpec as JaxPlaneSpec
from dynamo_tpu.parallel.sharding import cache_pspecs as jax_cache_pspecs
from dynamo_tpu.parallel.sharding import data_pspecs as jax_data_pspecs
from dynamo_tpu.parallel.sharding import (
    make_sharded_greedy_step,
    make_sharded_step,
    make_sharded_window,
)
from dynamo_tpu.parallel.sharding import param_pspecs as jax_param_pspecs
from dynamo_tpu.parallel.sharding import plane_capability as jax_capability
from dynamo_tpu.parallel.sharding import validate as jax_validate
from dynamo_tpu.runtime.metrics import KvCacheMetrics as JaxKvCacheMetrics
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxMetricsRegistry
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import (
    BlockAllocator,
    FinishReason,
    Request,
    Scheduler,
    SchedulerConfig,
)
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.weights import from_jax_params, init_params
from dynamo_tpu_torch.parallel import (
    DpGrid,
    MeshConfig,
    PlaneSpec,
    cache_pspecs,
    data_pspecs,
    param_pspecs,
    plane_capability,
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
# (mode, dp, tp): dp-attention flags of each mode.
MODES = {"dp": (False, False), "attn": (True, False), "local": (True, True)}
GRIDS = [("dp", 2, 1), ("dp", 2, 2), ("dp", 4, 1), ("attn", 2, 2),
         ("attn", 4, 1), ("local", 2, 2), ("local", 4, 1)]


def _grid(mode, dp, tp, places=None):
    da, dl = MODES[mode]
    return DpGrid(["cpu"] * (dp * tp), dp, da, dl, places=places)


def _mesh(dp, tp):
    return make_mesh(JaxMeshConfig(dp=dp, tp=tp), jax.devices()[:dp * tp])


def _spec_tree(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    jc = jcfg.get_config(request.param)
    params = jax_init_params(jc, jax.random.key(3))
    return (jc, tcfg.get_config(request.param), params,
            from_jax_params(jax.device_get(params), "cpu"))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _hold_shards(jax_tree, port_ranks, mesh):
    """Every leaf of the JAX sharded tree against the port's per-rank
    leaves, bit for bit (flat rank = the device's index in the mesh)."""
    jleaves, _ = jax.tree.flatten(jax_tree)
    per_rank = [jax.tree.flatten(r)[0] for r in port_ranks]
    assert all(len(p) == len(jleaves) for p in per_rank)
    flat = list(mesh.devices.reshape(-1))
    for i, leaf in enumerate(jleaves):
        for shard in leaf.addressable_shards:
            mine = _np(per_rank[flat.index(shard.device)][i])
            assert mine.shape == shard.data.shape
            assert mine.flags.c_contiguous
            np.testing.assert_array_equal(mine, np.asarray(shard.data))


def _rand_cache(tc, num_blocks, kv_quant, seed):
    rng = np.random.default_rng(seed)
    ccfg = kvc.KvCacheConfig.for_model(tc, num_blocks=num_blocks,
                                       block_size=BLOCK, kv_quant=kv_quant)
    return ccfg, {k: [torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                       .astype(np.float32)).to(t.dtype)
                      for t in v]
                  for k, v in kvc.init_cache(ccfg, "cpu").items()}


# ---------------------------------------------------------------------------
# 1. The shards


@pytest.mark.parametrize("mode,dp,tp", GRIDS)
def test_shard_state_equals_jax_shards(model, mode, dp, tp):
    jc, tc, params, state = model
    da, dl = MODES[mode]
    assert param_pspecs(tc, dp_attention=da) == _spec_tree(jax_param_pspecs(
        jc, dp_attention=da))
    mesh = _mesh(dp, tp)
    grid = _grid(mode, dp, tp)
    ranks = shard_state(state, param_pspecs(tc, dp_attention=da), grid)
    _hold_shards(shard_pytree(params, jax_param_pspecs(jc, dp_attention=da),
                              mesh), ranks, mesh)
    # The dp ranks on one device share one tensor of each tp slice.
    for f in range(grid.n):
        for a, b in zip(jax.tree.leaves(ranks[f]),
                        jax.tree.leaves(ranks[f % tp])):
            assert a is b
    for quant in (False, True):
        assert cache_pspecs(jc.num_layers, da, dl, quant) == _spec_tree(
            jax_cache_pspecs(jc.num_layers, da, dl, quant))
        ccfg, cache = _rand_cache(tc, 16, "int8" if quant else "none", dp)
        host = jax.tree.map(lambda t: t.numpy(), cache)
        specs = cache_pspecs(jc.num_layers, da, dl, quant)
        got = shard_state(cache, specs, grid, junk_rows=True)
        _hold_shards(shard_pytree(host, jax_cache_pspecs(
            jc.num_layers, da, dl, quant), mesh), got, mesh)
        # The engine's own grid caches have the shards' geometry, and
        # share what shard_state shares.
        empty = kvc.init_grid_caches(ccfg, grid)
        assert [jax.tree.map(lambda t: (tuple(t.shape), t.dtype), c)
                for c in empty] == [
            jax.tree.map(lambda t: (tuple(t.shape), t.dtype), c) for c in got]
        assert len({id(c["k"][0]) for c in empty}) == len(
            {id(c["k"][0]) for c in got})
    assert data_pspecs() == _spec_tree(jax_data_pspecs())


@pytest.mark.parametrize("mode,dp,tp", [("dp", 2, 2), ("attn", 2, 2),
                                        ("dp", 4, 1)])
@pytest.mark.parametrize("name", MODELS)
def test_grid_draw_equals_the_whole_draws_shards(name, mode, dp, tp):
    tc = tcfg.get_config(name)
    grid = _grid(mode, dp, tp)
    ranks = init_params(tc, torch.Generator().manual_seed(5), "cpu",
                        group=grid)
    whole = init_params(tc, torch.Generator().manual_seed(5), "cpu")
    want = shard_state(whole, param_pspecs(
        tc, dp_attention=grid.dp_attention), grid)
    for got_r, want_r in zip(ranks, want):
        for a, b in zip(jax.tree.leaves(got_r), jax.tree.leaves(want_r)):
            assert a.is_contiguous() and torch.equal(a, b)
    # One copy per (card, tp slice).
    for f in range(grid.n):
        assert all(a is b for a, b in zip(jax.tree.leaves(ranks[f]),
                                          jax.tree.leaves(ranks[f % tp])))


# ---------------------------------------------------------------------------
# 2. The sharded allocator and admission


@pytest.mark.parametrize("num_blocks,shards", [(16, 1), (16, 4), (64, 4),
                                               (64, 8)])
def test_sharded_allocator_matches_jax(num_blocks, shards):
    mine, theirs = (BlockAllocator(num_blocks, num_shards=shards),
                    JaxBlockAllocator(num_blocks, num_shards=shards))
    rng = np.random.default_rng(num_blocks + shards)
    held = []
    for _ in range(300):
        assert mine.free_blocks == theirs.free_blocks
        for s in range(shards):
            assert mine.shard_free_blocks(s) == theirs.shard_free_blocks(s)
        if held and rng.random() < 0.4:
            pages = held.pop(int(rng.integers(len(held))))
            mine.release(pages)
            theirs.release(pages)
            continue
        n = int(rng.integers(1, 4))
        shard = (None if shards == 1 or rng.random() < 0.2
                 else int(rng.integers(shards)))
        try:
            want = theirs.allocate(n, shard=shard)
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match=str(e)):
                mine.allocate(n, shard=shard)
            continue
        got = mine.allocate(n, shard=shard)
        assert got == want
        assert all(mine.shard_of_block(p) == theirs.shard_of_block(p)
                   for p in got)
        if shard is not None:
            assert {mine.shard_of_block(p) for p in got} == {shard}
        held.append(got)
    with pytest.raises(ValueError, match="must divide num_blocks"):
        BlockAllocator(18, num_shards=4)
    with pytest.raises(ValueError, match="null block"):
        mine.release([0])


def test_admission_with_shard_of_slot_matches_jax():
    """Both schedulers admit a seeded stream of prompts with 4 slots over
    4 shards of 8 blocks: equal slots, shards and pages, and page growth
    draws from the request's shard."""
    kw = dict(max_seqs=4, block_size=BLOCK, max_pages_per_seq=8,
              decode_buckets=(2, 4), prefill_buckets=(8, 16),
              max_prefill_chunk=16)
    mine = Scheduler(SchedulerConfig(shard_of_slot=lambda s: s, **kw),
                     BlockAllocator(32, num_shards=4))
    theirs = JaxScheduler(JaxSchedulerConfig(shard_of_slot=lambda s: s,
                                             **kw),
                          JaxBlockAllocator(32, num_shards=4))
    rng = np.random.default_rng(7)
    reqs = {}
    for i in range(10):
        prompt = [int(x) for x in rng.integers(1, 200, int(rng.integers(3, 30)))]
        a = Request(f"r{i}", prompt, SamplingParams(max_tokens=8))
        b = JaxRequest(f"r{i}", prompt, JaxSamplingParams(max_tokens=8))
        mine.add_request(a)
        theirs.add_request(b)
        reqs[a.request_id] = (a, b)
    for step in range(6):
        mine.plan()
        theirs.plan()
        for a, b in reqs.values():
            assert (a.slot, a.locality_shard, a.pages, a.state.value) == (
                b.slot, b.locality_shard, b.pages, b.state.value)
            if a.pages:
                assert {p // 8 for p in a.pages} == {a.locality_shard}
        running = [r for r in reqs.values() if r[0].slot is not None]
        if running:
            a, b = running[step % len(running)]
            grow = len(a.pages) * BLOCK + 5
            assert mine.ensure_capacity(a, grow) == theirs.ensure_capacity(
                b, grow)
            assert a.pages == b.pages
            mine.finish(running[0][0], FinishReason.STOP)
            theirs.finish(running[0][1], JaxFinishReason.STOP)


# ---------------------------------------------------------------------------
# 3. The sharded steps

PROMPTS = ([5, 6, 7, 8, 9, 10, 11], list(range(30, 43)), [3, 1, 4, 1, 5],
           list(range(60, 69)))
# Row f's pages lie in block range [4f, 4f + 4): shard f's under a 4-way
# dp-local grid over 16 blocks (rows 1-3 start on their shard's FIRST
# block, a real page there).
TABLES = np.asarray([[1, 2, 3], [4, 5, 6], [8, 9, 10], [12, 13, 14]],
                    np.int32)


def _padded():
    R, T = len(PROMPTS), 16
    tok = np.zeros((R, T), np.int32)
    pos = np.full((R, T), PAD, np.int32)
    for i, p in enumerate(PROMPTS):
        tok[i, :len(p)] = p
        pos[i, :len(p)] = np.arange(len(p))
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    return tok, pos, lens, TABLES, lens - 1


def _packed(split):
    """The prompts as a grid-shaped pack of `split` groups (contiguous
    rows each), segment starts on multiples of 8; returns the arrays and
    each prompt's segment row."""
    per = len(PROMPTS) // split
    groups = [list(range(g * per, (g + 1) * per)) for g in range(split)]
    Tg = max(sum(-(-len(PROMPTS[i]) // 8) * 8 for i in g) for g in groups)
    T, R = Tg * split, len(PROMPTS)
    tok = np.zeros(T, np.int32)
    pos = np.full(T, PAD, np.int32)
    seg = np.zeros(T, np.int32)
    qs = np.zeros(R, np.int32)
    smp = np.zeros(R, np.int32)
    for g, rows in enumerate(groups):
        off = g * Tg
        for i in rows:
            L = len(PROMPTS[i])
            tok[off:off + L], pos[off:off + L] = PROMPTS[i], np.arange(L)
            seg[off:off + L] = i
            qs[i], smp[i] = off, off + L - 1
            off += -(-L // 8) * 8
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    return (tok, pos, seg, TABLES, qs, lens, lens, smp)


def _jax_cache(jc, mesh, num_blocks, kv_quant, da, dl):
    return shard_pytree(
        jkvc.init_cache(jkvc.KvCacheConfig.for_model(
            jc, num_blocks=num_blocks, block_size=BLOCK, dtype=jnp.float32,
            kv_quant=kv_quant)),
        jax_cache_pspecs(jc.num_layers, da, dl, kv_quant == "int8"), mesh)


_MODELS = {}


def _model(name):
    """(jax config, port config, JAX params, the port's state), once a
    model."""
    if name not in _MODELS:
        jc = jcfg.get_config(name)
        params = jax_init_params(jc, jax.random.key(3))
        _MODELS[name] = (jc, tcfg.get_config(name), params,
                         from_jax_params(jax.device_get(params), "cpu"))
    return _MODELS[name]


# Every grid over both cache modes at tiny-test; tiny-gemma's soft caps
# and post-norms over the model-dtype cache.
STEP_GRIDS = (("dp", 2, 2), ("dp", 4, 1), ("attn", 2, 2), ("local", 2, 2))
STEP_CASES = ([("tiny-test", g, q) for g in STEP_GRIDS
               for q in ("none", "int8")]
              + [("tiny-gemma", g, "none") for g in STEP_GRIDS])


@pytest.mark.parametrize("name,grid_case,kv_quant", STEP_CASES)
def test_grid_steps_match_jax_sharded_steps(name, grid_case, kv_quant):
    jc, tc, params, state = _model(name)
    mode, dp, tp = grid_case
    da, dl = MODES[mode]
    quant = kv_quant == "int8"
    mesh = _mesh(dp, tp)
    grid = _grid(mode, dp, tp)
    kernel = not (da and not dl)
    jparams = shard_pytree(params, jax_param_pspecs(jc, dp_attention=da),
                           mesh)
    ranks = shard_state(state, param_pspecs(tc, dp_attention=da), grid)
    ccfg = kvc.KvCacheConfig.for_model(tc, num_blocks=16, block_size=BLOCK,
                                       kv_quant=kv_quant)
    cache = kvc.init_grid_caches(ccfg, grid)
    plane = JaxPlaneSpec(quant=quant, dp_attention=da, dp_local=dl)
    jstep = make_sharded_step(jc, BLOCK, mesh, plane)
    jcache = _jax_cache(jc, mesh, 16, kv_quant, da, dl)
    padded = _padded()
    want, jcache = jstep(jparams, jcache, *map(jnp.asarray, padded))
    split = dp * tp if da else dp
    targs = [torch.from_numpy(x) for x in _packed(split)]
    got, cache = llama.make_packed_prefill_step(tc, BLOCK, tp=grid)(
        ranks, cache, *targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # Decode: the unified step's logits, fed the same tokens on both
    # sides, K1 per rank or per shard (the gather path without locality).
    B = len(PROMPTS)
    bts, lens = padded[3], padded[2].copy()
    nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
    zero = np.zeros(B, np.int32)
    step = llama.make_forward_step(tc, BLOCK, use_decode_kernel=kernel,
                                   tp=grid)
    greedy = make_sharded_greedy_step(jc, BLOCK, mesh, dp_attention=da,
                                      dp_local=dl, kv_quant=quant)
    for _ in range(2):
        lens = lens + 1
        args = (nxt[:, None], (lens - 1)[:, None], lens, bts, zero)
        want, jcache = jstep(jparams, jcache, *map(jnp.asarray, args))
        got, cache = step(ranks, cache, *map(torch.from_numpy, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        nxt = got.argmax(-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(nxt, np.argmax(np.asarray(want), -1))
    # The fused greedy step on copies of both caches: the tokens equal.
    lens1 = lens + 1
    args = (nxt[:, None], (lens1 - 1)[:, None], lens1, bts, zero)
    jtok, _ = greedy(jparams, jax.tree.map(jnp.copy, jcache),
                     *map(jnp.asarray, args))
    copies = shard_state(kvc.init_cache(ccfg, "cpu"),
                         cache_pspecs(tc.num_layers, da, dl, quant), grid,
                         junk_rows=True)
    for mine, theirs in zip(copies, cache):
        for k in mine:
            for a, b in zip(mine[k], theirs[k]):
                a.copy_(b)
    got, _ = step(ranks, copies, *map(torch.from_numpy, args))
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(jtok))
    # The greedy window: K steps with the tokens fed back on the device.
    K = 3
    jrun = make_sharded_window(jc, BLOCK, mesh, K, greedy_only=True,
                               dp_attention=da, dp_local=dl, kv_quant=quant)
    jout = jrun(jparams, jcache, *map(jnp.asarray, (nxt, lens, lens1, bts)),
                jnp.zeros(B), jnp.zeros(B, jnp.int32), jnp.ones(B),
                jnp.zeros((B, 2), jnp.uint32), jnp.zeros(B, jnp.int32))
    trun = llama.make_decode_window(tc, BLOCK, K, use_decode_kernel=kernel,
                                    greedy_only=True, tp=grid)
    tout = trun(ranks, cache, *map(torch.from_numpy, (nxt, lens, lens1, bts)),
                torch.zeros(B), torch.zeros(B, dtype=torch.int32),
                torch.ones(B), [None] * B, [0] * B)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))


# ---------------------------------------------------------------------------
# 4. The engine

SCHED = dict(max_seqs=4, block_size=BLOCK, max_pages_per_seq=8,
             max_prefill_chunk=16, decode_buckets=(2, 4),
             prefill_buckets=(8, 16))
# test_sharded_serving.py's two requests, and a third.
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


ENGINE_CASES = [(m, q, 0) for m in MODES for q in ("none", "int8")] + [
    ("local", "none", 3), ("dp", "int8", 3)]


@pytest.mark.parametrize("mode,kv_quant,spec", ENGINE_CASES)
def test_dp_engine_matches_jax_dp_engine(tiny, mode, kv_quant, spec):
    params, state = tiny
    da, dl = MODES[mode]
    mesh = _mesh(2, 2)
    jcore = _jax_core(params, mesh, kv_quant=kv_quant,
                      speculative_tokens=spec, decode_window=4,
                      dp_attention=da, dp_attention_local=dl)
    want = _run(jcore, JaxSamplingParams)
    core = _port_core(state, dp=2, tp=2, dp_attention=da,
                      dp_attention_local=dl, kv_quant=kv_quant,
                      speculative_tokens=spec)
    assert core.grid.mode == {"dp": "dp", "attn": "dp_attention",
                              "local": "dp_local"}[mode]
    got = _run(core, SamplingParams)
    assert got == want
    assert all(len(t) == N_OUT for t in got.values())
    if spec:
        assert core.counters.spec_dispatches > 0
    else:
        assert core.counters.window_dispatches > 0
    assert core.counters.packed_prefill_dispatches > 0
    np.testing.assert_allclose(core.embed_tokens(EMBED),
                               jcore.embed_tokens(EMBED), **TOL)
    # JAX's auto rule: locality on with the plain allocator.
    if da:
        auto = _port_core(state, dp=2, tp=2, dp_attention=True)
        assert auto._dp_local and auto.grid.dp_local


def test_dp_engine_draws_the_meshless_weights():
    """No params: the grid engine draws the seed's weights cut into its
    ranks as they come, and serves the meshless engine's tokens."""
    want = _run(_port_core(None), SamplingParams)
    for kw in (dict(dp=2), dict(dp=2, tp=2, dp_attention=True)):
        assert _run(_port_core(None, **kw), SamplingParams) == want


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_engine_per_chip_bytes_as_jax(tiny, mode):
    """JAX's per-chip divisors: residency over kv_shard_count (tp, or the
    flat grid under dp-local; plain dp replicates), read traffic over
    dp * tp."""
    params, state = tiny
    da, dl = MODES[mode]
    core = _port_core(state, dp=2, tp=2, dp_attention=da,
                      dp_attention_local=dl)
    jcore = _jax_core(params, _mesh(2, 2), dp_attention=da,
                      dp_attention_local=dl)
    flat = _port_core(state)
    for c, cls in ((core, SamplingParams), (jcore, JaxSamplingParams),
                   (flat, SamplingParams)):
        c.add_request("a", WAVE["a"], cls(max_tokens=N_OUT))
        for _ in range(300):
            c.step()
            if not c._requests:
                break
    assert core.kv_shard_count == jcore.kv_shard_count == (4 if dl else 2)
    assert core.kv_traffic_shards == jcore.kv_traffic_shards == 4
    b0 = flat.counters.effective_bytes_per_token
    b4 = core.counters.effective_bytes_per_token
    assert b4 > 0 and abs(b4 / b0 - 0.25) < 1e-6
    assert b4 == jcore.counters.effective_bytes_per_token
    kvm = KvCacheMetrics(MetricsRegistry())
    kvm.observe_engine(core)
    jkvm = JaxKvCacheMetrics(JaxMetricsRegistry())
    jkvm.observe_engine(jcore)
    got = kvm.kv_bytes_per_block.value(labels={"kv_quant": "none"})
    assert got == core.cache_cfg.bytes_per_block / core.kv_shard_count
    assert got == jkvm.kv_bytes_per_block.value(labels={"kv_quant": "none"})
    # One device: the ranks share one copy of each piece (a tp slice, or
    # a weight every rank replicates), so the grid holds one model and
    # one cache.
    leaves = {id(t): t for r in core.params for t in jax.tree.leaves(r)}
    assert sum(t.numel() for t in leaves.values()) == sum(
        t.numel() for t in jax.tree.leaves(state))
    layer0 = {id(c["k"][0]): c["k"][0] for c in core.cache}
    assert sum(t.numel() for t in layer0.values()) == 64 * BLOCK * 64


# ---------------------------------------------------------------------------
# 5. The wire block, and copies on two places


def _filled_cache(tc, kv_quant):
    ccfg = kvc.KvCacheConfig.for_model(tc, num_blocks=16, block_size=BLOCK,
                                       kv_quant=kv_quant)
    flat = kvc.init_cache(ccfg, "cpu")
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((16 * BLOCK, ccfg.feature_dim)).astype(
        np.float32)
    slots = torch.arange(16 * BLOCK)
    for layer in range(tc.num_layers):
        x = torch.from_numpy(rows * (layer + 1))
        if kv_quant == "int8":
            kvc.write_kv_quant(flat["k"][layer], flat["v"][layer],
                               flat["k_scale"][layer], flat["v_scale"][layer],
                               slots, x, -x)
        else:
            kvc.write_kv(flat["k"][layer], flat["v"][layer], slots, x, -x)
    return flat


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mode,dp,tp,places", [
    ("dp", 2, 2, None), ("attn", 2, 2, None), ("local", 2, 2, None),
    ("local", 4, 1, None), ("dp", 2, 2, [0, 0, 1, 1]),
    ("attn", 2, 2, [0, 0, 1, 1])])
def test_wire_block_is_layout_independent(kv_quant, mode, dp, tp, places):
    tc = tcfg.get_config("tiny-test")
    quant = kv_quant == "int8"
    flat = _filled_cache(tc, kv_quant)
    grid = _grid(mode, dp, tp, places)
    specs = cache_pspecs(tc.num_layers, grid.dp_attention, grid.dp_local,
                         quant)
    sharded = shard_state(flat, specs, grid, junk_rows=True)
    pages = torch.tensor([4, 1, 13, 6, 11])
    want = kvc.extract_blocks(flat, pages, BLOCK)
    got = kvc.extract_grid_blocks(sharded, grid, pages, BLOCK)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int8), want.view(torch.int8))
    # Inject into other pages of both: the grid stays the shards of the
    # unsharded cache, every copy of them.
    dst = torch.tensor([2, 5, 8, 15, 0])
    kvc.inject_grid_blocks(sharded, grid, dst, got, BLOCK)
    kvc.inject_blocks(flat, dst, want, BLOCK)
    assert torch.equal(
        kvc.extract_grid_blocks(sharded, grid, dst, BLOCK).view(torch.int8),
        want.view(torch.int8))
    again = shard_state(flat, specs, grid, junk_rows=True)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(sharded)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["dp", "attn"])
def test_copies_on_two_places_take_every_write(mode):
    """A dp 2 x tp 2 grid whose dp rows lie on two places (two cards, on
    the CPU two distinct copies): every written row reaches both copies
    in its layer, as GSPMD all-gathers the update, and the logits are the
    one-place grid's."""
    jc, tc, params, state = _model("tiny-test")
    da, _ = MODES[mode]
    out = []
    for places in (None, [0, 0, 1, 1]):
        grid = _grid(mode, 2, 2, places)
        ranks = shard_state(state, param_pspecs(tc, dp_attention=da), grid)
        ccfg = kvc.KvCacheConfig.for_model(tc, num_blocks=16,
                                           block_size=BLOCK)
        cache = kvc.init_grid_caches(ccfg, grid)
        got, cache = llama.make_packed_prefill_step(tc, BLOCK, tp=grid)(
            ranks, cache, *map(torch.from_numpy, _packed(4 if da else 2)))
        step = llama.make_forward_step(tc, BLOCK, use_decode_kernel=not da,
                                       tp=grid)
        lens = _padded()[2] + 1
        nxt = got.argmax(-1).numpy().astype(np.int32)
        logits, cache = step(ranks, cache, *map(torch.from_numpy, (
            nxt[:, None], (lens - 1)[:, None], lens, TABLES,
            np.zeros(4, np.int32))))
        out.append((got, logits))
        if places is not None:
            assert cache[0]["k"][0] is not cache[2]["k"][0]
            for t in range(2):
                a, b = cache[t], cache[2 + t]
                for k in a:
                    for x, y in zip(a[k], b[k]):
                        assert torch.equal(x, y)
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ---------------------------------------------------------------------------
# 6. The refusals


def _jax_reason(mesh, **plane):
    return jax_capability(mesh, JaxPlaneSpec(**plane)).reason


def test_capability_table_refuses_as_jax():
    mesh = MeshConfig(dp=2, tp=2)
    jmesh = _mesh(2, 2)
    for plane, m, jm in (
            (dict(dp_local=True), mesh, jmesh),
            (dict(dp_attention=True), None, None),
            (dict(dp_attention=True, use_pallas=True), mesh, jmesh)):
        want = _jax_reason(jm, **plane)
        mine = {("use_kernel" if k == "use_pallas" else k): v
                for k, v in plane.items()}
        assert want and plane_capability(PlaneSpec(**mine), m).reason == want
    assert plane_capability(PlaneSpec(dp_attention=True, dp_local=True,
                                      use_kernel=True), mesh).ok
    assert not plane_capability(PlaneSpec(dp_attention=True,
                                          role="sp_prefill"), mesh).ok
    with pytest.raises(ValueError, match="pallas decode under dp_attention"):
        llama.make_forward_step(tcfg.get_config("tiny-test"), BLOCK,
                                use_decode_kernel=True,
                                tp=_grid("attn", 2, 2))
    # dp-attention lifts the tp-divides-Hkv rule, as JAX's validate.
    tc, jc = tcfg.get_config("tiny-test"), jcfg.get_config("tiny-test")
    validate(tc, MeshConfig(tp=8), dp_attention=True)
    jax_validate(jc, make_mesh(JaxMeshConfig(tp=8), jax.devices()),
                 dp_attention=True)
    with pytest.raises(ValueError, match="tp=8 must divide num_kv_heads=4"):
        validate(tc, MeshConfig(tp=8))


def _engine_error(make):
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


@pytest.mark.parametrize("kw,sched", [
    (dict(dp_attention_local=True), {}),
    (dict(dp=2, tp=2, dp_attention_local=True, enable_prefix_cache=True),
     {}),
    (dict(dp=2, tp=2, dp_attention=True, num_blocks=66), {}),
    (dict(dp=2, tp=2, dp_attention=True), dict(max_seqs=6,
                                               decode_buckets=(2, 4, 8))),
    (dict(dp=2, tp=2, dp_attention=True), dict(max_seqs=4,
                                               decode_buckets=(2, 4, 6))),
])
def test_engine_refuses_as_jax(tiny, kw, sched):
    params, state = tiny
    kw = dict(kw)
    prefix = kw.pop("enable_prefix_cache", False)
    blocks = kw.pop("num_blocks", 64)
    sc = dict(SCHED, **sched)
    if "max_seqs" in sched and sched["decode_buckets"][-1] == 6:
        sc["max_seqs"] = 6    # bucket_for_decode(6) = 6, max_seqs 6
    dp, tp = kw.pop("dp", 1), kw.pop("tp", 1)
    mine = _engine_error(lambda: EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=blocks, device="cpu",
        enable_prefix_cache=prefix, scheduler=SchedulerConfig(**sc), dp=dp,
        tp=tp, **kw), params=state))
    jmesh = _mesh(dp, tp) if dp * tp > 1 else None
    want = _engine_error(lambda: JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=blocks, mesh=jmesh,
        use_pallas_decode=False, enable_prefix_cache=prefix,
        scheduler=JaxSchedulerConfig(**sc), **kw), params=params))
    assert mine == want


def test_mesh_worker_and_moe_refusals():
    assert MeshConfig(dp=2, tp=2).describe() == JaxMeshConfig(
        dp=2, tp=2).describe() == "dp2xtp2"
    # ep is ported (tests/test_torch_ep.py): the mesh and the flag build.
    assert MeshConfig(ep=2).describe() == JaxMeshConfig(ep=2).describe()
    assert build_mesh(parse_args(["--control-plane", "h:1", "--device",
                                  "cpu", "--ep", "2"])) == MeshConfig(ep=2)
    # pp is ported (tests/test_torch_pp.py) and composes with no dp.
    assert MeshConfig(pp=2).describe() == JaxMeshConfig(pp=2).describe()
    with pytest.raises(ValueError, match=r"pp v1 composes with no other "
                                         r"axis in-mesh \(got dp=2\)"):
        MeshConfig(pp=2, dp=2)
    assert build_mesh(parse_args(["--control-plane", "h:1", "--device",
                                  "cpu", "--pp", "2"])) == MeshConfig(pp=2)
    args = parse_args(["--control-plane", "h:1", "--device", "cpu",
                       "--pp", "2", "--dp", "2"])
    with pytest.raises(SystemExit, match="composes with no other axis"):
        build_mesh(args)
    # sp x dp and sp x tp are ported (tests/test_torch_sp_grid.py): the
    # meshes build and the engine puts sp on the grid; sp x dp-attention
    # raises the capability table's words.
    assert MeshConfig(sp=2, dp=2).describe() == JaxMeshConfig(
        sp=2, dp=2).describe() == "dp2xsp2"
    assert MeshConfig(sp=2, tp=2).describe() == "sp2xtp2"
    core = EngineCore(EngineConfig(model=tcfg.get_config("tiny-test"),
                                   device="cpu", num_blocks=16, dp=2, sp=2))
    assert core.grid.sp == 2 and core.grid.dp == 2 and core.ring.sp == 2
    with pytest.raises(ValueError, match="ring-SP prefill is not wired for "
                                         "dp_attention"):
        EngineCore(EngineConfig(model=tcfg.get_config("tiny-test"),
                                device="cpu", num_blocks=16, dp=2, sp=2,
                                tp=2, dp_attention=True))
    args = parse_args(["--control-plane", "h:1", "--device", "cpu", "--dp",
                       "2", "--tp", "2", "--dp-attention"])
    assert build_mesh(args) == MeshConfig(dp=2, tp=2) and args.dp_attention
    # MoE under a dp or tp mesh is ported: JAX's auto gives "dense".
    for kw in (dict(dp=2), dict(tp=2, dp_attention=True)):
        core = EngineCore(EngineConfig(model=tcfg.get_config("tiny-moe"),
                                       device="cpu", num_blocks=16, **kw))
        assert core.moe_mode == "dense" and core.grid is not None
    assert callable(llama.make_forward_step(tcfg.get_config("tiny-moe"),
                                            BLOCK, tp=_grid("dp", 2, 1)))
    with pytest.raises(ValueError, match="dp_local implies dp_attention"):
        DpGrid(["cpu"] * 2, 2, dp_local=True)
    with pytest.raises(ValueError, match="must divide the grid"):
        DpGrid(["cpu"] * 3, 2)
    with pytest.raises(ValueError, match="takes a list of 4 rank states"):
        llama.make_forward_step(tcfg.get_config("tiny-test"), BLOCK,
                                tp=_grid("dp", 2, 2))(
            {}, {}, *[torch.zeros(4, 1, dtype=torch.int32)] * 4)
    with pytest.raises(ValueError, match="batch 3 must be a multiple of "
                                         "dp\\*tp = 4"):
        grid = _grid("attn", 2, 2)
        llama.make_forward_step(tcfg.get_config("tiny-test"), BLOCK,
                                tp=grid)(
            [{}] * 4, [{}] * 4, *[torch.zeros(3, 1, dtype=torch.int32)] * 4)


# ---------------------------------------------------------------------------
# 7. The pad-write trap


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_dp_local_pad_writes_never_land_on_a_shards_first_page(kv_quant):
    """dp-local over 4 shards of 4 blocks, 8 rows (2 a shard): one live
    request on shard 1 whose first page is block 4, shard 1's FIRST block
    (unlike shard 0's, a real page), beside pad rows on every shard.  The
    pad rows' writes (global slot 0, rebased past shards 1-3) land in
    each shard's junk row; block 4 holds what the meshless step writes
    and the decode's logits are the meshless step's."""
    jc, tc, params, state = _model("tiny-test")
    grid = _grid("local", 4, 1)
    ranks = shard_state(state, param_pspecs(tc, dp_attention=True), grid)
    ccfg = kvc.KvCacheConfig.for_model(tc, num_blocks=16, block_size=BLOCK,
                                       kv_quant=kv_quant)
    cache = kvc.init_grid_caches(ccfg, grid)
    flat = kvc.init_cache(ccfg, "cpu")
    prompt = list(range(40, 53))                       # 13 tokens, 2 pages
    B, T = 8, 16
    tok = np.zeros((B, T), np.int32)
    pos = np.full((B, T), PAD, np.int32)
    lens = np.zeros(B, np.int32)
    bts = np.zeros((B, 3), np.int32)
    tok[2, :13], pos[2, :13], lens[2] = prompt, np.arange(13), 13
    bts[2] = [4, 5, 6]
    smp = np.maximum(lens - 1, 0)
    meshless = llama.make_forward_step(tc, BLOCK, use_decode_kernel=True)
    step = llama.make_forward_step(tc, BLOCK, use_decode_kernel=True,
                                   tp=grid)
    args = [torch.from_numpy(x) for x in (tok, pos, lens, bts, smp)]
    want, flat = meshless(state, flat, *args)
    got, cache = step(ranks, cache, *args)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), **TOL)
    nxt = got.argmax(-1).numpy().astype(np.int32)
    lens2 = np.where(lens > 0, lens + 1, 0).astype(np.int32)
    pos2 = np.where(lens > 0, lens, PAD).astype(np.int32)[:, None]
    args = [torch.from_numpy(x) for x in (nxt[:, None], pos2, lens2, bts,
                                          np.zeros(B, np.int32))]
    want, flat = meshless(state, flat, *args)
    got, cache = step(ranks, cache, *args)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), **TOL)
    S = 4 * BLOCK
    page = slice(0, BLOCK)                 # shard 1's local page 0 = block 4
    for name in cache[1]:
        for layer in range(tc.num_layers):
            mine = cache[1][name][layer][page].float()
            theirs = flat[name][layer][4 * BLOCK:5 * BLOCK].float()
            np.testing.assert_allclose(mine.numpy(), theirs.numpy(),
                                       rtol=1e-4, atol=1e-4 if kv_quant ==
                                       "none" else 1.01)
            # The pad rows of shards 1-3 wrote into the junk row there.
            for f in (1, 2, 3):
                assert kvc._junk_view(cache[f][name][layer])[S].abs().sum() > 0


# ---------------------------------------------------------------------------
# 8. dp workers behind the frontend


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
def test_dp_workers_serve_chats_behind_the_frontend(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        http = s.getsockname()[1]
    fe_log = tmp_path / "frontend.log"
    procs = []
    workers = {"tiny-dp": ["--dp", "2"],
               "tiny-dpa": ["--tp", "2", "--dp", "2", "--dp-attention"]}
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.frontend",
             "--serve-control-plane", "--control-plane-port", "0",
             "--router-mode", "kv", "--http-port", str(http)],
            cwd=ROOT, stdout=open(fe_log, "w"), stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 120
        cp = _wait_for(fe_log, r"control plane on (\S+:\d+)", deadline,
                       procs[0])
        logs = {}
        for name, flags in workers.items():
            logs[name] = tmp_path / f"{name}.log"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.worker",
                 "--control-plane", cp, "--device", "cpu", "--model",
                 "tiny-test", "--model-name", name, "--block-size", "8",
                 "--health-port", "0", "--component", name, *flags],
                cwd=ROOT, stdout=open(logs[name], "w"),
                stderr=subprocess.STDOUT))
        base = f"http://127.0.0.1:{http}"
        for i, name in enumerate(workers):
            status = _wait_for(logs[name], r"worker status server on :(\d+)",
                               deadline, procs[1 + i])
            while not any(m["id"] == name
                          for m in _get(base + "/v1/models")["data"]):
                assert time.monotonic() < deadline, logs[name].read_text()
                time.sleep(0.2)
            req = urllib.request.Request(
                base + "/v1/chat/completions", data=json.dumps({
                    "model": name, "max_tokens": 8,
                    "messages": [{"role": "user", "content": "hello"}]
                }).encode(), headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                body = json.loads(r.read())
            assert body["usage"]["completion_tokens"] == 8
            stats = _get(f"http://127.0.0.1:{status}/debug/stats")
            assert stats["kv_traffic_shards"] == (4 if i else 2)
            assert stats["counters"]["packed_prefill_dispatches"] >= 1
            if i == 0:
                assert stats["mesh"] == "dp2" and stats["dp_mode"] == "dp"
                assert stats["kv_shard_count"] == 1
                assert stats["slice"]["mesh"] == [2, 1, 1, 1, 1]
            else:
                assert stats["mesh"] == "dp2xtp2"
                assert stats["dp_mode"] == "dp_attention"
                assert stats["kv_shard_count"] == 2
                assert "dp_attention" in stats["slice"]["features"]
                assert stats["slice"]["describe"] == "dp2xtp2"
            assert len(stats["rank_launches"]) == (4 if i else 2)
            assert "dp grid: " in logs[name].read_text()
    finally:
        for p in reversed(procs):
            p.terminate()
            p.wait(timeout=30)
