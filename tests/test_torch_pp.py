"""The port's pipeline parallelism against the JAX package's pp mesh, on
the CPU at `tiny-test` geometry (f32; 4 layers where 4 stages run).  The
JAX side runs on the conftest's 8-device CPU mesh
(`make_mesh(MeshConfig(pp=S), jax.devices()[:S])`); the port's stages
all lie on the CPU, where K1 and K2 take their plain versions.  Both
sides hold one set of weights: JAX's stacked pytree
(`stack_layer_params`), carried over by `from_jax_params` and cut into
stages by `shard_stages`.  Inputs are drawn from numpy seeds.

Tolerances: f32 logits and caches within rtol = atol = 5e-5, JAX's own
(tests/test_pipeline.py); tokens, launches, refusals and wire bytes
exactly.

1. The steps: `make_pp_step` logits and per-layer cache (block 0, the
   null block, excluded) at S in {2, 4} x M in {1, 2, 4} and with an
   untied head; a prefill then a decode step (tests/test_pipeline.py's
   counterpart); the fused greedy step's tokens and the greedy window's
   against JAX's `make_pp_greedy_step` and `make_pp_decode_window`; the
   stochastic window against the port's meshless window on the same
   seeds and offsets; the int8 step's logits and scales against JAX's pp
   step with `kv_quant=True`.
2. The block ops: `make_pp_block_ops` extract byte-equal to JAX's (bf16
   and the packed int8 wire block), inject into fresh stage caches and a
   decode step equal to the meshless step on the source cache.
3. The packed prefill under pp (the pack as one microbatch) against the
   port's meshless packed prefill and JAX's pp step on the same prompts.
4. The engine: `EngineCore(pp=2)` greedy ids equal JAX's pp engine with
   the window on and off and over an int8 cache; a G1 prefix hit and a
   G2 offload and onboard through the pp block ops, as JAX's pp engine;
   the per-chip modeled bytes divided by pp
   (`test_per_chip_modeled_bytes_pp_sp`'s counterpart).
5. The refusals, in JAX's words: MoE, speculative decode, embeddings and
   multimodal prompts under pp; pp x dp, tp, ep and sp; S not dividing
   the layers; post-norms.  The one row the port does not copy: K1 / K2
   under pp.
6. (`e2e`) a `--pp 2 --pp-microbatches 2 --device cpu` worker behind the
   port's frontend answers a chat with the in-process engine's ids and
   shows its mesh.
"""

import dataclasses
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
from dynamo_tpu.models.llama import make_forward_step as jax_forward_step
from dynamo_tpu.parallel import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel import make_mesh
from dynamo_tpu.parallel import pipeline as jpp
from dynamo_tpu.parallel.sharding import PlaneSpec as JaxPlaneSpec
from dynamo_tpu.parallel.sharding import plane_capability as jax_capability
from dynamo_tpu.parallel.sharding import shard_pytree
from dynamo_tpu.runtime.metrics import KvCacheMetrics as JaxKvCacheMetrics
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxMetricsRegistry
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.parallel import (
    MeshConfig,
    PlaneSpec,
    PpStages,
    plane_capability,
)
from dynamo_tpu_torch.parallel import pipeline as tpp
from dynamo_tpu_torch.runtime.metrics import KvCacheMetrics, MetricsRegistry
from dynamo_tpu_torch.worker.main import build_mesh, parse_args
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 8
PAD = 128 * BLOCK       # a pad position: past every block table
TOL = dict(rtol=5e-5, atol=5e-5)


def _configs(layers=2, tie=True):
    """(JAX config, port config) of tiny-test at `layers` layers."""
    return tuple(m.get_config("tiny-test").replace(num_layers=layers,
                                                   tie_embeddings=tie)
                 for m in (jcfg, tcfg))


class Pair:
    """One set of weights on a JAX pp mesh of S devices and on the port's
    S stages (M microbatches), with a cache on each side."""

    def __init__(self, S, M, layers=2, tie=True, kv_quant="none",
                 num_blocks=64):
        self.jc, self.tc = _configs(layers, tie)
        self.S, self.M, self.quant = S, M, kv_quant == "int8"
        params = jax_init_params(self.jc, jax.random.key(0))
        stacked = jpp.stack_layer_params(params)
        self.mesh = make_mesh(JaxMeshConfig(pp=S), jax.devices()[:S])
        self.jparams = shard_pytree(stacked, jpp.pp_param_pspecs(self.jc),
                                    self.mesh)
        self.params = params
        self.stages = PpStages(["cpu"] * S, M)
        # JAX's stacked pytree comes across as the port's layer list.
        self.state = from_jax_params(jax.device_get(stacked), "cpu")
        self.ranks = tpp.shard_stages(self.state, self.stages)
        self.jccfg = jkvc.KvCacheConfig.for_model(
            self.jc, num_blocks=num_blocks, block_size=BLOCK,
            dtype=jnp.float32, kv_quant=kv_quant)
        self.ccfg = kvc.KvCacheConfig.for_model(
            self.tc, num_blocks=num_blocks, block_size=BLOCK,
            kv_quant=kv_quant)
        self.jcache = self.new_jax_cache()
        self.cache = tpp.init_pp_cache(self.ccfg, self.stages)

    def new_jax_cache(self):
        return shard_pytree(jpp.init_pp_cache(self.jccfg),
                            jpp.pp_cache_pspecs(self.quant), self.mesh)

    def jax_step(self):
        return jpp.make_pp_step(self.jc, BLOCK, self.mesh, self.M,
                                kv_quant=self.quant)

    def step(self, kernel=False):
        return tpp.make_pp_step(self.tc, BLOCK, self.stages, self.M,
                                kv_quant=self.quant,
                                use_decode_kernel=kernel)


def _inputs(batch, T, seed=5):
    """JAX's `_inputs`: a [batch, T] chunk from position 0, each row on
    four pages of its own, drawn with numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (batch, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32),
                                (batch, T)).copy()
    bt = np.zeros((batch, 8), np.int32)
    for i in range(batch):
        bt[i, :4] = np.arange(1 + 4 * i, 5 + 4 * i)
    return (tokens, positions, np.full((batch,), T, np.int32), bt,
            np.full((batch,), T - 1, np.int32))


def _j(args):
    return [jnp.asarray(a) for a in args]


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _stacked_layer(cache, name, layer):
    """Layer `layer` of the port's stage caches (stage-owned lists)."""
    n = len(cache[0][name])
    return cache[layer // n][name][layer % n]


def _hold_cache(pair, names=("k", "v")):
    """Every layer of the port's stage caches against JAX's stacked
    cache, block 0 (junk by design) excluded."""
    got = jax.device_get(pair.jcache)
    for name in names:
        for layer in range(pair.tc.num_layers):
            np.testing.assert_allclose(
                _stacked_layer(pair.cache, name, layer).numpy()[BLOCK:],
                np.asarray(got[name][layer])[BLOCK:], **TOL)


# ---------------------------------------------------------------------------
# 1. The steps


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("S", [2, 4])
def test_pp_step_matches_jax(S, M):
    pair = Pair(S, M, layers=max(2, S))
    args = _inputs(4, 16)
    want, pair.jcache = pair.jax_step()(pair.jparams, pair.jcache, *_j(args))
    got, pair.cache = pair.step()(pair.ranks, pair.cache, *_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _hold_cache(pair)
    # The same call through llama's router (tp= a PpStages) and the
    # port's meshless step.
    ref, _ = llama.make_forward_step(pair.tc, BLOCK)(
        pair.state, kvc.init_cache(pair.ccfg, "cpu"), *_t(args))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    via, _ = llama.make_forward_step(pair.tc, BLOCK, tp=pair.stages)(
        pair.ranks, tpp.init_pp_cache(pair.ccfg, pair.stages), *_t(args))
    assert torch.equal(via, got)


def test_pp_step_untied_head_matches_jax():
    """An untied lm head lives on the last stage; the embedding on stage 0
    only."""
    pair = Pair(2, 2, tie=False)
    assert "lm_head" in pair.ranks[1] and "embed" not in pair.ranks[1]
    assert "embed" in pair.ranks[0] and "lm_head" not in pair.ranks[0]
    args = _inputs(4, 16, seed=9)
    want, _ = pair.jax_step()(pair.jparams, pair.jcache, *_j(args))
    got, _ = pair.step()(pair.ranks, pair.cache, *_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tie", [True, False])
def test_pp_specs_are_jax_specs(tie):
    jc, tc = _configs(tie=tie)

    def tuples(tree):
        return jax.tree.map(tuple, tree,
                            is_leaf=lambda x: isinstance(x, tuple))

    assert tpp.pp_param_pspecs(tc) == tuples(jpp.pp_param_pspecs(jc))
    for quant in (False, True):
        assert tpp.pp_cache_pspecs(quant) == tuples(
            jpp.pp_cache_pspecs(quant))
    assert [list(r) for r in tpp.stage_layers(8, 4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]


def test_tied_stages_share_the_embedding_table():
    """Tied embeddings: stage 0's lookup and the last stage's head read
    one table on one place, a copy of it on another."""
    pair = Pair(2, 2)
    assert pair.ranks[0]["embed"] is pair.ranks[1]["embed"]
    apart = PpStages(["cpu", "cpu"], 2, places=["a", "b"])
    ranks = tpp.shard_stages(pair.state, apart)
    assert ranks[0]["embed"] is pair.state["embed"]
    assert torch.equal(ranks[1]["embed"], ranks[0]["embed"])
    assert [len(r["layers"]) for r in ranks] == [1, 1]


def test_pp_prefill_then_decode():
    """tests/test_pipeline.py's prefill then decode: the cache handed
    across calls, the decode step through K1 (its plain version here)."""
    pair = Pair(2, 2)
    tokens, positions, seq_lens, bt, sample = _inputs(2, 12, seed=7)
    jref = jax_forward_step(pair.jc, BLOCK)
    jcache = jkvc.init_cache(jkvc.KvCacheConfig.for_model(
        pair.jc, num_blocks=64, block_size=BLOCK, dtype=jnp.float32))
    logits, jcache = jref(pair.params, jcache, *_j(
        (tokens, positions, seq_lens, bt, sample)))
    nxt = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    decode = (nxt, np.full((2, 1), 12, np.int32), np.full((2,), 13, np.int32),
              bt, np.zeros((2,), np.int32))
    want, _ = jref(pair.params, jcache, *_j(decode))
    got, cache = pair.step(kernel=True)(
        pair.ranks, pair.cache, *_t((tokens, positions, seq_lens, bt,
                                     sample)))
    np.testing.assert_array_equal(got.argmax(-1).numpy()[:, None], nxt)
    got, _ = pair.step(kernel=True)(pair.ranks, cache, *_t(decode))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jwant, _ = pair.jax_step()(pair.jparams, pair.jcache, *_j(
        (tokens, positions, seq_lens, bt, sample)))
    np.testing.assert_array_equal(np.argmax(np.asarray(jwant), -1),
                                  nxt[:, 0])


def _prefilled(S=2, M=2, kv_quant="none", B=4):
    """A Pair whose caches (both sides) hold a [B, 12] prefill."""
    pair = Pair(S, M, kv_quant=kv_quant)
    args = _inputs(B, 12, seed=11)
    want, pair.jcache = pair.jax_step()(pair.jparams, pair.jcache, *_j(args))
    got, pair.cache = pair.step()(pair.ranks, pair.cache, *_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
    return pair, args[3], nxt


def test_pp_greedy_step_matches_jax():
    pair, bt, nxt = _prefilled()
    args = (nxt[:, None], np.full((4, 1), 12, np.int32),
            np.full((4,), 13, np.int32), bt, np.zeros((4,), np.int32))
    jfused = jpp.make_pp_greedy_step(pair.jc, BLOCK, pair.mesh, pair.M)
    want, _ = jfused(pair.jparams, pair.jcache, *_j(args))
    fused = tpp.make_pp_greedy_step(pair.tc, BLOCK, pair.stages, pair.M,
                                    use_decode_kernel=True)
    got, _ = fused(pair.ranks, pair.cache, *_t(args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


K = 4


def test_pp_greedy_window_matches_jax():
    pair, bt, nxt = _prefilled()
    pos0, lens0 = np.full((4,), 12, np.int32), np.full((4,), 13, np.int32)
    jrun = jpp.make_pp_decode_window(pair.jc, BLOCK, pair.mesh, pair.M, K,
                                     greedy_only=True)
    jout = jrun(pair.jparams, pair.jcache, *_j((nxt, pos0, lens0, bt)),
                jnp.zeros(4), jnp.zeros(4, jnp.int32), jnp.ones(4),
                jnp.zeros((4, 2), jnp.uint32), jnp.zeros(4, jnp.int32))
    run = tpp.make_pp_decode_window(pair.tc, BLOCK, pair.stages, pair.M, K,
                                    greedy_only=True, use_decode_kernel=True)
    out = run(pair.ranks, pair.cache, *_t((nxt, pos0, lens0, bt)),
              torch.zeros(4), torch.zeros(4, dtype=torch.int32),
              torch.ones(4), [None] * 4, [0] * 4)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    for a, b in zip(out[2:4], jout[2:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out[4] == [K] * 4
    # llama's router builds the same window for a PpStages.
    via = llama.make_decode_window(pair.tc, BLOCK, K, use_decode_kernel=True,
                                   greedy_only=True, tp=pair.stages)
    assert via.__code__ is run.__code__


def test_pp_stochastic_window_matches_the_meshless_window():
    """The draws are keyed by (seed, index): the pp window samples the
    meshless window's tokens row for row."""
    pair, bt, nxt = _prefilled()
    flat = kvc.init_cache(pair.ccfg, "cpu")
    llama.make_forward_step(pair.tc, BLOCK)(pair.state, flat,
                                            *_t(_inputs(4, 12, seed=11)))
    args = _t((nxt, np.full((4,), 12, np.int32), np.full((4,), 13, np.int32),
               bt))
    temp = torch.tensor([0.8, 1.0, 0.0, 1.3])
    top_k = torch.tensor([0, 20, 0, 5], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.9, 1.0, 1.0])
    seeds, offsets = [7, 8, None, 9], [0, 3, 0, 11]
    run = tpp.make_pp_decode_window(pair.tc, BLOCK, pair.stages, pair.M, K,
                                    use_decode_kernel=True)
    got = run(pair.ranks, pair.cache, *args, temp, top_k, top_p, seeds,
              offsets)
    ref = llama.make_decode_window(pair.tc, BLOCK, K, use_decode_kernel=True)
    want = ref(pair.state, flat, *args, temp, top_k, top_p, seeds, offsets)
    assert torch.equal(got[1], want[1])
    assert got[4] == want[4] == [o + K for o in offsets]


# int8 logits against JAX: the two frameworks' f32 K/V rows differ in
# the last bit, so a row element near a .5 quantization boundary lands
# one int8 step apart on the two sides (below one element in a thousand
# here), which moves the logits that attend it by up to ~1e-3.
INT8_TOL = dict(rtol=0, atol=2e-3)


def test_pp_int8_step_matches_jax():
    """JAX's pp step with `kv_quant=True` (stacked scale buffers) runs
    on the CPU: logits (INT8_TOL) and scales (TOL) against it, the int8
    pages within one step; and the port's meshless int8 step's logits
    and pages exactly, within TOL."""
    pair = Pair(2, 2, kv_quant="int8")
    args = _inputs(4, 16, seed=3)
    want, pair.jcache = pair.jax_step()(pair.jparams, pair.jcache, *_j(args))
    got, pair.cache = pair.step()(pair.ranks, pair.cache, *_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **INT8_TOL)
    flat = kvc.init_cache(pair.ccfg, "cpu")
    ref, flat = llama.make_forward_step(pair.tc, BLOCK)(pair.state, flat,
                                                        *_t(args))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    for name in ("k", "v", "k_scale", "v_scale"):
        for layer in range(pair.tc.num_layers):
            assert torch.equal(_stacked_layer(pair.cache, name, layer),
                               flat[name][layer])
    _hold_cache(pair, ("k_scale", "v_scale"))
    jc = jax.device_get(pair.jcache)
    for name in ("k", "v"):
        for layer in range(pair.tc.num_layers):
            mine = _stacked_layer(pair.cache, name, layer).numpy()[BLOCK:]
            diff = np.abs(mine.astype(np.int32)
                          - np.asarray(jc[name][layer])[BLOCK:])
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


# ---------------------------------------------------------------------------
# 2. The block ops


def _filled(pair, rng):
    """The same random pages (and int8 scales) in both sides' caches."""
    jhost = jax.device_get(pair.jcache)
    filled = {}
    for name, arr in jhost.items():
        if arr.dtype == np.int8:
            filled[name] = rng.integers(-127, 128, arr.shape).astype(np.int8)
        elif name.endswith("_scale"):
            filled[name] = rng.uniform(1e-3, 1.0, arr.shape).astype(np.float32)
        else:
            filled[name] = rng.standard_normal(arr.shape).astype(arr.dtype)
    pair.jcache = shard_pytree({k: jnp.asarray(v) for k, v in filled.items()},
                               jpp.pp_cache_pspecs(pair.quant), pair.mesh)
    n = pair.tc.num_layers // pair.S
    pair.cache = [{name: [from_jax_params(filled[name][s * n + j], "cpu")
                          for j in range(n)] for name in filled}
                  for s in range(pair.S)]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_block_ops_match_jax(kv_quant):
    pair = Pair(2, 2, kv_quant=kv_quant, num_blocks=8)
    if kv_quant == "none":
        # The wire block at a 16-bit cache dtype, as served.
        pair.jccfg = dataclasses.replace(pair.jccfg, dtype=jnp.bfloat16)
        pair.jcache = pair.new_jax_cache()
    _filled(pair, np.random.default_rng(4))
    jex, jinj = jpp.make_pp_block_ops(BLOCK, pair.mesh, kv_quant=pair.quant)
    ex, inj = tpp.make_pp_block_ops(BLOCK, pair.stages, pair.quant)
    pages = [5, 1, 3]
    got = ex(pair.cache, torch.tensor(pages))
    assert got.shape[1:] == pair.ccfg.block_wire_shape
    for i, p in enumerate(pages):
        want = np.asarray(jex(pair.jcache, p))
        assert _bytes(got[i]) == want.tobytes()
    # Inject into other pages: JAX's inject and the port's write the same
    # bytes back, read again by both extracts.
    for i, p in enumerate([2, 6, 7]):
        block = got[i].contiguous()
        host = (block.view(torch.int16).numpy().view(jnp.bfloat16)
                if block.dtype == torch.bfloat16 else block.numpy())
        pair.jcache = jinj(pair.jcache, p, jnp.asarray(host))
    inj(pair.cache, torch.tensor([2, 6, 7]), got)
    again = ex(pair.cache, torch.tensor([2, 6, 7]))
    assert _bytes(again) == _bytes(got)
    assert np.asarray(jex(pair.jcache, 6)).tobytes() == _bytes(got[1])


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_injected_stage_caches_decode_as_the_meshless_cache(kv_quant):
    """A meshless cache's wire blocks injected into fresh stage caches:
    the next decode step through the stages equals the meshless step on
    the source cache."""
    pair = Pair(2, 2, kv_quant=kv_quant)
    flat = kvc.init_cache(pair.ccfg, "cpu")
    tokens, positions, lens, bt, sample = _inputs(4, 12, seed=2)
    logits, flat = llama.make_forward_step(pair.tc, BLOCK)(
        pair.state, flat, *_t((tokens, positions, lens, bt, sample)))
    pages = torch.tensor(sorted({int(p) for p in bt.reshape(-1) if p}))
    blocks = kvc.extract_blocks(flat, pages, BLOCK)
    _, inj = tpp.make_pp_block_ops(BLOCK, pair.stages, pair.quant)
    inj(pair.cache, pages, blocks)
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    args = (nxt, torch.full((4, 1), 12, dtype=torch.int32),
            torch.full((4,), 13, dtype=torch.int32), torch.from_numpy(bt),
            torch.zeros(4, dtype=torch.int32))
    want, _ = llama.make_forward_step(pair.tc, BLOCK, use_decode_kernel=True)(
        pair.state, flat, *args)
    got, _ = pair.step(kernel=True)(pair.ranks, pair.cache, *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------------------
# 3. The packed prefill under pp

PROMPTS = ([5, 6, 7, 8, 9, 10, 11], list(range(30, 43)))


def _prefill_inputs():
    """Both prompts padded [2, 16] (JAX's unified step) and packed [24]
    with segment starts on multiples of 8 (the port's packed step)."""
    R, T = 2, 16
    bts = np.asarray([[1, 2, 0], [3, 4, 5]], np.int32)
    tok2 = np.zeros((R, T), np.int32)
    pos2 = np.full((R, T), PAD, np.int32)
    for i, p in enumerate(PROMPTS):
        tok2[i, :len(p)] = p
        pos2[i, :len(p)] = np.arange(len(p))
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    tok = np.zeros(24, np.int32)
    pos = np.full(24, PAD, np.int32)
    seg = np.zeros(24, np.int32)
    tok[:7], pos[:7] = PROMPTS[0], np.arange(7)
    tok[8:21], pos[8:21], seg[8:21] = PROMPTS[1], np.arange(13), 1
    packed = (tok, pos, seg, bts, np.asarray([0, 8], np.int32), lens, lens,
              np.asarray([6, 20], np.int32))
    return (tok2, pos2, lens, bts, lens - 1), packed


@pytest.mark.parametrize("S", [2, 4])
def test_pp_packed_prefill_matches_meshless_and_jax(S):
    pair = Pair(S, 2, layers=max(2, S))
    padded, packed = _prefill_inputs()
    want, pair.jcache = pair.jax_step()(pair.jparams, pair.jcache,
                                        *_j(padded))
    step = llama.make_packed_prefill_step(pair.tc, BLOCK, tp=pair.stages)
    got, pair.cache = step(pair.ranks, pair.cache, *_t(packed))
    got = got[:2]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    flat = kvc.init_cache(pair.ccfg, "cpu")
    ref, flat = llama.make_packed_prefill_step(pair.tc, BLOCK)(
        pair.state, flat, *_t(packed))
    # The same ops in the same order as the meshless packed step.
    assert torch.equal(got, ref[:2])
    for name in ("k", "v"):
        for layer in range(pair.tc.num_layers):
            assert torch.equal(_stacked_layer(pair.cache, name, layer)[BLOCK:],
                               flat[name][layer][BLOCK:])
    _hold_cache(pair)
    with pytest.raises(ValueError, match="multimodal"):
        step(pair.ranks, pair.cache, *_t(packed),
             input_embeds=torch.zeros(24, pair.tc.hidden_size),
             embed_mask=torch.zeros(24, dtype=torch.bool))


# ---------------------------------------------------------------------------
# 4. The engine

SCHED = dict(max_seqs=4, block_size=BLOCK, max_pages_per_seq=8,
             max_prefill_chunk=16, decode_buckets=(2, 4),
             prefill_buckets=(8, 16))
WAVE = {"a": [5, 6, 7, 8, 9, 10, 5, 6, 7, 8], "b": list(range(20, 34))}
N_OUT = 12


@pytest.fixture(scope="module")
def tiny():
    jc = jcfg.get_config("tiny-test")
    params = jax_init_params(jc, jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def _pp_mesh(S=2):
    return make_mesh(JaxMeshConfig(pp=S), jax.devices()[:S])


def _port_core(state, **kw):
    kw.setdefault("enable_prefix_cache", False)
    sched = dict(SCHED, **kw.pop("sched", {}))
    return EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=kw.pop(
            "num_blocks", 64), device="cpu",
        scheduler=SchedulerConfig(**sched), **kw), params=state)


def _jax_core(params, mesh, **kw):
    kw.setdefault("enable_prefix_cache", False)
    sched = dict(SCHED, **kw.pop("sched", {}))
    return JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=kw.pop(
            "num_blocks", 64), mesh=mesh, scheduler=JaxSchedulerConfig(
                **sched), **kw), params=params)


def _run(core, prompts=WAVE, n=N_OUT):
    cls = SamplingParams if isinstance(core, EngineCore) else \
        JaxSamplingParams
    for rid, prompt in prompts.items():
        core.add_request(rid, list(prompt), cls(max_tokens=n))
    out = {}
    for _ in range(400):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core._requests:
            break
    assert not core._requests, "engine did not finish"
    return out


@pytest.mark.parametrize("window,kv_quant", [
    (True, "none"), (False, "none"), (False, "int8")])
def test_pp_engine_matches_jax_pp_engine(tiny, window, kv_quant):
    """test_sharded_serving.py's `test_pp_engine_serving` oracle, on both
    engines: the window path (the port's pp window; JAX's window of 4)
    and the single step (JAX's decode_window 1; the port's window kept
    off, so each decode step is the fused pp greedy step)."""
    params, state = tiny
    jcore = _jax_core(params, _pp_mesh(), kv_quant=kv_quant,
                      decode_window=4 if window else 1,
                      window_pipeline_depth=2)
    want = _run(jcore)
    core = _port_core(state, pp=2, kv_quant=kv_quant)
    assert core.stages is not None and core.group is core.stages
    if not window:
        core._window_eligible = lambda plan: False
    got = _run(core)
    assert got == want
    assert all(len(t) == N_OUT for t in got.values())
    c = core.counters
    if window:
        assert c.window_dispatches > 0
    else:
        assert c.window_dispatches == 0 and c.single_step_dispatches > 0
    assert c.packed_prefill_dispatches > 0
    if kv_quant == "none":
        assert got == _run(_port_core(state))


def test_pp_engine_draws_the_meshless_weights():
    """No params: the pp engine draws the seed's weights onto its stages
    as they come, and serves the meshless engine's tokens."""
    got = _run(_port_core(None, pp=2, pp_microbatches=4))
    assert got == _run(_port_core(None))


CHURN = [[100 + 16 * i + j for j in range(16)] for i in range(4)]


def test_pp_engine_prefix_hit_and_g2_round_trip(tiny):
    """The tiered prefix cache through the pp block ops, as JAX's pp
    engine: a second ask of a prompt hits G1; churn evicts its blocks
    into G2 (the extract), a third ask onboards them (the inject) and
    answers as before.  Tokens, offloaded and onboarded blocks and prefix
    hit tokens equal JAX's."""
    params, state = tiny
    kw = dict(enable_prefix_cache=True, num_blocks=9, host_blocks=16,
              sched=dict(decode_buckets=(1, 2, 4)))
    jcore = _jax_core(params, _pp_mesh(), decode_window=4,
                      window_pipeline_depth=2, **kw)
    core = _port_core(state, pp=2, **kw)
    prompt = list(range(1, 17))
    try:
        out = {}
        for c in (jcore, core):
            runs = [_run(c, {"a": prompt}, 2)["a"],
                    _run(c, {"a1": prompt}, 2)["a1"]]
            hit = c.scheduler.prefix_hit_tokens
            for i, p in enumerate(CHURN):
                runs.append(_run(c, {f"c{i}": p}, 2)[f"c{i}"])
            runs.append(_run(c, {"a2": prompt}, 2)["a2"])
            m = c.allocator.manager
            out[c is core] = (runs, hit, m.offloaded_blocks,
                              m.onboarded_blocks,
                              c.scheduler.prefix_hit_tokens)
        assert out[True] == out[False]
        runs, hit, offloaded, onboarded, _ = out[True]
        assert runs[0] == runs[1] == runs[-1]
        assert hit > 0 and offloaded > 0 and onboarded > 0
    finally:
        jcore.allocator.manager.close()
        core.allocator.manager.close()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_pp_engine_per_chip_bytes_as_jax(tiny, kv_quant):
    """JAX's test_per_chip_modeled_bytes_pp_sp on both engines: a pp2
    engine's per-chip effective bytes a token halve against the meshless
    one's (each stage sweeps its layer slice for every row), and the
    per-chip block bytes report the stage-owned pages (and scales)
    divided by the stage count."""
    params, state = tiny
    flat = _port_core(state, kv_quant=kv_quant)
    pp2 = _port_core(state, pp=2, kv_quant=kv_quant)
    jpp2 = _jax_core(params, _pp_mesh(), kv_quant=kv_quant)
    for core in (flat, pp2, jpp2):
        _run(core, {"a": WAVE["a"]})
    assert pp2.kv_traffic_shards == pp2.kv_shard_count == 2
    assert jpp2.kv_traffic_shards == jpp2.kv_shard_count == 2
    b0 = flat.counters.effective_bytes_per_token
    b2 = pp2.counters.effective_bytes_per_token
    assert b0 > 0 and abs(b2 / b0 - 0.5) < 1e-6
    assert b2 == jpp2.counters.effective_bytes_per_token
    kvm = KvCacheMetrics(MetricsRegistry())
    kvm.observe_engine(pp2)
    jkvm = JaxKvCacheMetrics(JaxMetricsRegistry())
    jkvm.observe_engine(jpp2)
    labels = {"kv_quant": kv_quant}
    got = kvm.kv_bytes_per_block.value(labels=labels)
    assert got == pp2.cache_cfg.bytes_per_block / 2
    assert got == jkvm.kv_bytes_per_block.value(labels=labels)
    # Each stage holds its layers' pages only.
    assert [len(c["k"]) for c in pp2.cache] == [1, 1]


# ---------------------------------------------------------------------------
# 5. The refusals


def _error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _jax_reason(plane):
    return jax_capability(_pp_mesh(), plane, multihost=False).reason


@pytest.mark.parametrize("axis", ["dp", "sp", "ep", "tp"])
def test_pp_beside_another_axis_refuses_in_jax_words(axis):
    jc = jcfg.get_config("tiny-test")
    want = _error(lambda: jpp.make_pp_step(jc, BLOCK, make_mesh(
        JaxMeshConfig(pp=2, **{axis: 2}), jax.devices()[:4]), 2))
    assert _error(lambda: MeshConfig(pp=2, **{axis: 2})) == want
    args = parse_args(["--control-plane", "h:1", "--device", "cpu", "--pp",
                       "2", *([f"--{axis}", "2"] if axis != "sp" else [])])
    if axis != "sp":   # the worker has no --sp
        with pytest.raises(SystemExit, match="composes with no other axis"):
            build_mesh(args)


def test_validate_pp_refuses_as_jax():
    jc, tc = _configs()
    mesh8 = make_mesh(JaxMeshConfig(pp=8), jax.devices())
    want = _error(lambda: jpp.make_pp_step(jc, BLOCK, mesh8, 2))
    assert want == "pp=8 must divide num_layers=2"
    assert _error(lambda: tpp.make_pp_step(
        tc, BLOCK, PpStages(["cpu"] * 8, 2), 2)) == want
    with pytest.raises(ValueError, match="pp=4 must divide num_layers=2"):
        EngineCore(EngineConfig(model=tc, device="cpu", num_blocks=16, pp=4))
    jm, tm = jcfg.get_config("tiny-moe"), tcfg.get_config("tiny-moe")
    want = _error(lambda: jpp.make_pp_step(jm, BLOCK, _pp_mesh(), 2))
    assert want == "pp v1 supports dense models only"
    assert _error(lambda: tpp.make_pp_step(
        tm, BLOCK, PpStages(["cpu"] * 2, 2), 2)) == want
    jg = jcfg.get_config("tiny-gemma").replace(num_layers=2)
    tg = tcfg.get_config("tiny-gemma").replace(num_layers=2)
    want = _error(lambda: jpp.make_pp_step(jg, BLOCK, _pp_mesh(), 2))
    assert _error(lambda: tpp.make_pp_step(
        tg, BLOCK, PpStages(["cpu"] * 2, 2), 2)) == want


def test_capability_rows_are_jax_rows():
    """MoE, spec, embeddings and multimodal under pp: the port's table
    gives JAX's reasons, and the engine raises them."""
    mesh = MeshConfig(pp=2)
    for port, jax_plane in (
            (PlaneSpec(moe=True), JaxPlaneSpec(moe=True)),
            (PlaneSpec(spec=True), JaxPlaneSpec(spec=True)),
            (PlaneSpec(role="embed"), JaxPlaneSpec(role="embed")),
            (PlaneSpec(role="mm"), JaxPlaneSpec(role="mm"))):
        got = plane_capability(port, mesh)
        assert not got.ok and got.reason == _jax_reason(jax_plane)
        assert plane_capability(port, None).ok
    # The row the port does not copy: its stages attend through K1 / K2.
    assert not jax_capability(_pp_mesh(), JaxPlaneSpec(use_pallas=True),
                              multihost=False).ok
    assert plane_capability(PlaneSpec(use_kernel=True), mesh).ok
    tc = tcfg.get_config("tiny-test")
    assert _error(lambda: EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-moe"), device="cpu", num_blocks=16,
        pp=2))) == _jax_reason(JaxPlaneSpec(moe=True))
    assert _error(lambda: EngineCore(EngineConfig(
        model=tc, device="cpu", num_blocks=16, pp=2,
        speculative_tokens=3))) == _jax_reason(JaxPlaneSpec(spec=True))
    core = EngineCore(EngineConfig(model=tc, device="cpu", num_blocks=16,
                                   pp=2))
    assert _error(lambda: core.embed_tokens([[1, 2, 3]])) == _jax_reason(
        JaxPlaneSpec(role="embed"))
    assert _error(lambda: core.add_request(
        "mm", [1, 2, 3], SamplingParams(max_tokens=2),
        prompt_embeds=np.zeros((2, tc.hidden_size), np.float32))) == \
        _jax_reason(JaxPlaneSpec(role="mm"))
    with pytest.raises(ValueError, match="no return_hidden path"):
        llama.make_forward_step(tc, BLOCK, return_hidden=True,
                                tp=PpStages(["cpu"] * 2, 2))
    with pytest.raises(ValueError, match="not divisible by 2 microbatches"):
        tpp.make_pp_step(tc, BLOCK, PpStages(["cpu"] * 2, 2), 2)(
            tpp.shard_stages({"embed": torch.zeros(256, 64),
                              "final_norm": torch.ones(64),
                              "layers": [{}, {}]},
                             PpStages(["cpu"] * 2, 2)), [{}, {}],
            *_t(_inputs(3, 4)))


def test_worker_pp_flags_build_the_pp_engine():
    args = parse_args(["--control-plane", "h:1", "--device", "cpu", "--pp",
                       "2", "--pp-microbatches", "4"])
    assert build_mesh(args) == MeshConfig(pp=2) and args.pp_microbatches == 4
    assert MeshConfig(pp=2).describe() == JaxMeshConfig(pp=2).describe()
    assert parse_args(["--control-plane", "h:1"]).pp_microbatches == 2


# ---------------------------------------------------------------------------
# 6. A pp worker behind the frontend


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
def test_pp_worker_serves_a_chat_behind_the_frontend(tmp_path):
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        http = s.getsockname()[1]
    fe_log, w_log = tmp_path / "frontend.log", tmp_path / "worker.log"
    body = {"model": "tiny-pp", "max_tokens": 8, "temperature": 0,
            "logprobs": True,
            "return_tokens_as_token_ids": True,
            "messages": [{"role": "user", "content": "hello"}]}
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
             "tiny-test", "--model-name", "tiny-pp", "--block-size", "8",
             "--health-port", "0", "--pp", "2", "--pp-microbatches", "2"],
            cwd=ROOT, stdout=open(w_log, "w"), stderr=subprocess.STDOUT))
        status = _wait_for(w_log, r"worker status server on :(\d+)",
                           deadline, procs[1])
        base = f"http://127.0.0.1:{http}"
        while not any(m["id"] == "tiny-pp"
                      for m in _get(base + "/v1/models")["data"]):
            assert time.monotonic() < deadline, w_log.read_text()
            time.sleep(0.2)
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
        ids = [int(e["token"].split(":")[1])
               for e in reply["choices"][0]["logprobs"]["content"]]
        stats = _get(f"http://127.0.0.1:{status}/debug/stats")
        assert stats["mesh"] == "pp2" and stats["kv_shard_count"] == 2
        assert stats["kv_traffic_shards"] == 2
        assert stats["tp_devices"] == ["cpu", "cpu"]
        assert stats["rank_launches"] == [0, 0]     # plain versions on CPU
        assert stats["slice"]["describe"] == "pp2"
        assert stats["slice"]["mesh"] == [1, 2, 1, 1, 1]
        assert stats["counters"]["packed_prefill_dispatches"] >= 1
        assert "pp stages: 2 stages, 2 microbatches, on ['cpu', 'cpu']" in \
            w_log.read_text()
    finally:
        for p in reversed(procs):
            p.terminate()
            p.wait(timeout=30)
    # The in-process engine on the worker's weights and scheduler.
    pre = OpenAIPreprocessor(ByteTokenizer()).preprocess_chat(
        ChatCompletionRequest.from_dict(body), "x")
    core = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), device="cpu",
        scheduler=SchedulerConfig(block_size=8)))
    core.add_request("x", pre.token_ids, SamplingParams(max_tokens=8))
    want = []
    for _ in range(100):
        for d in core.step():
            want.extend(d.token_ids)
        if not core._requests:
            break
    assert ids == want
