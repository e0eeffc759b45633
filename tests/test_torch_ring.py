"""The port's sequence-parallel ring prefill against the JAX package, on
the CPU at `tiny-test` geometry.

1. `ring_causal_attention` of the port over sp in {1, 2, 4, 8} CPU shards
   against the JAX `ring_causal_attention` under `shard_map` on the 8
   forced host devices and against JAX `causal_attention`: the same numpy
   inputs from a seed.  f32: rtol = atol = 2e-5 (the reference test's
   own; the two sum in other orders).  bf16: both sides compute in f32 and
   round the output once, so they may differ by one bf16 unit (rtol 2^-7,
   atol 1e-3 near zero).  Also with soft_cap, with padding rows and keys
   at a pad position (junk-but-finite rows included), and with int8 rows
   and scales from the port's `quantize_kv_rows`.  The CUDA kernel's ring
   loop (`ring_flash_attention`, whose fold is the plain version for
   CPU tensors) must give the plain ring's bits through its two slots.
2. `make_sp_prefill_step` of the port (sp 2 and 4; model-dtype and int8
   cache) against JAX `make_sp_prefill_step(use_pallas=False)` on an sp
   mesh and against the port's own packed prefill step: logits and the
   written cache rows.  f32 model: logits and rows to 5e-4 (the reference
   test's own); int8 rows may sit one step apart where the f32 K/V of the
   two frameworks differ in their last bits.
3. Engine: one prompt fleet (whole prompts at or past a lowered
   `sp_prefill_threshold`, one under it, one with a prefix hit) through a
   port `EngineCore(sp=2)`, a JAX `EngineCore` on an sp2 mesh and the
   port's `sp=1` engine: greedy tokens equal, `sp_prefill_count` and
   `ring_exchange_bytes_modeled` equal to JAX's.
4. The declared errors and the one geometry predicate.
5. The frontend on `--device cpu --sp 2` serves a long prompt; its
   `/debug/stats` shows the counters and the rank map.
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
from jax.sharding import PartitionSpec as P

from dynamo_tpu.engine import kv_cache as jkvc
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.ops.attention import causal_attention as jax_causal_attention
from dynamo_tpu.ops.ring_attention import (
    ring_causal_attention as jax_ring_causal_attention,
)
from dynamo_tpu.parallel import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel import (
    cache_pspecs,
    make_mesh,
    param_pspecs,
    shard_pytree,
)
from dynamo_tpu.parallel import make_sp_prefill_step as jax_make_sp_prefill_step
from dynamo_tpu.parallel.sharding import PlaneSpec as JaxPlaneSpec
from dynamo_tpu.parallel.sharding import plane_capability as jax_plane_capability
from dynamo_tpu.runtime.jax_compat import shard_map
from dynamo_tpu_torch.engine import engine as port_engine
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as port_llama
from dynamo_tpu_torch.models.llama import make_packed_prefill_step
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.ops.cuda import ring_attention as port_ring_kernel
from dynamo_tpu_torch.ops.cuda import (
    launch_counts,
    ring_flash_attention,
    ring_geometry_ok,
    ring_kernel_supported,
)
from dynamo_tpu_torch.ops.ring_attention import ring_causal_attention
from dynamo_tpu_torch.parallel import (
    MeshConfig,
    PlaneSpec,
    SpRing,
    make_sp_prefill_step,
    plane_capability,
)
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

ROOT = Path(__file__).resolve().parents[1]
JCFG = jcfg.get_config("tiny-test")
TCFG = tcfg.get_config("tiny-test")
BLOCK = 8
PAD = 4096      # a pad position: past every real key
B, T, HQ, HKV, D = 2, 64, 8, 4, 16


# ---------------------------------------------------------------------------
# 1. The ring op


def _inputs(seed, padded=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, T, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, HKV, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if padded:
        pos[1, 41:] = PAD          # row 1: 41 real tokens, the rest padding
    return q, k, v, pos


def _jax_ring(sp, q, k, v, pos, soft_cap=None, k_scale=None, v_scale=None):
    """The JAX ring as its own tests run it on the CPU: plain at sp 1,
    under shard_map over the first sp forced host devices otherwise."""
    quant = k_scale is not None
    if sp == 1:
        return np.asarray(jax_ring_causal_attention(
            q, k, v, pos, soft_cap=soft_cap, k_scale=k_scale,
            v_scale=v_scale).astype(jnp.float32))
    mesh = make_mesh(JaxMeshConfig(sp=sp), jax.devices()[:sp])
    spec4, spec3, spec2 = (P(None, "sp", None, None), P(None, "sp", None),
                           P(None, "sp"))
    if quant:
        fn = shard_map(
            lambda qs, ks, vs, ps, ksc, vsc: jax_ring_causal_attention(
                qs, ks, vs, ps, axis_name="sp", soft_cap=soft_cap,
                k_scale=ksc, v_scale=vsc),
            mesh=mesh, in_specs=(spec4, spec4, spec4, spec2, spec3, spec3),
            out_specs=spec4, check_vma=False)
        out = fn(q, k, v, pos, k_scale, v_scale)
    else:
        fn = shard_map(
            lambda qs, ks, vs, ps: jax_ring_causal_attention(
                qs, ks, vs, ps, axis_name="sp", soft_cap=soft_cap),
            mesh=mesh, in_specs=(spec4, spec4, spec4, spec2),
            out_specs=spec4, check_vma=False)
        out = fn(q, k, v, pos)
    return np.asarray(out.astype(jnp.float32))


def _cut(x, sp):
    return [c.contiguous() for c in torch.from_numpy(np.array(x)).chunk(sp, dim=1)]


def _port_ring(sp, q, k, v, pos, soft_cap=None, k_scale=None, v_scale=None,
               dtype=torch.float32):
    """The port's plain ring and the kernel's ring loop over sp CPU
    shards; both outputs as f32 numpy."""
    kw = dict(soft_cap=soft_cap)
    if k_scale is not None:
        kw.update(k_scale=_cut(k_scale, sp), v_scale=_cut(v_scale, sp))
        ks, vs = _cut(k, sp), _cut(v, sp)
    else:
        ks = [t.to(dtype) for t in _cut(k, sp)]
        vs = [t.to(dtype) for t in _cut(v, sp)]
    qs = [t.to(dtype) for t in _cut(q, sp)]
    ps = _cut(pos, sp)
    plain = torch.cat(ring_causal_attention(qs, ks, vs, ps, **kw), dim=1)
    ring = SpRing(["cpu"] * sp)
    driven = torch.cat(ring_flash_attention(ring, qs, ks, vs, ps, **kw), dim=1)
    return plain.float().numpy(), driven.float().numpy()


# sp 8 costs the JAX side ~12 s of compile a case: it runs once for each
# of the four kinds of input, the other degrees for every variant.
@pytest.mark.parametrize("sp,variant", [
    (sp, v) for v in ("plain", "soft_cap", "padded") for sp in (1, 2, 4)]
    + [(8, "plain")])
def test_ring_matches_jax_ring_and_causal_f32(sp, variant):
    q, k, v, pos = _inputs(sp, padded=variant == "padded")
    cap = 30.0 if variant == "soft_cap" else None
    want = _jax_ring(sp, q, k, v, pos, soft_cap=cap)
    got, driven = _port_ring(sp, q, k, v, pos, soft_cap=cap)
    assert np.isfinite(got).all()
    # Every row, the junk-but-finite padding rows included.
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(driven, got)
    if variant == "plain":
        causal = np.asarray(jax_causal_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
        np.testing.assert_allclose(got, causal, rtol=2e-5, atol=2e-5)
    if variant == "padded":
        # The real rows of the padded prompt see only its real keys.
        short = np.asarray(jax_causal_attention(
            jnp.asarray(q[1:, :41]), jnp.asarray(k[1:, :41]),
            jnp.asarray(v[1:, :41])))
        np.testing.assert_allclose(got[1:, :41], short, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_ring_matches_jax_ring_bf16_soft_cap(sp):
    q, k, v, pos = _inputs(10 + sp)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = _jax_ring(sp, *jb, pos, soft_cap=30.0)
    # The same bf16 values on the port's side.
    rounded = [np.asarray(x.astype(jnp.float32)) for x in jb]
    got, driven = _port_ring(sp, *rounded, pos, soft_cap=30.0,
                             dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-3)
    np.testing.assert_array_equal(driven, got)


@pytest.mark.parametrize("sp,dtype", [
    (sp, d) for d in ("float32", "bfloat16") for sp in (1, 2, 4)]
    + [(8, "float32")])
def test_ring_int8_matches_jax_ring(sp, dtype):
    """int8 rows and scales made by the port's quantize_kv_rows (byte-equal
    to JAX's) ride both rings; each dequantizes through q's dtype."""
    q, k, v, pos = _inputs(20 + sp, padded=True)
    kq, ks = kvc.quantize_kv_rows(torch.from_numpy(k).reshape(B * T, HKV * D), HKV)
    vq, vs = kvc.quantize_kv_rows(torch.from_numpy(v).reshape(B * T, HKV * D), HKV)
    kq, vq = (x.reshape(B, T, HKV, D).numpy() for x in (kq, vq))
    ks, vs = (x.reshape(B, T, HKV).numpy() for x in (ks, vs))
    jq = jnp.asarray(q).astype(dtype)
    want = _jax_ring(sp, jq, jnp.asarray(kq), jnp.asarray(vq), pos,
                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got, driven = _port_ring(sp, np.asarray(jq.astype(jnp.float32)), kq, vq,
                             pos, k_scale=ks, v_scale=vs,
                             dtype=getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-3)
    np.testing.assert_array_equal(driven, got)


def test_ring_loop_reuses_its_slots_across_calls():
    """A second ring over the same SpRing (the next layer) finds the
    first one's blocks in the slots and must not read them."""
    q, k, v, pos = _inputs(31)
    ring = SpRing(["cpu"] * 4)
    args = [_cut(x, 4) for x in (q, k, v, pos)]
    first = torch.cat(ring_flash_attention(ring, *args), dim=1)
    swapped = [args[0], args[2], args[1], args[3]]
    second = torch.cat(ring_flash_attention(ring, *swapped), dim=1)
    np.testing.assert_array_equal(
        first.numpy(), torch.cat(ring_causal_attention(*args), 1).numpy())
    np.testing.assert_array_equal(
        second.numpy(), torch.cat(ring_causal_attention(*swapped), 1).numpy())
    assert len(ring._slots[0]) == 1          # one geometry, one pair of slots


# ---------------------------------------------------------------------------
# 2. The sp prefill step


@pytest.fixture(scope="module")
def weights():
    params = jax_init_params(JCFG, jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def _step_inputs():
    rng = np.random.default_rng(7)
    rows, Tc, Pw = 2, 16, 4
    lens = [16, 11]
    tokens = np.zeros((rows, Tc), np.int32)
    positions = np.full((rows, Tc), PAD, np.int32)
    bts = np.zeros((rows, Pw), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, JCFG.vocab_size, n)
        positions[i, :n] = np.arange(n)
        bts[i, :2] = [1 + 2 * i, 2 + 2 * i]
    seq = np.asarray(lens, np.int32)
    return tokens, positions, seq, bts, seq - 1, lens


def _real_slots(bts, lens):
    return np.concatenate([bts[i, np.arange(n) // BLOCK] * BLOCK
                           + np.arange(n) % BLOCK for i, n in enumerate(lens)])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_sp_prefill_step_matches_jax_and_packed(weights, sp, kv_quant):
    params, state = weights
    tokens, positions, seq, bts, sample, lens = _step_inputs()
    quant = kv_quant == "int8"
    # JAX: the sp step on an sp mesh, the XLA ring.
    mesh = make_mesh(JaxMeshConfig(sp=sp), jax.devices()[:sp])
    jcache = shard_pytree(
        jkvc.init_cache(jkvc.KvCacheConfig.for_model(
            JCFG, num_blocks=16, block_size=BLOCK, dtype=jnp.float32,
            kv_quant=kv_quant)),
        cache_pspecs(JCFG.num_layers, kv_quant=quant), mesh)
    jstep = jax_make_sp_prefill_step(JCFG, BLOCK, mesh, kv_quant=quant,
                                     use_pallas=False)
    want, want_cache = jstep(shard_pytree(params, param_pspecs(JCFG), mesh),
                             jcache, *(jnp.asarray(x) for x in (
                                 tokens, positions, seq, bts, sample)))
    want = np.asarray(want)
    # The port: the sp step over sp CPU ranks.
    ccfg = kvc.KvCacheConfig.for_model(TCFG, num_blocks=16, block_size=BLOCK,
                                       kv_quant=kv_quant)
    cache = kvc.init_cache(ccfg, "cpu")
    ring = SpRing(["cpu"] * sp)
    step = make_sp_prefill_step(TCFG, BLOCK, ring, kv_quant=quant)
    targs = [torch.from_numpy(x) for x in (tokens, positions, seq, bts, sample)]
    got, cache = step(state, cache, *targs)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)
    # The port's packed prefill of the same prompts.
    pcache = kvc.init_cache(ccfg, "cpu")
    flat_tok = np.concatenate([tokens[i, :n] for i, n in enumerate(lens)])
    flat_pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]).astype(np.int32)
    pad = (-len(flat_tok)) % 8
    flat_tok = np.concatenate([flat_tok, np.zeros(pad, np.int32)])
    flat_pos = np.concatenate([flat_pos, np.full(pad, PAD, np.int32)])
    seg = np.concatenate([seg, np.zeros(pad, np.int32)])
    qs = np.asarray([0, lens[0]], np.int32)
    packed = make_packed_prefill_step(TCFG, BLOCK)
    plogits, pcache = packed(state, pcache, *(torch.from_numpy(x) for x in (
        flat_tok, flat_pos, seg, bts, qs, seq, seq,
        np.asarray([lens[0] - 1, sum(lens) - 1], np.int32))))
    np.testing.assert_allclose(got.numpy(), plogits.numpy(), rtol=5e-4,
                               atol=5e-4)
    # The written rows of the real tokens, every layer.
    slots = _real_slots(bts, lens)
    for i in range(TCFG.num_layers):
        for kv in ("k", "v"):
            mine = cache[kv][i][slots].numpy()
            theirs = np.asarray(want_cache[kv][i])[slots]
            own = pcache[kv][i][slots].numpy()
            if quant:
                for other in (theirs, own):
                    step_off = np.abs(mine.astype(np.int32) - other)
                    assert step_off.max() <= 1
                    assert (step_off > 0).mean() < 0.01
                np.testing.assert_allclose(
                    cache[kv + "_scale"][i][slots].numpy(),
                    np.asarray(want_cache[kv + "_scale"][i])[slots],
                    rtol=1e-4)
            else:
                np.testing.assert_allclose(mine, theirs, rtol=5e-4, atol=5e-4)
                np.testing.assert_allclose(mine, own, rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# 3. The engine

GEOM = dict(max_seqs=8, block_size=8, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16))
# Waves, each sent once the one before has finished: two whole prompts at
# or past the threshold (ring); one whose first block is cached (its
# prefill starts at 8: packed, and it takes the wave's other prompt with
# it); one under the threshold (packed); one more long one (ring).
WAVES = [
    {"a": list(range(30, 44)), "b": [5, 6, 7, 8, 9, 10, 5, 6, 7, 8]},
    {"c": list(range(30, 38)) + [90, 91, 92, 93, 94, 95],
     "d": list(range(100, 112))},
    {"e": [3, 1, 4]},
    {"f": list(range(60, 73))},
]
N_OUT = 10


def _run_waves(core, sampling_cls):
    toks = {}
    for wave in WAVES:
        for rid, prompt in wave.items():
            core.add_request(rid, prompt, sampling_cls(max_tokens=N_OUT))
        for _ in range(500):
            for d in core.step():
                toks.setdefault(d.request_id, []).extend(d.token_ids)
            if not core._requests:
                break
        assert not core._requests, "engine did not finish the wave"
    return toks


def _port_core(state, **kw):
    return EngineCore(EngineConfig(
        model=TCFG, num_blocks=64, device="cpu",
        scheduler=SchedulerConfig(**GEOM), sp_prefill_threshold=8, **kw),
        params=state)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_sp_engine_matches_jax_sp_engine_and_sp1(weights, kv_quant):
    params, state = weights
    mesh = make_mesh(JaxMeshConfig(sp=2), jax.devices()[:2])
    jcore = JaxEngineCore(JaxEngineConfig(
        model=JCFG, num_blocks=64, mesh=mesh, sp_prefill_threshold=8,
        kv_quant=kv_quant,
        scheduler=JaxSchedulerConfig(**GEOM)), params=params)
    want = _run_waves(jcore, JaxSamplingParams)
    core = _port_core(state, sp=2, kv_quant=kv_quant)
    got = _run_waves(core, SamplingParams)
    flat = _run_waves(_port_core(state, kv_quant=kv_quant), SamplingParams)
    assert got == want
    assert got == flat
    assert all(len(t) == N_OUT for t in got.values())
    c = core.counters
    assert c.sp_prefill_count == jcore.sp_prefill_count == 3
    assert c.sp_prefill_dispatches == 2
    assert (c.ring_exchange_bytes_modeled
            == jcore.counters.ring_exchange_bytes_modeled > 0)
    payload = core.cache_cfg.ring_payload_bytes_per_token
    assert payload == jcore.cache_cfg.ring_payload_bytes_per_token
    assert c.ring_exchange_bytes_modeled == (
        (14 + 10) * payload // 2 + 13 * payload // 2)
    # On the CPU the ring folds with the kernel's plain version: no kernel
    # prefill is counted, on either side, and no kernel body launched.
    assert c.ring_kernel_prefills == jcore.counters.ring_kernel_prefills == 0
    assert core.scheduler.prefix_hit_tokens == 8
    # The prefix cache still publishes after a ring prefill: prompt "a"'s
    # first block served prompt "c".
    assert core.prefix_cache_stats()["pool"]["g1_hits"] >= 1


# ---------------------------------------------------------------------------
# 4. Declared errors, one predicate


def test_sp_step_refuses_a_chunk_that_sp_does_not_divide(weights):
    _, state = weights
    ring = SpRing(["cpu"] * 4)
    step = make_sp_prefill_step(TCFG, BLOCK, ring)
    cache = kvc.init_cache(kvc.KvCacheConfig.for_model(
        TCFG, num_blocks=8, block_size=BLOCK), "cpu")
    tok = torch.zeros(1, 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="must divide by sp=4"):
        step(state, cache, tok, tok, torch.tensor([10]),
             torch.zeros(1, 2, dtype=torch.int32), torch.tensor([9]))
    with pytest.raises(ValueError, match="prefill buckets"):
        EngineCore(EngineConfig(
            model=TCFG, device="cpu", sp=4, sp_prefill_threshold=8,
            scheduler=SchedulerConfig(**{**GEOM, "prefill_buckets": (8, 10, 16)})),
            params=state)


def test_moe_and_dp_attention_errors_are_the_reference_tables():
    moe = JaxPlaneSpec(role="sp_prefill", moe=True)
    want = jax_plane_capability(None, moe, multihost=False).reason
    got = plane_capability(PlaneSpec(role="sp_prefill", moe=True))
    assert not got.ok and got.reason == want
    mesh = make_mesh(JaxMeshConfig(sp=2), jax.devices()[:2])
    want = jax_plane_capability(mesh, JaxPlaneSpec(
        role="sp_prefill", dp_attention=True), multihost=False).reason
    got = plane_capability(PlaneSpec(role="sp_prefill", dp_attention=True),
                           MeshConfig(sp=2))
    assert not got.ok and got.reason == want
    with pytest.raises(ValueError, match="declared impossible for MoE"):
        EngineCore(EngineConfig(model=tcfg.get_config("tiny-moe"),
                                device="cpu", sp=2))
    with pytest.raises(ValueError, match="declared impossible for MoE"):
        make_sp_prefill_step(tcfg.get_config("tiny-moe"), BLOCK,
                             SpRing(["cpu"] * 2))


def test_mesh_config_and_ring_construction():
    assert MeshConfig(sp=4).describe() == JaxMeshConfig(sp=4).describe() == "sp4"
    assert MeshConfig().describe() == "single" and MeshConfig(sp=4).size == 4
    # pp is ported (tests/test_torch_pp.py) and composes with no sp.
    assert MeshConfig(pp=2).describe() == "pp2"
    with pytest.raises(ValueError, match=r"pp v1 composes with no other "
                                         r"axis in-mesh \(got sp=2\)"):
        MeshConfig(pp=2, sp=2)
    # tp, dp and ep are ported (tests/test_torch_tp.py, test_torch_dp.py,
    # test_torch_ep.py), and so are sp x tp and sp x dp
    # (tests/test_torch_sp_grid.py).  sp x ep builds as a mesh, as JAX's
    # does; the engine refuses it in JAX's words: `validate`'s ep rule on
    # a dense model, the capability table's sp_prefill row on an MoE one.
    assert MeshConfig(ep=2).describe() == JaxMeshConfig(ep=2).describe()
    assert MeshConfig(sp=2, ep=2).describe() == JaxMeshConfig(
        sp=2, ep=2).describe() == "sp2xep2"
    with pytest.raises(ValueError, match="ep > 1 on a dense model wastes "
                                         "chips"):
        EngineCore(EngineConfig(model=TCFG, device="cpu", sp=2, ep=2))
    with pytest.raises(ValueError, match="declared impossible for MoE"):
        EngineCore(EngineConfig(model=tcfg.get_config("tiny-moe"),
                                device="cpu", sp=2, ep=2))
    assert MeshConfig(tp=2).describe() == "tp2"
    assert MeshConfig(dp=2).describe() == "dp2"
    assert MeshConfig(sp=2, tp=2).describe() == "sp2xtp2"
    assert MeshConfig(sp=2, dp=2).describe() == "dp2xsp2"
    ring = SpRing.for_mesh(MeshConfig(sp=3), torch.device("cpu"))
    assert ring.describe() == ["cpu"] * 3 and ring.cards == [torch.device("cpu")]
    with pytest.raises(ValueError, match="needs 2 rank devices"):
        SpRing.for_mesh(MeshConfig(sp=2), torch.device("cpu"), ["cpu"] * 3)
    with pytest.raises(ValueError, match="all be cpu or all cuda"):
        SpRing(["cpu", "cuda:0"])


def test_one_geometry_predicate_for_dispatch_and_counter():
    assert (port_engine.ring_kernel_supported
            is port_llama.ring_kernel_supported
            is port_ring_kernel.ring_kernel_supported
            is ring_kernel_supported)
    assert ring_geometry_ok(32, 8, 64) and ring_geometry_ok(32, 8, 128)
    assert ring_geometry_ok(8, 2, 32) and ring_geometry_ok(16, 16, 128)
    assert not ring_geometry_ok(32, 8, 48)      # no such compiled width
    assert not ring_geometry_ok(32, 8, 256)
    assert not ring_geometry_ok(24, 8, 64)      # 3 heads a group: 64 % 3
    assert not ring_geometry_ok(30, 8, 64)
    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    assert not ring_kernel_supported(32, 8, 64, 128, cpu, bf16)
    assert ring_kernel_supported(32, 8, 64, 128, torch.device("cuda"), bf16)
    assert not ring_kernel_supported(32, 8, 64, 128, torch.device("cuda"),
                                     torch.float32)
    assert not ring_kernel_supported(32, 8, 48, 128, torch.device("cuda"), bf16)
    assert KvPayload.none == 2 * 2 * 64 * 4 and KvPayload.int8 == 2 * 2 * (64 + 16)


class KvPayload:
    """tiny-test: 2 layers, F = 4 x 16, f32 rows or int8 rows + 4 scales."""

    none = kvc.KvCacheConfig.for_model(
        TCFG, num_blocks=2, block_size=8).ring_payload_bytes_per_token
    int8 = kvc.KvCacheConfig.for_model(
        TCFG, num_blocks=2, block_size=8,
        kv_quant="int8").ring_payload_bytes_per_token


# ---------------------------------------------------------------------------
# 5. The frontend


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def test_frontend_serves_a_long_prompt_over_the_ring_on_cpu(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = open(tmp_path / "frontend.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--model",
         "tiny-test", "--model-name", "m", "--http-port", str(port),
         "--device", "cpu", "--sp", "2", "--max-prefill-chunk", "512"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, (tmp_path / "frontend.log").read_text()
            try:
                if _get(base + "/health", timeout=2)["status"] == "ready":
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "frontend did not come up"
            time.sleep(0.2)

        def chat(content):
            req = urllib.request.Request(
                base + "/v1/chat/completions", data=json.dumps({
                    "model": "m", "temperature": 0, "max_tokens": 4,
                    "messages": [{"role": "user", "content": content}],
                }).encode(), headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        long = chat("ring " * 50)                 # ~350 prompt tokens
        assert long["usage"]["completion_tokens"] == 4
        assert 256 <= long["usage"]["prompt_tokens"] <= 512
        short = chat("hi")
        assert short["usage"]["completion_tokens"] == 4
        stats = _get(base + "/debug/stats")
        assert stats["sp"] == 2 and stats["sp_devices"] == ["cpu", "cpu"]
        c = stats["counters"]
        assert c["sp_prefill_count"] == 1 and c["sp_prefill_dispatches"] == 1
        assert c["ring_kernel_prefills"] == 0        # the CPU: the plain fold
        assert c["ring_exchange_bytes_modeled"] == (
            long["usage"]["prompt_tokens"] * KvPayload.none // 2)
        assert stats["kernels"]["ring_flash_attention"] == 0
        assert stats["kernels"]["ring_flash_attention_int8"] == 0
        assert set(stats["kernels"]) == set(launch_counts())
        req = urllib.request.Request(base + "/debug/stats/reset", data=b"{}",
                                     headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=10).read()
        stats = _get(base + "/debug/stats")
        assert set(stats["counters"].values()) == {0}
        assert stats["sp"] == 2
        log_text = (tmp_path / "frontend.log").read_text()
        assert "sp 2 ranks on ['cpu', 'cpu']" in log_text
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    assert proc.returncode == 0
