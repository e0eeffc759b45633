"""Sequence parallelism on the port's rank grid against the JAX package,
on the CPU at `tiny-test` geometry (f32 weights and activations).

1. The step: the port's ring prefill on a `DpGrid` with an sp axis
   (`make_sp_prefill_step(cfg, block, grid)`) against JAX's
   `make_sp_prefill_step(..., use_pallas=False)`, the XLA ppermute ring,
   on `make_mesh` over the conftest's 8 CPU devices, for sp 2 x tp 2,
   dp 2 x sp 2 and dp 2 x sp 2 x tp 2, over an f32 and an int8 cache, on
   the same numpy-seeded prompts and weights: the logits, every layer's
   written K/V rows in every copy of each tp slice, the int8 scales, and
   one decode step after it (the port's grid step against JAX's unsharded
   step on JAX's cache).  Tolerances: logits, f32 rows and the decode
   step 5e-4 (JAX's own `test_sp_prefill_step_matches_unsharded`); int8
   rows at most one int8 step apart on under 1% of the values (the two
   frameworks' f32 K/V differ in their last bits before rounding);
   scales rtol 1e-4.  The grid's numbering and shared pieces too.
2. The engine: `EngineCore(sp=2, tp=2)` and `EngineCore(dp=2, sp=2)`
   against JAX's `EngineCore` on the same mesh (the compose matrix's
   scheduler and prompts, `sp_prefill_threshold=8`): greedy tokens,
   `sp_prefill_count`, the modeled ring bytes and `kv_traffic_shards`
   (dp * tp: sp divides nothing); spec decode on sp 2 x tp 2 (the
   matrix's `sp2+spec` cell).
3. The refusals in JAX's words: sp x ep (a dense model: `validate`'s ep
   rule; an MoE model: the capability table's sp_prefill row), sp x
   dp-attention, pp x sp.
4. The slice grammar: `parse_slice` against JAX's (`to_dict()` equal),
   and the port's own refusal of a window other than its 8.
5. The worker: `--sp` / `--slice` through `build_mesh` and
   `derive_slice_spec`, and (`e2e`) a `--slice sp2xtp2` worker behind the
   frontend that answers a long chat through the ring with the meshless
   engine's tokens.
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
from dynamo_tpu.fleet.topology import parse_slice as jax_parse_slice
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.models.llama import make_forward_step as jax_forward_step
from dynamo_tpu.parallel import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel import cache_pspecs as jax_cache_pspecs
from dynamo_tpu.parallel import make_mesh
from dynamo_tpu.parallel import make_sp_prefill_step as jax_make_sp_prefill_step
from dynamo_tpu.parallel import param_pspecs as jax_param_pspecs
from dynamo_tpu.parallel import shard_pytree
from dynamo_tpu.parallel.sharding import PlaneSpec as JaxPlaneSpec
from dynamo_tpu.parallel.sharding import plane_capability as jax_capability
from dynamo_tpu.parallel.sharding import validate as jax_validate
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.engine.engine import DECODE_WINDOW, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.fleet import topology
from dynamo_tpu_torch.fleet.topology import parse_slice
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.parallel import (
    DpGrid,
    MeshConfig,
    make_sp_prefill_step,
    param_pspecs,
    shard_state,
)
from dynamo_tpu_torch.worker.main import (
    build_mesh,
    derive_slice_spec,
    parse_args,
)
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

ROOT = Path(__file__).resolve().parents[1]
JCFG = jcfg.get_config("tiny-test")
TCFG = tcfg.get_config("tiny-test")
BLOCK = 8
PAD = 128 * BLOCK       # a pad position: past every block table
TOL = dict(rtol=5e-4, atol=5e-4)
MESHES = {"sp2xtp2": dict(sp=2, tp=2), "dp2xsp2": dict(dp=2, sp=2),
          "dp2xsp2xtp2": dict(dp=2, sp=2, tp=2)}


@pytest.fixture(scope="module")
def weights():
    params = jax_init_params(JCFG, jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def _grid(**axes) -> DpGrid:
    mesh = MeshConfig(**axes)
    return DpGrid.for_mesh(mesh, torch.device("cpu"))


# ---------------------------------------------------------------------------
# 1. The step


def _step_inputs():
    """Four whole prompts (two padded) of a 16-token chunk, three pages a
    row so that the decode step after the prefill has its own page."""
    rng = np.random.default_rng(11)
    R, T, P = 4, 16, 4
    lens = [16, 11, 16, 9]
    tokens = np.zeros((R, T), np.int32)
    positions = np.full((R, T), PAD, np.int32)
    bts = np.zeros((R, P), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, JCFG.vocab_size, n)
        positions[i, :n] = np.arange(n)
        bts[i, :3] = [1 + 3 * i, 2 + 3 * i, 3 + 3 * i]
    seq = np.asarray(lens, np.int32)
    return (tokens, positions, seq, bts, seq - 1), lens


def _real_slots(bts, lens):
    return np.concatenate([bts[i, np.arange(n) // BLOCK] * BLOCK
                           + np.arange(n) % BLOCK for i, n in enumerate(lens)])


def _jax_sp(params, axes, kv_quant, inputs):
    """JAX's sp step (the XLA ring) on a mesh of `axes`, then one decode
    step of JAX's unsharded step on its cache: (prefill logits, cache,
    decode logits), as numpy."""
    quant = kv_quant == "int8"
    mcfg = JaxMeshConfig(**axes)
    mesh = make_mesh(mcfg, jax.devices()[:mcfg.size])
    cache = shard_pytree(
        jkvc.init_cache(jkvc.KvCacheConfig.for_model(
            JCFG, num_blocks=16, block_size=BLOCK, dtype=jnp.float32,
            kv_quant=kv_quant)),
        jax_cache_pspecs(JCFG.num_layers, kv_quant=quant), mesh)
    step = jax_make_sp_prefill_step(JCFG, BLOCK, mesh, kv_quant=quant,
                                    use_pallas=False)
    logits, cache = step(shard_pytree(params, jax_param_pspecs(JCFG), mesh),
                         cache, *(jnp.asarray(x) for x in inputs))
    cache = jax.device_get(cache)
    logits = np.asarray(logits)
    tokens, _, seq, bts, _ = inputs
    nxt = logits.argmax(-1).astype(np.int32)
    cur = seq + 1
    dlogits, _ = jax_forward_step(JCFG, BLOCK)(
        params, jax.tree.map(jnp.asarray, cache), jnp.asarray(nxt[:, None]),
        jnp.asarray((cur - 1)[:, None]), jnp.asarray(cur), jnp.asarray(bts),
        jnp.zeros(len(seq), jnp.int32))
    return logits, cache, np.asarray(dlogits)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_grid_sp_step_matches_jax_xla_ring(weights, mesh, kv_quant):
    params, state = weights
    inputs, lens = _step_inputs()
    want, want_cache, want_decode = _jax_sp(params, MESHES[mesh], kv_quant,
                                            inputs)
    quant = kv_quant == "int8"
    grid = _grid(**MESHES[mesh])
    tp = grid.tp
    ranks = shard_state(state, param_pspecs(TCFG), grid)
    ccfg = kvc.KvCacheConfig.for_model(TCFG, num_blocks=16, block_size=BLOCK,
                                       kv_quant=kv_quant)
    cache = kvc.init_grid_caches(ccfg, grid)
    step = make_sp_prefill_step(TCFG, BLOCK, grid, kv_quant=quant)
    targs = [torch.from_numpy(x) for x in inputs]
    got, cache = step(ranks, cache, *targs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # Every layer's rows of the real tokens, in every copy of each tp
    # slice (the attention ranks' caches: slice f % tp of the columns).
    slots = _real_slots(inputs[3], lens)
    F = TCFG.num_kv_heads * TCFG.head_dim // tp
    H = TCFG.num_kv_heads // tp
    for f, c in enumerate(cache):
        t = f % tp
        for i in range(TCFG.num_layers):
            for kv in ("k", "v"):
                mine = c[kv][i][slots].numpy()
                theirs = np.asarray(want_cache[kv][i])[slots][:, t * F:(t + 1) * F]
                if quant:
                    off = np.abs(mine.astype(np.int32) - theirs)
                    assert off.max() <= 1 and (off > 0).mean() < 0.01
                    np.testing.assert_allclose(
                        c[kv + "_scale"][i][slots].numpy(),
                        np.asarray(want_cache[kv + "_scale"][i])[slots][
                            :, t * H:(t + 1) * H], rtol=1e-4)
                else:
                    np.testing.assert_allclose(mine, theirs, **TOL)
    # One decode step on the grid (the ranks of sp index 0) after it.
    nxt = torch.from_numpy(want.argmax(-1).astype(np.int32))
    assert torch.equal(got.argmax(-1).to(torch.int32), nxt)
    cur = targs[2] + 1
    decode = llama.make_forward_step(TCFG, BLOCK, use_decode_kernel=True,
                                     tp=grid)
    dl, _ = decode(ranks, cache, nxt[:, None], (cur - 1)[:, None], cur,
                   targs[3], torch.zeros(len(lens), dtype=torch.int32))
    np.testing.assert_allclose(dl.numpy(), want_decode, **TOL)


def test_grid_numbering_and_shared_pieces(weights):
    _, state = weights
    # sp 1: today's numbering, (d * ep + e) * tp + t.
    g = DpGrid(["cpu"] * 8, 2, ep=2)
    assert [g.flat(d, e, t) for d in range(2) for e in range(2)
            for t in range(2)] == list(range(8))
    assert g.attention is not g and g.rings is None
    # JAX's axis order with sp: ((d * sp + s) * ep + e) * tp + t.
    grid = _grid(dp=2, sp=2, tp=2)
    assert (grid.dp, grid.sp, grid.ep, grid.tp) == (2, 2, 1, 2)
    assert [grid.flat(d, 0, t, s) for d in range(2) for s in range(2)
            for t in range(2)] == list(range(8))
    assert all(grid.coords(grid.flat(d, 0, t, s)) == (d, s, 0, t)
               for d in range(2) for s in range(2) for t in range(2))
    # The cache's grid: sp index 0 of each row, `d * tp + t`.
    assert grid.attention.n == 4 and grid.attention.tp == 2
    assert grid.sp_tps[1][0] is grid.rows[1]
    ring = grid.rings[1][1]
    assert ring.sp == 2 and ring.members == [(grid.sp_tps[1][0], 1),
                                             (grid.sp_tps[1][1], 1)]
    # Ranks of one place and one piece share one copy: on one host every
    # rank of tp slice t holds the same tensors.
    ranks = shard_state(state, param_pspecs(TCFG), grid)
    for f in range(grid.n):
        t = grid.coords(f)[3]
        assert ranks[f]["layers"][0]["attn"]["wq"] is \
            ranks[t]["layers"][0]["attn"]["wq"]
    with pytest.raises(ValueError, match="must divide the grid's 6 ranks"):
        DpGrid(["cpu"] * 6, 2, sp=2)
    # What sp does not compose with, the step's builder refuses.
    with pytest.raises(ValueError, match="not wired for dp_attention"):
        make_sp_prefill_step(TCFG, BLOCK, DpGrid(["cpu"] * 4, 2, sp=2,
                                                 dp_attention=True))
    with pytest.raises(ValueError, match="ep > 1 on a dense model"):
        make_sp_prefill_step(TCFG, BLOCK, DpGrid(["cpu"] * 4, 1, sp=2, ep=2))


def test_grid_sp_step_refuses_rows_dp_does_not_divide(weights):
    _, state = weights
    grid = _grid(dp=2, sp=2)
    step = make_sp_prefill_step(TCFG, BLOCK, grid)
    ccfg = kvc.KvCacheConfig.for_model(TCFG, num_blocks=16, block_size=BLOCK)
    tok = torch.zeros(3, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="3 rows must split over dp=2"):
        step(shard_state(state, param_pspecs(TCFG), grid),
             kvc.init_grid_caches(ccfg, grid), tok, tok,
             torch.full((3,), 16), torch.zeros(3, 2, dtype=torch.int32),
             torch.full((3,), 15))
    with pytest.raises(ValueError, match="grid's own sp axis"):
        llama.make_forward_step(TCFG, BLOCK, sp_ring=_grid(dp=2, sp=2),
                                tp=grid)


# ---------------------------------------------------------------------------
# 2. The engine

SCHED = dict(max_seqs=4, block_size=8, max_pages_per_seq=8,
             max_prefill_chunk=16, decode_buckets=(2, 4),
             prefill_buckets=(8, 16))
PROMPTS = {"a": [5, 6, 7, 8, 9, 10, 5, 6, 7, 8], "b": list(range(20, 34))}
N_OUT = 12


def _run(core):
    cls = SamplingParams if isinstance(core, EngineCore) else \
        JaxSamplingParams
    for rid, prompt in PROMPTS.items():
        core.add_request(rid, list(prompt), cls(max_tokens=N_OUT))
    out = {}
    for _ in range(300):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core._requests:
            break
    assert not core._requests, "engine did not finish"
    return out


def _engines(weights, axes, **kw):
    params, state = weights
    mcfg = JaxMeshConfig(**axes)
    jcore = JaxEngineCore(JaxEngineConfig(
        model=JCFG, num_blocks=64, mesh=make_mesh(
            mcfg, jax.devices()[:mcfg.size]), enable_prefix_cache=False,
        sp_prefill_threshold=8, decode_window=1,
        scheduler=JaxSchedulerConfig(**SCHED), **kw), params=params)
    core = EngineCore(EngineConfig(
        model=TCFG, num_blocks=64, device="cpu", enable_prefix_cache=False,
        sp_prefill_threshold=8, scheduler=SchedulerConfig(**SCHED),
        **axes, **kw), params=state)
    return jcore, core


@pytest.fixture(scope="module")
def meshless(weights):
    return _run(EngineCore(EngineConfig(
        model=TCFG, num_blocks=64, device="cpu", enable_prefix_cache=False,
        scheduler=SchedulerConfig(**SCHED)), params=weights[1]))


@pytest.mark.parametrize("mesh,spec", [("sp2xtp2", 0), ("dp2xsp2", 0),
                                       ("sp2xtp2", 3)])
def test_grid_sp_engine_matches_jax_engine(weights, meshless, mesh, spec):
    axes = MESHES[mesh]
    jcore, core = _engines(weights, axes, speculative_tokens=spec)
    assert core.grid is not None and core.grid.sp == 2
    assert core.mesh.describe() == mesh
    want = _run(jcore)
    got = _run(core)
    assert got == want == meshless
    assert all(len(t) == N_OUT for t in got.values())
    c = core.counters
    # Both prompts are whole and past the threshold: the ring, on both.
    assert c.sp_prefill_count == jcore.sp_prefill_count == len(PROMPTS)
    assert c.packed_prefill_dispatches == 0
    assert (c.ring_exchange_bytes_modeled
            == jcore.counters.ring_exchange_bytes_modeled
            == sum(map(len, PROMPTS.values()))
            * core.cache_cfg.ring_payload_bytes_per_token // 2)
    # Per-chip divisors: dp * tp; sp divides nothing.
    dp_tp = axes.get("dp", 1) * axes.get("tp", 1)
    assert core.kv_traffic_shards == jcore.kv_traffic_shards == dp_tp
    assert core.kv_shard_count == jcore.kv_shard_count == axes.get("tp", 1)
    # On the CPU the ring folds with the kernel's plain version.
    assert c.ring_kernel_prefills == 0
    if spec:
        assert c.spec_dispatches > 0


def test_grid_sp_engine_pads_a_lone_chat_to_the_dp_rows(weights):
    """A lone whole prompt under dp 2 is one row: the ring prefill pads
    it to a row a dp row, and its tokens stay the meshless engine's."""
    _, state = weights
    prompt = list(range(40, 56))
    outs = []
    for axes in ({}, {"dp": 2, "sp": 2}):
        core = EngineCore(EngineConfig(
            model=TCFG, num_blocks=64, device="cpu",
            enable_prefix_cache=False, sp_prefill_threshold=8,
            scheduler=SchedulerConfig(**SCHED), **axes), params=state)
        core.add_request("x", prompt, SamplingParams(max_tokens=6))
        out = [t for d in core.step() for t in d.token_ids]
        if axes:
            # The first step is the ring prefill: [2, 16], one row a dp row.
            assert core.counters.sp_prefill_count == 1
            assert core.counters.model_rows == 2 * 16
        for _ in range(100):
            for d in core.step():
                out.extend(d.token_ids)
            if not core._requests:
                break
        outs.append(out)
    assert outs[0] == outs[1] and len(outs[0]) == 6


# ---------------------------------------------------------------------------
# 3. Refusals, in JAX's words


def _error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_are_jax_words():
    # sp x ep, a dense model: validate's ep rule.
    jmesh = make_mesh(JaxMeshConfig(sp=2, ep=2), jax.devices()[:4])
    want = _error(lambda: jax_validate(JCFG, jmesh))
    assert want == _error(lambda: EngineCore(EngineConfig(
        model=TCFG, device="cpu", num_blocks=16, sp=2, ep=2)))
    # sp x ep, an MoE model: the capability table's sp_prefill row, at
    # construction.
    want = jax_capability(jmesh, JaxPlaneSpec(role="sp_prefill", moe=True),
                          multihost=False).reason
    assert want == _error(lambda: EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-moe"), device="cpu", num_blocks=16,
        sp=2, ep=2)))
    # sp x dp-attention.
    jmesh = make_mesh(JaxMeshConfig(sp=2, tp=2), jax.devices()[:4])
    want = jax_capability(jmesh, JaxPlaneSpec(role="sp_prefill",
                                              dp_attention=True),
                          multihost=False).reason
    assert want == _error(lambda: EngineCore(EngineConfig(
        model=TCFG, device="cpu", num_blocks=16, sp=2, tp=2,
        dp_attention=True, enable_prefix_cache=False)))
    # pp x sp: JAX's _validate_pp.
    assert _error(lambda: MeshConfig(pp=2, sp=2)) == (
        "pp v1 composes with no other axis in-mesh (got sp=2); run dp via "
        "engine replicas")
    with pytest.raises(ValueError, match="sp_devices places the meshless"):
        EngineCore(EngineConfig(model=TCFG, device="cpu", num_blocks=16,
                                sp=2, tp=2, sp_devices=("cpu", "cpu")))


# ---------------------------------------------------------------------------
# 4. The slice grammar

SLICES = ["sp2xtp2", "sp2xtp2,int8,packed,role=prefill", "tp2,int8,role=decode",
          "dp2xsp2", "dp2xsp2xtp2,bf16", "single", "tp4,spec,window8",
          "dp2xtp2,dp_attention,dp_local", "pp2,packed_prefill,pallas",
          " SP2xTP2 , INT8 ", "ep2xtp2,role=both", ""]


@pytest.mark.parametrize("spec", SLICES)
def test_parse_slice_matches_jax(spec):
    mine, theirs = parse_slice(spec), jax_parse_slice(spec)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.describe() == theirs.describe()
    assert all(mine.axis(a) == theirs.axis(a) for a in topology.AXES)
    for role in ("prefill", "decode", "both"):
        assert mine.serves_role(role) == theirs.serves_role(role)
    assert mine.mesh_config().shape == theirs.mesh_config().shape


def test_parse_slice_refusals():
    assert topology.PORT_WINDOW == DECODE_WINDOW
    jax_parse_slice("tp2,window4")       # JAX's worker has the knob
    with pytest.raises(ValueError, match="ROADMAP.md A2"):
        parse_slice("tp2,window4")
    for bad in ("tp2,role=router", "tp2,fast"):
        want = _error(lambda: jax_parse_slice(bad))
        assert _error(lambda: parse_slice(bad)) == want


# ---------------------------------------------------------------------------
# 5. The worker


def _args(*flags):
    return parse_args(["--control-plane", "h:1", "--device", "cpu", *flags])


def test_worker_sp_and_slice_flags(weights):
    assert build_mesh(_args("--sp", "2", "--tp", "2")) == MeshConfig(sp=2,
                                                                     tp=2)
    args = _args("--slice", "sp2xtp2")
    assert (args.sp, args.tp, args.dp, args.role, args.kv_quant) == (
        2, 2, 1, "both", "none")
    assert build_mesh(args) == MeshConfig(sp=2, tp=2)
    args = _args("--slice", "dp2xsp2,int8,spec,role=prefill")
    assert (args.dp, args.sp, args.kv_quant, args.role, args.spec_decode) \
        == (2, 2, "int8", "prefill", 3)
    args = _args("--slice", "dp2xtp2,dp_attention")
    assert args.dp_attention and build_mesh(args) == MeshConfig(dp=2, tp=2)
    with pytest.raises(SystemExit):
        _args("--slice", "tp2,window4")
    with pytest.raises(SystemExit, match="composes with no other axis"):
        build_mesh(_args("--sp", "2", "--pp", "2"))
    core = EngineCore(EngineConfig(
        model=TCFG, device="cpu", num_blocks=16, sp=2, tp=2,
        sp_prefill_threshold=8, scheduler=SchedulerConfig(**SCHED)),
        params=weights[1])
    published = derive_slice_spec(core)
    assert published.describe() == "sp2xtp2"
    assert published.mesh == (1, 1, 2, 1, 2)
    assert published.mesh_config() == core.mesh


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
def test_slice_worker_serves_a_ring_prefill_behind_the_frontend(tmp_path):
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        http = s.getsockname()[1]
    fe_log, w_log = tmp_path / "frontend.log", tmp_path / "worker.log"
    body = {"model": "tiny-sp", "max_tokens": 8, "temperature": 0,
            "logprobs": True, "return_tokens_as_token_ids": True,
            "messages": [{"role": "user", "content": "ring " * 60}]}
    pre = OpenAIPreprocessor(ByteTokenizer()).preprocess_chat(
        ChatCompletionRequest.from_dict(body), "x")
    assert 256 <= len(pre.token_ids) <= 512
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
             "tiny-test", "--model-name", "tiny-sp", "--block-size", "8",
             "--health-port", "0", "--slice", "sp2xtp2"],
            cwd=ROOT, stdout=open(w_log, "w"), stderr=subprocess.STDOUT))
        status = _wait_for(w_log, r"worker status server on :(\d+)",
                           deadline, procs[1])
        base = f"http://127.0.0.1:{http}"
        while not any(m["id"] == "tiny-sp"
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
        assert stats["mesh"] == "sp2xtp2" and stats["kv_shard_count"] == 2
        assert stats["kv_traffic_shards"] == 2 and stats["sp"] == 2
        assert stats["slice"]["describe"] == "sp2xtp2"
        assert stats["slice"]["mesh"] == [1, 1, 2, 1, 2]
        c = stats["counters"]
        assert c["sp_prefill_count"] == 1 and c["sp_prefill_dispatches"] == 1
        assert c["packed_prefill_dispatches"] == 0
        assert c["ring_exchange_bytes_modeled"] == (
            len(pre.token_ids) * kvc.KvCacheConfig.for_model(
                TCFG, num_blocks=2, block_size=8)
            .ring_payload_bytes_per_token // 2)
        assert "sp prefill on the grid sp2xtp2: 2 rings of 2 ranks" in \
            w_log.read_text()
    finally:
        for p in reversed(procs):
            p.terminate()
            p.wait(timeout=30)
    # The meshless in-process engine on the worker's weights and scheduler.
    core = EngineCore(EngineConfig(
        model=TCFG, device="cpu",
        scheduler=SchedulerConfig(block_size=8)))
    core.add_request("x", pre.token_ids, SamplingParams(max_tokens=8))
    want = []
    for _ in range(100):
        for d in core.step():
            want.extend(d.token_ids)
        if not core._requests:
            break
    assert ids == want
