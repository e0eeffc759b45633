"""The port's expert parallelism and MoE under a mesh against the JAX
package, on the CPU at `tiny-moe` (H 64, F 128, 8 experts, top-2) in f32.
The JAX side runs on the conftest's 8-device CPU mesh with its XLA path
(`use_pallas_decode=False`); the port's ranks all lie on the CPU, where
K1 and K2 take their plain versions.  JAX weights cross over through
`from_jax_params` and inputs come from numpy seeds.

Tolerances: outputs and logits within rtol = atol = 2e-5 (f32; tighter
than JAX's own dispatch-against-dense bound, 5e-4 in tests/test_moe.py);
expert-load vectors and drop counts exactly equal; greedy tokens equal.

1. `moe_dispatch` meshless against JAX's `ops/moe.moe_dispatch`, at exact
   capacity and at bounded capacities that drop.
2. The sharded forward step on `dp2 x ep4` and `dp2 x ep2 x tp2` (JAX's
   `make_sharded_step(moe_mode="dispatch", with_expert_load=True)`,
   tests/test_moe.py's meshes): the padded prefill, the packed prefill
   and a decode step, exact and at a bounded capacity.
3. MoE under tp 2 and dp 2 ("dense"), explicit "dense" on an ep mesh,
   and MoE under dp-attention, each against JAX's sharded step.
4. `resolve_moe_mode`'s ladder and errors, `param_pspecs(cfg, moe_mode)`,
   `validate`'s ep refusals and `plane_capability` over MoE x mesh, each
   equal to JAX's.
5. The engine: tiny-moe on `dp2 x ep2` and on `tp2`, greedy tokens equal
   JAX's `EngineCore` on the same mesh (tests/test_compose_matrix.py's
   `moe+ep2` and `moe+tp2` cells), the expert load non-zero, nothing
   dropped.
6. The worker: `--ep 2 --tp 2 --moe-capacity C` builds `MeshConfig(ep=2,
   tp=2)`, the dispatch engine with capacity C, its slice `ep2xtp2`.
7. `init_params(group=)` on ep grids: each rank's expert slices equal the
   whole draw's, the ranks of one device sharing one copy of each piece.
"""

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
from dynamo_tpu.ops import moe as jmoe
from dynamo_tpu.parallel import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel import make_mesh, shard_pytree
from dynamo_tpu.parallel.sharding import PlaneSpec as JaxPlaneSpec
from dynamo_tpu.parallel.sharding import cache_pspecs as jax_cache_pspecs
from dynamo_tpu.parallel.sharding import make_sharded_step
from dynamo_tpu.parallel.sharding import param_pspecs as jax_param_pspecs
from dynamo_tpu.parallel.sharding import plane_capability as jax_capability
from dynamo_tpu.parallel.sharding import resolve_moe_mode as jax_resolve
from dynamo_tpu.parallel.sharding import validate as jax_validate
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.frontend.main import stats_hooks
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.weights import from_jax_params, init_params
from dynamo_tpu_torch.ops import moe as tmoe
from dynamo_tpu_torch.parallel import (
    DpGrid,
    MeshConfig,
    PlaneSpec,
    param_pspecs,
    plane_capability,
    resolve_moe_mode,
    shard_state,
    validate,
)
from dynamo_tpu_torch.worker.main import (
    build_engine,
    build_mesh,
    derive_slice_spec,
    parse_args,
)
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK = 8
PAD = 128 * BLOCK       # a pad position: past every block table
JC, TC = jcfg.get_config("tiny-moe"), tcfg.get_config("tiny-moe")


@pytest.fixture(scope="module")
def model():
    params = jax_init_params(JC, jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _spec_tree(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, tuple))


def _mesh(dp=1, ep=1, tp=1):
    n = dp * ep * tp
    return make_mesh(JaxMeshConfig(dp=dp, ep=ep, tp=tp), jax.devices()[:n])


def _grid(dp=1, ep=1, tp=1, dp_attention=False):
    return DpGrid(["cpu"] * (dp * ep * tp), dp, dp_attention, ep=ep)


# ---------------------------------------------------------------------------
# 1. moe_dispatch, meshless


@pytest.mark.parametrize("capacity", [None, 1, 3])
def test_moe_dispatch_matches_jax(model, capacity):
    params, state = model
    jp, tp_ = params["layers"][0]["moe"], state["layers"][0]["moe"]
    x = np.random.default_rng(11).standard_normal(
        (2, 12, JC.hidden_size)).astype(np.float32)
    want, wstats = jmoe.moe_dispatch(JC, jp, jnp.asarray(x), capacity)
    got, stats = tmoe.moe_dispatch(TC, tp_, torch.from_numpy(x), capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(wstats))
    if capacity is None:
        assert int(stats[-1]) == 0
        dense, dstats = tmoe.moe_dense(TC, tp_, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)
        assert torch.equal(stats, dstats)
    else:
        assert int(stats[-1]) > 0
    assert int(stats[:-1].sum()) == 2 * 12 * TC.num_experts_per_token


# ---------------------------------------------------------------------------
# 2-3. The sharded steps

B, T = 8, 16            # batch divisible by dp * ep (and dp * tp)
P = 8                   # block table width


def _inputs():
    rng = np.random.default_rng(5)
    lens = rng.integers(9, T + 1, B).astype(np.int32)
    tok = np.zeros((B, T), np.int32)
    pos = np.full((B, T), PAD, np.int32)
    for i, L in enumerate(lens):
        tok[i, :L] = rng.integers(0, JC.vocab_size, L)
        pos[i, :L] = np.arange(L)
    bt = np.zeros((B, P), np.int32)
    for i in range(B):
        bt[i, :2] = (1 + 2 * i, 2 + 2 * i)
    return tok, pos, lens, bt, lens - 1


def _packed(padded, split):
    """The padded prompts as a grid-shaped pack of `split` groups
    (contiguous rows each), segment starts on multiples of 8."""
    tok2, _, lens, bt, _ = padded
    per = B // split
    Tg = max(sum(-(-int(lens[i]) // 8) * 8 for i in range(g * per,
                                                            (g + 1) * per))
             for g in range(split))
    n = Tg * split
    tok = np.zeros(n, np.int32)
    pos = np.full(n, PAD, np.int32)
    seg = np.zeros(n, np.int32)
    qs = np.zeros(B, np.int32)
    smp = np.zeros(B, np.int32)
    for g in range(split):
        off = g * Tg
        for i in range(g * per, (g + 1) * per):
            L = int(lens[i])
            tok[off:off + L], pos[off:off + L] = tok2[i, :L], np.arange(L)
            seg[off:off + L] = i
            qs[i], smp[i] = off, off + L - 1
            off += -(-L // 8) * 8
    return tok, pos, seg, bt, qs, lens, lens, smp


# (dp, ep, tp, moe_mode, dp_attention, moe_capacity)
STEP_CASES = [
    (2, 4, 1, "dispatch", False, None),
    (2, 2, 2, "dispatch", False, None),
    (2, 2, 2, "dispatch", False, 2),
    (2, 4, 1, "dispatch", False, 1),
    (1, 1, 2, "dense", False, None),
    (2, 1, 1, "dense", False, None),
    (2, 2, 1, "dense", False, None),
    (2, 1, 2, "dense", True, None),
    (1, 2, 2, "dispatch", True, None),
]


@pytest.mark.parametrize("dp,ep,tp,mode,da,cap", STEP_CASES)
def test_sharded_moe_steps_match_jax(model, dp, ep, tp, mode, da, cap):
    params, state = model
    jc, tc = JC.replace(moe_capacity=cap), TC.replace(moe_capacity=cap)
    mesh = _mesh(dp, ep, tp)
    grid = _grid(dp, ep, tp, da)
    jparams = shard_pytree(params, jax_param_pspecs(jc, mode, da), mesh)
    ranks = shard_state(state, param_pspecs(tc, mode, dp_attention=da), grid)
    jcache = shard_pytree(
        jkvc.init_cache(jkvc.KvCacheConfig.for_model(
            jc, num_blocks=32, block_size=BLOCK, dtype=jnp.float32)),
        jax_cache_pspecs(jc.num_layers, da), mesh)
    cache = kvc.init_grid_caches(kvc.KvCacheConfig.for_model(
        tc, num_blocks=32, block_size=BLOCK), grid)
    assert len(cache) == dp * tp and len(ranks) == dp * ep * tp
    jstep = make_sharded_step(jc, BLOCK, mesh, JaxPlaneSpec(
        dp_attention=da, moe=True), moe_mode=mode, with_expert_load=True)
    padded = _inputs()
    want, jcache, wload = jstep(jparams, jcache, *map(jnp.asarray, padded))
    # The port's padded step on a copy of the cache, then its packed
    # prefill (K2's plain version per rank) on the engine's cache.
    step = llama.make_forward_step(tc, BLOCK, use_decode_kernel=not da,
                                   moe_mode=mode, with_expert_load=True,
                                   tp=grid)
    scratch = kvc.init_grid_caches(kvc.KvCacheConfig.for_model(
        tc, num_blocks=32, block_size=BLOCK), grid)
    got, _, load = step(ranks, scratch, *map(torch.from_numpy, padded))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(load.numpy(), np.asarray(wload))
    k = tc.num_experts_per_token
    assert int(load[:-1].sum()) == B * T * k * tc.num_layers
    assert (int(load[-1]) == 0) == (cap is None)
    if not da and cap is None:
        # The packed prefill routes the pack's tokens (a bounded capacity
        # would drop other assignments than the padded step's).
        pk = [torch.from_numpy(a) for a in _packed(padded, dp)]
        got, cache, pload = llama.make_packed_prefill_step(
            tc, BLOCK, moe_mode=mode, tp=grid)(ranks, cache, *pk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert int(pload[:-1].sum()) == pk[0].shape[0] * k * tc.num_layers
        assert int(pload[-1]) == 0
    else:
        _, cache, _ = step(ranks, cache, *map(torch.from_numpy, padded))
    # A decode step fed the same tokens on both sides (K1's plain
    # version per rank where the grid attends through it).
    lens = padded[2] + 1
    nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
    args = (nxt[:, None], (lens - 1)[:, None], lens, padded[3],
            np.zeros(B, np.int32))
    want, _, wload = jstep(jparams, jcache, *map(jnp.asarray, args))
    got, _, load = step(ranks, cache, *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(load.numpy(), np.asarray(wload))
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.argmax(np.asarray(want), -1))


# ---------------------------------------------------------------------------
# 4. The rules


def test_resolve_moe_mode_ladder_as_jax():
    cases = [(None, "auto"), (None, "dense"), (None, "grouped"),
             (None, "dispatch"), (None, "bogus"),
             ((4, 2, 1), "grouped"), ((4, 2, 1), "auto"),
             ((8, 1, 1), "auto"), ((2, 2, 2), "dense"),
             ((2, 1, 2), "dispatch"), ((1, 1, 2), "auto")]
    for shape, mode in cases:
        mine = theirs = None
        try:
            mine = resolve_moe_mode(TC, None if shape is None else
                                    MeshConfig(*shape[:1], ep=shape[1],
                                               tp=shape[2]), mode)
        except ValueError as e:
            mine = str(e)
        try:
            theirs = jax_resolve(JC, None if shape is None else
                                 _mesh(*shape), mode)
        except ValueError as e:
            theirs = str(e)
        if shape is None and mode in ("dispatch", "grouped", "auto",
                                      "dense"):
            # Meshless: the same ladder, "grouped" naming the port's kernel.
            assert (mine == theirs) or ("needs a mesh with an ep axis"
                                        in mine and "ep axis" in theirs)
        else:
            assert mine == theirs, (shape, mode)
    dense = tcfg.get_config("tiny-test")
    assert resolve_moe_mode(dense, MeshConfig(dp=2)) == "dense"


@pytest.mark.parametrize("mode", ["dense", "dispatch"])
@pytest.mark.parametrize("da", [False, True])
def test_param_pspecs_as_jax(mode, da):
    assert param_pspecs(TC, mode, dp_attention=da) == _spec_tree(
        jax_param_pspecs(JC, mode, da))
    dense = "tiny-test"
    assert param_pspecs(tcfg.get_config(dense), mode,
                        dp_attention=da) == _spec_tree(jax_param_pspecs(
                            jcfg.get_config(dense), mode, da))


def test_validate_and_capability_as_jax():
    def err(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    for model, shape in (("tiny-moe", (1, 3, 1)), ("tiny-moe", (2, 2, 2)),
                         ("tiny-test", (1, 2, 1)), ("tiny-moe", (1, 8, 1)),
                         ("tiny-test", (2, 1, 2))):
        tcf, jcf = tcfg.get_config(model), jcfg.get_config(model)
        mine = err(lambda: validate(tcf, MeshConfig(dp=shape[0], ep=shape[1],
                                                    tp=shape[2])))
        n = shape[0] * shape[1] * shape[2]
        theirs = err(lambda: jax_validate(jcf, make_mesh(JaxMeshConfig(
            dp=shape[0], ep=shape[1], tp=shape[2]), jax.devices()[:n])))
        assert mine == theirs, (model, shape)
    assert "ep=3 must divide num_experts=8" in err(
        lambda: validate(TC, MeshConfig(ep=3)))
    for shape in ((2, 1, 1), (1, 1, 2), (1, 2, 1), (2, 2, 2)):
        for plane in (dict(moe=True), dict(moe=True, dp_attention=True),
                      dict(moe=True, role="sp_prefill"),
                      dict(moe=True, dp_attention=True, dp_local=True)):
            want = jax_capability(_mesh(*shape), JaxPlaneSpec(**plane))
            got = plane_capability(PlaneSpec(**plane), MeshConfig(
                dp=shape[0], ep=shape[1], tp=shape[2]))
            assert (got.ok, got.reason) == (want.ok, want.reason), (
                shape, plane)


# ---------------------------------------------------------------------------
# 5. The engine

SCHED = dict(max_seqs=4, block_size=BLOCK, max_pages_per_seq=8,
             max_prefill_chunk=16, decode_buckets=(2, 4),
             prefill_buckets=(8, 16))
PROMPTS = {"a": [5, 6, 7, 8, 9, 10, 5, 6, 7, 8], "b": list(range(20, 34))}


def _run(core, sampling_cls):
    out = {}
    for rid, prompt in PROMPTS.items():
        core.add_request(rid, prompt, sampling_cls(max_tokens=12))
    for _ in range(300):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core._requests:
            break
    assert not core._requests, "engine did not finish"
    return out


@pytest.mark.parametrize("shape,mode", [((2, 2, 1), "dispatch"),
                                        ((1, 1, 2), "dense")])
def test_moe_engine_matches_jax_engine(model, shape, mode):
    params, state = model
    dp, ep, tp = shape
    jcore = JaxEngineCore(JaxEngineConfig(
        model=JC, num_blocks=64, mesh=_mesh(dp, ep, tp),
        use_pallas_decode=False, enable_prefix_cache=False,
        decode_window=4, scheduler=JaxSchedulerConfig(**SCHED)),
        params=params)
    want = _run(jcore, JaxSamplingParams)
    core = EngineCore(EngineConfig(
        model=TC, num_blocks=64, device="cpu", enable_prefix_cache=False,
        dp=dp, ep=ep, tp=tp, scheduler=SchedulerConfig(**SCHED)),
        params=state)
    assert core.moe_mode == jcore._moe_mode == mode
    assert core.mesh.describe() == MeshConfig(dp=dp, ep=ep,
                                              tp=tp).describe()
    got = _run(core, SamplingParams)
    assert got == want
    assert core.counters.window_dispatches > 0
    assert core.counters.packed_prefill_dispatches > 0
    load = core.snapshot_expert_load()
    assert int(load.sum()) > 0 and core.moe_dropped_tokens == 0
    # Every model row routed k experts a layer.
    assert int(load.sum()) == (core.counters.model_rows
                               * TC.num_experts_per_token * TC.num_layers)


# ---------------------------------------------------------------------------
# 6. The worker


def test_worker_ep_flags_build_the_dispatch_engine():
    args = parse_args(["--control-plane", "h:1", "--device", "cpu",
                       "--model", "tiny-moe", "--num-blocks", "32",
                       "--block-size", "8", "--ep", "2", "--tp", "2",
                       "--moe-capacity", "3"])
    assert build_mesh(args) == MeshConfig(ep=2, tp=2)
    assert args.moe_mode == "auto" and args.moe_capacity == 3
    core, _, _ = build_engine(args, None)
    assert core.moe_mode == "dispatch" and core.grid.ep == 2
    assert core.config.model.moe_capacity == 3
    assert derive_slice_spec(core).describe() == "ep2xtp2"
    stats, _ = stats_hooks(core)
    s = stats()
    assert s["mesh"] == "ep2xtp2" and s["moe_mode"] == "dispatch"
    assert len(s["rank_launches"]) == 4
    assert parse_args(["--control-plane", "h:1", "--moe-mode",
                       "dispatch"]).moe_mode == "dispatch"
    with pytest.raises(ValueError, match="ep=3 must divide num_experts"):
        build_engine(parse_args(["--control-plane", "h:1", "--device", "cpu",
                                 "--model", "tiny-moe", "--ep", "3"]), None)


# ---------------------------------------------------------------------------
# 7. The weight draw


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 1), (1, 4, 1)])
def test_grid_draw_equals_the_whole_draws_expert_slices(shape):
    dp, ep, tp = shape
    grid = _grid(dp, ep, tp)
    ranks = init_params(TC, torch.Generator().manual_seed(7), "cpu",
                        group=grid)
    whole = init_params(TC, torch.Generator().manual_seed(7), "cpu")
    want = shard_state(whole, param_pspecs(TC, "dispatch"), grid)
    E, F = TC.num_experts, TC.intermediate_size
    for f, (got_r, want_r) in enumerate(zip(ranks, want)):
        for a, b in zip(jax.tree.leaves(got_r), jax.tree.leaves(want_r)):
            assert a.is_contiguous() and torch.equal(a, b)
        e, t = (f // tp) % ep, f % tp
        moe = got_r["layers"][1]["moe"]
        assert torch.equal(moe["w_up"], whole["layers"][1]["moe"]["w_up"][
            e * E // ep:(e + 1) * E // ep, :, t * F // tp:(t + 1) * F // tp])
        assert torch.equal(moe["router"], whole["layers"][1]["moe"]["router"])
    # One copy of each piece a device: the attention weights of tp slice
    # t are shared by every ep rank and dp row.
    for f in range(grid.n):
        a = ranks[f]["layers"][0]["attn"]["wq"]
        assert a is ranks[f % tp]["layers"][0]["attn"]["wq"]
