"""The port's MoE path against the JAX package, on `tiny-moe` (H 64, F 128,
8 experts, top-2) with JAX weights crossed through `from_jax_params` and
activations from numpy seeds.

Tolerances:
- routing (expert ids) and the [E+1] expert-load stats: exact;
- f32 outputs: 1e-5 absolute (summation order only);
- bf16 outputs: 2^-6 relative to the output's largest magnitude.  The two
  frameworks round silu at different places (JAX: x * round(sigmoid(x)),
  PyTorch: round(x / (1 + exp(-x)))), so single elements of the activation
  may sit one bf16 unit apart;
- logits through whole steps: 1e-4 absolute (f32);
- greedy engine tokens: identical.

The port is not held bitwise to JAX's grouped interpret output: on some
CPUs that output already differs from JAX's own dense oracle
(tests/test_moe.py::test_grouped_matches_dense_bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_cache as jkvc
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops import moe as jmoe
from dynamo_tpu.ops.pallas import moe_grouped as jgrouped
from dynamo_tpu_torch.engine import kv_cache as tkvc
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.weights import from_jax_params, init_params
from dynamo_tpu_torch.ops import cuda as tcuda
from dynamo_tpu_torch.ops import moe as tmoe

F32_TOL = 1e-5
BF16_REL = 2.0 ** -6
LOGIT_TOL = 1e-4
BS = 8
JC, TC = jcfg.get_config("tiny-moe"), tcfg.get_config("tiny-moe")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype is not None else t


def _np(x) -> np.ndarray:
    """A JAX array or a torch tensor as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dt):
    got, want = _np(got), _np(want)
    tol = F32_TOL if dt == "f32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def params():
    return jllama.init_params(JC, jax.random.key(0))


def _moe(params, dt):
    """Layer 0's JAX moe dict in `dt` and its port twin."""
    jdt, _ = DTYPES[dt]
    p = jax.tree.map(lambda a: a.astype(jdt), params["layers"][0]["moe"])
    return p, from_jax_params(jax.device_get(p), "cpu")


def _x(seed, shape, dt):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x).astype(jdt), _t(x).to(tdt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_router_and_dense_match_jax(params, dt):
    jp, tp = _moe(params, dt)
    jx, tx = _x(1, (2, 16, JC.hidden_size), dt)
    jids, jg = jmoe.router_topk(JC, jp, jx.reshape(32, -1))
    tids, tg = tmoe.router_topk(TC, tp, tx.reshape(32, -1))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _assert_close(tg, jg, dt)
    jout, jload = jmoe.moe_dense(JC, jp, jx)
    tout, tload = tmoe.moe_dense(TC, tp, tx)
    _assert_close(tout, jout, dt)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(jload))
    assert tload.dtype == torch.int32 and int(tload[-1]) == 0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_grouped_matches_jax_grouped_and_dense(params, dt):
    jp, tp = _moe(params, dt)
    jx, tx = _x(2, (2, 16, JC.hidden_size), dt)
    jout, jload = jmoe.moe_grouped(JC, jp, jx, interpret=True)
    tout, tload = tmoe.moe_grouped(TC, tp, tx)
    _assert_close(tout, jout, dt)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(jload))
    dout, dload = tmoe.moe_dense(TC, tp, tx)
    np.testing.assert_array_equal(tout.float().numpy(), dout.float().numpy())
    np.testing.assert_array_equal(tload.numpy(), dload.numpy())
    assert int(tload[:-1].sum()) == 32 * TC.num_experts_per_token


def test_expert_tiles_plan():
    """Groups padded to block_rows, the static S_pad, tile -> expert and
    the live rows of each tile (0 past the last span)."""
    flat_e = torch.tensor([3, 0, 3, 3, 1, 0, 3, 0], dtype=torch.int64)
    order, dest, S_pad, te, tr, counts = tmoe.expert_tiles(flat_e, 4, 2)
    assert counts.tolist() == [3, 1, 0, 4]
    assert S_pad == (8 + 4 * 1) // 2 * 2
    # Expert 0 owns rows 0-3 (3 live), expert 1 rows 4-5, expert 3 rows 6-9.
    assert te.tolist() == [0, 0, 1, 3, 3, 3]
    assert tr.tolist() == [2, 1, 1, 2, 2, 0]
    assert te.dtype == tr.dtype == torch.int32
    assert sorted(dest.tolist()) == [0, 1, 2, 4, 6, 7, 8, 9]
    assert flat_e[order].tolist() == [0, 0, 0, 1, 3, 3, 3, 3]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_grouped_expert_ffn_plain_matches_jax_kernel(params, dt):
    """The kernel's plain version against the Pallas kernel in interpret
    mode on the same x_pad / tile_expert; padding rows come back zero."""
    jp, tp = _moe(params, dt)
    rng = np.random.default_rng(3)
    ids = rng.choice(6, size=40, p=[.3, .3, .2, .1, .1, 0.])  # expert 5 idle
    order, dest, S_pad, te, tr, _ = tmoe.expert_tiles(
        torch.from_numpy(ids), 6, 8)
    x = rng.standard_normal((40, JC.hidden_size)).astype(np.float32)
    x_pad = np.zeros((S_pad, JC.hidden_size), np.float32)
    x_pad[dest.numpy()] = x[order.numpy()]
    jdt, tdt = DTYPES[dt]
    w = [jp[n][:6] for n in ("w_gate", "w_up", "w_down")]
    want = jgrouped.grouped_expert_ffn(
        jnp.asarray(x_pad).astype(jdt), jnp.asarray(te.numpy()), *w,
        block_rows=8, interpret=True)
    got = tcuda.grouped_expert_ffn(
        _t(x_pad).to(tdt), te, *[tp[n][:6] for n in ("w_gate", "w_up",
                                                     "w_down")],
        tile_rows=tr, block_rows=8)
    _assert_close(got, want, dt)
    live = np.zeros(S_pad, bool)
    live[dest.numpy()] = True
    assert not got[torch.from_numpy(~live)].any()


def test_int8_experts_match_jax(params):
    jp, tp = _moe(params, "bf16")
    jq = jgrouped.quantize_moe_params(jp)
    tq = tcuda.quantize_moe_params(tp)
    assert tcuda.moe_params_quantized(tq) and not tcuda.moe_params_quantized(tp)
    for name in ("w_gate", "w_up", "w_down"):   # byte-equal weights, scales
        assert tq[name].dtype == torch.int8
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jq[name]))
        np.testing.assert_array_equal(tq[name + "_scale"].numpy(),
                                      np.asarray(jq[name + "_scale"]))
    # The quantized dict crosses the weight bridge leaf for leaf.
    crossed = from_jax_params(jax.device_get(jq), "cpu")
    for k, v in crossed.items():
        assert v.dtype == tq[k].dtype and torch.equal(v, tq[k])
    deq = tcuda.dequantize_moe_params(tq, torch.bfloat16)
    jdeq = jgrouped.dequantize_moe_params(jq, jnp.bfloat16)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(_np(deq[name]), _np(jdeq[name]))
    jx, tx = _x(4, (2, 16, JC.hidden_size), "bf16")
    jout, jload = jmoe.moe_grouped(JC, jq, jx, interpret=True)
    tout, tload = tmoe.moe_grouped(TC, tq, tx)
    _assert_close(tout, jout, "bf16")
    np.testing.assert_array_equal(tload.numpy(), np.asarray(jload))
    dout, _ = tmoe.moe_dense(TC, deq, tx)
    np.testing.assert_array_equal(tout.float().numpy(), dout.float().numpy())


def test_init_params_moe_shapes_and_std():
    ref = jax.device_get(jllama.init_params(JC, jax.random.key(0)))
    state = init_params(TC, torch.Generator().manual_seed(0), "cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, ref)
    shapes_t = jax.tree_util.tree_map(
        lambda t: tuple(t.shape), state,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes_j == shapes_t
    moe = state["layers"][1]["moe"]
    assert "mlp" not in state["layers"][1]
    for name, fan_in in (("router", 64), ("w_gate", 64), ("w_down", 128)):
        std = moe[name].std().item()
        assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name


def _caches(num_blocks=16):
    jcache = jkvc.init_cache(jkvc.KvCacheConfig.for_model(
        JC, num_blocks=num_blocks, block_size=BS))
    tcache = tkvc.init_cache(tkvc.KvCacheConfig.for_model(
        TC, num_blocks=num_blocks, block_size=BS), "cpu")
    return jcache, tcache


@pytest.mark.parametrize("mode", ["dense", "grouped"])
def test_forward_step_matches_jax(params, mode):
    """A chunked prefill and a decode step (decode kernel branch) with the
    expert load, on two ragged rows and a pad row."""
    state = from_jax_params(jax.device_get(params), "cpu")
    jcache, tcache = _caches()
    bt = np.asarray([[3, 9, 0, 0], [5, 6, 7, 0], [0, 0, 0, 0]], np.int32)
    toks = np.asarray([[5, 6, 7, 8, 9], [1, 2, 3, 4, 0], [0] * 5], np.int32)
    pad = 128 * BS
    pos = np.asarray([[0, 1, 2, 3, 4], [0, 1, 2, 3, pad], [pad] * 5], np.int32)
    sl = np.asarray([5, 4, 0], np.int32)
    jstep = jllama.make_forward_step(JC, BS, moe_mode=mode,
                                     with_expert_load=True)
    tstep = tllama.make_forward_step(TC, BS, moe_mode=mode,
                                     with_expert_load=True)
    jl, jcache, jload = jstep(params, jcache,
                              *map(jnp.asarray, (toks, pos, sl, bt)))
    tl, tcache, tload = tstep(state, tcache, *map(_t, (toks, pos, sl, bt)))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(jload))
    assert int(tload.sum()) == 15 * 2 * JC.num_layers
    nxt = np.asarray([[11], [12], [0]], np.int32)
    dpos = np.asarray([[5], [4], [pad]], np.int32)
    dsl = np.asarray([6, 5, 0], np.int32)
    smp = np.zeros((3,), np.int32)
    jdec = jllama.make_forward_step(JC, BS, use_pallas_decode=True,
                                    moe_mode=mode, with_expert_load=True)
    tdec = tllama.make_forward_step(TC, BS, use_decode_kernel=True,
                                    moe_mode=mode, with_expert_load=True)
    jl, _, jload = jdec(params, jcache,
                        *map(jnp.asarray, (nxt, dpos, dsl, bt, smp)))
    tl, _, tload = tdec(state, tcache, *map(_t, (nxt, dpos, dsl, bt, smp)))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(jload))


@pytest.mark.parametrize("mode", ["dense", "grouped"])
def test_packed_prefill_step_matches_jax(params, mode):
    """Two packed segments and pad rows; the step's third output is the
    expert load of every packed row (pads included)."""
    state = from_jax_params(jax.device_get(params), "cpu")
    jcache, tcache = _caches()
    T, R, pad = 24, 4, 128 * BS
    tokens = np.zeros(T, np.int32)
    positions = np.full(T, pad, np.int32)
    seg = np.zeros(T, np.int32)
    tokens[0:7] = [1, 2, 3, 4, 5, 6, 7]
    positions[0:7] = np.arange(7)
    tokens[8:19] = np.arange(30, 41)
    positions[8:19] = np.arange(11)
    seg[8:19] = 1
    bts = np.zeros((R, 3), np.int32)
    bts[:2] = [[2, 3, 0], [4, 5, 0]]
    q_starts = np.asarray([0, 8, 0, 0], np.int32)
    q_lens = np.asarray([7, 11, 0, 0], np.int32)
    seq_lens = np.asarray([7, 11, 0, 0], np.int32)
    smp = np.asarray([6, 18, 0, 0], np.int32)
    args = (tokens, positions, seg, bts, q_starts, q_lens, seq_lens, smp)
    jl, _, jload = jllama.make_packed_prefill_step(JC, BS, moe_mode=mode)(
        params, jcache, *map(jnp.asarray, args))
    tl, _, tload = tllama.make_packed_prefill_step(TC, BS, moe_mode=mode)(
        state, tcache, *map(_t, args))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(jload))
    assert int(tload.sum()) == T * 2 * JC.num_layers


def test_decode_window_moe_matches_jax(params):
    """A 4-step greedy window: tokens, and the window's summed load."""
    state = from_jax_params(jax.device_get(params), "cpu")
    jcache, tcache = _caches()
    bt = np.asarray([[2, 3, 4], [0, 0, 0]], np.int32)
    pre = (np.asarray([[9, 8, 7, 6, 5, 4, 3]], np.int32),
           np.arange(7, dtype=np.int32)[None], np.asarray([7], np.int32),
           bt[:1])
    jl, jcache, _ = jllama.make_forward_step(JC, BS, with_expert_load=True)(
        params, jcache, *map(jnp.asarray, pre), jnp.asarray([6]))
    tllama.make_forward_step(TC, BS)(state, tcache, *map(_t, pre))
    first = int(np.argmax(np.asarray(jl)[0]))
    K, pad = 4, 128 * BS
    last = np.asarray([first, 0], np.int32)
    pos0 = np.asarray([7, pad], np.int32)
    sl0 = np.asarray([8, 0], np.int32)
    ones = np.ones(2, np.float32)
    zeros_i = np.zeros(2, np.int32)
    jout = jllama.make_decode_window(
        JC, BS, K, use_pallas_decode=True, greedy_only=True,
        moe_mode="grouped", with_expert_load=True)(
        params, jcache, *map(jnp.asarray, (last, pos0, sl0, bt)),
        jnp.zeros(2), jnp.asarray(zeros_i), jnp.asarray(ones),
        jnp.zeros((2, 2), jnp.uint32), jnp.asarray(zeros_i))
    tout = tllama.make_decode_window(
        TC, BS, K, use_decode_kernel=True, greedy_only=True,
        moe_mode="grouped", with_expert_load=True)(
        state, tcache, *map(_t, (last, pos0, sl0, bt)), torch.zeros(2),
        _t(zeros_i), _t(ones), [None, None], [0, 0])
    np.testing.assert_array_equal(tout[1][:, 0].numpy(),
                                  np.asarray(jout[1])[:, 0])
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
    assert int(tout[5].sum()) == K * 2 * 2 * JC.num_layers


GEOM = dict(max_seqs=4, block_size=8, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4),
            prefill_buckets=(8, 16))


def _serve(core, sp_cls, **a_kw):
    core.add_request("a", [5, 6, 7, 8, 9, 10], sp_cls(max_tokens=8, **a_kw))
    core.add_request("b", list(range(20, 29)), sp_cls(max_tokens=8))
    out = {}
    for _ in range(300):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core._requests:
            break
    assert not core._requests
    return out


def test_engine_greedy_tokens_match_jax(params):
    """Two greedy requests (the scenario of tests/test_moe.py's engine
    runs): the port's engine, dense and grouped, emits JAX's tokens, with
    every routed row in the expert load and nothing dropped."""
    from dynamo_tpu.engine.engine import EngineConfig as JEngineConfig
    from dynamo_tpu.engine.engine import EngineCore as JEngineCore
    from dynamo_tpu.engine.sampling import SamplingParams as JSampling
    from dynamo_tpu.engine.scheduler import SchedulerConfig as JSched
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig

    jcore = JEngineCore(JEngineConfig(
        model=JC, num_blocks=64, moe_mode="dense", packed_prefill=True,
        enable_prefix_cache=False, scheduler=JSched(**GEOM)), params=params)
    want = _serve(jcore, JSampling)
    state = from_jax_params(jax.device_get(params), "cpu")
    for mode in ("auto", "grouped"):
        core = EngineCore(EngineConfig(
            model=TC, num_blocks=64, device="cpu", moe_mode=mode,
            scheduler=SchedulerConfig(**GEOM)), params=state)
        assert core.moe_mode == ("dense" if mode == "auto" else "grouped")
        assert _serve(core, SamplingParams) == want
        load = core.snapshot_expert_load()
        assert load.shape == (TC.num_experts,) and int(load.sum()) > 0
        assert int(load.sum()) == (core.counters.model_rows
                                   * TC.num_experts_per_token * TC.num_layers)
        assert core.moe_dropped_tokens == 0
        core.reset_expert_load()
        assert int(core.snapshot_expert_load().sum()) == 0
    # A logprob row takes the single-step path: same tokens, same count.
    core = EngineCore(EngineConfig(
        model=TC, num_blocks=64, device="cpu", moe_mode="grouped",
        scheduler=SchedulerConfig(**GEOM)), params=state)
    assert _serve(core, SamplingParams, logprobs=True) == want
    assert core.counters.single_step_dispatches > 0
    assert int(core.snapshot_expert_load().sum()) == (
        core.counters.model_rows * TC.num_experts_per_token * TC.num_layers)


def test_engine_takes_int8_experts(params):
    """A quantized `moe` dict flows through `EngineCore(params=...)`: the
    grouped path on int8 experts emits the tokens of the dense oracle on
    the dequantised weights.  The dense path refuses int8 experts."""
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig

    state = from_jax_params(jax.device_get(params), "cpu")
    quant = [tcuda.quantize_moe_params(layer["moe"])
             for layer in state["layers"]]
    q_state = {**state, "layers": [{**layer, "moe": q} for layer, q in
                                   zip(state["layers"], quant)]}
    d_state = {**state, "layers": [
        {**layer, "moe": tcuda.dequantize_moe_params(q, torch.float32)}
        for layer, q in zip(state["layers"], quant)]}

    def core(p, mode):
        return EngineCore(EngineConfig(
            model=TC, num_blocks=64, device="cpu", moe_mode=mode,
            scheduler=SchedulerConfig(**GEOM)), params=p)

    want = _serve(core(d_state, "dense"), SamplingParams)
    q_core = core(q_state, "grouped")
    assert _serve(q_core, SamplingParams) == want
    assert q_core.moe_dropped_tokens == 0
    with pytest.raises(ValueError, match="int8 experts"):
        _serve(core(q_state, "dense"), SamplingParams)


def test_resolve_moe_mode():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tmoe.resolve_moe_mode(TC, cpu) == "dense"
    assert tmoe.resolve_moe_mode(TC, cpu, "grouped") == "grouped"
    # On a card: the kernel's rule decides (bf16, H and F multiples of 64).
    assert tmoe.resolve_moe_mode(TC, cuda) == "dense"            # f32
    assert tmoe.resolve_moe_mode(TC.replace(dtype=torch.bfloat16),
                                 cuda) == "grouped"
    mixtral = tcfg.get_config("mixtral-8x7b")
    assert tmoe.resolve_moe_mode(mixtral, cuda) == "grouped"
    assert tmoe.resolve_moe_mode(mixtral.replace(hidden_size=4100),
                                 cuda) == "dense"
    with pytest.raises(ValueError, match="needs a mesh with an ep axis"):
        tmoe.resolve_moe_mode(TC, cpu, "dispatch")
    with pytest.raises(ValueError, match="not in"):
        tmoe.resolve_moe_mode(TC, cpu, "bogus")
    assert tmoe.resolve_moe_mode(tcfg.get_config("tiny-test"), cuda) == "dense"


def test_frontend_num_layers_and_moe_mode_flags():
    from dynamo_tpu_torch.frontend.main import model_config, parse_args

    args = parse_args(["--model", "mixtral-8x7b", "--num-layers", "16",
                       "--moe-mode", "grouped"])
    assert args.moe_mode == "grouped"
    cfg = model_config(args)
    assert cfg.num_layers == 16 and cfg.hidden_size == 4096
    assert cfg.num_experts == 8 and cfg.intermediate_size == 14_336
    assert model_config(parse_args(["--model", "mixtral-8x7b"])).num_layers == 32
    assert parse_args([]).moe_mode == "auto"
    with pytest.raises(ValueError, match="outside 1..32"):
        model_config(parse_args(["--model", "mixtral-8x7b",
                                 "--num-layers", "33"]))
    with pytest.raises(SystemExit):
        parse_args(["--moe-mode", "dispatch"])


def test_debug_stats_report_expert_load():
    """The frontend's stats hooks on a one-layer tiny-moe engine: the
    [E+1] expert load counts k assignments per model row, and the reset
    zeroes it with the counters."""
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.frontend.main import (
        model_config, parse_args, stats_hooks)

    args = parse_args(["--model", "tiny-moe", "--num-layers", "1",
                       "--device", "cpu"])
    cfg = model_config(args)
    core = EngineCore(EngineConfig(
        model=cfg, num_blocks=64, device="cpu", moe_mode=args.moe_mode,
        scheduler=SchedulerConfig(**GEOM)))
    stats, reset = stats_hooks(core)
    _serve(core, SamplingParams)
    s = stats()
    assert s["moe_mode"] == "dense"
    load = s["expert_load"]
    assert len(load) == cfg.num_experts + 1 and load[-1] == 0
    assert sum(load) == s["counters"]["model_rows"] * 2 * 1 > 0
    reset()
    s = stats()
    assert sum(s["expert_load"]) == 0 and set(s["counters"].values()) == {0}
