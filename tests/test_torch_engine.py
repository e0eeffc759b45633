"""The port's EngineCore against the JAX EngineCore on the same prompts.

Both engines get the same `tiny-test` weights (f32, through the weight
bridge), the same scheduler geometry, packed prefill and no prefix cache.
Greedy output must be token-identical — through chunked prefill, decode
windows, the single-step path, and recompute-preemption under block
contention (the scenario of tests/test_engine.py).  Logprobs agree to
1e-4 (f32 logits, summation order only).
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine.engine import (
    EngineConfig,
    EngineCore,
    InferenceEngine,
)
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import FinishReason, SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params

GEOM = dict(max_seqs=8, block_size=8, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16))


@pytest.fixture(scope="module")
def weights():
    params = jax_init_params(jcfg.get_config("tiny-test"), jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def jax_core(params, num_blocks=64):
    return JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=num_blocks,
        packed_prefill=True, enable_prefix_cache=False,
        scheduler=JaxSchedulerConfig(**GEOM)), params=params)


def port_core(state, num_blocks=64, **kw):
    return EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=num_blocks,
        device="cpu", scheduler=SchedulerConfig(**GEOM), **kw), params=state)


def run(core, requests, max_steps=2000):
    """requests: {rid: (prompt, sampling)} → ({rid: tokens},
    {rid: logprobs}, {rid: finish_reason})."""
    for rid, (prompt, sp) in requests.items():
        core.add_request(rid, prompt, sp)
    toks, lps, fin = {}, {}, {}
    for _ in range(max_steps):
        for d in core.step():
            toks.setdefault(d.request_id, []).extend(d.token_ids)
            if d.logprobs:
                lps.setdefault(d.request_id, []).extend(d.logprobs)
            if d.finished:
                fin[d.request_id] = d.finish_reason
        if not core._requests:
            break
    return toks, lps, fin


def both(weights, prompts, n_out, num_blocks=64, logprobs=()):
    params, state = weights
    jreq = {r: (p, JaxSamplingParams(max_tokens=n_out, logprobs=r in logprobs))
            for r, p in prompts.items()}
    treq = {r: (p, SamplingParams(max_tokens=n_out, logprobs=r in logprobs))
            for r, p in prompts.items()}
    want = run(jax_core(params, num_blocks), jreq)
    port = port_core(state, num_blocks)
    got = run(port, treq)
    return want, got, port


def test_greedy_fleet_token_identical_to_jax(weights):
    prompts = {"a": [1, 2, 3], "b": list(range(10, 31)),  # chunked (21 > 16)
               "c": [9, 8, 7, 6, 5], "d": list(range(40, 52))}
    want, got, port = both(weights, prompts, 20)
    assert got[0] == want[0]
    assert all(len(t) == 20 for t in got[0].values())
    assert all(r.value == "length" for r in got[2].values())
    # The windows and the packed prefill plane both ran.
    assert port.counters.window_dispatches > 0
    assert port.counters.prefill_dispatches > 0
    assert port.allocator.free_blocks == 63


def test_preemption_token_identical_to_jax(weights):
    """9 blocks → 8 usable pages of 8 tokens; two requests growing to ~38
    tokens each must collide: one is preempted and recomputed."""
    prompts = {"a": [1, 2, 3, 4, 5, 6, 7, 8], "b": [9, 10, 11, 12, 13, 14]}
    params, state = weights
    port = port_core(state, num_blocks=9)
    preempted = []
    orig = port.scheduler.preempt
    port.scheduler.preempt = lambda req: (preempted.append(req.request_id),
                                          orig(req))
    treq = {r: (p, SamplingParams(max_tokens=30)) for r, p in prompts.items()}
    got = run(port, treq)
    jreq = {r: (p, JaxSamplingParams(max_tokens=30)) for r, p in prompts.items()}
    want = run(jax_core(params, 9), jreq)
    assert preempted, "the scenario must preempt"
    assert got[0] == want[0]
    assert all(len(t) == 30 for t in got[0].values())


def test_logprob_rows_single_step_match_jax(weights):
    """Logprob requests take the single-step decode path on both sides."""
    prompts = {"a": [3, 1, 4, 1, 5], "b": [2, 7, 1, 8, 2, 8, 1, 8, 2]}
    want, got, port = both(weights, prompts, 6, logprobs=("a",))
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1]["a"], want[1]["a"], rtol=0, atol=1e-4)
    assert "b" not in got[1]
    assert port.counters.single_step_dispatches > 0


def test_stop_token_and_cancel(weights):
    _, state = weights
    core = port_core(state)
    first = run(core, {"r": ([5, 6, 7, 8], SamplingParams(max_tokens=32))})[0]["r"][0]
    core = port_core(state)
    toks, _, fin = run(core, {"r": ([5, 6, 7, 8], SamplingParams(
        max_tokens=32, stop_token_ids=(first,)))})
    assert toks["r"] == [first] and fin["r"] is FinishReason.STOP
    core = port_core(state)
    core.add_request("c", [1, 2, 3], SamplingParams(max_tokens=32))
    core.step()
    core.cancel("c")
    deltas = core.step()
    assert any(d.finished and d.finish_reason is FinishReason.CANCELLED
               for d in deltas)
    for _ in range(20):
        core.step()
    assert not core.has_work and core.allocator.free_blocks == 63


def test_seeded_sampling_reproducible_across_batch_mix(weights):
    """The port's draw law: a seeded request's stream depends only on
    (seed, token index), whatever shares its batch."""
    _, state = weights
    sp = SamplingParams(max_tokens=12, temperature=0.9, top_k=20, seed=42)
    alone = run(port_core(state), {"s": ([4, 5, 6], sp)})[0]["s"]
    mixed = run(port_core(state), {
        "x": ([9, 9, 9, 9], SamplingParams(max_tokens=12, temperature=1.0)),
        "s": ([4, 5, 6], sp),
        "g": ([1, 2], SamplingParams(max_tokens=12))})[0]["s"]
    assert alone == mixed and len(alone) == 12


def test_inference_engine_streams_concurrent_requests(weights):
    _, state = weights

    async def main():
        eng = InferenceEngine(port_core(state))
        await eng.start()

        async def one(rid, prompt):
            toks = []
            async for d in eng.generate(rid, prompt,
                                        SamplingParams(max_tokens=5)):
                toks.extend(d.token_ids)
            return toks

        try:
            return await asyncio.wait_for(asyncio.gather(
                one("a", [1, 2, 3]), one("b", [4, 5, 6]), one("c", [7, 8])),
                60)
        finally:
            await eng.stop()

    assert [len(t) for t in asyncio.run(main())] == [5, 5, 5]


def test_engine_defaults_to_cuda_and_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineCore(EngineConfig(model=tcfg.get_config("tiny-test")))
