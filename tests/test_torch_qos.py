"""QoS admission and preemption: the port against the JAX package.

- Scheduler level: JAX's `Scheduler` and the port's step over the same
  mixed-class requests (prompts, classes and arrival steps drawn with
  numpy from a seed) at a small `num_blocks`, stepped by the same
  script (prefill completion, decode growth, capacity preemption,
  finish).  Every step's running / waiting order, prefill and decode
  work, `qos_preemptions`, `qos_active` and the preemption victims must
  be exactly equal, also under a scripted `qos_pressure_fn` (hold and
  shed).
- Engine level: both `EngineCore`s (tiny-test, the same weights, prefix
  cache on) serve best-effort requests that fill the pages, then an
  interactive one: the greedy tokens and the preemption count are equal,
  and `qos_demoted_blocks` is 0 on both (no host tier).
- `slo_eviction_bias` on both `BlockPool`s evicts in the same order.
- The `priority` annotation reaches the port's scheduler through
  `LocalEngineClient`.
"""

import asyncio

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.llm.block_manager import pool as jpool
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore, InferenceEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.llm.block_manager import pool as tpool
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.llm.service import LocalEngineClient
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

GEOM = dict(max_seqs=8, block_size=8, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16))


def scenario(seed, n=14, steps=40):
    """{step: [(rid, prompt, max_tokens, priority)]} from a seed."""
    rng = np.random.default_rng(seed)
    arrivals = {}
    for i in range(n):
        step = int(rng.integers(0, steps // 2))
        prompt = rng.integers(1, 200, size=int(rng.integers(3, 30))).tolist()
        arrivals.setdefault(step, []).append(
            (f"r{i}", prompt, int(rng.integers(4, 24)),
             int(rng.integers(0, 3))))
    return arrivals


def drive(mod, sp_cls, arrivals, num_blocks, steps=120, burn=None):
    """Step one package's Scheduler with a scripted engine; returns the
    per-step log and the preemption victims in order."""
    sched = mod.Scheduler(mod.SchedulerConfig(**GEOM),
                          mod.BlockAllocator(num_blocks))
    # JAX's static mixed caps have no counterpart in the port: both take
    # an override that never binds.
    sched.mixed_budget_override = 10 ** 6
    victims = []
    orig = sched.preempt

    def preempt(req):
        victims.append(req.request_id)
        orig(req)

    sched.preempt = preempt
    clock = [0]
    if burn is not None:
        sched.qos_pressure_fn = lambda: burn[min(clock[0], len(burn) - 1)]
    log = []
    for step in range(steps):
        clock[0] = step
        for rid, prompt, max_tokens, prio in arrivals.get(step, []):
            sched.add_request(mod.Request(
                rid, list(prompt), sp_cls(max_tokens=max_tokens),
                priority=prio))
        plan = sched.plan()
        log.append((
            [r.request_id for r in sched.running],
            [r.request_id for r in sched.waiting],
            [(w.request.request_id, w.start, w.length)
             for w in (plan.prefill.items if plan.prefill else [])],
            [r.request_id for r in (plan.decode.requests
                                    if plan.decode else [])],
            sched.qos_preemptions, sched.qos_active))
        if plan.prefill:
            for w in plan.prefill.items:
                sched.prefill_done(w)
                if w.request.state is mod.RequestState.DECODE:
                    w.request.output_tokens.append(7)
        if plan.decode:
            for r in plan.decode.requests:
                if r.state is not mod.RequestState.DECODE:
                    continue   # preempted earlier in this step
                if not sched.ensure_capacity(r, r.total_len):
                    if len(sched.running) <= 1:
                        sched.finish(r, mod.FinishReason.LENGTH)
                    else:
                        sched.preempt(r)
                    continue
                r.output_tokens.append(7)
        for r in list(sched.running):
            if (r.state is mod.RequestState.DECODE and
                    len(r.output_tokens) + r.prior_output
                    >= r.sampling.max_tokens):
                sched.finish(r, mod.FinishReason.LENGTH)
        if not (sched.running or sched.waiting) and step > max(arrivals):
            break
    return log, victims


@pytest.mark.parametrize("seed,num_blocks", [(0, 14), (1, 12), (2, 20),
                                             (3, 10)])
def test_scheduler_admission_and_victims_equal_jax(seed, num_blocks):
    arrivals = scenario(seed)
    want = drive(jsched, JaxSamplingParams, arrivals, num_blocks)
    got = drive(tsched, SamplingParams, arrivals, num_blocks)
    assert got == want
    log, victims = got
    # The scenario exercised what it is for: classes out of FCFS order
    # and at least one capacity preemption of a lower class.
    assert log[-1][4] >= 1 and victims


@pytest.mark.parametrize("seed", [4, 5])
def test_scheduler_hold_and_shed_under_pressure_equal_jax(seed):
    arrivals = scenario(seed)
    rng = np.random.default_rng(seed)
    burn = [float(rng.choice([0.0, 0.5, 1.0, 3.0])) for _ in range(60)]
    want = drive(jsched, JaxSamplingParams, arrivals, 40, burn=burn)
    got = drive(tsched, SamplingParams, arrivals, 40, burn=burn)
    assert got == want
    log, _ = got
    assert any(active for *_, active in log)
    assert log[-1][4] >= 1           # sheds counted as QoS preemptions


def test_broken_pressure_signal_never_wedges_admission():
    for mod in (jsched, tsched):
        sched = mod.Scheduler(mod.SchedulerConfig(**GEOM),
                              mod.BlockAllocator(16))

        def boom():
            raise RuntimeError("monitor gone")

        sched.qos_pressure_fn = boom
        sp = (JaxSamplingParams if mod is jsched else SamplingParams)
        sched.add_request(mod.Request("a", [1, 2, 3], sp(max_tokens=2),
                                      priority=0))
        sched.plan()
        assert [r.request_id for r in sched.running] == ["a"]
        assert sched.qos_active is False


# -- engine level -------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    params = jax_init_params(jcfg.get_config("tiny-test"), jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def serve_classes(core, sp_cls, late_step=3, max_steps=3000):
    """Two best-effort requests fill the pages; an interactive one
    arrives at `late_step` and must preempt the newer of them."""
    early = {"be0": list(range(1, 25)), "be1": list(range(30, 54))}
    late = {"ia": list(range(60, 84))}
    for rid, p in early.items():
        core.add_request(rid, p, sp_cls(max_tokens=20), priority=0)
    toks, order = {}, []
    for step in range(max_steps):
        if step == late_step:
            for rid, p in late.items():
                core.add_request(rid, p, sp_cls(max_tokens=20), priority=2)
        for d in core.step():
            if d.token_ids and d.request_id not in toks:
                order.append(d.request_id)
            toks.setdefault(d.request_id, []).extend(d.token_ids)
        if step > late_step and not core._requests:
            break
    return toks, order


def test_engine_qos_preemption_equal_jax(weights):
    params, state = weights
    jcore = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=12,
        packed_prefill=True, enable_prefix_cache=True,
        scheduler=jsched.SchedulerConfig(**GEOM)), params=params)
    tcore = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=12, device="cpu",
        enable_prefix_cache=True, scheduler=tsched.SchedulerConfig(**GEOM)),
        params=state)
    want = serve_classes(jcore, JaxSamplingParams)
    got = serve_classes(tcore, SamplingParams)
    assert got == want
    assert all(len(t) == 20 for t in got[0].values())
    assert tcore.scheduler.qos_preemptions == jcore.scheduler.qos_preemptions
    assert tcore.scheduler.qos_preemptions >= 1
    # No host tier: the demotion is a no-op on both, and the victim's
    # sealed blocks stay resident in G1.
    assert tcore.qos_demoted_blocks == jcore.qos_demoted_blocks == 0


def test_greedy_tokens_survive_qos_preemption(weights):
    """The preempted request's greedy tokens equal an unpressured run's."""
    _, state = weights

    def core(nb):
        return EngineCore(EngineConfig(
            model=tcfg.get_config("tiny-test"), num_blocks=nb,
            device="cpu", scheduler=tsched.SchedulerConfig(**GEOM)),
            params=state)

    pressured = core(12)
    toks, _ = serve_classes(pressured, SamplingParams)
    assert pressured.scheduler.qos_preemptions >= 1
    roomy = core(64)
    ref, _ = serve_classes(roomy, SamplingParams)
    assert roomy.scheduler.qos_preemptions == 0
    assert toks == ref


# -- the pool's SLO eviction bias ---------------------------------------------


def eviction_order(mod, burn):
    evicted = []
    pool = mod.BlockPool(8, on_evict=lambda h, s: evicted.append(h))
    pool.set_eviction_bias(mod.slo_eviction_bias(lambda: burn), scan=4)
    slots = pool.allocate(8)
    for i, s in enumerate(slots):
        pool.register(s, 1000 + i)
    pool.release(slots)
    # Hits on some blocks: those are hot while the budget burns.
    for h, n in ((1000, 2), (1001, 1), (1004, 3)):
        for _ in range(n):
            ids = pool.acquire_matched(pool.match_sequence_hashes([h]))
            pool.release(ids)
    pool.allocate(6)
    return evicted, pool.bias_protected, pool.evictions


@pytest.mark.parametrize("burn", [0.0, 2.0])
def test_slo_eviction_bias_order_equal_jax(burn):
    got = eviction_order(tpool, burn)
    assert got == eviction_order(jpool, burn)
    if burn >= 1.0:
        assert got[1] >= 1      # a hot block was skipped over


def test_discard_and_demote_hash_equal_jax():
    def run(mod):
        ev = []
        pool = mod.BlockPool(6, on_evict=lambda h, s: ev.append((h, s)))
        slots = pool.allocate(4)
        for i, s in enumerate(slots):
            pool.register(s, 50 + i)
        pool.release(slots[:3])
        out = [pool.demote_hash(50), pool.demote_hash(53),   # 53 pinned
               pool.discard(51), pool.discard(53), pool.discard(99)]
        return out, ev, pool.free_slots, pool.evictions, pool.reusable_slots

    assert run(tpool) == run(jpool)


# -- the class through the serving seam ---------------------------------------


def test_priority_reaches_the_scheduler_through_local_client(weights):
    _, state = weights
    core = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=32, device="cpu",
        scheduler=tsched.SchedulerConfig(**GEOM)), params=state)
    seen = {}
    orig = core.scheduler.add_request

    def add(req):
        seen[req.request_id] = req.priority
        orig(req)

    core.scheduler.add_request = add
    engine = InferenceEngine(core)
    client = LocalEngineClient(engine)

    async def main():
        await engine.start()
        try:
            for rid, ann in (("a", {"priority": "interactive"}),
                             ("b", {"priority": "0"}), ("c", {}),
                             ("d", {"priority": "bogus"})):
                req = PreprocessedRequest(rid, "m", [1, 2, 3],
                                          SamplingParams(max_tokens=2),
                                          annotations=ann)
                async for _ in client.generate(req):
                    pass
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(main(), 60))
    assert seen == {"a": 2, "b": 0, "c": 1, "d": 1}
