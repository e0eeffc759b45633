"""The measured-cost mixed-prefill controller, the port's against the JAX
engine's, on the CPU.

- `MixedPrefillController.observe_cost_ratio` / `budget_for` /
  `modeled_interference` / `plan` and `EngineStepCounters.note_window_interval`
  / `measured_prefill_cost_ratio` give JAX's numbers over one seeded
  sequence of samples (exactly: both are the same float arithmetic).
- Both engines under one pinned clock make the same (duty, chunk) plan
  at every step and emit the same tokens, with measured samples folded
  in on both sides.

The engines read `time.monotonic()` at every steady window sync, and
the JAX engine fetches its first tokens on a thread pool whose futures
may or may not be done at the next step; either can change a plan, and
so the tokens, preemptions and KV events of a parity test.
`pinned_engine_clocks` pins both: the engine modules' `time` is a clock
that only the test moves, and the JAX engine's fetches finish inline
(as the port's CPU copies are ready at once).  The other parity test
files take it from here.
"""

import time

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import engine as jax_engine
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import MixedPrefillController as JaxCtl
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime.metrics import EngineStepCounters as JaxStepCounters
from dynamo_tpu_torch.engine import engine as torch_engine
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import MixedPrefillController, SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.runtime.metrics import EngineStepCounters


class PinnedClock:
    """Stands in for an engine module's `time`: `monotonic()` returns
    `now()` (by default a constant), everything else is the real module."""

    def __init__(self, now=lambda: 0.0):
        self.now = now

    def monotonic(self) -> float:
        return float(self.now())

    def __getattr__(self, name):
        return getattr(time, name)


class InlineExecutor:
    """A fetch pool whose futures are done when `submit` returns."""

    def submit(self, fn, *args):
        from concurrent.futures import Future

        fut = Future()
        fut.set_result(fn(*args))
        return fut

    def shutdown(self, *args, **kwargs):
        pass


@pytest.fixture
def pinned_engine_clocks(monkeypatch):
    """Both engine modules read one constant clock; the JAX engine's host
    fetches complete inline.  Returns the clock (tests may set `now`)."""
    clock = PinnedClock()
    monkeypatch.setattr(jax_engine, "time", clock)
    monkeypatch.setattr(torch_engine, "time", clock)
    init = jax_engine.EngineCore.__init__

    def inline_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._fetch_pool.shutdown(wait=False)
        self._fetch_pool = InlineExecutor()

    monkeypatch.setattr(jax_engine.EngineCore, "__init__", inline_init)
    return clock


def test_controller_and_counters_match_jax_over_a_seeded_sequence():
    rng = np.random.default_rng(0)
    jc, tc = JaxCtl(), MixedPrefillController()
    jn, tn = JaxStepCounters(), EngineStepCounters()
    assert tc.effective_cost_ratio == jc.effective_cost_ratio == 1.15
    assert tn.measured_prefill_cost_ratio is None
    for i in range(200):
        wall = float(rng.choice([0.0, rng.uniform(1e-4, 0.2)]))
        window_tokens = int(rng.choice([0, 8, 64, 256]))
        prefill = int(rng.choice([0, 0, 16, 128, 512]))
        jn.note_window_interval(wall, window_tokens, prefill)
        tn.note_window_interval(wall, window_tokens, prefill)
        assert tn.decode_token_cost_ewma == jn.decode_token_cost_ewma
        assert tn.prefill_token_cost_ewma == jn.prefill_token_cost_ewma
        assert tn.prefill_cost_samples == jn.prefill_cost_samples
        assert tn.measured_prefill_cost_ratio == jn.measured_prefill_cost_ratio
        # Clamped to [0.1, 10]: ratios well outside both ends.
        ratio = float(rng.choice([1e-3, 50.0, rng.uniform(0.05, 12.0)]))
        jc.observe_cost_ratio(ratio)
        tc.observe_cost_ratio(ratio)
        assert tc.measured_cost == jc.measured_cost
        assert tc.effective_cost_ratio == jc.effective_cost_ratio
        n, want = int(rng.integers(0, 40)), int(rng.integers(0, 600))
        duty = int(rng.integers(1, 9))
        assert tc.budget_for(duty, n, 8) == jc.budget_for(duty, n, 8)
        assert (tc.modeled_interference(duty, n, 8, want)
                == jc.modeled_interference(duty, n, 8, want))
        assert tc.plan(n, 8, want) == jc.plan(n, 8, want)
    assert jn.prefill_cost_samples > 0
    # The wall-clock floats stay out of the exact counts.
    assert not {"decode_token_cost_ewma", "prefill_token_cost_ewma",
                "prefill_cost_samples"} & set(tn.as_dict())


GEOM = dict(max_seqs=16, block_size=8, max_pages_per_seq=64,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4, 8, 16),
            prefill_buckets=(8, 16))
# Eight long decoders first; three prompts arrive once windows run, so
# their chunks ride behind windows in a full pipeline and the controller
# plans them.
FIRST = {f"d{i}": [i + 1, i + 2, i + 3, i + 4, i + 5] for i in range(8)}
LATER = {f"p{i}": [(7 * i + j) % 250 + 1 for j in range(30 + 13 * i)]
         for i in range(3)}


def _plans(core, sp):
    """Steps the core through FIRST, then LATER once windows run; returns
    (per-step (duty, chunk) plans, tokens)."""
    for rid, p in FIRST.items():
        core.add_request(rid, p, sp(max_tokens=300))
    plans, toks, added = [], {}, False
    for _ in range(3000):
        for d in core.step():
            toks.setdefault(d.request_id, []).extend(d.token_ids)
        plans.append((core._mixed_duty, core.scheduler.mixed_budget_override))
        if not added and core.counters.window_dispatches >= 3:
            for rid, p in LATER.items():
                core.add_request(rid, p, sp(max_tokens=30))
            added = True
        if added and not core._requests:
            break
    return plans, toks


def test_engines_plan_alike_under_one_pinned_clock(pinned_engine_clocks):
    """The clock reads the engine's dispatched work (a window 1 unit, a
    prefill dispatch 3), so sync intervals are samples and both EWMAs
    move; both engines must still make the same plan at every step."""
    params = jax_init_params(jcfg.get_config("tiny-test"), jax.random.key(0))
    state = from_jax_params(jax.device_get(params), "cpu")
    current = [None]

    def work_clock():
        c = current[0].counters
        return c.window_dispatches + 3.0 * c.prefill_dispatches

    pinned_engine_clocks.now = work_clock
    j = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=512,
        packed_prefill=True, enable_prefix_cache=False,
        scheduler=JaxSchedulerConfig(**GEOM)), params=params)
    current[0] = j
    jplans, jtoks = _plans(j, JaxSamplingParams)
    t = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=512, device="cpu",
        enable_prefix_cache=False, scheduler=SchedulerConfig(**GEOM)),
        params=state)
    current[0] = t
    tplans, ttoks = _plans(t, SamplingParams)
    assert ttoks == jtoks
    assert tplans == jplans
    # Samples were taken and folded on both sides, to the same EWMA.
    assert t.counters.prefill_cost_samples == j.counters.prefill_cost_samples > 0
    assert t._mixed_ctl.measured_cost == j._mixed_ctl.measured_cost
    assert t._mixed_ctl.measured_cost is not None
    # The measured cost moved the plan off the prior's (duty 2, 16).
    assert {(2, 16), (8, 64)} <= set(tplans)
