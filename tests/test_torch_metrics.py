"""The port's `runtime/metrics.py` against `dynamo_tpu/runtime/metrics.py`
on the CPU.

- Counter / Gauge / Histogram: the same observations (seeded numpy,
  label values that need escaping) give byte-equal
  `MetricsRegistry.expose()` text, and equal quantiles, `count_le`,
  means and totals.
- FrontendMetrics / RequestMetrics / KvCacheMetrics register the same
  families with the same HELP text.
- EngineStepCounters: `note_dispatch` / `note_kv_read` /
  `note_window_interval` / `snapshot` / `delta` /
  `effective_bytes_per_token` equal over a seeded sequence, and a port
  `EngineCore`'s `to_dict()` equals a JAX `EngineCore`'s over one engine
  scenario (windows, a chunk behind them, a logprob row; prefix cache off
  and on), under the pinned clocks of `test_torch_mixed_prefill.py`.
- HbmPoller without a card reports JAX's host fallback.
"""

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime import metrics as jm
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.runtime import metrics as tm

from test_torch_mixed_prefill import FIRST, GEOM, LATER
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

LABELS = ({}, {"model": "m"}, {"model": 'a"b\\c\nd'}, {"tier": "device",
                                                       "pool": "G1"})


def _observe(mod, rng_seed: int):
    rng = np.random.default_rng(rng_seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("c_total", "a counter")
    g = reg.gauge("g", "a gauge")
    h = reg.histogram("h_seconds", "a histogram")
    tok = reg.histogram("tokens", "token counts", buckets=(1, 4, 16, 64))
    for _ in range(300):
        lab = LABELS[int(rng.integers(len(LABELS)))]
        x = float(rng.exponential(0.3))
        c.inc(float(rng.integers(1, 4)), labels=lab)
        g.set(x, labels=lab)
        g.add(-x / 2, labels=lab)
        h.observe(x, labels=lab)
        tok.observe(int(rng.integers(0, 100)), labels=lab)
    return reg, h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_and_quantiles_match_jax(seed):
    jreg, jh = _observe(jm, seed)
    treg, th = _observe(tm, seed)
    assert treg.expose() == jreg.expose()
    for lab in LABELS + ({"model": "absent"},):
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0, 1.5):
            a, b = th.quantile(q, lab), jh.quantile(q, lab)
            assert a == b or (np.isnan(a) and np.isnan(b))
        assert th.count(lab) == jh.count(lab)
        assert th.sum(lab) == jh.sum(lab)
    for v in (0.0, 0.001, 0.1, 0.25, 0.3, 1.0, 100.0):
        assert th.count_le(v) == jh.count_le(v)
    assert th.total_count() == jh.total_count()
    assert th.total_sum() == jh.total_sum()
    assert th.total_mean() == jh.total_mean()


def test_metric_families_match_jax():
    def families(mod):
        reg = mod.MetricsRegistry()
        mod.FrontendMetrics(reg)
        mod.RequestMetrics(reg)
        mod.KvCacheMetrics(reg)
        return [ln for ln in reg.expose().splitlines()
                if ln.startswith("#")]

    assert families(tm) == families(jm)


def test_step_counters_match_jax_over_a_seeded_sequence():
    rng = np.random.default_rng(3)
    j, t = jm.EngineStepCounters(), tm.EngineStepCounters()
    jhits, thits = [], []
    j.on_recompile, t.on_recompile = jhits.append, thits.append
    snap_j = snap_t = None
    for i in range(400):
        tag = str(rng.choice(["window", "decode1", "prefill_packed"]))
        sig = tuple(int(x) for x in rng.integers(0, 4, size=2))
        assert t.note_dispatch(tag, *sig) == j.note_dispatch(tag, *sig)
        nbytes, toks = int(rng.integers(0, 10_000)), int(rng.integers(0, 9))
        j.note_kv_read(nbytes, toks)
        t.note_kv_read(nbytes, toks)
        j.note_ring_exchange(nbytes)
        t.note_ring_exchange(nbytes)
        wall, pre = float(rng.uniform(0, 0.01)), int(rng.choice([0, 16]))
        j.note_window_interval(wall, 8, pre)
        t.note_window_interval(wall, 8, pre)
        j.host_syncs += 1
        t.host_syncs += 1
        if i == 200:
            snap_j, snap_t = j.snapshot(), t.snapshot()
    assert thits == jhits
    assert t.to_dict() == j.to_dict()
    assert t.delta(snap_t) == j.delta(snap_j)
    assert t.effective_bytes_per_token == j.effective_bytes_per_token
    assert t.decode_token_cost_ewma == j.decode_token_cost_ewma
    assert t.measured_prefill_cost_ratio == j.measured_prefill_cost_ratio
    # The port's own counters ride as_dict, not to_dict; the reset zeroes
    # every count and keeps the shapes seen and the calibration.
    assert set(t.as_dict()) - set(t.to_dict()) == set(t.PORT_COUNTERS)
    ewma = t.decode_token_cost_ewma
    t.reset_counts()
    assert set(t.as_dict().values()) == {0}
    assert t.decode_token_cost_ewma == ewma
    assert not t.note_dispatch(tag, *sig)


def _run(core, sp):
    for rid, p in FIRST.items():
        core.add_request(rid, p, sp(max_tokens=40))
    added = False
    toks = {}
    for _ in range(3000):
        for d in core.step():
            toks.setdefault(d.request_id, []).extend(d.token_ids)
        if not added and core.counters.window_dispatches >= 3:
            for rid, p in LATER.items():
                core.add_request(rid, p, sp(max_tokens=30))
            core.add_request("lp", [5, 6, 7, 8, 9],
                             sp(max_tokens=6, logprobs=True))
            added = True
        if added and not core._requests:
            break
    return toks


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_counters_to_dict_match_jax(pinned_engine_clocks,
                                           prefix_cache):
    params = jax_init_params(jcfg.get_config("tiny-test"), jax.random.key(0))
    j = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=512,
        packed_prefill=True, enable_prefix_cache=prefix_cache,
        scheduler=JaxSchedulerConfig(**GEOM)), params=params)
    t = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=512, device="cpu",
        enable_prefix_cache=prefix_cache, scheduler=SchedulerConfig(**GEOM)),
        params=from_jax_params(jax.device_get(params), "cpu"))
    assert _run(t, SamplingParams) == _run(j, JaxSamplingParams)
    td, jd = t.counters.to_dict(), j.counters.to_dict()
    assert td == jd
    assert td["window_dispatches"] > 0 and td["xla_cache_misses"] > 0
    assert td["kv_read_bytes_modeled"] > 0
    assert td["decode_tokens_emitted"] > 0


def test_hbm_poller_host_fallback_matches_jax():
    jreg, treg = jm.MetricsRegistry(), tm.MetricsRegistry()
    jk, tk = jm.KvCacheMetrics(jreg), tm.KvCacheMetrics(treg)
    assert tm.HbmPoller(tk, devices=[]).poll_once() == 0
    assert jm.HbmPoller(jk).poll_once() == 0
    lab = {"device": "host", "kind": "cpu"}
    assert tk.hbm_limit.value(lab) == jk.hbm_limit.value(lab) > 0
    assert tk.hbm_used.value(lab) > 0
