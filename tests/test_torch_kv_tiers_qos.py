"""QoS demotion into the host tier: the port against the JAX package, on
the CPU (the scenarios of JAX's tests/test_chaos.py, with G2 sized).

- A burn sheds the running best-effort stream: its sealed blocks demote
  into G2 (REMOVED from G1) and its resumption onboards them, on
  tiny-test and tiny-moe.  Tokens, QoS preemptions, demoted and
  onboarded counts and KV events equal JAX's, and the best-effort answer
  equals an undisturbed run's.
- A capacity-blocked standard request displaces the best-effort one on
  11 usable pages with G2 sized: tokens and counts equal JAX's.

Tolerance: none; everything is exact.
"""

import pytest

from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu_torch.engine.sampling import SamplingParams
from test_torch_kv_tiers import _close, _events, _pair, _run, weights  # noqa: F401
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")


@pytest.mark.parametrize("model", ["tiny-test", "tiny-moe"])
def test_qos_demotion_into_g2_equal_jax(weights, model):
    """JAX's test_qos_burn_preempts_best_effort_demotes_then_resumes: a
    burn sheds the running best-effort stream, its sealed blocks demote
    into G2 (REMOVED from G1), and its resumption onboards them; tokens,
    preemptions, demoted and onboarded counts equal JAX's, and the
    best-effort answer equals an undisturbed run's."""
    long_prompt = list(range(1, 36))
    (jref, _), (tref, _) = _pair(weights, model, num_blocks=64,
                                 host_blocks=32)
    ref = _run(tref, "be", long_prompt, 12, priority=0)
    assert ref == _run(jref, "be", long_prompt, 12, priority=0)
    _close(jref, tref)

    (j, jev), (t, tev) = _pair(weights, model, num_blocks=64, host_blocks=32)
    try:
        results = []
        for core in (t, j):
            sp = (SamplingParams if core is t else JaxSamplingParams)
            pressure = [0.0]
            core.scheduler.qos_pressure_fn = lambda p=pressure: p[0]
            core.add_request("be", list(long_prompt), sp(max_tokens=12),
                             priority=0)
            got = {"be": [], "std": []}

            def pump(stop, core=core, got=got):
                for _ in range(600):
                    for d in core.step():
                        got.setdefault(d.request_id, []).extend(d.token_ids)
                    if stop():
                        return
                raise AssertionError(got)

            pump(lambda: len(got["be"]) >= 6)
            pressure[0] = 2.0
            core.add_request("std", list(range(100, 120)), sp(max_tokens=6),
                             priority=1)
            pump(lambda: len(got["std"]) >= 6)
            mgr = core.allocator.manager
            demoted = (core.qos_demoted_blocks,
                       len(mgr.host.registry.by_hash))
            onboarded = mgr.onboarded_blocks
            pressure[0] = 0.0
            pump(lambda: not core._requests)
            results.append((got, core.scheduler.qos_preemptions, demoted,
                            mgr.onboarded_blocks - onboarded))
        assert results[0] == results[1]
        got, preemptions, (demoted, g2), onboarded = results[0]
        assert preemptions >= 1 and demoted >= 1 and g2 >= demoted
        assert onboarded >= demoted
        assert got["be"] == ref and len(got["std"]) == 6
        assert _events(tev) == _events(jev)
    finally:
        _close(j, t)


def test_qos_capacity_preemption_with_host_tier_equal_jax(weights):
    """JAX's test_qos_capacity_preemption_prefers_lower_class on 11 usable
    pages with a G2 tier."""
    (j, _), (t, _) = _pair(weights, num_blocks=12, host_blocks=32)
    try:
        results = []
        for core in (t, j):
            sp = (SamplingParams if core is t else JaxSamplingParams)
            core.add_request("be", list(range(1, 41)), sp(max_tokens=16),
                             priority=0)
            got = {"be": [], "std": []}
            steps = 0
            while not got["be"] and steps < 600:
                for d in core.step():
                    got.setdefault(d.request_id, []).extend(d.token_ids)
                steps += 1
            core.add_request("std", list(range(200, 248)), sp(max_tokens=4),
                             priority=1)
            for _ in range(1000):
                for d in core.step():
                    got.setdefault(d.request_id, []).extend(d.token_ids)
                if not core._requests:
                    break
            results.append((got, core.scheduler.qos_preemptions,
                            core.qos_demoted_blocks,
                            core.allocator.manager.onboarded_blocks))
        assert results[0] == results[1]
        assert results[0][1] >= 1
        assert len(results[0][0]["std"]) == 4
        assert len(results[0][0]["be"]) == 16
    finally:
        _close(j, t)
