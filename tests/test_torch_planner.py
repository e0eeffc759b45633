"""The port's planners against the JAX package's.

- Predictors (constant, moving average, trend, AR) and the perf
  interpolators over the same seeded series and queries: equal to
  rtol 1e-12.
- `LoadPlanner.plan_step` over the same scripted load observations and
  SLO payloads (a fake connector), and `SlaPlanner.decide` over the same
  scripted observations and profile: the same decisions, replica targets
  and correction factors, and the same `planner_metrics_text`.
- The profiler on tiny-test (`--device cpu`) writes JAX's schema: the
  same keys, grid values and shapes as JAX's profiler on the same grid,
  every time finite and positive.  The timings are not compared.
- `LocalConnector` end to end (marker `e2e`): mocker workers under a
  control-plane server; a load spike grows the fleet to 2, idleness
  drains it back to 1, and a stream in flight during the drain completes
  (as tests/test_planner.py does for JAX).
"""

import asyncio
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from dynamo_tpu.llm.kv_router.protocols import (
    ForwardPassMetrics as JaxFpm,
    KvStats as JaxKvStats,
    WorkerStats as JaxWorkerStats,
)
from dynamo_tpu.planner import core as jcore
from dynamo_tpu.planner import interpolation as jinterp
from dynamo_tpu.planner import predictor as jpred
from dynamo_tpu.planner import sla as jsla
from dynamo_tpu.runtime.control_plane import (
    InProcessControlPlane as JaxInProcessControlPlane,
)
from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvStats,
    WorkerStats,
)
from dynamo_tpu_torch.planner import core as tcore
from dynamo_tpu_torch.planner import interpolation as tinterp
from dynamo_tpu_torch.planner import predictor as tpred
from dynamo_tpu_torch.planner import sla as tsla
from dynamo_tpu_torch.planner.connector import LocalConnector
from dynamo_tpu_torch.runtime.control_plane import InProcessControlPlane

ROOT = Path(__file__).resolve().parents[1]

PROFILE = {
    "prefill": {"isl": [128, 512, 2048], "ttft_s": [0.1, 0.4, 1.6],
                "tok_s_per_chip": [1000.0, 1100.0, 900.0]},
    "decode": {"kv_usage": [0.2, 0.5, 0.8], "context": [256, 1024],
               "itl_s": [[0.01, 0.02, 0.05], [0.012, 0.025, 0.06]],
               "tok_s_per_chip": [[200.0, 500.0, 800.0],
                                  [180.0, 450.0, 700.0]]},
}


@pytest.mark.parametrize("kind", ["constant", "moving_average", "trend",
                                  "ar"])
def test_predictors_equal_jax(kind):
    rng = np.random.default_rng(11)
    t = np.arange(300)
    series = 50 + 30 * np.sin(2 * np.pi * t / 37) + rng.normal(0, 3, 300)
    a, b = jpred.make_predictor(kind), tpred.make_predictor(kind)
    got, want = [], []
    for v in series:
        want.append(a.predict_next())
        got.append(b.predict_next())
        a.add_data_point(float(v))
        b.add_data_point(float(v))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_interpolators_equal_jax():
    rng = np.random.default_rng(3)
    jp, tp = (jinterp.PrefillInterpolator(PROFILE),
              tinterp.PrefillInterpolator(PROFILE))
    jd, td = (jinterp.DecodeInterpolator(PROFILE),
              tinterp.DecodeInterpolator(PROFILE))
    got, want = [], []
    for _ in range(200):
        isl = float(rng.uniform(50, 3000))
        kv = float(rng.uniform(0.0, 1.0))
        ctx = float(rng.uniform(100, 1500))
        itl = float(rng.uniform(0.005, 0.07))
        for side, p, d in ((got, tp, td), (want, jp, jd)):
            side.append([p.interpolate_ttft(isl),
                         p.interpolate_thpt_per_chip(isl),
                         d.interpolate_itl(kv, ctx),
                         d.interpolate_thpt_per_chip(kv, ctx),
                         d.find_best_throughput_per_chip(itl, ctx)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


class FakeConnector:
    def __init__(self, n=1):
        self.n = n
        self.clean_drains = 0
        self.force_kills = 0

    def replicas(self):
        return self.n

    async def add_worker(self):
        self.n += 1

    async def remove_worker(self):
        self.n -= 1
        self.clean_drains += 1


def plan_script(core_mod, cp_cls, fpm, ws, ks, script):
    """Apply `script` [(replicas, {wid: (waiting, usage)}, burn)] to one
    package's LoadPlanner; returns the decisions and the metrics text."""
    async def main():
        cp = cp_cls()
        await cp.start()
        conn = FakeConnector()
        planner = core_mod.LoadPlanner(cp, conn, core_mod.PlannerConfig(
            min_replicas=1, max_replicas=4, kv_high=0.8, kv_low=0.3,
            predictor="moving_average"))
        out = []
        try:
            for replicas, loads, burn in script:
                conn.n = replicas
                planner._watcher._metrics.clear()
                for wid, (waiting, usage) in loads.items():
                    m = fpm(worker_stats=ws(num_requests_waiting=waiting),
                            kv_stats=ks(gpu_cache_usage_perc=usage))
                    planner._watcher._metrics[wid] = (m, time.monotonic())
                planner._slo = ({"enabled": True, "objectives": [
                    {"name": "ttft", "burn_fast": burn}]}
                    if burn is not None else None)
                planner._slo_ts = time.monotonic()
                d = planner.plan_step()
                out.append((d, planner.slo_pressure()))
                planner.decisions.append((0.0, d, ""))
            text = core_mod.planner_metrics_text(planner, conn)
        finally:
            await cp.close()
        return out, text

    return asyncio.run(asyncio.wait_for(main(), 60))


def test_load_planner_decisions_equal_jax():
    rng = np.random.default_rng(5)
    script = [(0, {}, None), (1, {}, None)]
    for i in range(60):
        busy = (i // 10) % 2 == 0          # busy and idle phases
        n = int(rng.integers(1, 5))
        loads = {w: (int(rng.choice([0, 0, 0, 2])) if busy else 0,
                     float(rng.uniform(0, 1) if busy
                           else rng.uniform(0, 0.1)))
                 for w in range(1, n + 1)}
        burn = (None if rng.random() < 0.7
                else float(rng.choice([0.5, 1.5, 3.0])))
        script.append((n, loads, burn))
    got = plan_script(tcore, InProcessControlPlane, ForwardPassMetrics,
                      WorkerStats, KvStats, script)
    want = plan_script(jcore, JaxInProcessControlPlane, JaxFpm,
                       JaxWorkerStats, JaxKvStats, script)
    assert got == want
    kinds = {d for d, _ in got[0]}
    assert {"up", "down", None} <= kinds


def test_sla_targets_equal_jax():
    rng = np.random.default_rng(9)
    obs = []
    for _ in range(40):
        obs.append(dict(num_requests=float(rng.integers(0, 400)),
                        avg_isl=float(rng.uniform(0, 2500)),
                        avg_osl=float(rng.uniform(0, 400)),
                        ttft_s=float(rng.choice([0.0, rng.uniform(0.05, 2)])),
                        itl_s=float(rng.choice([0.0,
                                                rng.uniform(0.005, 0.08)]))))

    def run(mod):
        planner = mod.SlaPlanner(PROFILE, observe=None, decode_connector=None,
                                 config=mod.SlaPlannerConfig(
                                     ttft_s=0.5, itl_s=0.03,
                                     adjustment_interval_s=10.0,
                                     max_replicas=8, max_chip_budget=12))
        out = []
        for o in obs:
            d = planner.decide(mod.SlaObservation(**o))
            out.append((d.num_prefill, d.num_decode, d.p_correction,
                        d.d_correction, d.predicted.num_requests,
                        d.predicted.avg_isl, d.predicted.avg_osl))
        return out

    got, want = run(tsla), run(jsla)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2:] for g in got], [w[2:] for w in want],
                               rtol=1e-12, atol=0)
    assert len({g[:2] for g in got}) > 3


def test_profiler_writes_jax_schema(tmp_path):
    from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
    from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSched
    from dynamo_tpu.models import config as jcfg
    from dynamo_tpu.planner.profiler import profile_engine as jax_profile

    grid = dict(isl_grid=(8, 16), context_grid=(16, 24), kv_grid=(0.2, 0.6),
                decode_tokens=4)

    def jax_make():
        return JaxEngineCore(JaxEngineConfig(
            model=jcfg.get_config("tiny-test"), num_blocks=64,
            enable_prefix_cache=False, decode_window=1,
            scheduler=JaxSched(max_seqs=4, block_size=8,
                               max_pages_per_seq=8, max_prefill_chunk=16,
                               decode_buckets=(1, 2, 4),
                               prefill_buckets=(8, 16))))

    want = jax_profile(jax_make, **grid)
    out = tmp_path / "p.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.planner.profiler",
         "--model", "tiny-test", "--device", "cpu", "--isl", "8", "16",
         "--context", "16", "24", "--kv", "0.2", "0.6", "--num-blocks",
         "64", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(out.read_text())

    def shape(obj):
        if isinstance(obj, dict):
            return {k: shape(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [shape(v) for v in obj]
        return type(obj).__name__

    assert shape(got) == shape(want)
    for side in ("prefill", "decode"):
        for key in ("isl", "kv_usage", "context"):
            if key in want[side]:
                assert got[side][key] == want[side][key]
    times = (got["prefill"]["ttft_s"] + got["prefill"]["tok_s_per_chip"]
             + sum(got["decode"]["itl_s"], [])
             + sum(got["decode"]["tok_s_per_chip"], []))
    assert all(math.isfinite(t) and t > 0 for t in times)
    # The profile drives the SLA planner's target computation.
    planner = tsla.SlaPlanner(got, observe=None, decode_connector=None)
    d = planner.decide(tsla.SlaObservation(num_requests=40, avg_isl=12,
                                           avg_osl=8, ttft_s=0.01,
                                           itl_s=0.002))
    assert d.num_prefill >= 1 and d.num_decode >= 1


def _metrics(waiting=0, usage=0.0):
    return ForwardPassMetrics(
        worker_stats=WorkerStats(num_requests_waiting=waiting),
        kv_stats=KvStats(gpu_cache_usage_perc=usage)).to_dict()


@pytest.mark.e2e
def test_connector_scales_mocker_fleet_up_and_down(tmp_path):
    from dynamo_tpu_torch.runtime.control_plane_tcp import (
        ControlPlaneClient,
        ControlPlaneServer,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    async def main():
        srv = ControlPlaneServer()
        port = await srv.start()
        cp = ControlPlaneClient("127.0.0.1", port)
        await cp.start()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        connector = LocalConnector(
            f"127.0.0.1:{port}",
            worker_args=["--mocker", "--model-name", "m", "--block-size",
                         "8", "--metrics-interval", "10"],
            env=env, log_dir=str(tmp_path))
        planner = tcore.LoadPlanner(cp, connector, tcore.PlannerConfig(
            min_replicas=1, max_replicas=2, kv_high=0.8, kv_low=0.3,
            adjustment_interval=0.3, predictor="constant"))
        await planner.start()

        async def instances():
            return len(await cp.get_prefix("instances/"))

        async def until(cond, secs=60):
            deadline = time.monotonic() + secs
            while not await cond() and time.monotonic() < deadline:
                await asyncio.sleep(0.2)
            assert await cond()

        try:
            await until(lambda: _const(connector.replicas() == 1))
            await until(lambda: _eq(instances(), 1))
            for _ in range(4):
                await cp.publish("load_metrics", {
                    "worker_id": 1, "metrics": _metrics(waiting=5,
                                                        usage=0.95)})
                await asyncio.sleep(0.2)
            await until(lambda: _const(connector.replicas() == 2))
            await until(lambda: _eq(instances(), 2))

            runtime = DistributedRuntime(cp)
            client = await (runtime.namespace("dynamo").component("backend")
                            .endpoint("generate").client("round_robin"))
            await client.wait_for_instances()

            async def one_stream():
                toks = []
                async for d in client.generate({
                        "request_id": "s1", "model": "m",
                        "token_ids": list(range(24)),
                        "sampling": {"max_tokens": 24}}):
                    toks.extend(d.get("token_ids", []))
                return toks

            stream = asyncio.create_task(one_stream())
            await asyncio.sleep(0.05)
            for _ in range(4):
                for wid in (1, 2):
                    await cp.publish("load_metrics", {
                        "worker_id": wid, "metrics": _metrics(usage=0.02)})
                await asyncio.sleep(0.2)
            await until(lambda: _const(connector.replicas() == 1))
            # The replica leaves the roster when its drain starts; the
            # drain is counted when the worker exits.
            await until(lambda: _const(connector.clean_drains == 1))
            assert connector.force_kills == 0
            assert len(await asyncio.wait_for(stream, 30)) == 24
            assert [d[1] for d in planner.decisions][:2] == ["up", "up"]
            assert "down" in [d[1] for d in planner.decisions]
            await client.stop()
            await runtime.shutdown()
        finally:
            await planner.stop()
            await connector.shutdown()
            await cp.close()
            await srv.stop()

    asyncio.run(asyncio.wait_for(main(), 150))


async def _const(v):
    return v


async def _eq(coro, n):
    return (await coro) == n
