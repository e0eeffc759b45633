"""The port's metrics aggregator against the JAX package's.

- In process, one clock: both aggregators get the same published load
  metrics and `kv_hit_rate` events and the same scraped texts (a
  frontend's ledger series, a worker's drift series, a stale target);
  their `/metrics` expositions must be byte-equal, but for one HELP
  text: the port's program registry holds modeled costs, not XLA's, so
  its `program_registry_size` help says so (`JAX_HELP` maps it back).
- Real sweeps (`_scrape_once`) of the same live status server, both
  aggregators side by side: a healthy target, the same target crashed
  (carried STALE, failure counted), past the drop window (dropped), a
  clean de-registration (dropped at once) and a dead-pid registration
  (reaped: key deleted, counted).  Every exposition byte-equal.
- As processes (marker `e2e`): a frontend, a tiny-test worker with the
  device profiler on and `python -m dynamo_tpu_torch.metrics_aggregator`;
  after a chat the aggregator's `/metrics` carries the worker's load
  series, the frontend's and the worker's scraped expositions, the
  frontend ledger's phase sums and the worker's program registry — the
  regexes read the port's live names.
"""

import asyncio
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from dynamo_tpu import metrics_aggregator as jagg
from dynamo_tpu.runtime import status as jstatus
from dynamo_tpu.runtime.control_plane import (
    InProcessControlPlane as JaxInProcessControlPlane,
)
from dynamo_tpu_torch import metrics_aggregator as tagg
from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvStats,
    WorkerStats,
)
from dynamo_tpu_torch.runtime import status as tstatus
from dynamo_tpu_torch.runtime.control_plane import InProcessControlPlane
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.status import StatusServer

ROOT = Path(__file__).resolve().parents[1]

FRONTEND_TEXT = """# HELP dynamo_frontend_requests_total Requests received
# TYPE dynamo_frontend_requests_total counter
dynamo_frontend_requests_total{model="m"} 12
dynamo_request_phase_seconds_sum{phase="queue"} 0.5
dynamo_request_phase_seconds_count{phase="queue"} 12
dynamo_request_phase_seconds_sum{phase="prefill",model="m"} 1.25
dynamo_request_phase_seconds_count{phase="prefill",model="m"} 12
dynamo_goodput_good_tokens_total 300
dynamo_goodput_tokens_total 400
"""
WORKER_TEXT = """# HELP dynamo_frontend_requests_total Requests received
# TYPE dynamo_frontend_requests_total counter
dynamo_worker_request_active_slots 2
dynamo_modeled_vs_measured_ratio{series="kv_decode"} 0.4
dynamo_modeled_vs_measured_ratio{series="window_time"} 0.03
dynamo_program_registry_size 5
"""


PORT_HELP = ("program_registry_size program cost-registry entries summed "
             "across workers")
JAX_HELP = "program_registry_size XLA cost-registry programs summed across workers"


def as_jax(text):
    return text.replace(PORT_HELP, JAX_HELP)


class Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _fpm(active, waiting, blocks, usage):
    return ForwardPassMetrics(
        worker_stats=WorkerStats(request_active_slots=active,
                                 num_requests_waiting=waiting),
        kv_stats=KvStats(kv_active_blocks=blocks,
                         gpu_cache_usage_perc=usage)).to_dict()


async def _feed(mod, cp_cls, clock):
    cp = cp_cls()
    await cp.start()
    agg = mod.MetricsAggregator(cp)
    await agg.start()
    try:
        for wid, args in ((1, (2, 0, 10, 0.25)), (2, (5, 3, 40, 0.75))):
            await cp.publish("load_metrics", {"worker_id": wid,
                                              "metrics": _fpm(*args)})
        for isl, ov in ((10, 4), (7, 7)):
            await cp.publish("kv_hit_rate", {"isl_blocks": isl,
                                             "overlap_blocks": ov})
        for _ in range(200):
            if (len(agg.fresh_workers()) == 2
                    and "17" in agg.registry.expose()):
                break
            await asyncio.sleep(0.01)
        agg._scraped = {
            "127.0.0.1:9001": {"text": FRONTEND_TEXT,
                               "last_ok": clock.now, "stale": False},
            "127.0.0.1:9002": {"text": WORKER_TEXT,
                               "last_ok": clock.now - 7.25, "stale": True},
            "127.0.0.1:9003": {"text": WORKER_TEXT.replace("0.4", "0.6"),
                               "last_ok": clock.now, "stale": False},
        }
        return agg.expose()
    finally:
        await agg.stop()
        await cp.close()


def test_exposition_equal_jax(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(jagg, "time", clock)
    monkeypatch.setattr(tagg, "time", clock)
    got = asyncio.run(asyncio.wait_for(
        _feed(tagg, InProcessControlPlane, clock), 30))
    want = asyncio.run(asyncio.wait_for(
        _feed(jagg, JaxInProcessControlPlane, clock), 30))
    assert PORT_HELP in got
    assert as_jax(got) == want
    for line in ("dynamo_aggregate_workers 2",
                 "dynamo_aggregate_kv_hit_isl_blocks_total 17",
                 'dynamo_aggregate_request_phase_seconds_sum{phase="prefill"}'
                 " 1.25",
                 'dynamo_aggregate_modeled_vs_measured_ratio'
                 '{series="kv_decode"} 0.5',
                 "dynamo_aggregate_program_registry_size 10",
                 "(STALE: last success 7.2s ago)",
                 'dynamo_worker_request_active_slots'
                 '{instance="127.0.0.1:9003"} 2'):
        assert line in got, line


def test_scrape_sweeps_stale_drop_and_reap_equal_jax(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(jagg, "time", clock)
    monkeypatch.setattr(tagg, "time", clock)
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()

    async def main():
        reg = MetricsRegistry()
        reg.gauge("router_requests", "t").set(5.0)
        alive = StatusServer(registry=reg)
        port = await alive.start()
        other = StatusServer(extra_text_fn=lambda: "dynamo_planner_x 1\n")
        oport = await other.start()
        sides = []
        for mod, cp_cls, status_mod in (
                (tagg, InProcessControlPlane, tstatus),
                (jagg, JaxInProcessControlPlane, jstatus)):
            cp = cp_cls()
            await cp.start()
            agg = mod.MetricsAggregator(cp, stale_drop_secs=30.0,
                                        scrape_timeout=1.0)
            await status_mod.register_status_endpoint(cp, "router", port)
            key = await status_mod.register_status_endpoint(cp, "planner",
                                                            oport)
            # A registration whose pid is dead: reaped on the first sweep.
            await cp.put(f"{status_mod.STATUS_ENDPOINTS_PREFIX}/worker-dead/"
                         f"{child.pid}", {"address": "127.0.0.1:1",
                                          "component": "worker-dead",
                                          "pid": child.pid})
            sides.append((agg, cp, key))
        texts = [[] for _ in sides]

        async def sweep():
            for i, (agg, _, _) in enumerate(sides):
                await agg._scrape_once()
                texts[i].append(agg.expose())

        await sweep()                       # healthy; dead pid reaped
        for _, cp, key in sides:
            await cp.delete(key)            # clean de-registration
        await sweep()
        await alive.stop()                  # the router crashes
        clock.now += 5.0
        await sweep()
        clock.now += 40.0                   # past the drop window
        await sweep()
        await other.stop()
        for agg, cp, _ in sides:
            await agg.stop()
            await cp.close()
        return texts

    got, want = asyncio.run(asyncio.wait_for(main(), 60))
    # The addresses are the same live servers: the texts must be equal.
    assert [as_jax(t) for t in got] == want
    assert "dynamo_planner_x" in got[0] and "dynamo_planner_x" not in got[1]
    assert 'endpoint_reaps_total{endpoint="127.0.0.1:1"} 1' in got[0]
    assert "(STALE: last success 5.0s ago)" in got[2]
    assert "dynamo_router_requests" in got[2]
    assert "dynamo_router_requests" not in got[3]
    assert re.search(r'scrape_failures_total\{endpoint="127.0.0.1:\d+"\} 2',
                     got[3])


# -- as processes ---------------------------------------------------------------


def _spawn(args, log_path):
    log = open(log_path, "w+")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                            stdout=log, stderr=subprocess.STDOUT, text=True)
    proc.log, proc.log_path = log, log_path
    return proc


def _wait_log(proc, pattern, deadline):
    while time.monotonic() < deadline:
        m = re.search(pattern, Path(proc.log_path).read_text())
        if m:
            return m
        assert proc.poll() is None, Path(proc.log_path).read_text()[-3000:]
        time.sleep(0.1)
    raise TimeoutError(f"no {pattern!r} in {proc.log_path}")


@pytest.mark.e2e
def test_live_port_expositions_through_the_aggregator(tmp_path):
    import json

    procs = []
    deadline = time.monotonic() + 180
    try:
        fe = _spawn(["dynamo_tpu_torch.frontend", "--serve-control-plane",
                     "--control-plane-port", "0", "--http-port", "0"],
                    tmp_path / "frontend.log")
        procs.append(fe)
        m = _wait_log(fe, r"discovering models via (\S+) .* on (http://\S+)",
                      deadline)
        cp, base = m.group(1), m.group(2)
        w = _spawn(["dynamo_tpu_torch.worker", "--control-plane", cp,
                    "--device", "cpu", "--model", "tiny-test",
                    "--model-name", "m", "--num-blocks", "64",
                    "--block-size", "8", "--device-profiler", "on",
                    "--flight-dump-dir", str(tmp_path)],
                   tmp_path / "worker.log")
        agg = _spawn(["dynamo_tpu_torch.metrics_aggregator",
                      "--control-plane", cp, "--http-port", "0"],
                     tmp_path / "agg.log")
        procs += [w, agg]
        _wait_log(w, r"worker instance \d+ serving", deadline)
        aport = _wait_log(agg, r"serving :(\d+)/metrics", deadline).group(1)
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/v1/models", timeout=10) as r:
                if json.loads(r.read())["data"]:
                    break
            time.sleep(0.1)
        body = {"model": "m", "max_tokens": 8, "temperature": 0,
                "messages": [{"role": "user", "content": "hello there"}]}
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["usage"]["completion_tokens"] == 8
        want = ("dynamo_aggregate_workers 1",
                "dynamo_worker_request_active_slots{instance=",
                "dynamo_frontend_requests_total{",
                'dynamo_aggregate_request_phase_seconds_sum{phase="prefill"}',
                "dynamo_qos_preemptions_total{instance=")
        text = ""
        while time.monotonic() < deadline:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{aport}/metrics", timeout=10) as r:
                text = r.read().decode()
            reg = re.search(r"^dynamo_aggregate_program_registry_size (\S+)",
                            text, re.M)
            if all(s in text for s in want) and reg and float(reg.group(1)):
                break
            time.sleep(0.5)
        else:
            raise AssertionError(text[-4000:])
        phase = re.search(r'^dynamo_aggregate_request_phase_seconds_count'
                          r'\{phase="prefill"\} (\S+)', text, re.M)
        assert phase and float(phase.group(1)) >= 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
            p.log.close()
