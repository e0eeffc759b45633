"""The observability plane end to end on the CPU: the port's frontend and
worker processes with every plane on, held against the JAX package's
surfaces.

- `chip_smoke.py`'s lists of the JAX frontend's and worker's /metrics
  families (which its `serve_observed` phase checks on the card) are the
  JAX modules' own: the registries of FrontendMetrics, RequestMetrics,
  KvCacheMetrics, LedgerSink and SloMonitor, the KV router's and
  migration's counters, the worker's `worker_metrics_text` lines and the
  device profiler's `metrics_lines`, the drain, migration and QoS series
  (`DRAIN_QOS_FAMILIES`) among them.
- A frontend (`--serve-control-plane --router-mode kv`) and a CPU worker
  as subprocesses, every plane on: /metrics on both carries every JAX
  family, the drain and QoS ones too; /live; the /debug/traces,
  /debug/requests, /debug/slo, /debug/flightrecorder and
  /debug/deviceprofile payloads have JAX's keys; a bad `?ms=` is a 400;
  each chat's ledger holds the frontend, routing, wire (`rpc`) and
  engine phases and claims no more than its TTFT; a
  `profile/<pid>` key on the control plane makes the worker capture, and
  SIGUSR2 dumps its flight recorder.
- The `x-dynamo-priority` header reaches the KV router's selector (in
  process): `interactive` → 2, `0` → 0, absent → None.
- The thread contracts are live in the suite: a core stepped by one
  thread refuses another until released; the engine's and the facade's
  methods carry JAX's contract tags.
"""

import argparse
import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import chip_smoke
from dynamo_tpu.runtime import device_profiler as jdp
from dynamo_tpu.runtime import flight_recorder as jfr
from dynamo_tpu.runtime import ledger as jled
from dynamo_tpu.runtime import metrics as jm
from dynamo_tpu.runtime import slo as jslo
from dynamo_tpu.runtime import tracing as jtr
from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneClient
from dynamo_tpu_torch.runtime.ledger import TTFT_PHASES

REPO = Path(__file__).resolve().parent.parent

# The worker's drain, migration and QoS series (JAX `worker_metrics_text`).
DRAIN_QOS_FAMILIES = ("dynamo_requests_migrated_total",
                      "dynamo_worker_draining",
                      "dynamo_requests_migrated_in_total",
                      "dynamo_qos_preemptions_total",
                      "dynamo_qos_demoted_blocks_total")


def _jax_slo(registry):
    """JAX's monitor with one TTFT objective, its gauges on `registry`."""
    args = argparse.Namespace(
        slo_ttft_p99=5.0, slo_tpot_p99=None, slo_error_rate=None,
        slo_target=0.99, slo_fast_window=300.0, slo_slow_window=3600.0,
        slo_warn_burn=3.0, slo_page_burn=14.4, slo_tick=5.0)
    return jslo.monitor_from_args(args, jm.RequestMetrics(
        jm.MetricsRegistry()), registry=registry)


def _source_names(path: str, start: str, end: str):
    src = (REPO / path).read_text()
    body = src[src.index(start):]
    return set(re.findall(r"dynamo_[a-z_]+", body[:body.index(end)]))


def test_chip_smoke_family_lists_are_jax_surfaces():
    front = jm.MetricsRegistry()
    jm.FrontendMetrics(front)
    jm.RequestMetrics(front)
    jled.LedgerSink(front)
    _jax_slo(front)
    router = re.findall(r'registry\.counter\(\s*"(\w+)"', (
        REPO / "dynamo_tpu/llm/kv_router/client.py").read_text())
    migration = re.findall(r'registry\.counter\(\s*"(\w+)"', (
        REPO / "dynamo_tpu/llm/migration.py").read_text())
    want = chip_smoke.metric_families(front.expose()) | {
        "dynamo_" + n for n in router + migration}
    assert set(chip_smoke.JAX_FRONTEND_FAMILIES) == want

    worker = jm.MetricsRegistry()
    jm.RequestMetrics(worker)
    jm.KvCacheMetrics(worker)
    _jax_slo(worker)
    lines = _source_names("dynamo_tpu/worker/main.py",
                          "def worker_metrics_text",
                          'return "\\n".join(lines)')
    engine = {"dynamo_worker_engine_" + k
              for k in jm.EngineStepCounters().to_dict()}
    lines = {n for n in lines if not n.startswith("dynamo_moe_")}  # MoE only
    lines = (lines - {"dynamo_worker_engine_"}) | engine
    prof = jdp.DeviceProfiler("w", enabled=True)
    prof.registry.record("window:x", flops=1.0, bytes_accessed=1.0)
    prof.auditor.observe("kv_decode", 1.0, 2.0)
    want = (chip_smoke.metric_families(worker.expose()) | lines
            | chip_smoke.metric_families("\n".join(prof.metrics_lines())))
    assert set(chip_smoke.JAX_WORKER_FAMILIES) == want
    assert set(DRAIN_QOS_FAMILIES) <= want


# ---------------------------------------------------------------------------
# Frontend and CPU worker processes, every plane on.


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read().decode()
    return json.loads(body) if body.startswith(("{", "[")) else body


def _chat(base, i, headers=None):
    req = urllib.request.Request(
        base + "/v1/chat/completions",
        data=json.dumps({"model": "m", "max_tokens": 12, "temperature": 0,
                         "messages": [{"role": "user",
                                       "content": f"hello {i}"}]}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _wait(path: Path, pattern: str, timeout: float = 120.0) -> str:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        m = re.search(pattern, path.read_text())
        if m:
            return m.group(1)
        time.sleep(0.1)
    raise AssertionError(f"{pattern!r} not in {path}: "
                         + path.read_text()[-3000:])


def test_frontend_and_worker_planes_end_to_end(tmp_path):
    planes = ["--trace", "--trace-sample", "1.0", "--request-ledger", "on",
              "--slo-ttft-p99", "5.0", "--flight-recorder", "on",
              "--flight-dump-dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []

    def spawn(name, *args):
        log = tmp_path / f"{name}.log"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", *args], cwd=REPO, env=env,
            stdout=open(log, "w"), stderr=subprocess.STDOUT))
        return log

    try:
        fe = spawn("fe", "dynamo_tpu_torch.frontend", "--serve-control-plane",
                   "--control-plane-port", "0", "--router-mode", "kv",
                   "--http-port", "0", *planes)
        cp = _wait(fe, r"control plane on (\S+)")
        base = _wait(fe, r"on (http://\S+)")
        wl = spawn("worker", "dynamo_tpu_torch.worker", "--control-plane", cp,
                   "--device", "cpu", "--model", "tiny-test",
                   "--model-name", "m", "--block-size", "8",
                   "--health-port", "0", *planes, "--device-profiler", "on",
                   "--watchdog-stall-s", "30")
        w = "http://127.0.0.1:" + _wait(wl, r"worker status server on :(\d+)")
        t0 = time.monotonic()
        while [d["id"] for d in _get(base + "/v1/models")["data"]] != ["m"]:
            assert time.monotonic() - t0 < 120
            time.sleep(0.2)
        for i in range(3):
            assert _chat(base, i)["usage"]["completion_tokens"] == 12
        fm, wm = _get(base + "/metrics"), _get(w + "/metrics")
        payloads = {
            "traces": (_get(base + "/debug/traces"),
                       jtr.debug_traces_payload(1, jtr.Tracer())),
            "requests": (_get(base + "/debug/requests?n=5"),
                         jled.LedgerSink(jm.MetricsRegistry())
                         .debug_payload()),
            "flight": (_get(w + "/debug/flightrecorder?n=500"),
                       jfr.FlightRecorder().debug_payload()),
            "profiler": (_get(w + "/debug/deviceprofile"),
                         jdp.DeviceProfiler().debug_payload()),
            "slo": (_get(base + "/debug/slo"),
                    _jax_slo(jm.MetricsRegistry()).payload()),
        }
        assert _get(base + "/live") == _get(w + "/live") == {"status": "live"}
        with pytest.raises(urllib.error.HTTPError) as bad:
            _get(w + "/debug/deviceprofile?ms=bogus")
        assert bad.value.code == 400
        capture = _get(w + "/debug/deviceprofile?ms=50")
        # The control-plane capture command, then a SIGUSR2 dump.
        pid = payloads["flight"][0]["pid"]

        async def command():
            host, port = cp.rsplit(":", 1)
            client = ControlPlaneClient(host, int(port))
            await client.start()
            await client.put(f"profile/{pid}", 40)
            await client.close()

        asyncio.run(asyncio.wait_for(command(), 30))
        _wait(wl, r"(device capture result: \{'ok': True)")
        os.kill(pid, signal.SIGUSR2)
        dump = tmp_path / f"flight_worker-backend_{pid}.jsonl"
        t0 = time.monotonic()
        while not (dump.exists() and "sigusr2" in dump.read_text()):
            assert time.monotonic() - t0 < 30
            time.sleep(0.1)
    finally:
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=60)

    for side, text, want in (
            ("frontend", fm, chip_smoke.JAX_FRONTEND_FAMILIES),
            ("worker", wm, chip_smoke.JAX_WORKER_FAMILIES)):
        missing = set(want) - chip_smoke.metric_families(text)
        assert not missing, (side, missing)
    assert set(DRAIN_QOS_FAMILIES) <= chip_smoke.metric_families(wm)
    assert chip_smoke.metric_value(wm, "dynamo_program_registry_size") > 0
    for name, (got, jax_shape) in payloads.items():
        assert set(got) == set(jax_shape), name
    assert payloads["slo"][0]["enabled"] and payloads["profiler"][0]["enabled"]
    kinds = {e["kind"] for e in payloads["flight"][0]["events"]}
    assert {"window", "prefill_packed", "recompile"} <= kinds
    for entry in payloads["requests"][0]["slowest"]:
        phases = {s["phase"] for s in entry["stamps"]}
        assert {"receive", "route", "queue", "prefill",
                "first_token", "decode"} <= phases, phases
        # The port's wire phase (JAX's ledger leaves the wire dark), and
        # no over-claim: the TTFT phases lie in disjoint stretches of it.
        covered = sum(s["dur"] for s in entry["stamps"]
                      if s["phase"] in TTFT_PHASES)
        assert "rpc" in phases and covered <= entry["ttft_s"] + 1e-5
    assert capture["ok"] and capture["files"]
    meta = json.loads((Path(capture["dir"]) / "capture_meta.json")
                      .read_text())
    assert meta["pid"] == pid
    header = json.loads(dump.read_text().splitlines()[0])
    assert header["flight_dump"] and header["service"] == "worker-backend"


def test_priority_header_reaches_the_selector(monkeypatch):
    """x-dynamo-priority → the request's `priority` annotation → the KV
    router's selector, through the port's frontend, in process."""
    from dynamo_tpu_torch.llm.kv_router.scheduler import DefaultWorkerSelector

    seen = []
    select = DefaultWorkerSelector.select

    def spy(self, candidates, request_blocks, priority=None):
        seen.append(priority)
        return select(self, candidates, request_blocks, priority)

    monkeypatch.setattr(DefaultWorkerSelector, "select", spy)
    asyncio.run(asyncio.wait_for(_priority_stack(), 120))
    assert seen == [2, 0, None]


async def _priority_stack():
    from dynamo_tpu_torch.engine.engine import (
        EngineConfig, EngineCore, InferenceEngine)
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.llm import discovery as disc
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.service import LocalEngineClient, ModelManager
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.runtime import control_plane_tcp as tcp
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    server = tcp.ControlPlaneServer()
    port = await server.start()
    wcp = tcp.ControlPlaneClient("127.0.0.1", port)
    await wcp.start()
    wrt = DistributedRuntime(wcp)
    engine = InferenceEngine(EngineCore(EngineConfig(
        model=get_config("tiny-test"), num_blocks=64, device="cpu",
        scheduler=SchedulerConfig(max_seqs=4, block_size=8,
                                  max_pages_per_seq=16, max_prefill_chunk=64,
                                  decode_buckets=(1, 2, 4),
                                  prefill_buckets=(16, 64)))))
    await engine.start()
    endpoint = wrt.namespace("dynamo").component("backend").endpoint(
        "generate")
    instance = await endpoint.serve(
        disc.engine_wire_handler(LocalEngineClient(engine)))
    await disc.register_llm(endpoint, instance,
                            ModelDeploymentCard(name="m", kv_block_size=8))
    fcp = tcp.ControlPlaneClient("127.0.0.1", port)
    await fcp.start()
    frt = DistributedRuntime(fcp)
    models = ModelManager()
    watcher = disc.ModelWatcher(frt, models, router_mode="kv")
    await watcher.start()
    svc = HttpService(models)
    http_port = await svc.start()
    try:
        while not len(models):
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.3)
        base = f"http://127.0.0.1:{http_port}"
        for i, header in enumerate(("interactive", "0", None)):
            await asyncio.to_thread(
                _chat, base, i,
                {"x-dynamo-priority": header} if header else None)
    finally:
        await svc.stop()
        await watcher.stop()
        await endpoint.leave()
        await engine.stop()
        await frt.shutdown()
        await fcp.close()
        await wrt.shutdown()
        await wcp.close()
        await server.stop()


def test_thread_contracts_are_live_and_match_jax():
    """DYNAMO_CONTRACTS=1 (the suite's conftest): a core that one thread
    stepped refuses another thread until the owner is released, as JAX's
    does; the engine's and the facade's methods carry JAX's contracts."""
    import threading

    from dynamo_tpu.runtime import contracts as jc
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.engine import InferenceEngine
    from dynamo_tpu_torch.models.config import get_config
    from dynamo_tpu_torch.runtime import contracts as tc

    assert tc.ENABLED and jc.ENABLED
    core = EngineCore(EngineConfig(model=get_config("tiny-test"),
                                   num_blocks=32, device="cpu"))
    core.step()
    errors = []

    def other():
        try:
            core.step()
        except tc.ContractViolation as e:
            errors.append(e)

    t = threading.Thread(target=other, name="intruder")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(errors) == 1
    assert "intruder" in str(errors[0])
    tc.release_owner(core)
    t = threading.Thread(target=core.step)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    from dynamo_tpu.engine import engine as jax_engine

    for cls, jcls, names in (
            (EngineCore, jax_engine.EngineCore, (
                "add_request", "cancel", "step", "clear_prefix_cache",
                "embed_tokens", "export_blocks", "export_blocks_device",
                "resident_prefix_blocks", "import_blocks",
                "_publish_completed_blocks", "_append_token")),
            (InferenceEngine, jax_engine.InferenceEngine, (
                "generate", "run_in_engine", "watch_seals", "export_blocks",
                "export_blocks_device", "import_blocks",
                "resident_prefix_blocks", "clear_kv_blocks", "embed",
                "_on_seal"))):
        for name in names:
            assert (getattr(getattr(cls, name), "__dynamo_contract__", None)
                    == getattr(getattr(jcls, name), "__dynamo_contract__",
                               None)), name
