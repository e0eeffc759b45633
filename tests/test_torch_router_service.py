"""The port's standalone KV-router service (`dynamo_tpu_torch.router_service`)
on the port's control plane, on the CPU (the scenario of JAX's
tests/test_router_service.py).

- In process: two tiny-test engines register model `m` with their KV
  events on the control plane; the `RouterService` discovers them and
  registers `m-routed`; a plain round-robin consumer discovers the routed
  name and sends chats over two shared prefixes through it (wrapped in a
  `StreamRecorder`).  Every chat returns its tokens, equal to the JAX
  engine's greedy tokens; every repeat lands on the worker holding its
  prefix (prefix hits there, none on the other); the service's metrics
  count the streams.
- The CLI: `python -m dynamo_tpu_torch.router_service` against a TCP
  control plane and a mocker worker serves the routed name, advertises
  its metrics port, and exits on SIGTERM.

Tolerance: none; tokens and counts are exact.
"""

import asyncio
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import pytest

from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore, InferenceEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.discovery import (
    ModelWatcher,
    engine_wire_handler,
    register_llm,
)
from dynamo_tpu_torch.llm.kv_router.client import KV_EVENTS_SUBJECT
from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.perf import StreamRecorder
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.llm.service import LocalEngineClient, ModelManager
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.router_service import RouterService
from dynamo_tpu_torch.runtime.control_plane import InProcessControlPlane
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 8
GEOM = dict(max_seqs=8, block_size=BS, max_pages_per_seq=16,
            max_prefill_chunk=32, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16, 32))
PREFIX = {"a": list(range(100, 132)), "b": list(range(200, 232))}  # 4 blocks
CHATS = [(f"{p}{i}", PREFIX[p] + [i + 1, 7]) for i in range(3) for p in "ab"]
N_OUT = 5


@pytest.fixture(scope="module")
def weights():
    params = jax_init_params(jcfg.get_config("tiny-test"), jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def _jax_tokens(params):
    core = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=64,
        packed_prefill=True, scheduler=JaxSchedulerConfig(**GEOM)),
        params=params)
    out = {}
    for rid, toks in CHATS:
        core.add_request(rid, toks, JaxSamplingParams(max_tokens=N_OUT))
        while core._requests:
            for d in core.step():
                out.setdefault(d.request_id, []).extend(d.token_ids)
    return out


def test_router_service_routes_by_prefix_equal_jax(weights):
    params, state = weights
    want = _jax_tokens(params)

    async def main():
        cp = InProcessControlPlane()
        await cp.start()
        loop = asyncio.get_running_loop()
        workers, pumps, runtimes = {}, [], []
        for _ in range(2):
            rt = DistributedRuntime(cp)
            pending = []
            core = EngineCore(EngineConfig(
                model=tcfg.get_config("tiny-test"), num_blocks=64,
                device="cpu", scheduler=SchedulerConfig(**GEOM)),
                params=state,
                kv_event_sink=lambda ev, p=pending: loop.call_soon_threadsafe(
                    p.append, ev))
            engine = InferenceEngine(core)
            await engine.start()
            ep = rt.namespace("dynamo").component("backend").endpoint(
                "generate")
            inst = await ep.serve(engine_wire_handler(
                LocalEngineClient(engine)))
            await register_llm(ep, inst, ModelDeploymentCard(
                name="m", kv_block_size=BS))
            workers[inst.instance_id] = (core, engine)
            runtimes.append(rt)

            async def pump(pending=pending, iid=inst.instance_id):
                while True:
                    await asyncio.sleep(0.005)
                    while pending:
                        await cp.publish(KV_EVENTS_SUBJECT, RouterEvent(
                            worker_id=iid, event=pending.pop(0)).to_dict())

            pumps.append(asyncio.create_task(pump()))
        svc_rt, front = DistributedRuntime(cp), DistributedRuntime(cp)
        svc = RouterService(svc_rt, "m")
        models = ModelManager()
        watcher = ModelWatcher(front, models)      # plain round-robin
        out, placed = {}, {}
        try:
            await svc.start(wait_for_model_s=30)
            await watcher.start()
            await watcher.wait_for_model("m-routed", timeout=15)
            rec = StreamRecorder(models.get("m-routed").client)
            for rid, toks in CHATS:
                before = {i: c.scheduler.prefix_hit_tokens
                          for i, (c, _) in workers.items()}
                out[rid] = [t async for d in rec.generate(PreprocessedRequest(
                    request_id=rid, model="m-routed", token_ids=list(toks),
                    sampling=SamplingParams(max_tokens=N_OUT)))
                    for t in d.token_ids]
                placed[rid] = {i: c.scheduler.prefix_hit_tokens - before[i]
                               for i, (c, _) in workers.items()}
                await asyncio.sleep(0.05)          # let the events index
            assert svc.models.get("m") is not None
            text = svc.registry.expose()
            summary = rec.summary()
        finally:
            for t in pumps:
                t.cancel()
            await watcher.stop()
            await svc.stop()
            for _, engine in workers.values():
                await engine.stop()
            for rt in runtimes + [svc_rt, front]:
                await rt.shutdown()
            await cp.close()
        return out, placed, text, summary

    out, placed, text, summary = asyncio.run(asyncio.wait_for(main(), 120))
    assert out == want and all(len(v) == N_OUT for v in out.values())
    home = {}
    for rid, hits in placed.items():
        if rid[1] == "0":
            assert sum(hits.values()) == 0, (rid, hits)
            continue
        (w, n), = [(w, n) for w, n in hits.items() if n]
        assert n == len(PREFIX[rid[0]])
        assert home.setdefault(rid[0], w) == w
    assert f"dynamo_router_requests_total {float(len(CHATS))}" in text
    assert "dynamo_router_inflight_streams 0.0" in text
    assert summary["requests"] == len(CHATS)
    assert summary["output_tokens"] == N_OUT * len(CHATS)
    assert summary["ttft_p50"] > 0


def test_router_service_cli(tmp_path):
    """The CLI against a TCP control plane with a mocker worker."""
    from dynamo_tpu_torch.llm.mocker import MockEngine, MockEngineArgs
    from dynamo_tpu_torch.runtime.control_plane_tcp import (
        ControlPlaneClient,
        ControlPlaneServer,
    )

    async def main():
        srv = ControlPlaneServer()
        port = await srv.start()
        cp = ControlPlaneClient("127.0.0.1", port)
        await cp.start()
        rt = DistributedRuntime(cp)
        mock = MockEngine(MockEngineArgs(block_size=BS, speedup_ratio=100.0))
        await mock.start()
        ep = rt.namespace("dynamo").component("backend").endpoint("generate")
        inst = await ep.serve(engine_wire_handler(mock))
        await register_llm(ep, inst, ModelDeploymentCard(name="m",
                                                         kv_block_size=BS))
        log = open(tmp_path / "router.log", "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.router_service",
             "--control-plane", f"127.0.0.1:{port}", "--model-name", "m",
             "--serve-as", "m-kv", "--metrics-port", "0"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=log,
            stderr=subprocess.STDOUT, text=True)
        models = ModelManager()
        front = DistributedRuntime(cp)
        watcher = ModelWatcher(front, models)
        try:
            await watcher.start()
            await watcher.wait_for_model("m-kv", timeout=60)
            toks = [t async for d in models.get("m-kv").client.generate(
                PreprocessedRequest(request_id="r", model="m-kv",
                                    token_ids=list(range(1, 20)),
                                    sampling=SamplingParams(max_tokens=5)))
                for t in d.token_ids]
            assert len(toks) == 5
            entries = await cp.get_prefix("status_endpoints/")
            urls = [f"http://{e['address']}" for e in entries.values()
                    if e["component"] == "router"]
            assert urls
            body = urllib.request.urlopen(urls[0] + "/metrics",
                                          timeout=10).read().decode()
            assert "dynamo_router_requests_total 1.0" in body
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = await asyncio.to_thread(proc.wait, 30)
            await watcher.stop()
            await ep.leave()
            await mock.stop()
            await front.shutdown()
            await rt.shutdown()
            await cp.close()
            await srv.stop()
            log.seek(0)
            text = log.read()
            log.close()
        assert rc == 0, text[-2000:]
        assert "router service for 'm'" in text
        assert "router metrics on :" in text

    asyncio.run(asyncio.wait_for(main(), 120))
