"""The port's `runtime/tracing.py` against `dynamo_tpu/runtime/tracing.py`
on the CPU.

- `TraceContext` round-trips across the two packages both ways (the wire
  dict, and through the port's RPC codec), and a malformed wire form is
  None in both.
- The head-sampling decision (`_sample_decision`, crc32 of the trace id)
  is equal over seeded trace ids and rates.
- One scripted sequence of spans (nested, remote-parented, recorded from
  timestamps, unsampled, slow) leaves the same traces in both tracers:
  names, parent names, attrs, drop counters; `chrome_trace` gives equal
  event lists for equal payloads.
- One chat through a frontend (HTTP service, KV router) and a CPU worker
  (RPC endpoint, engine) in process: the spans' names and parent chain
  are JAX's for the same path.
"""

import asyncio
import json
import urllib.request

import jax
import numpy as np
import pytest

from dynamo_tpu.runtime import tracing as jt
from dynamo_tpu_torch.runtime import rpc as trpc
from dynamo_tpu_torch.runtime import tracing as tt

from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_tracers():
    for mod in (jt, tt):
        mod.get_tracer().configure(enabled=False, sampling=1.0)
        mod.get_tracer().slow_ms = None
        mod.get_tracer().reset()
    yield
    for mod in (jt, tt):
        mod.get_tracer().configure(enabled=False, sampling=1.0)
        mod.get_tracer().slow_ms = None
        mod.get_tracer().reset()


def test_trace_context_round_trips_across_packages():
    rng = np.random.default_rng(0)
    for _ in range(50):
        tid = rng.bytes(8).hex()
        sid = rng.bytes(8).hex()
        sampled = bool(rng.integers(2))
        for src, dst in ((jt, tt), (tt, jt)):
            ctx = src.TraceContext(tid, sid, None, sampled)
            wire = ctx.to_wire()
            assert wire == dst.TraceContext(tid, sid, None,
                                            sampled).to_wire()
            back = dst.TraceContext.from_wire(
                trpc.unpackb(trpc.packb(wire)))
            assert (back.trace_id, back.span_id, back.parent_id,
                    back.sampled) == (tid, sid, None, sampled)
    for bad in (None, "x", {}, {"trace_id": "a"}, {"span_id": "b"}, [1, 2]):
        assert jt.TraceContext.from_wire(bad) is None
        assert tt.TraceContext.from_wire(bad) is None


def test_sampling_decisions_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(2000):
        tid = rng.bytes(int(rng.integers(1, 24))).hex()
        rate = float(rng.choice([0.0, 1.0, rng.uniform(), 1.5, -0.1]))
        assert tt._sample_decision(tid, rate) == jt._sample_decision(tid, rate)


def _script(mod):
    """The same span operations on one package's fresh tracer; returns
    its completed traces with ids replaced by span names."""
    tr = mod.Tracer("svc", enabled=True, sampling=0.5, ring_size=8,
                    slow_ms=50.0, max_spans_per_trace=6)
    out = []
    for i in range(12):
        tid = f"trace-{i}"
        root = tr.start_span("http.chat", trace_id=tid, attrs={"i": i})
        tok = mod.use_span(root) if root.ctx is not None else None
        with tr.start_span("frontend.preprocess"):
            pass
        remote = (mod.TraceContext.from_wire(root.ctx.to_wire())
                  if root.ctx is not None else None)
        if remote is not None:
            server = tr.start_span("rpc.server:gen", remote)
            tr.bind(tid, server.ctx)
            tr.record_span("engine.ttft", tr.ctx_for(tid), 0.0,
                           attrs={"request_id": tid})
            for k in range(6):     # past max_spans_per_trace
                tr.start_span(f"work{k}", server).end(k=k)
            server.end()
            tr.unbind(tid)
        if tok is not None:
            mod.restore(tok)
        if i == 5:
            root.start_mono -= 1.0   # a slow root: force-sampled
        root.end(done=True)
    for trace in tr.completed():
        names = {s["span_id"]: s["name"] for s in trace["spans"]}
        out.append({
            "trace_id": trace["trace_id"],
            "spans": sorted((s["name"], names.get(s["parent_id"]),
                             json.dumps(s["attrs"], sort_keys=True))
                            for s in trace["spans"]),
            "dropped": trace.get("spans_dropped"),
            "slow": trace.get("forced_slow_sample")})
    stats = (tr.spans_recorded, tr.traces_dropped_unsampled,
             tr.traces_forced_slow)
    return out, stats, tr.completed()


def test_tracer_sequence_and_chrome_trace_match_jax():
    jout, jstats, jraw = _script(jt)
    tout, tstats, _ = _script(tt)
    assert tout == jout and tstats == jstats
    assert any(t["slow"] for t in jout) and any(t["dropped"] for t in jout)
    assert tt.chrome_trace(jraw) == jt.chrome_trace(jraw)
    payload = tt.debug_traces_payload(4, tt.Tracer("w", enabled=True))
    assert set(payload) == set(jt.debug_traces_payload(4, jt.Tracer("w")))


# ---------------------------------------------------------------------------
# One chat through frontend and worker, in process, in both packages.

GEOM = dict(max_seqs=4, block_size=8, max_pages_per_seq=32,
            max_prefill_chunk=128, decode_buckets=(1, 2, 4),
            prefill_buckets=(16, 128))


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


async def _chat_through(pkg, core):
    """Control plane, a worker serving `core` over RPC, a frontend with
    discovery and the KV router; one unary chat.  Returns the tracer's
    completed traces."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    tcp = mod("runtime.control_plane_tcp")
    dist = mod("runtime.distributed")
    disc = mod("llm.discovery")
    svc_mod = mod("llm.service")
    http = mod("llm.http_service")
    card = mod("llm.model_card")
    eng = mod("engine.engine")
    tracer = mod("runtime.tracing").get_tracer()
    tracer.configure(enabled=True, sampling=1.0)

    server = tcp.ControlPlaneServer()
    port = await server.start()
    wcp = tcp.ControlPlaneClient("127.0.0.1", port)
    await wcp.start()
    wrt = dist.DistributedRuntime(wcp)
    engine = eng.InferenceEngine(core)
    await engine.start()
    endpoint = wrt.namespace("dynamo").component("backend").endpoint(
        "generate")
    instance = await endpoint.serve(
        disc.engine_wire_handler(svc_mod.LocalEngineClient(engine)))
    await disc.register_llm(endpoint, instance, card.ModelDeploymentCard(
        name="m", kv_block_size=8))
    fcp = tcp.ControlPlaneClient("127.0.0.1", port)
    await fcp.start()
    frt = dist.DistributedRuntime(fcp)
    models = svc_mod.ModelManager()
    watcher = disc.ModelWatcher(frt, models, router_mode="kv")
    await watcher.start()
    svc = http.HttpService(models)
    http_port = await svc.start()
    try:
        for _ in range(400):
            if len(models):
                break
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.3)   # the router's instance watch
        await asyncio.to_thread(
            _post, f"http://127.0.0.1:{http_port}/v1/chat/completions",
            {"model": "m", "max_tokens": 6, "temperature": 0,
             "messages": [{"role": "user", "content": "hello trace"}]})
        for _ in range(200):
            if tracer.completed():
                break
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.2)
        return tracer.completed()
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


def _chain(traces):
    """(span name, parent span name) pairs of the request's trace; the
    per-token decode.tpot spans are collapsed (their count follows the
    engine's window and the stream's chunking)."""
    assert len(traces) == 1, [t["trace_id"] for t in traces]
    spans = traces[0]["spans"]
    assert len({s["trace_id"] for s in spans}) == 1
    names = {s["span_id"]: s["name"] for s in spans}
    return sorted({(s["name"], names.get(s["parent_id"])) for s in spans})


def test_one_chat_span_chain_matches_jax(pinned_engine_clocks):
    from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
    from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSched
    from dynamo_tpu.models import config as jcfg
    from dynamo_tpu.models.llama import init_params
    from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.models import config as tcfg
    from dynamo_tpu_torch.models.weights import from_jax_params

    params = init_params(jcfg.get_config("tiny-test"), jax.random.key(0))
    jcore = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=128,
        scheduler=JaxSched(**GEOM)), params=params)
    tcore = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=128, device="cpu",
        scheduler=SchedulerConfig(**GEOM)),
        params=from_jax_params(jax.device_get(params), "cpu"))
    jchain = _chain(asyncio.run(_chat_through("dynamo_tpu", jcore)))
    tchain = _chain(asyncio.run(_chat_through("dynamo_tpu_torch", tcore)))
    assert tchain == jchain
    assert ("rpc.server:dynamo/backend/generate",
            "rpc.client:dynamo/backend/generate") in tchain
    assert ("engine.ttft", "rpc.server:dynamo/backend/generate") in tchain
    assert ("router.select", "http.chat") in tchain
