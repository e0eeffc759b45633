"""The port's distributed runtime on the CPU (`dynamo_tpu_torch.runtime`).

- The wire codec: `packb` / `unpackb` round-trip a hypothesis-generated
  set of messages (dict, list, tuple, str, bytes, int up to u64, float,
  bool, None) to exactly the objects msgpack's `unpackb(raw=False)`
  gives; and the messages the port puts on the wire
  (`request_to_wire`, `RouterEvent.to_dict`, `ForwardPassMetrics.to_dict`)
  decode to the same objects as JAX's messages through its msgpack
  framing.  Exact equality, types included.
- The control plane, the RPC and the component model: the cases of
  `tests/test_runtime.py` on the port's modules (leases and TTL expiry,
  prefix watches, pub/sub, the TCP server and client and
  its reconnect, RPC streams, errors, cancellation and connection loss,
  serve / route / leave, the file backend).
- The layered config, the status server and the migration client.
"""

import asyncio
import json
import math
import urllib.error
import urllib.request

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu_torch.runtime.control_plane import (
    ControlPlaneState,
    InProcessControlPlane,
)
from dynamo_tpu_torch.runtime.control_plane_tcp import (
    ControlPlaneClient,
    ControlPlaneServer,
)
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime, NoInstancesError
from dynamo_tpu_torch.runtime.rpc import RpcClient, RpcError, RpcServer, packb, unpackb


def _run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _msgpack_roundtrip(obj):
    return msgpack.unpackb(msgpack.packb(obj, use_bin_type=True), raw=False)


def _same(a, b) -> bool:
    """Equal values of equal types, recursively (NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# -- wire codec --------------------------------------------------------------

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
            | st.floats(allow_nan=True, allow_infinity=True)
            | st.text() | st.binary())
_messages = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=6)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=8), inner, max_size=6)),
    max_leaves=40)


@settings(max_examples=300, deadline=None)
@given(_messages)
def test_codec_roundtrips_to_msgpacks_objects(msg):
    got = unpackb(packb(msg))
    assert _same(got, _msgpack_roundtrip(msg)), (msg, got)


def test_codec_keeps_bytes_str_and_u64_apart():
    msg = {"h": [0, (1 << 64) - 1, -(1 << 63)], "b": b"\x00\xff",
           "s": "ÿ", "t": (1, "x"), "n": None, "f": 0.5}
    got = unpackb(packb(msg))
    assert _same(got, _msgpack_roundtrip(msg))
    assert type(got["b"]) is bytes and type(got["s"]) is str
    assert got["t"] == [1, "x"]
    with pytest.raises(OverflowError):
        packb(1 << 64)
    with pytest.raises(TypeError):
        packb(np.int64(3))
    with pytest.raises(ValueError):
        unpackb(packb([1, 2, 3])[:-3])
    with pytest.raises(ValueError):
        unpackb(packb(1) + b"N")


def _jax_and_port_requests():
    from dynamo_tpu.engine.sampling import SamplingParams as JSP
    from dynamo_tpu.llm.preprocessor import PreprocessedRequest as JReq

    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest

    rng = np.random.default_rng(0)
    for i in range(8):
        toks = rng.integers(0, 128256, int(rng.integers(1, 300))).tolist()
        kw = dict(temperature=float(rng.uniform(0, 2)) if i % 2 else 0.0,
                  top_k=int(rng.integers(0, 50)),
                  top_p=float(rng.uniform(0.1, 1.0)),
                  max_tokens=int(rng.integers(1, 512)),
                  stop_token_ids=tuple(int(x) for x in
                                       rng.integers(0, 256, i % 3)),
                  seed=None if i % 3 == 0 else int(rng.integers(0, 2 ** 31)),
                  logprobs=bool(i % 4 == 1), seed_offset=i)
        common = dict(request_id=f"chatcmpl-{i}", model="m", token_ids=toks,
                      stop_sequences=["\n\n"] if i % 2 else [],
                      annotations={"formatted_prompt": f"p{i}"})
        yield (JReq(sampling=JSP(**kw), **common),
               PreprocessedRequest(sampling=SamplingParams(**kw), **common))


def test_port_messages_decode_as_jax_msgpack_messages():
    """request_to_wire, RouterEvent.to_dict and ForwardPassMetrics.to_dict
    of the port, through the port's codec, equal JAX's through msgpack
    (exact, types included), and decode back to equal objects."""
    from dynamo_tpu.llm import discovery as jdisc
    from dynamo_tpu.llm.kv_router import protocols as jp

    from dynamo_tpu_torch.llm import discovery as tdisc
    from dynamo_tpu_torch.llm.kv_router import protocols as tp

    for jreq, treq in _jax_and_port_requests():
        got = unpackb(packb(tdisc.request_to_wire(treq)))
        assert _same(got, _msgpack_roundtrip(jdisc.request_to_wire(jreq)))
        back = tdisc.request_from_wire(got)
        assert back == treq

    rng = np.random.default_rng(1)
    for i in range(12):
        hashes = rng.integers(0, 2 ** 64, 1 + i % 4, dtype=np.uint64).tolist()
        parent = None if i % 3 == 0 else int(rng.integers(0, 2 ** 64,
                                                           dtype=np.uint64))
        kinds = [("stored", (hashes, parent)), ("removed", (hashes,)),
                 ("cleared", ())]
        name, args = kinds[i % 3]
        jev = jp.RouterEvent(worker_id=i, event=jp.KvCacheEvent(
            event_id=i + 1, data=getattr(jp.KvCacheEventData, name)(*args)))
        tev = tp.RouterEvent(worker_id=i, event=tp.KvCacheEvent(
            event_id=i + 1, data=getattr(tp.KvCacheEventData, name)(*args)))
        got = unpackb(packb(tev.to_dict()))
        assert _same(got, _msgpack_roundtrip(jev.to_dict()))
        # A tuple of hashes comes back as a list: compare on the wire.
        assert packb(tp.RouterEvent.from_dict(got).to_dict()) == packb(
            tev.to_dict())
        assert all(type(h) is int for h in hashes)

        kw = dict(
            worker_stats=dict(request_active_slots=i, request_total_slots=64,
                              num_requests_waiting=i % 5),
            kv_stats=dict(kv_active_blocks=3 * i, kv_total_blocks=511,
                          gpu_cache_usage_perc=i / 12,
                          gpu_prefix_cache_hit_rate=1 / (i + 1)),
            expert_load=None if i % 2 else [int(x) for x in
                                            rng.integers(0, 1000, 9)],
            moe_dropped_tokens=i % 2)
        jm = jp.ForwardPassMetrics.from_dict(kw)
        tm = tp.ForwardPassMetrics.from_dict(kw)
        got = unpackb(packb(tm.to_dict()))
        assert _same(got, _msgpack_roundtrip(jm.to_dict()))
        assert tp.ForwardPassMetrics.from_dict(got) == tm


# -- control plane state -----------------------------------------------------


def test_kv_lease_expiry_removes_keys():
    async def main():
        st_ = ControlPlaneState()
        lease = st_.lease_grant(ttl=0.05)
        st_.put("instances/ns/c/e:1", {"x": 1}, lease=lease)
        st_.put("persistent", {"y": 2})
        assert st_.get("instances/ns/c/e:1") == {"x": 1}
        await asyncio.sleep(0.1)
        st_.expire_leases()
        assert st_.get("instances/ns/c/e:1") is None
        assert st_.get("persistent") == {"y": 2}

    _run(main())


def test_watch_sees_existing_and_new():
    async def main():
        cp = InProcessControlPlane()
        await cp.start()
        try:
            await cp.put("pre/a", {"v": 1})
            w = await cp.watch_prefix("pre/")
            ev = await w.next()
            assert (ev.kind, ev.key, ev.value) == ("put", "pre/a", {"v": 1})
            await cp.put("pre/b", {"v": 2})
            ev = await w.next()
            assert ev.key == "pre/b"
            await cp.delete("pre/a")
            ev = await w.next()
            assert (ev.kind, ev.key) == ("delete", "pre/a")
        finally:
            await cp.close()

    _run(main())


def test_pubsub_fans_out_to_every_subscriber():
    async def main():
        cp = InProcessControlPlane()
        await cp.start()
        try:
            a = await cp.subscribe("kv_events")
            b = await cp.subscribe("kv_events")
            await cp.publish("kv_events", {"n": 1})
            assert await a.next() == {"n": 1} == await b.next()
            b.cancel()
            await cp.publish("kv_events", {"n": 2})
            assert await a.next() == {"n": 2}
            assert cp.state.publish("kv_events", {"n": 3}) == 1
        finally:
            await cp.close()

    _run(main())


# -- TCP control plane -------------------------------------------------------


def test_tcp_control_plane_roundtrip():
    async def main():
        srv = ControlPlaneServer()
        port = await srv.start()
        c1 = ControlPlaneClient("127.0.0.1", port)
        c2 = ControlPlaneClient("127.0.0.1", port)
        await c1.start()
        await c2.start()
        try:
            w = await c2.watch_prefix("m/")
            lease = await c1.lease_grant(ttl=5.0)
            await c1.put("m/x", {"addr": "h:1"}, lease=lease)
            ev = await w.next()
            assert (ev.kind, ev.key, ev.value) == ("put", "m/x", {"addr": "h:1"})
            assert await c2.get("m/x") == {"addr": "h:1"}
            assert await c2.get_prefix("m/") == {"m/x": {"addr": "h:1"}}

            # Lease revoke propagates as a delete event.
            await c1.lease_revoke(lease)
            ev = await w.next()
            assert (ev.kind, ev.key) == ("delete", "m/x")

            # Pub/sub across clients; u64 block hashes stay ints.
            sub = await c2.subscribe("s")
            await c1.publish("s", {"k": 9, "h": [(1 << 64) - 1]})
            assert await sub.next() == {"k": 9, "h": [(1 << 64) - 1]}

            # A failed op answers an error; the connection survives it.
            with pytest.raises(RuntimeError, match="unknown lease"):
                await c1.put("m/y", {}, lease=12345)
            assert await c1.get("m/y") is None
        finally:
            await c1.close()
            await c2.close()
            await srv.stop()

    _run(main())


def test_tcp_lease_ttl_expires_dead_client():
    async def main():
        srv = ControlPlaneServer()
        port = await srv.start()
        c1 = ControlPlaneClient("127.0.0.1", port)
        await c1.start()
        lease = await c1.lease_grant(ttl=0.2, auto_keepalive=False)
        await c1.put("inst/a:1", {"x": 1}, lease=lease)
        # Worker death: close without revoke; the TTL reaps the key.
        await c1.close()
        await asyncio.sleep(1.5)   # reaper interval 1 s + ttl
        c2 = ControlPlaneClient("127.0.0.1", port)
        await c2.start()
        try:
            assert await c2.get("inst/a:1") is None
        finally:
            await c2.close()
            await srv.stop()

    _run(main())


def test_tcp_client_reconnects_and_restores_streams():
    """Connection loss → the client reconnects with backoff and restores
    its watches and subscriptions under their original sids; consumers
    see ONE ConnectionError per outage and then resume."""

    async def main():
        server = ControlPlaneServer()
        port = await server.start()
        client = ControlPlaneClient("127.0.0.1", port)
        await client.start()
        sub = await client.subscribe("events")
        watch = await client.watch_prefix("models/")
        await client.put("models/a", {"v": 1})
        ev = await asyncio.wait_for(watch.next(), 5)
        assert ev.key == "models/a"
        await client.publish("events", {"n": 1})
        assert (await asyncio.wait_for(sub.next(), 5))["n"] == 1

        state = server.state
        await server.stop()
        with pytest.raises(ConnectionError):
            await asyncio.wait_for(sub.next(), 5)
        with pytest.raises(ConnectionError):
            await asyncio.wait_for(watch.next(), 5)

        server2 = ControlPlaneServer(state)
        await server2.start(port=port)
        deadline = asyncio.get_running_loop().time() + 10
        ev = await asyncio.wait_for(watch.next(), 10)
        assert ev.key == "models/a" and ev.value == {"v": 1}
        pub = ControlPlaneClient("127.0.0.1", port)
        while True:
            try:
                await pub.start()
                break
            except OSError:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.1)
        await pub.publish("events", {"n": 2})
        assert (await asyncio.wait_for(sub.next(), 10))["n"] == 2
        await pub.close()
        await client.close()
        await server2.stop()

    _run(main())


def _unused_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tcp_client_start_waits_for_a_late_server():
    """A process started beside its control plane (the entry points pass
    `STARTUP_WAIT_S`) dials until the server listens."""
    async def main():
        port = _unused_port()
        client = ControlPlaneClient("127.0.0.1", port)
        dial = asyncio.ensure_future(client.start(wait_s=10.0))
        await asyncio.sleep(0.3)
        assert not dial.done()
        srv = ControlPlaneServer()
        await srv.start(port=port)
        try:
            await asyncio.wait_for(dial, 10)
            await client.put("k", {"v": 1})
            assert await client.get("k") == {"v": 1}
        finally:
            await client.close()
            await srv.stop()

    _run(main())


@pytest.mark.parametrize("wait_s", [0.0, 0.3])
def test_tcp_client_start_gives_up_after_its_wait(wait_s):
    async def main():
        client = ControlPlaneClient("127.0.0.1", _unused_port())
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        with pytest.raises(OSError):
            await client.start(wait_s=wait_s)
        assert wait_s <= loop.time() - t0 < wait_s + 5.0

    _run(main())


def test_kv_file_backend_persists_unleased_only(tmp_path):
    from dynamo_tpu_torch.runtime.kv_store import FileBackend, make_backend

    path = str(tmp_path / "kv.json")

    async def main():
        state = ControlPlaneState(backend=FileBackend(path))
        cp = InProcessControlPlane(state)
        await cp.start()
        lease = await cp.lease_grant(ttl=5.0, auto_keepalive=False)
        await cp.put("config/ns", {"max_local_prefill_length": 64})
        await cp.put("instances/ns/backend/gen:1", {"addr": "x"},
                     lease=lease)
        await cp.close()

        cp2 = InProcessControlPlane(ControlPlaneState(backend=FileBackend(path)))
        await cp2.start()
        assert await cp2.get("config/ns") == {"max_local_prefill_length": 64}
        assert await cp2.get("instances/ns/backend/gen:1") is None
        await cp2.delete("config/ns")
        await cp2.close()
        assert ControlPlaneState(backend=FileBackend(path)).get(
            "config/ns") is None

    _run(main())
    assert type(make_backend(None)).__name__ == "MemoryBackend"
    assert type(make_backend(f"file:{path}")).__name__ == "FileBackend"
    with pytest.raises(ValueError):
        make_backend("redis://nope")


# -- rpc ---------------------------------------------------------------------


def test_rpc_stream_and_error():
    async def main():
        srv = RpcServer()

        async def echo3(payload):
            for i in range(3):
                yield {"i": i, "msg": payload["msg"], "raw": payload["raw"]}

        async def boom(payload):
            yield {"ok": 1}
            raise ValueError("kaboom")

        srv.register("ns/c/echo", echo3)
        srv.register("ns/c/boom", boom)
        addr = await srv.start()
        client = RpcClient(addr)
        try:
            got = [d async for d in client.call(
                "ns/c/echo", {"msg": "hi", "raw": b"\x01\x02"})]
            assert got == [{"i": i, "msg": "hi", "raw": b"\x01\x02"}
                           for i in range(3)]
            with pytest.raises(RpcError, match="kaboom"):
                async for d in client.call("ns/c/boom", {}):
                    assert d == {"ok": 1}
            with pytest.raises(RpcError, match="no such endpoint"):
                async for _ in client.call("ns/c/missing", {}):
                    pass
        finally:
            await client.close()
            await srv.stop()

    _run(main())


def test_rpc_cancellation_stops_handler():
    async def main():
        srv = RpcServer()
        cancelled = asyncio.Event()

        async def slow(payload):
            try:
                for i in range(1000):
                    yield {"i": i}
                    await asyncio.sleep(0.01)
            except asyncio.CancelledError:
                cancelled.set()
                raise

        srv.register("e", slow)
        addr = await srv.start()
        client = RpcClient(addr)
        try:
            agen = client.call("e", {})
            assert await agen.__anext__() == {"i": 0}
            await agen.aclose()          # the client walks away
            await asyncio.wait_for(cancelled.wait(), 5)
        finally:
            await client.close()
            await srv.stop()

    _run(main())


def test_rpc_connection_loss_surfaces():
    async def main():
        srv = RpcServer()

        async def forever(payload):
            yield {"first": True}
            await asyncio.sleep(3600)

        srv.register("e", forever)
        addr = await srv.start()
        client = RpcClient(addr)
        try:
            agen = client.call("e", {})
            assert await agen.__anext__() == {"first": True}
            await srv.stop()             # the worker dies mid-stream
            with pytest.raises(ConnectionError):
                await agen.__anext__()
        finally:
            await client.close()

    _run(main())


# -- component model ---------------------------------------------------------


def test_component_serve_route_and_leave():
    async def main():
        cp = InProcessControlPlane(ControlPlaneState())
        await cp.start()
        w1, w2 = DistributedRuntime(cp), DistributedRuntime(cp)
        frontend = DistributedRuntime(cp)

        def make_handler(tag):
            async def handler(payload):
                yield {"from": tag, "echo": payload["x"]}
            return handler

        ep1 = w1.namespace("dyn").component("backend").endpoint("generate")
        ep2 = w2.namespace("dyn").component("backend").endpoint("generate")
        await ep1.serve(make_handler("w1"))
        await ep2.serve(make_handler("w2"))

        client = await (frontend.namespace("dyn").component("backend")
                        .endpoint("generate").client())
        await client.wait_for_instances()
        assert len(client.instance_ids()) == 2

        sources = set()
        for i in range(4):
            async for d in client.generate({"x": i}):
                sources.add(d["from"])
        assert sources == {"w1", "w2"}

        iid = client.instance_ids()[0]
        async for d in client.direct({"x": 9}, iid):
            assert d["echo"] == 9

        await ep1.leave()
        await asyncio.sleep(0.05)
        assert len(client.instance_ids()) == 1
        async for d in client.generate({"x": 5}):
            assert d["from"] == "w2"

        await ep2.leave()
        await asyncio.sleep(0.05)
        with pytest.raises(NoInstancesError):
            async for _ in client.generate({"x": 0}):
                pass

        await client.stop()
        for rt in (w1, w2, frontend):
            await rt.shutdown()
        await cp.close()

    _run(main())


# -- config, status server, migration ---------------------------------------


def test_layered_config_precedence(tmp_path, monkeypatch):
    """defaults < dynamo.toml (top level, then [worker]) < DYN_* env <
    CLI flags."""
    from dynamo_tpu_torch.worker.main import parse_args

    toml = tmp_path / "dynamo.toml"
    toml.write_text('block_size = 16\nnamespace = "top"\n'
                    '[worker]\nnamespace = "sec"\nnum_blocks = 99\n')
    monkeypatch.setenv("DYN_CONFIG", str(toml))
    monkeypatch.setenv("DYN_NUM_BLOCKS", "77")
    monkeypatch.setenv("DYN_CONTROL_PLANE", "127.0.0.1:1")
    args = parse_args([])
    assert (args.block_size, args.namespace, args.num_blocks,
            args.control_plane) == (16, "sec", 77, "127.0.0.1:1")
    args = parse_args(["--num-blocks", "5"])
    assert args.num_blocks == 5
    monkeypatch.delenv("DYN_CONTROL_PLANE")
    monkeypatch.delenv("DYN_CONFIG")
    with pytest.raises(SystemExit):
        parse_args([])


def test_status_server_routes():
    from dynamo_tpu_torch.runtime.status import StatusServer

    state = {"ready": False, "resets": 0}

    def reset():
        state["resets"] += 1

    async def main():
        srv = StatusServer(ready_fn=lambda: state["ready"],
                           stats_fn=lambda: {"n": 1}, reset_fn=reset)
        port = await srv.start()
        base = f"http://127.0.0.1:{port}"

        def get(path, data=None):
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        base + path, data=data), timeout=10) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        try:
            res = await asyncio.to_thread(
                lambda: [get("/live"), get("/health")])
            state["ready"] = True
            res += await asyncio.to_thread(
                lambda: [get("/health"), get("/debug/stats"),
                         get("/debug/stats/reset", b"{}"), get("/nope")])
        finally:
            await srv.stop()
        return res

    res = _run(main())
    assert res == [(200, {"status": "live"}), (503, {"status": "starting"}),
                   (200, {"status": "ready"}), (200, {"n": 1}),
                   (200, {"ok": True}),
                   (404, {"error": "GET /nope not served"})]
    assert state["resets"] == 1


def test_migration_resumes_with_prompt_plus_tokens():
    """A stream that dies mid-way re-issues prompt + tokens so far with the
    budget and seed offset moved on; the caller sees one stream."""
    from dynamo_tpu_torch.engine.engine import TokenDelta
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import FinishReason
    from dynamo_tpu_torch.llm.migration import MigrationClient
    from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest

    seen = []

    class Flaky:
        async def generate(self, req):
            seen.append(req)
            if len(seen) == 1:
                yield TokenDelta(req.request_id, [7, 8])
                raise ConnectionError("worker died")
            if len(seen) == 2:
                raise NoInstancesError("none yet")
                yield  # an async generator
            n = req.sampling.max_tokens
            yield TokenDelta(req.request_id, list(range(n)), finished=True,
                             finish_reason=FinishReason.LENGTH)

    async def main():
        mc = MigrationClient(Flaky(), migration_limit=3, retry_delay=0.001)
        req = PreprocessedRequest("r", "m", [1, 2, 3],
                                  SamplingParams(max_tokens=5, seed=4))
        out = [d async for d in mc.generate(req)]
        return mc, out

    mc, out = _run(main())
    assert [t for d in out for t in d.token_ids] == [7, 8, 0, 1, 2]
    assert out[-1].finish_reason is FinishReason.LENGTH
    assert mc.migrations == 2
    last = seen[-1]
    assert last.token_ids == [1, 2, 3, 7, 8]
    assert last.request_id == "r#m2"
    assert (last.sampling.max_tokens, last.sampling.seed_offset,
            last.sampling.seed) == (3, 2, 4)

    class Dead:
        async def generate(self, req):
            raise ConnectionError("gone")
            yield

    async def exhaust():
        mc = MigrationClient(Dead(), migration_limit=1, retry_delay=0.001)
        async for _ in mc.generate(seen[0]):
            pass

    with pytest.raises(ConnectionError, match="budget exhausted"):
        _run(exhaust())
