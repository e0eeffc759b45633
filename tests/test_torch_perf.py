"""The port's stream recorder and event record/replay (`llm/perf.py`)
against the JAX package's (the scenarios of tests/test_perf.py), on the
CPU.

- `StreamRecorder` over a client that streams on a scripted clock: the
  per-request timings and `summary()` equal JAX's on the same timelines,
  and a live stream's timings are sane.
- `JsonlRecorder` / `replay_jsonl` round-trip, and a file written by one
  package replays in the other.
- KV events recorded off the port's control plane rebuild, on replay,
  the live router's index; the same recording replayed into JAX's router
  gives the same overlap scores.

Tolerance: none; everything is exact.
"""

import asyncio

import pytest

from dynamo_tpu.engine.engine import TokenDelta as JaxTokenDelta
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.llm import perf as jperf
from dynamo_tpu.llm.kv_router.router import KvRouter as JaxKvRouter
from dynamo_tpu.llm.kv_router.router import KvRouterConfig as JaxKvRouterConfig
from dynamo_tpu.llm.preprocessor import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.llm import perf as tperf
from dynamo_tpu_torch.llm.kv_router.protocols import (
    KvCacheEvent,
    KvCacheEventData,
    RouterEvent,
)
from dynamo_tpu_torch.llm.kv_router.router import KvRouter, KvRouterConfig
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.runtime.control_plane import InProcessControlPlane


class _Clock:
    """A module's `time` with a scripted monotonic clock."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now

    def time(self):
        return self.now


class _Scripted:
    """Streams `gaps` (seconds before each delta, tokens in it) on the
    clock, the last delta finishing the stream."""

    def __init__(self, clock, timelines, delta_cls):
        self.clock, self.timelines, self.delta_cls = clock, timelines, delta_cls

    async def generate(self, request):
        steps = self.timelines[request.request_id]
        for i, (gap, n) in enumerate(steps):
            self.clock.now += gap
            yield self.delta_cls(request.request_id, list(range(n)),
                                 finished=(i == len(steps) - 1))


TIMELINES = {
    "a": [(0.25, 1), (0.03, 1), (0.05, 2), (0.02, 1)],
    "b": [(0.5, 0), (0.1, 3), (0.04, 1)],
    "c": [(0.07, 1)],
    "d": [(0.0, 0)],                         # no token at all
}


@pytest.mark.parametrize("order", [["a", "b", "c", "d"], ["d", "c", "b", "a"]])
def test_stream_recorder_equal_jax_on_scripted_timelines(monkeypatch, order):
    results = []
    for mod, delta_cls, req_cls, sp in (
            (tperf, TokenDelta, PreprocessedRequest, SamplingParams),
            (jperf, JaxTokenDelta, JaxRequest, JaxSamplingParams)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        rec = mod.StreamRecorder(_Scripted(clock, TIMELINES, delta_cls))

        async def main():
            for rid in order:
                async for _ in rec.generate(req_cls(
                        request_id=rid, model="m", token_ids=[1, 2],
                        sampling=sp(max_tokens=5))):
                    clock.now += 0.001
        asyncio.run(main())
        results.append((
            {rid: (t.start, t.arrivals, t.tokens, t.finished, t.ttft,
                   t.itls, t.output_tokens, t.duration)
             for rid, t in rec.timings.items()},
            rec.summary()))
    assert results[0] == results[1]
    summary = results[0][1]
    assert summary["requests"] == 3 and summary["output_tokens"] == 10
    assert summary["ttft_p50"] > 0 and summary["tok_s"] > 0


def test_stream_recorder_live_timings():
    class Slow:
        async def generate(self, request):
            for i in range(5):
                await asyncio.sleep(0.01)
                yield TokenDelta(request.request_id, [i], finished=(i == 4))

    async def main():
        rec = tperf.StreamRecorder(Slow())
        for rid in ("a", "b"):
            async for _ in rec.generate(PreprocessedRequest(
                    request_id=rid, model="m", token_ids=[1, 2],
                    sampling=SamplingParams(max_tokens=5))):
                pass
        t = rec.timings["a"]
        assert t.finished and t.output_tokens == 5
        assert t.ttft >= 0.005 and len(t.itls) == 4
        assert all(x >= 0.005 for x in t.itls)
        s = rec.summary()
        assert s["requests"] == 2 and s["output_tokens"] == 10
        assert s["itl_p50"] >= 0.005 and s["tok_s"] > 0

    asyncio.run(main())


def test_jsonl_roundtrip_and_cross_replay(tmp_path):
    for writer, reader in ((tperf, tperf), (tperf, jperf), (jperf, tperf)):
        path = str(tmp_path / f"{writer.__name__}-{reader.__name__}.jsonl")
        rec = writer.JsonlRecorder(path)
        rec.record("a", {"x": 1})
        rec.record("b", {"y": [1, 2]})
        assert rec.count == 2
        rec.close()
        events = list(reader.replay_jsonl(path))
        assert [(k, p) for _, k, p in events] == [("a", {"x": 1}),
                                                 ("b", {"y": [1, 2]})]
        assert events[0][0] <= events[1][0]


def _stored(eid, hashes, parent=None, worker=7):
    return RouterEvent(worker_id=worker, event=KvCacheEvent(
        event_id=eid, data=KvCacheEventData.stored(hashes,
                                                   parent_hash=parent)))


def test_kv_event_record_and_replay_equal_jax(tmp_path):
    """Events published on the port's control plane, recorded, rebuild the
    live router's index on replay; JAX's router replaying the same file
    scores every probe the same."""
    path = str(tmp_path / "kv.jsonl")
    evs = [_stored(1, [101, 102]), _stored(2, [103], parent=102),
           _stored(3, [201, 202], worker=9),
           RouterEvent(worker_id=7, event=KvCacheEvent(
               event_id=4, data=KvCacheEventData.removed([103])))]

    async def main():
        cp = InProcessControlPlane()
        await cp.start()
        task = await tperf.record_kv_events(cp, path)
        live = KvRouter(KvRouterConfig(block_size=8))
        for ev in evs:
            live.apply_event(ev)
            await cp.publish("kv_events", ev.to_dict())
        await asyncio.sleep(0.1)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        await cp.close()
        return live

    live = asyncio.run(main())
    replayed = KvRouter(KvRouterConfig(block_size=8))
    jrouter = JaxKvRouter(JaxKvRouterConfig(block_size=8))
    assert tperf.replay_kv_events(path, replayed) == len(evs)
    assert jperf.replay_kv_events(path, jrouter) == len(evs)
    for h in ([101], [101, 102], [101, 102, 103], [201, 202], [999]):
        want = live.indexer.find_matches(h).scores
        assert replayed.indexer.find_matches(h).scores == want
        assert dict(jrouter.indexer.find_matches(h).scores) == dict(want)
