"""Perf recording + event record/replay (port of `dynamo_tpu/llm/perf.py`).

Role of the reference's `lib/llm/src/perf.rs` (stream timing recorder:
per-response arrival timestamps), `recorder.rs` (JSONL event recorder)
and `kv_router/recorder.rs` (KV-event record + replay into an indexer).

- `StreamRecorder` wraps any EngineClient and records, per request, the
  arrival time of every token delta: TTFT, ITLs, and summary percentiles
  come out of the raw timeline, not from pre-aggregated histograms — the
  difference matters when diagnosing tail stalls (the reference keeps
  raw arrivals for the same reason, `perf.rs:1-30`).
- `JsonlRecorder` appends timestamped events to a JSONL file and
  `replay_jsonl` streams them back.
- `record_kv_events` subscribes a control plane's `kv_events` subject
  into a JSONL file; `replay_kv_events` feeds a recording back into a
  KvRouter/KvIndexer — reproducing a production routing state offline.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, List, Optional

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Stream timing


@dataclass
class StreamTiming:
    """Raw per-request timeline (monotonic seconds)."""

    request_id: str
    start: float
    arrivals: List[float] = field(default_factory=list)  # per-delta times
    tokens: List[int] = field(default_factory=list)      # tokens per delta
    finished: bool = False

    @property
    def ttft(self) -> Optional[float]:
        return self.arrivals[0] - self.start if self.arrivals else None

    @property
    def itls(self) -> List[float]:
        return [b - a for a, b in zip(self.arrivals, self.arrivals[1:])]

    @property
    def output_tokens(self) -> int:
        return sum(self.tokens)

    @property
    def duration(self) -> Optional[float]:
        return self.arrivals[-1] - self.start if self.arrivals else None


def _pct(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    idx = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
    return s[idx]


class StreamRecorder:
    """EngineClient decorator recording stream timings."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.timings: Dict[str, StreamTiming] = {}

    async def generate(self, request) -> AsyncIterator:
        t = StreamTiming(request_id=request.request_id,
                         start=time.monotonic())
        self.timings[request.request_id] = t
        async for delta in self.inner.generate(request):
            if delta.token_ids:
                t.arrivals.append(time.monotonic())
                t.tokens.append(len(delta.token_ids))
            if delta.finished:
                t.finished = True
            yield delta

    def summary(self) -> dict:
        """Aggregate percentiles across recorded streams (the numbers the
        reference's profiler tables report: TTFT/ITL p50/p95)."""
        done = [t for t in self.timings.values() if t.arrivals]
        ttfts = [t.ttft for t in done if t.ttft is not None]
        itls = [x for t in done for x in t.itls]
        total_tokens = sum(t.output_tokens for t in done)
        span = (max(t.arrivals[-1] for t in done)
                - min(t.start for t in done)) if done else 0.0
        return {
            "requests": len(done),
            "output_tokens": total_tokens,
            "ttft_p50": _pct(ttfts, 0.50),
            "ttft_p95": _pct(ttfts, 0.95),
            "itl_p50": _pct(itls, 0.50),
            "itl_p95": _pct(itls, 0.95),
            "tok_s": total_tokens / span if span > 0 else 0.0,
        }


# ---------------------------------------------------------------------------
# JSONL event recording


class JsonlRecorder:
    """Append-only timestamped JSONL event log (reference recorder.rs)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "a")
        self.count = 0

    def record(self, kind: str, payload: dict) -> None:
        self._f.write(json.dumps({
            "ts": time.time(), "kind": kind, "payload": payload}) + "\n")
        self.count += 1

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def replay_jsonl(path: str):
    """Yield (ts, kind, payload) tuples from a recording."""
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            yield d["ts"], d["kind"], d["payload"]


# ---------------------------------------------------------------------------
# KV-event record/replay (kv_router/recorder.rs)


async def record_kv_events(cp, path: str,
                           subject: str = "kv_events") -> asyncio.Task:
    """Subscribe `kv_events` into a JSONL file; returns the pump task
    (cancel it to stop; the recorder is flushed per event)."""
    rec = JsonlRecorder(path)
    sub = await cp.subscribe(subject)

    async def pump():
        try:
            while True:
                payload = await sub.next()
                rec.record("kv_event", payload)
                rec.flush()
        except (asyncio.CancelledError, ConnectionError):
            raise
        finally:
            sub.cancel()
            rec.close()

    return asyncio.create_task(pump())


def replay_kv_events(path: str, router) -> int:
    """Apply a recording to a KvRouter (or anything with `apply_event`);
    returns the number of events applied.  Rebuilds the exact radix-index
    state a production run had — offline routing analysis."""
    from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent

    n = 0
    for _, kind, payload in replay_jsonl(path):
        if kind != "kv_event":
            continue
        router.apply_event(RouterEvent.from_dict(payload))
        n += 1
    return n
