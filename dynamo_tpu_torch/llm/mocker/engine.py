"""Mock engine: scheduler + simulated timing over MockKvManager (port of
`dynamo_tpu/llm/mocker/engine.py`).

Role of the reference's `mocker/{engine,scheduler,sequence}.rs`: an
`EngineClient` that behaves like a real continuous-batching engine —
watermark admission, chunked prefill under a token budget, prefix-cache
hits skipping prefill work, per-step simulated latency (scaled by
`speedup_ratio`), synthetic-but-deterministic output tokens — and emits
real KV events + ForwardPassMetrics.

Defaults mirror `mocker/protocols.rs:79-108` (16384 blocks × 64, 256 seqs,
8192 batched tokens, watermark 0.01).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Callable, Dict, List, Optional

from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    KvStats,
    WorkerStats,
)
from dynamo_tpu_torch.llm.mocker.kv_manager import MockKvManager
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.runtime.ledger import enabled, ledger_of
from dynamo_tpu_torch.tokens import ROOT_PARENT_HASH, TokenBlockSequence

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class MockEngineArgs:
    """Reference `MockEngineArgs` (`mocker/protocols.rs:79-108`)."""

    num_blocks: int = 16_384
    block_size: int = 64
    max_num_seqs: int = 256
    max_batched_tokens: int = 8_192
    watermark: float = 0.01
    speedup_ratio: float = 1.0           # >1 → faster than "real" timing
    # Simulated step timing model (ms), the reference package's defaults:
    prefill_ms_per_token: float = 0.35
    decode_base_ms: float = 4.0
    decode_ms_per_seq: float = 0.05


@dataclass
class _MockSeq:
    request: PreprocessedRequest
    queue: asyncio.Queue
    hash_seq: TokenBlockSequence
    prefilled: int = 0
    cached_tokens: int = 0               # prefix-cache hit, skipped work
    output: List[int] = field(default_factory=list)
    acquired_blocks: List[int] = field(default_factory=list)
    decoding: bool = False
    # Request-ledger timings (runtime/ledger.py): arrival → admission →
    # first token, stamped when the first token emits.
    arrival_ts: float = 0.0
    admit_ts: float = 0.0

    @property
    def prompt(self) -> List[int]:
        return self.request.token_ids

    @property
    def sampling(self) -> SamplingParams:
        return self.request.sampling


def _synthetic_token(request_id: str, index: int) -> int:
    """Deterministic pseudo-random output stream per request.

    Tokens land in printable ASCII (32..126) so any tokenizer — including
    the byte tokenizer used in e2e tests — detokenizes mock streams into
    visible text."""
    h = hashlib.blake2b(f"{request_id}:{index}".encode(),
                       digest_size=4).digest()
    return 32 + int.from_bytes(h, "little") % 95


class MockEngine:
    """Async mock engine implementing the EngineClient contract."""

    def __init__(
        self,
        args: MockEngineArgs = MockEngineArgs(),
        kv_event_sink: Optional[Callable[[KvCacheEvent], None]] = None,
    ) -> None:
        self.args = args
        self.kv = MockKvManager(args.num_blocks, args.block_size,
                                event_sink=kv_event_sink)
        self._waiting: List[_MockSeq] = []
        self._running: List[_MockSeq] = []
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self.metrics = ForwardPassMetrics(
            worker_stats=WorkerStats(request_total_slots=args.max_num_seqs),
            kv_stats=KvStats(kv_total_blocks=args.num_blocks))

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # -- EngineClient -----------------------------------------------------

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[TokenDelta]:
        await self.start()
        seq = _MockSeq(
            request=request,
            queue=asyncio.Queue(),
            hash_seq=TokenBlockSequence(block_size=self.args.block_size),
            arrival_ts=time.monotonic())
        self._waiting.append(seq)
        self._wake.set()
        try:
            while True:
                delta: TokenDelta = await seq.queue.get()
                yield delta
                if delta.finished:
                    return
        finally:
            # Client gone: retire the sequence if still active.
            if seq in self._waiting:
                self._waiting.remove(seq)
            if seq in self._running:
                self._retire(seq)

    # -- engine loop ------------------------------------------------------

    async def _loop(self) -> None:
        while True:
            if not self._waiting and not self._running:
                self._wake.clear()
                await self._wake.wait()
            step_ms = self._step()
            self._refresh_metrics()
            # Simulated hardware time, compressed by speedup_ratio.
            await asyncio.sleep(step_ms / 1000.0 / self.args.speedup_ratio)

    def _step(self) -> float:
        """One iteration: admit, chunked-prefill, decode.  Returns the
        simulated step latency in ms."""
        self._admit()
        budget = self.args.max_batched_tokens
        prefill_tokens = 0
        emitted_this_step = set()

        # Chunked prefill, FCFS.
        for seq in self._running:
            if seq.decoding or budget <= 0:
                continue
            remaining = len(seq.prompt) - seq.prefilled
            chunk = min(remaining, budget)
            seq.prefilled += chunk
            budget -= chunk
            prefill_tokens += chunk
            if seq.prefilled >= len(seq.prompt):
                seq.decoding = True
                emitted_this_step.add(id(seq))
                self._emit_token(seq)   # first token at end of prefill

        # Decode: every decoding sequence advances one token (those that
        # just produced their first token above wait for the next step).
        decoding = [s for s in self._running if s.decoding]
        for seq in list(decoding):
            if id(seq) in emitted_this_step:
                continue
            self._emit_token(seq)

        ms = prefill_tokens * self.args.prefill_ms_per_token
        if decoding:
            ms += (self.args.decode_base_ms
                   + self.args.decode_ms_per_seq * len(decoding))
        return ms

    def _admit(self) -> None:
        while self._waiting and len(self._running) < self.args.max_num_seqs:
            seq = self._waiting[0]
            hashes = [b.block_hash for b in TokenBlockSequence(
                seq.prompt, block_size=self.args.block_size).blocks]
            free_frac = (self.kv.capacity - self.kv.active_blocks) / self.kv.capacity
            if free_frac < self.args.watermark:
                break
            try:
                parents = [None] + hashes[:-1]
                reused = self.kv.acquire(hashes, parents)
            except RuntimeError:
                break  # capacity exhausted; retry after something finishes
            self._waiting.pop(0)
            seq.admit_ts = time.monotonic()
            seq.acquired_blocks = hashes
            seq.cached_tokens = reused * self.args.block_size
            # Prefix-cached tokens skip prefill work entirely.
            seq.prefilled = min(seq.cached_tokens, len(seq.prompt) - 1)
            seq.hash_seq.extend(seq.prompt)
            self._running.append(seq)

    def _emit_token(self, seq: _MockSeq) -> None:
        idx = len(seq.output)
        if idx == 0:
            self._stamp_ledger(seq)
        token = _synthetic_token(seq.request.request_id, idx)
        seq.output.append(token)
        # Decode growth: register newly-sealed blocks.
        newly = seq.hash_seq.extend([token])
        for blk in newly:
            parent = (blk.parent_hash
                      if blk.parent_hash != ROOT_PARENT_HASH else None)
            self.kv.extend(blk.block_hash, parent)
            seq.acquired_blocks.append(blk.block_hash)

        finished = (len(seq.output) >= seq.sampling.max_tokens
                    or token in seq.sampling.stop_token_ids)
        delta = TokenDelta(
            request_id=seq.request.request_id,
            token_ids=[token],
            finished=finished,
            finish_reason=(
                (FinishReason.STOP if token in seq.sampling.stop_token_ids
                 else FinishReason.LENGTH) if finished else None))
        seq.queue.put_nowait(delta)
        if finished:
            self._retire(seq)

    def _stamp_ledger(self, seq: _MockSeq) -> None:
        """Mock timing is real wall-clock (the loop sleeps the simulated
        step latency), so the same queue/prefill/first_token phases real
        engines stamp hold here."""
        led = ledger_of(seq.request)
        if led is None or not enabled():
            return
        now = time.monotonic()
        admit = seq.admit_ts or seq.arrival_ts
        led.stamp("queue", dur=admit - seq.arrival_ts, t=admit)
        led.stamp("prefill", dur=now - admit, t=now,
                  prompt_tokens=len(seq.prompt),
                  cached_tokens=seq.cached_tokens)
        led.stamp("first_token", dur=0.0, t=now)

    def _retire(self, seq: _MockSeq) -> None:
        if seq in self._running:
            self._running.remove(seq)
        self.kv.release(seq.acquired_blocks)
        seq.acquired_blocks = []

    def _refresh_metrics(self) -> None:
        ws = self.metrics.worker_stats
        ws.request_active_slots = len(self._running)
        ws.num_requests_waiting = len(self._waiting)
        ks = self.metrics.kv_stats
        ks.kv_active_blocks = self.kv.active_blocks
        ks.gpu_cache_usage_perc = self.kv.usage
        total = self.kv.hit_blocks + self.kv.miss_blocks
        ks.gpu_prefix_cache_hit_rate = (
            self.kv.hit_blocks / total if total else 0.0)
