"""Router-local tracking of in-flight load per worker (port of
`dynamo_tpu/llm/kv_router/sequence.py`).

Role of the reference's `lib/llm/src/kv_router/sequence.rs`
(ActiveSequences :48 / ActiveSequencesMultiWorker :225): the router cannot
wait for worker metrics to observe the load *it just created*, so it
optimistically accounts each routed request — prefill tokens it will cost
(minus cached overlap) and KV blocks it will occupy — and releases them as
the request progresses.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from dynamo_tpu_torch.llm.kv_router.protocols import WorkerId


@dataclass
class ActiveSeq:
    request_id: str
    isl_tokens: int          # input sequence length
    overlap_blocks: int      # cached prefix blocks at admission
    total_blocks: int        # blocks the sequence occupies (grows with decode)
    reserved_blocks: int = 0  # pre-reserved for expected decode growth
    prefilling: bool = True
    created_at: float = 0.0


class ActiveSequences:
    """Per-worker in-flight accounting (one worker's view)."""

    def __init__(self, block_size: int = 64) -> None:
        self.block_size = block_size
        self._seqs: Dict[str, ActiveSeq] = {}

    # -- lifecycle --------------------------------------------------------
    def add_request(
        self,
        request_id: str,
        isl_tokens: int,
        overlap_blocks: int,
        expected_output_tokens: int = 0,
    ) -> None:
        """Track a routed request.  `expected_output_tokens` pre-reserves the
        decode blocks the request is expected to grow into (the reference
        scheduler's `potential_blocks` accounting, `kv_router/scheduler.rs`),
        so the selector sees future occupancy, not just the prompt."""
        total_blocks = (
            isl_tokens + (expected_output_tokens or 0) + self.block_size - 1
        ) // self.block_size
        self._seqs[request_id] = ActiveSeq(
            request_id=request_id,
            isl_tokens=isl_tokens,
            overlap_blocks=overlap_blocks,
            total_blocks=total_blocks,
            reserved_blocks=total_blocks,
            created_at=time.monotonic(),
        )

    def mark_prefill_complete(self, request_id: str) -> None:
        seq = self._seqs.get(request_id)
        if seq:
            seq.prefilling = False

    def push_token(self, request_id: str, n: int = 1) -> None:
        """Decode produced n tokens; grows block occupancy at boundaries."""
        seq = self._seqs.get(request_id)
        if not seq:
            return
        seq.prefilling = False
        seq.isl_tokens += n
        # Occupancy never drops below the admission-time reservation: the
        # pre-reserved decode growth stays visible to the selector until the
        # sequence actually outgrows it.
        seq.total_blocks = max(
            (seq.isl_tokens + self.block_size - 1) // self.block_size,
            seq.reserved_blocks,
        )

    def free(self, request_id: str) -> None:
        self._seqs.pop(request_id, None)

    # -- load views -------------------------------------------------------
    def expire_older_than(self, ttl_secs: float, now: Optional[float] = None) -> int:
        """Drop sequences older than `ttl_secs` (leaked accounting from
        callers that died between routing and free()); returns count dropped."""
        now = time.monotonic() if now is None else now
        stale = [rid for rid, s in self._seqs.items() if now - s.created_at > ttl_secs]
        for rid in stale:
            del self._seqs[rid]
        return len(stale)

    def active_prefill_tokens(self) -> int:
        """Tokens of prefill work outstanding (cached prefix excluded)."""
        return sum(
            max(0, s.isl_tokens - s.overlap_blocks * self.block_size)
            for s in self._seqs.values()
            if s.prefilling
        )

    def active_decode_blocks(self) -> int:
        """KV blocks occupied by in-flight sequences."""
        return sum(s.total_blocks for s in self._seqs.values())

    def num_active(self) -> int:
        return len(self._seqs)


class ActiveSequencesMultiWorker:
    """All workers' in-flight accounting, with request → worker attribution.

    Thread-safe: the router's selection path and the response-stream
    completion callbacks run on different tasks/threads.
    """

    def __init__(self, block_size: int = 64) -> None:
        self.block_size = block_size
        self._lock = threading.Lock()
        self._workers: Dict[WorkerId, ActiveSequences] = {}
        self._request_worker: Dict[str, WorkerId] = {}

    def _worker(self, worker: WorkerId) -> ActiveSequences:
        ws = self._workers.get(worker)
        if ws is None:
            ws = ActiveSequences(self.block_size)
            self._workers[worker] = ws
        return ws

    def workers(self) -> list:
        with self._lock:
            return sorted(self._workers)

    def add_request(
        self,
        request_id: str,
        worker: WorkerId,
        isl_tokens: int,
        overlap_blocks: int,
        expected_output_tokens: int = 0,
    ) -> None:
        with self._lock:
            self._request_worker[request_id] = worker
            self._worker(worker).add_request(
                request_id, isl_tokens, overlap_blocks,
                expected_output_tokens=expected_output_tokens)

    def mark_prefill_complete(self, request_id: str) -> None:
        with self._lock:
            w = self._request_worker.get(request_id)
            if w is not None:  # worker id 0 is falsy but real
                self._worker(w).mark_prefill_complete(request_id)

    def push_token(self, request_id: str, n: int = 1) -> None:
        with self._lock:
            w = self._request_worker.get(request_id)
            if w is not None:  # worker id 0 is falsy but real
                self._worker(w).push_token(request_id, n)

    def free(self, request_id: str) -> None:
        with self._lock:
            w = self._request_worker.pop(request_id, None)
            if w is not None:  # worker id 0 is falsy but real
                self._worker(w).free(request_id)

    def remove_worker(self, worker: WorkerId) -> None:
        with self._lock:
            ws = self._workers.pop(worker, None)
            if ws:
                for rid in list(self._request_worker):
                    if self._request_worker[rid] == worker:
                        del self._request_worker[rid]

    def expire_older_than(self, ttl_secs: float) -> int:
        """Sweep leaked sequences across all workers (call periodically)."""
        with self._lock:
            dropped = 0
            for ws in self._workers.values():
                dropped += ws.expire_older_than(ttl_secs)
            live = {rid for ws in self._workers.values() for rid in ws._seqs}
            for rid in [r for r in self._request_worker if r not in live]:
                del self._request_worker[rid]
            return dropped

    # -- load views -------------------------------------------------------
    def prefill_tokens(self) -> Dict[WorkerId, int]:
        with self._lock:
            return {w: ws.active_prefill_tokens() for w, ws in self._workers.items()}

    def decode_blocks(self) -> Dict[WorkerId, int]:
        with self._lock:
            return {w: ws.active_decode_blocks() for w, ws in self._workers.items()}

    def active_counts(self) -> Dict[WorkerId, int]:
        with self._lock:
            return {w: ws.num_active() for w, ws in self._workers.items()}
