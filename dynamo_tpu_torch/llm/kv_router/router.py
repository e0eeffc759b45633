"""KvRouter: the routing decision engine (port of
`dynamo_tpu/llm/kv_router/router.py`; the worker-sharded indexer is not
ported).

Role of the reference's `lib/llm/src/kv_router.rs` (KvRouterConfig :76,
KvRouter :145): combine

  - overlap scores from the (exact or approximate) indexer,
  - router-local optimistic load (ActiveSequences),
  - the worker selector's cost/sampling policy,

into `find_best_match(request_id, tokens) -> (worker, overlap_blocks)`,
and keep the optimistic accounting in sync with the request lifecycle
(prefill done / token pushed / freed).

Transport-agnostic: candidate workers are provided by the caller (the
runtime's client watches instance liveness); KV events arrive via
`apply_event`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.llm.kv_router.approx import ApproxKvIndexer
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent, WorkerId
from dynamo_tpu_torch.llm.kv_router.scheduler import (
    DefaultWorkerSelector,
    KVHitRateEvent,
    RemotePrefixHint,
    WorkerLoadSnapshot,
    pick_donor,
)
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequencesMultiWorker
from dynamo_tpu_torch.tokens import compute_block_hashes

logger = logging.getLogger(__name__)


@dataclass
class KvRouterConfig:
    block_size: int = 64
    overlap_score_weight: float = 1.0
    temperature: float = 0.0
    # Exact indexer (engine emits KV events) vs TTL-based approximation.
    use_kv_events: bool = True
    approx_ttl_secs: float = 120.0
    # Publish/consume routing decisions across router replicas (reference
    # ACTIVE_SEQUENCES_SUBJECT, kv_router.rs:62-63) — needed once more
    # than one frontend routes the same workers.
    replica_sync: bool = True
    # Fleet-wide prefix reuse: when the chosen worker's overlap is poor
    # but a peer's is deep, offer the peer as a donor (pick_donor) so the
    # serving worker pulls the prefix instead of recomputing it.
    remote_prefix_hints: bool = True
    remote_prefix_min_frac: float = 0.5    # donor must cover >= this
    remote_prefix_min_gain_blocks: int = 2  # donor - chosen overlap floor


class KvRouter:
    def __init__(
        self,
        config: Optional[KvRouterConfig] = None,
        on_hit_rate_event: Optional[Callable[[KVHitRateEvent], None]] = None,
    ) -> None:
        self.config = config or KvRouterConfig()
        self.indexer: Optional[KvIndexer] = (
            KvIndexer(self.config.block_size)
            if self.config.use_kv_events else None)
        self.approx: Optional[ApproxKvIndexer] = (
            None
            if self.config.use_kv_events
            else ApproxKvIndexer(self.config.block_size, self.config.approx_ttl_secs)
        )
        self.active = ActiveSequencesMultiWorker(self.config.block_size)
        self.selector = DefaultWorkerSelector(
            overlap_score_weight=self.config.overlap_score_weight,
            temperature=self.config.temperature,
            on_hit_rate_event=on_hit_rate_event,
        )
        # Donor of the LAST find_best_match (None when the chosen worker's
        # own overlap was fine, or hints are off).
        self.last_donor: Optional[RemotePrefixHint] = None

    def workers(self) -> List[WorkerId]:
        """Workers the router currently knows anything about (index
        residency or in-flight accounting)."""
        known = set(self.active.workers())
        if self.indexer:
            known.update(self.indexer.tree.workers())
        return sorted(known)

    # -- event ingestion --------------------------------------------------
    def apply_event(self, ev: RouterEvent) -> None:
        if self.indexer:
            self.indexer.apply_event(ev)

    def remove_worker(self, worker: WorkerId) -> None:
        if self.indexer:
            self.indexer.remove_worker(worker)
        if self.approx:
            self.approx.remove_worker(worker)
        self.active.remove_worker(worker)

    # -- routing ----------------------------------------------------------
    def find_best_match(
        self,
        request_id: str,
        token_ids: Sequence[int],
        workers: Sequence[WorkerId],
        update_states: bool = True,
        expected_output_tokens: int = 0,
        metrics: Optional[Dict[WorkerId, object]] = None,
        priority: Optional[int] = None,
        slices: Optional[Dict[WorkerId, object]] = None,
    ) -> Tuple[WorkerId, int]:
        """Choose a worker for the request; returns (worker, overlap_blocks).

        `workers` is the current live instance set.  When `update_states`
        the decision is recorded in the optimistic accounting (callers must
        later `free(request_id)`).  `expected_output_tokens` (e.g. the
        request's max_tokens) pre-reserves decode-growth blocks in that
        accounting so the selector sees future occupancy.

        `priority` (0 best effort, 1 standard, 2 interactive) enables the
        QoS bias: interactive requests avoid over-threshold queues.
        `slices` maps worker id → published SliceSpec (instance-record
        metadata) so the selector weighs per-slice HBM capacity; both
        default to the topology-blind behavior for fleets that publish
        nothing.
        """
        if not workers:
            raise ValueError("no live workers to route to")
        seq_hashes = compute_block_hashes(token_ids, self.config.block_size)
        request_blocks = (len(token_ids) + self.config.block_size - 1) // self.config.block_size

        if self.indexer:
            overlaps = self.indexer.find_matches(seq_hashes)
        elif self.approx:
            overlaps = self.approx.find_matches(seq_hashes)
        else:  # pragma: no cover
            raise RuntimeError("router has neither exact nor approximate indexer")

        bs = self.config.block_size
        decode_blocks = self.active.decode_blocks()
        prefill_tokens = self.active.prefill_tokens()
        candidates = [
            WorkerLoadSnapshot(
                worker_id=w,
                overlap_blocks=overlaps.scores.get(w, 0),
                decode_blocks=decode_blocks.get(w, 0),
                prefill_blocks=(prefill_tokens.get(w, 0) + bs - 1) // bs,
                metrics=(metrics or {}).get(w),
                slice=(slices or {}).get(w),
            )
            for w in workers
        ]
        try:
            chosen = self.selector.select(candidates, request_blocks,
                                          priority=priority)
        except TypeError:
            # Custom selectors predating the QoS surface keep working;
            # they just route priority-blind.
            chosen = self.selector.select(candidates, request_blocks)

        # Offer the deepest-overlap LIVE peer as a donor when it beats the
        # chosen worker's own coverage (scores restricted to `workers`).
        self.last_donor = None
        if self.config.remote_prefix_hints:
            live_scores = {w: overlaps.scores.get(w, 0) for w in workers}
            self.last_donor = pick_donor(
                live_scores, chosen.worker_id, chosen.overlap_blocks,
                request_blocks,
                min_donor_frac=self.config.remote_prefix_min_frac,
                min_gain_blocks=self.config.remote_prefix_min_gain_blocks,
                slices=slices, metrics=metrics)

        if update_states:
            self.active.add_request(
                request_id, chosen.worker_id, len(token_ids),
                chosen.overlap_blocks,
                expected_output_tokens=expected_output_tokens,
            )
            if self.approx:
                self.approx.process_routing_decision(chosen.worker_id, seq_hashes)
        return chosen.worker_id, chosen.overlap_blocks

    # -- request lifecycle ------------------------------------------------
    def mark_prefill_complete(self, request_id: str) -> None:
        self.active.mark_prefill_complete(request_id)

    def push_token(self, request_id: str, n: int = 1) -> None:
        self.active.push_token(request_id, n)

    def free(self, request_id: str) -> None:
        self.active.free(request_id)
