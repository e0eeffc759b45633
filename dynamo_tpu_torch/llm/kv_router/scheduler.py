"""Worker selection: overlap-aware cost with temperature sampling, and
the remote-prefix donor pick (port of
`dynamo_tpu/llm/kv_router/scheduler.py`).

Role of the reference's `lib/llm/src/kv_router/scheduler.rs`
(DefaultWorkerSelector :321, cost formula :371-374, softmax_sample :248).

Cost per candidate worker:

    potential_prefill_blocks = request_blocks - overlap_blocks(worker)
    cost = overlap_score_weight * (potential_prefill_blocks
                                   + outstanding_prefill_blocks(worker))
           + decode_blocks(worker)

(outstanding_prefill_blocks = queued prefill work the router already sent to
that worker — same units, so a worker busy prefilling someone else's long
prompt is as unattractive as prefilling ours from scratch.)

Lower is better.  With temperature 0 the lowest-cost worker wins (random
tie-break); with temperature > 0 workers are sampled ∝ softmax(-cost / T),
which spreads load when costs are close and avoids herding every request at
the momentarily-cheapest worker.
"""

from __future__ import annotations

import logging
import math
import random
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

from dynamo_tpu_torch.fleet.topology import (
    SliceSpec,
    donor_preference_key,
    free_hbm_bytes,
)
from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics, WorkerId

logger = logging.getLogger(__name__)

# QoS routing bias: interactive-class requests
# (priority >= INTERACTIVE_PRIORITY, see llm.service.PRIORITY_CLASSES)
# avoid workers whose published waiting queue exceeds the threshold —
# a deep queue is head-of-line latency an interactive request must not
# eat for a few blocks of prefix overlap.  Best-effort and standard
# traffic keeps the plain cost (it FILLS the busy workers interactive
# traffic vacates).  When EVERY candidate is over the threshold the
# bias cancels out by construction — the degenerate all-busy fleet
# routes exactly as before rather than herding onto an arbitrary pick.
INTERACTIVE_PRIORITY = 2
QUEUE_DEPTH_THRESHOLD = 4
BUSY_QUEUE_PENALTY = 1024.0

# Slice-capacity weighting: decode load is normalized by the slice's
# total HBM relative to the largest candidate slice — 10 busy blocks on
# a small card mean more pressure than 10 on a large one.  Clamped
# so a tiny or absurd published HBM figure cannot dominate the cost.
HBM_FACTOR_MIN = 0.25
HBM_FACTOR_MAX = 4.0


@dataclass(frozen=True)
class KVHitRateEvent:
    """Emitted per routing decision for observability (reference
    `scheduler.rs:22`): how much of the request's prefix was already
    cached on the chosen worker, plus the decision's cost and candidate
    count, which show WHY a worker won, not just which one."""

    worker_id: WorkerId
    isl_blocks: int
    overlap_blocks: int
    cost: float = 0.0
    candidates: int = 0


@dataclass(frozen=True)
class RemotePrefixHint:
    """A donor for fleet-wide prefix reuse: `worker_id` holds the
    request's first `overlap_blocks` blocks (per the indexer's stored
    events).  The routing client turns it into the `remote_prefix`
    annotation the serving worker's PrefixFetcher consumes."""

    worker_id: WorkerId
    overlap_blocks: int


def pick_donor(
    scores: Dict[WorkerId, int],
    chosen: WorkerId,
    chosen_overlap: int,
    request_blocks: int,
    *,
    min_donor_frac: float = 0.5,
    min_gain_blocks: int = 2,
    slices: Optional[Dict[WorkerId, Optional[SliceSpec]]] = None,
    metrics: Optional[Dict[WorkerId, object]] = None,
) -> Optional[RemotePrefixHint]:
    """The remote-prefix donor decision: when the chosen worker's own
    overlap is poor but a peer's is deep, pulling the peer's sealed
    blocks beats recomputing them.  A peer qualifies when it covers at
    least `min_donor_frac` of the request's blocks AND beats the chosen
    worker's overlap by `min_gain_blocks`; among qualifiers
    `donor_preference_key` decides (reachable over the device fabric
    from the chosen worker, coverage, free memory, stable id).  `scores`
    must already be restricted to live workers."""
    if request_blocks <= 0:
        return None
    floor = max(1, math.ceil(min_donor_frac * request_blocks))
    puller_spec = (slices or {}).get(chosen)
    best: Optional[RemotePrefixHint] = None
    best_key = None
    for w, ov in scores.items():
        if w == chosen:
            continue
        if ov < floor or ov - chosen_overlap < min_gain_blocks:
            continue
        spec = (slices or {}).get(w)
        key = donor_preference_key(
            w, ov,
            reachable=bool(puller_spec is not None and spec is not None
                           and puller_spec.reachable(spec)),
            free_hbm=free_hbm_bytes(spec, (metrics or {}).get(w)))
        if best_key is None or key > best_key:
            best = RemotePrefixHint(worker_id=w, overlap_blocks=ov)
            best_key = key
    return best


@dataclass
class WorkerLoadSnapshot:
    """Candidate worker state at selection time: router-local optimistic
    accounting merged with the worker's last published metrics."""

    worker_id: WorkerId
    overlap_blocks: int = 0
    decode_blocks: int = 0
    prefill_blocks: int = 0  # outstanding prefill work already routed there
    metrics: Optional[ForwardPassMetrics] = None
    # Published slice topology (instance-record metadata), None for
    # workers predating the topology plane — every read degrades to the
    # topology-blind cost.
    slice: Optional[SliceSpec] = None


def softmax_sample(
    costs: Dict[WorkerId, float],
    temperature: float,
    rng: Optional[random.Random] = None,
) -> WorkerId:
    """Sample a worker: argmin at T=0 (ties broken uniformly), else
    softmax over -cost/T."""
    if not costs:
        raise ValueError("no candidate workers")
    rng = rng or random
    if temperature <= 0.0:
        lo = min(costs.values())
        best = [w for w, c in costs.items() if c == lo]
        return rng.choice(best)
    # Stabilized softmax over negated costs.
    mx = max(-c / temperature for c in costs.values())
    weights = {w: math.exp(-c / temperature - mx) for w, c in costs.items()}
    total = sum(weights.values())
    r = rng.random() * total
    acc = 0.0
    for w, wt in weights.items():
        acc += wt
        if r <= acc:
            return w
    return next(reversed(weights))  # numeric fallthrough


class DefaultWorkerSelector:
    """The stock cost function; custom selectors implement the same
    `select(candidates, request_blocks) -> (worker, overlap)` surface
    (the reference exposes WorkerSelector for exactly this extension,
    `components/router/src/main.rs:27-44`)."""

    def __init__(
        self,
        overlap_score_weight: float = 1.0,
        temperature: float = 0.0,
        waiting_request_weight: float = 8.0,
        rng: Optional[random.Random] = None,
        on_hit_rate_event: Optional[Callable[[KVHitRateEvent], None]] = None,
        queue_depth_threshold: int = QUEUE_DEPTH_THRESHOLD,
        busy_queue_penalty: float = BUSY_QUEUE_PENALTY,
    ) -> None:
        self.overlap_score_weight = overlap_score_weight
        self.temperature = temperature
        self.waiting_request_weight = waiting_request_weight
        self.rng = rng or random.Random()
        self.on_hit_rate_event = on_hit_rate_event
        self.queue_depth_threshold = queue_depth_threshold
        self.busy_queue_penalty = busy_queue_penalty

    def select(
        self,
        candidates: Sequence[WorkerLoadSnapshot],
        request_blocks: int,
        priority: Optional[int] = None,
    ) -> WorkerLoadSnapshot:
        if not candidates:
            raise ValueError("no candidate workers")
        # Slice-capacity reference: the biggest candidate slice with a
        # published HBM figure normalizes everyone else's decode load.
        ref_hbm = max((c.slice.total_hbm_bytes for c in candidates
                       if c.slice is not None
                       and c.slice.total_hbm_bytes > 0), default=0)
        waiting_by_id: Dict[WorkerId, int] = {
            c.worker_id: (c.metrics.worker_stats.num_requests_waiting
                          if c.metrics is not None else 0)
            for c in candidates
        }
        # QoS: the interactive bias only applies when SOME candidate is
        # under the queue threshold — an all-busy fleet must route
        # unbiased (degenerate case), not herd on a random worker.
        bias_busy = (priority is not None
                     and priority >= INTERACTIVE_PRIORITY
                     and any(w <= self.queue_depth_threshold
                             for w in waiting_by_id.values()))
        costs: Dict[WorkerId, float] = {}
        by_id: Dict[WorkerId, WorkerLoadSnapshot] = {}
        for c in candidates:
            potential_prefill = max(0, request_blocks - c.overlap_blocks)
            # Decode load: router-local optimistic accounting merged with
            # the worker's last PUBLISHED stats (reference merges scraped
            # ForwardPassMetrics into routing via `scoring.rs`
            # ProcessedEndpoints).  max(): local accounting reacts
            # instantly to our own decisions; published truth covers load
            # this router never saw (other frontends, engine-internal
            # state).
            decode_load = c.decode_blocks
            waiting = waiting_by_id[c.worker_id]
            if c.metrics is not None:
                decode_load = max(decode_load,
                                  c.metrics.kv_stats.kv_active_blocks)
            if ref_hbm and c.slice is not None \
                    and c.slice.total_hbm_bytes > 0:
                factor = ref_hbm / c.slice.total_hbm_bytes
                decode_load *= min(HBM_FACTOR_MAX,
                                   max(HBM_FACTOR_MIN, factor))
            cost = (
                self.overlap_score_weight * (potential_prefill + c.prefill_blocks)
                + decode_load
                + self.waiting_request_weight * waiting
            )
            if bias_busy and waiting > self.queue_depth_threshold:
                cost += self.busy_queue_penalty
            costs[c.worker_id] = cost
            by_id[c.worker_id] = c
        chosen_id = softmax_sample(costs, self.temperature, self.rng)
        chosen = by_id[chosen_id]
        logger.debug(
            "selected worker %s cost=%.1f overlap=%d/%d blocks",
            chosen_id,
            costs[chosen_id],
            chosen.overlap_blocks,
            request_blocks,
        )
        if self.on_hit_rate_event:
            self.on_hit_rate_event(
                KVHitRateEvent(
                    worker_id=chosen_id,
                    isl_blocks=request_blocks,
                    overlap_blocks=min(chosen.overlap_blocks, request_blocks),
                    cost=costs[chosen_id],
                    candidates=len(costs),
                )
            )
        return chosen
