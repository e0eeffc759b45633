"""KV-aware routed engine client: the frontend side of KV routing (port
of `dynamo_tpu/llm/kv_router/client.py`, without the hit-rate events'
publication on the control plane, which feeds the metrics aggregator
that is not ported).

Ties the router core (indexer + selector + active sequences, this package)
into the serving path, playing the reference's `KvPushRouter`
(`kv_router.rs:304`) role:

- subscribes to the `kv_events` subject on the control plane and feeds the
  RadixTree indexer (reference: NATS kv_events → `KvIndexer` event loop);
- on every request, scores live instances (prefix overlap + decode/prefill
  load) and dispatches *direct* to the chosen worker;
- tracks in-flight state (ActiveSequencesMultiWorker) — prefill complete on
  first token, per-token block growth, free on finish;
- when the chosen worker's own overlap is poor but a live peer's is deep,
  attaches a remote-prefix hint (the donor's RPC address and covered
  tokens, `block_manager/prefix_share.py`) so the worker pulls the
  donor's blocks instead of prefilling them;
- removes workers from the index when their instances vanish;
- records each decision as a `router.select` span (worker, overlap,
  cost, candidates, donor) and a `route` ledger stamp, reads the
  request's QoS class (`priority` annotation) into the selector, and
  folds a returned worker-hop ledger into the request's live one.

Composes under MigrationClient: a retried generate() re-routes, and the
dead worker has already been dropped from the instance set by its lease.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import AsyncIterator, Optional

from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.llm.block_manager.prefix_share import (
    HINT_ANNOTATION,
    attach_hint,
)
from dynamo_tpu_torch.llm.drain import DRAIN_REFUSAL
from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent
from dynamo_tpu_torch.llm.kv_router.router import KvRouter, KvRouterConfig
from dynamo_tpu_torch.llm.kv_router.watcher import LoadMetricsWatcher
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.llm.service import PRIORITY_ANNOTATION, priority_of
from dynamo_tpu_torch.runtime import ledger as ledger_mod
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.rpc import RpcError

logger = logging.getLogger(__name__)

KV_EVENTS_SUBJECT = "kv_events"
ACTIVE_SEQS_SUBJECT = "active_seqs"  # reference kv_router.rs:63


class KvRoutedEngineClient:
    """EngineClient with KV-cache-aware worker selection."""

    def __init__(self, client, runtime, block_size: int = 64,
                 config: Optional[KvRouterConfig] = None,
                 registry=None) -> None:
        from dynamo_tpu_torch.llm.discovery import delta_from_wire, request_to_wire

        self._to_wire = request_to_wire
        self._from_wire = delta_from_wire
        self.client = client          # runtime Client (instance watcher)
        self.runtime = runtime
        self.router = KvRouter(config or KvRouterConfig(block_size=block_size),
                               on_hit_rate_event=self._note_decision)
        self._last_decision = None  # last KVHitRateEvent (span attrs)
        self._event_task: Optional[asyncio.Task] = None
        self._sub = None
        # Worker-published ForwardPassMetrics, merged into selection cost.
        self._metrics = LoadMetricsWatcher(runtime.cp, name="kv-router")
        # Replica sync: other frontends' routing decisions fold into our
        # optimistic accounting under a namespaced request key (reference
        # ACTIVE_SEQUENCES_SUBJECT replica sync, kv_router.rs:62-63).
        import uuid as _uuid

        self._router_id = _uuid.uuid4().hex[:12]
        self._seq_sub = None
        self._seq_task: Optional[asyncio.Task] = None
        # Penalty box: workers that just failed a connection are excluded
        # from routing until their lease expires or the TTL passes —
        # otherwise the highest-overlap (dead) worker would be re-chosen on
        # every migration retry (reference PushRouter fault detection,
        # `push_router.rs:168`).  A draining worker (it handed a stream
        # off, or refused one) goes in too: its leave from the instance
        # set may reach this frontend after the handoff, and the re-issue
        # would come back to it, the highest-overlap worker, be refused,
        # and lose the KV it carried.
        self._penalty: dict = {}
        self._penalty_ttl = 3.0
        # Fire-and-forget publishes: the loop holds tasks weakly, so
        # they stay referenced here until done.
        self._publishes: set = set()
        # Requests sent with a remote-prefix hint: a plain int, and a
        # counter on the frontend's /metrics when it hands its registry.
        self.remote_hint_routes = 0
        self._remote_routes_counter = (
            registry.counter(
                "router_remote_prefix_routes_total",
                "Requests routed with a remote-prefix donor hint")
            if registry is not None else None)

    async def start(self) -> None:
        self._sub = await self.runtime.cp.subscribe(KV_EVENTS_SUBJECT)
        self._event_task = asyncio.create_task(self._pump_events())
        await self._metrics.start()
        if self.router.config.replica_sync:
            self._seq_sub = await self.runtime.cp.subscribe(
                ACTIVE_SEQS_SUBJECT)
            self._seq_task = asyncio.create_task(self._pump_active_seqs())

    async def stop(self) -> None:
        for sub in (self._sub, self._seq_sub):
            if sub:
                sub.cancel()
        for task in (self._event_task, self._seq_task):
            if task:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        await self._metrics.stop()

    # -- replica sync ------------------------------------------------------

    def _publish_seq(self, kind: str, request_id: str, **fields) -> None:
        if not self.router.config.replica_sync:
            return

        async def pub():
            # One retry: a dropped 'free' leaves a phantom
            # reservation on peer routers skewing placement until the
            # 900 s expire sweep; still best-effort after that — local
            # accounting holds either way.
            for attempt in (0, 1):
                try:
                    await self.runtime.cp.publish(ACTIVE_SEQS_SUBJECT, {
                        "router": self._router_id, "kind": kind,
                        "request_id": request_id, **fields})
                    return
                except Exception:
                    if attempt == 0:
                        await asyncio.sleep(0.2)

        self._spawn(pub)

    def _spawn(self, coro_fn) -> None:
        try:
            task = asyncio.get_running_loop().create_task(coro_fn())
        except RuntimeError:
            return  # no loop (sync tests): drop
        self._publishes.add(task)
        task.add_done_callback(self._publishes.discard)

    async def _pump_active_seqs(self) -> None:
        last_sweep = time.monotonic()
        backoff = 1.0
        while True:
            try:
                msg = await asyncio.wait_for(self._seq_sub.next(),
                                             timeout=30.0)
                backoff = 1.0
            except asyncio.TimeoutError:
                msg = None
            except asyncio.CancelledError:
                raise
            except ConnectionError:
                # Don't go silently dark until restart.  The
                # control-plane client reconnects and restores this SAME
                # subscription; just keep draining after a pause.
                logger.warning("active_seqs subscription lost; waiting "
                               "%.0fs for reconnect", backoff)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 30.0)
                continue
            # Periodic leak sweep: a remote router SIGKILLed between its
            # "add" and "free" would otherwise reserve phantom load
            # forever (ActiveSequences.expire_older_than exists for
            # exactly this).  The TTL comfortably exceeds any real
            # stream; local entries also freed by generate()'s finally.
            now = time.monotonic()
            if now - last_sweep > 60.0:
                last_sweep = now
                dropped = self.router.active.expire_older_than(900.0)
                if dropped:
                    logger.warning("expired %d leaked sequence "
                                   "reservations", dropped)
            if msg is None:
                continue
            if msg.get("router") == self._router_id:
                continue  # own echo
            try:
                key = f"{msg['router']}:{msg['request_id']}"
                kind = msg["kind"]
                if kind == "add":
                    self.router.active.add_request(
                        key, msg["worker"], msg["isl"], msg["overlap"],
                        expected_output_tokens=msg.get("expected", 0))
                elif kind == "prefill":
                    self.router.active.mark_prefill_complete(key)
                elif kind == "free":
                    self.router.active.free(key)
            except Exception:
                logger.exception("bad active_seqs payload")

    async def _pump_events(self) -> None:
        backoff = 1.0
        while True:
            try:
                payload = await self._sub.next()
                backoff = 1.0
            except asyncio.CancelledError:
                raise
            except ConnectionError:
                # A frozen index silently degrades routing
                # until restart.  The control-plane client reconnects and
                # restores this SAME subscription; keep draining.
                logger.warning("kv_events subscription lost; waiting "
                               "%.0fs for reconnect", backoff)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 30.0)
                continue
            try:
                self.router.apply_event(RouterEvent.from_dict(payload))
            except Exception:
                logger.exception("bad kv event payload")

    def _sync_workers(self) -> list:
        """Reconcile the router's worker set with live instances."""
        live = self.client.instance_ids()
        known = self.router.workers()
        for w in known:
            if w not in live:
                self.router.remove_worker(w)
        now = time.monotonic()
        self._penalty = {w: t for w, t in self._penalty.items() if t > now}
        healthy = [w for w in live if w not in self._penalty]
        return healthy or live  # all penalised → try anyway

    def _worker_slices(self) -> dict:
        """Published SliceSpec per live instance (instance-record
        metadata, `fleet.topology`): the selector's HBM-capacity
        weighting.  Workers that publish none map to None."""
        from dynamo_tpu_torch.fleet.topology import SliceSpec

        return {
            i.instance_id: SliceSpec.from_dict(i.metadata.get("slice"))
            for i in self.client.instances()
        }

    def _note_decision(self, ev) -> None:
        self._last_decision = ev

    @staticmethod
    def _request_priority(request) -> Optional[int]:
        """QoS class from the request's annotations (the frontend's
        `x-dynamo-priority` header lands there): the selector biases
        interactive traffic away from deep queues."""
        if PRIORITY_ANNOTATION not in getattr(request, "annotations", {}):
            return None  # unannotated: keep the topology-blind cost
        return priority_of(request)

    async def embed(self, token_lists):
        from dynamo_tpu_torch.llm.discovery import RemoteEngineClient

        return await RemoteEngineClient(self.client).embed(token_lists)

    async def clear_kv_blocks(self) -> int:
        """Flush every worker's reusable blocks; their REMOVED events
        then empty this frontend's index of them."""
        from dynamo_tpu_torch.llm.discovery import RemoteEngineClient

        return await RemoteEngineClient(self.client).clear_kv_blocks()

    def _attach_donor_hint(self, request: PreprocessedRequest
                           ) -> Optional[int]:
        """Attach the last decision's donor as a remote-prefix hint; its
        worker id, or None.  A stale hint is cleared first: a migration
        retry reuses the request (and its annotations), and its old donor
        may have died."""
        request.annotations.pop(HINT_ANNOTATION, None)
        donor = self.router.last_donor
        if donor is None:
            return None
        addr = next((i.address for i in self.client.instances()
                     if i.instance_id == donor.worker_id), None)
        if not addr:   # a donor that just vanished attaches no hint
            return None
        attach_hint(request, addr,
                    donor.overlap_blocks * self.router.config.block_size,
                    donor.worker_id)
        self.remote_hint_routes += 1
        if self._remote_routes_counter is not None:
            self._remote_routes_counter.inc()
        return donor.worker_id

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[TokenDelta]:
        route_t0 = time.monotonic()
        workers = self._sync_workers()
        led = ledger_mod.ledger_of(request)
        # The routing decision's span: which worker won, the overlap it
        # won on, the selector's cost and candidate count.
        route_span = tracing.get_tracer().start_span(
            "router.select", attrs={"request_id": request.request_id})
        try:
            worker_id, overlap = self.router.find_best_match(
                request.request_id, request.token_ids, workers,
                expected_output_tokens=request.sampling.max_tokens,
                metrics=self._metrics.fresh(),
                priority=self._request_priority(request),
                slices=self._worker_slices())
        except BaseException as e:
            # No candidates / selector failure: the span must still end,
            # or an empty fleet leaks one open span per rejected request.
            route_span.end(error=type(e).__name__)
            raise
        ev = self._last_decision
        donor_id = self._attach_donor_hint(request)
        route_span.end(
            worker=int(worker_id), overlap_blocks=int(overlap),
            candidates=(ev.candidates if ev is not None else len(workers)),
            cost=(round(ev.cost, 3) if ev is not None else None),
            remote_prefix_donor=donor_id)
        sent = time.monotonic()
        if led is not None:
            attrs = {"worker": int(worker_id),
                     "overlap_blocks": int(overlap)}
            if donor_id is not None:
                attrs["donor"] = int(donor_id)
            led.stamp("route", dur=sent - route_t0, t=sent, **attrs)
        logger.debug("kv-routed %s → worker %s (overlap %d blocks)",
                     request.request_id, worker_id, overlap)
        self._publish_seq("add", request.request_id, worker=worker_id,
                          isl=len(request.token_ids), overlap=overlap,
                          expected=request.sampling.max_tokens)
        first = None
        try:
            async for d in self.client.direct(self._to_wire(request),
                                              worker_id):
                delta = self._from_wire(d)
                delta.request_id = request.request_id
                if delta.token_ids and first is None:
                    first = time.monotonic()
                    self.router.mark_prefill_complete(request.request_id)
                    self._publish_seq("prefill", request.request_id)
                ledger_mod.absorb_delta(request, delta, where="kv_router",
                                        sent=sent, first=first)
                if delta.token_ids:
                    self.router.push_token(request.request_id,
                                           len(delta.token_ids))
                if delta.migrate is not None:
                    self._penalty[worker_id] = (time.monotonic()
                                                + self._penalty_ttl)
                yield delta
        except ConnectionError:
            self._penalty[worker_id] = time.monotonic() + self._penalty_ttl
            raise
        except RpcError as e:
            if DRAIN_REFUSAL in str(e):
                self._penalty[worker_id] = (time.monotonic()
                                            + self._penalty_ttl)
            raise
        finally:
            self.router.free(request.request_id)
            self._publish_seq("free", request.request_id)
