"""Worker-side drain: hand in-flight streams to peers WITH their KV
(port of `dynamo_tpu/llm/drain.py`).

A planner scale-down SIGTERMs a worker.  Without a drain the worker
would wait for its longest stream, or drop it and let the frontend's
MigrationClient re-prefill the whole prompt on a peer, throwing away the
KV the worker already paid for.  `DrainableService` is the worker's
outermost serving wrapper (directly under `engine_wire_handler`); on
drain it

1. refuses new admissions with the `DRAIN_REFUSAL` marker (retryable —
   the frontend re-routes; the instance record is leaving anyway),
2. interrupts each in-flight stream and ends it with a `migrate` delta
   naming this worker's RPC address (its kv_blocks donor endpoint) and
   the stream's sealed-token high-water mark,
3. stays alive serving `kv_blocks` until the peers' pulls finish (the
   worker main bounds that wait), so the handed-off KV actually moves.

The frontend's MigrationClient (llm/migration.py) consumes the migrate
delta: it re-issues prompt+generated to a peer with a `migrate_kv`
annotation, and the peer's PrefixShareClient pulls the sealed prefix
over the device plane (CUDA IPC on one card) or the host-staged
`kv_blocks` wire before admission.  Cancelling the local
request releases its pages, but every SEALED block stays registered in
the tiered cache (inactive → exportable), which is exactly what the
donor pull reads.

Drain triggers (worker/main.py): SIGTERM with `--drain on` (default),
or the control-plane command key `drain/{pid}` / `drain/instance/{id}`
(`ControlPlane.put` from an operator or the planner).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.runtime import flight_recorder
from dynamo_tpu_torch.runtime.contracts import never_engine_thread
from dynamo_tpu_torch.runtime.ledger import ledger_of

logger = logging.getLogger(__name__)

# Keep in sync with llm/migration.DRAIN_REFUSAL (string-matched across
# the RPC error relay; defined in both modules so neither frontend nor
# worker pulls the other's import graph).
DRAIN_REFUSAL = "worker-draining"

# Control-plane drain command prefix: `drain/{pid}` or
# `drain/instance/{instance_id}` (value is free-form metadata).
DRAIN_PREFIX = "drain/"


def drain_key_pid(pid: int) -> str:
    return f"{DRAIN_PREFIX}{pid}"


def drain_key_instance(instance_id: int) -> str:
    return f"{DRAIN_PREFIX}instance/{instance_id}"


class WorkerDrainingError(RuntimeError):
    """New admission refused mid-drain; the message carries the marker
    the frontend's MigrationClient retries on."""

    def __init__(self) -> None:
        super().__init__(DRAIN_REFUSAL)


class DrainableService:
    """EngineClient wrapper that can hand its in-flight streams off.

    `kv_address`: this worker's RPC address (where peers pull kv_blocks
    from); None for engines with no exportable KV (mocker) — handoffs
    then carry no hint and the peer re-prefills (still zero failed
    requests).
    """

    def __init__(self, inner, *, kv_address: Optional[str] = None,
                 block_size: int = 64) -> None:
        self.inner = inner
        self.kv_address = kv_address
        self.block_size = block_size
        self.draining = False
        self.migrated_out = 0          # streams handed off with KV hints
        self._active: Dict[str, asyncio.Event] = {}
        self.flight = flight_recorder.get_recorder()

    @property
    def active_requests(self) -> int:
        return len(self._active)

    @never_engine_thread
    async def generate(self, request):
        if self.draining:
            raise WorkerDrainingError()
        rid = request.request_id
        drain_ev = asyncio.Event()
        self._active[rid] = drain_ev
        emitted = 0
        q: asyncio.Queue = asyncio.Queue()
        _DONE = object()

        async def pump():
            # Inner stream consumed on its own task so the outer loop can
            # race deltas against the drain signal; exceptions cross the
            # queue and re-raise in the caller's context.
            try:
                async for d in self.inner.generate(request):
                    await q.put(d)
                await q.put(_DONE)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                await q.put(e)

        task = asyncio.create_task(pump())
        ev_wait = asyncio.create_task(drain_ev.wait())
        get: Optional[asyncio.Task] = None
        try:
            while True:
                get = asyncio.create_task(q.get())
                done, _ = await asyncio.wait(
                    {get, ev_wait}, return_when=asyncio.FIRST_COMPLETED)
                if ev_wait not in done:
                    item = get.result()
                    get = None
                    if item is _DONE:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    emitted += len(item.token_ids)
                    yield item
                    if item.finished:
                        return
                    continue
                # Drain signalled — PREFERRED over any deltas still
                # queued (they were never delivered, so the peer simply
                # regenerates them; `emitted` counts delivered tokens
                # only).  Cancel the local request (pages free; sealed
                # blocks stay registered → exportable) and end the
                # stream with the handoff marker.
                get.cancel()
                get = None
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass  # the handoff below is the outcome either way
                total = len(request.token_ids) + emitted
                covered = (total // self.block_size) * self.block_size
                migrate = {"reason": "drain",
                           "covered_tokens": int(covered)}
                if self.kv_address and covered > 0:
                    migrate["address"] = self.kv_address
                self.migrated_out += 1
                fl = self.flight
                if fl.enabled:
                    fl.record("migrate_out", rid=rid, emitted=emitted,
                              covered=covered)
                led = ledger_of(request)
                if led is not None:
                    # Rides home on this very migrate delta (the wire
                    # handler attaches the hop ledger to it).
                    led.stamp("drain_handoff", covered_tokens=int(covered),
                              emitted=emitted)
                logger.info("drain: handing off %s (%d tokens emitted, "
                            "%d KV tokens offered)", rid, emitted, covered)
                yield TokenDelta(request_id=rid, token_ids=[],
                                 finished=False, migrate=migrate)
                return
        finally:
            if get is not None:
                get.cancel()
            ev_wait.cancel()
            task.cancel()
            self._active.pop(rid, None)

    @never_engine_thread
    async def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting, hand every in-flight stream off, and wait for
        the handoffs to flush (bounded).  Returns True when every stream
        was handed off inside the budget."""
        self.draining = True
        fl = self.flight
        if fl.enabled:
            fl.record("drain", inflight=len(self._active),
                      kv=bool(self.kv_address))
        logger.info("drain: %d in-flight stream(s) to hand off",
                    len(self._active))
        for ev in list(self._active.values()):
            ev.set()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max(0.0, timeout_s)
        while self._active and loop.time() < deadline:
            await asyncio.sleep(0.02)
        if self._active:
            logger.warning("drain: %d stream(s) still open at timeout",
                           len(self._active))
        return not self._active
