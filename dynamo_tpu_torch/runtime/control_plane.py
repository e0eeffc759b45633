"""Control plane: lease-based KV discovery + pub/sub + work queues.

Port of `dynamo_tpu/runtime/control_plane.py`.

The reference runs three external services for this (SURVEY.md §2.6):
etcd (leases/watches — `transports/etcd.rs`), NATS pub-sub subjects
(`transports/nats.rs:53`) and NATS JetStream work queues (`NatsQueue`,
`transports/nats.rs:360`).  This module provides the discovery and
pub/sub capabilities as one self-contained service, because the
capability — not the binary — is the contract:

- **KV with leases + watches**: `put(key, value, lease_id)`; keys die with
  their lease (TTL, refreshed by keep-alives); prefix watches push
  PUT/DELETE events to watchers.  Worker instances register under
  `instances/{namespace}/{component}/{endpoint}:{lease}` exactly like the
  reference's path scheme (`component.rs:72-75`).
- **Pub/sub**: fire-and-forget subjects (KV events, metrics).
- **Work queues**: at-least-once delivery with acks (the JetStream
  `NatsQueue` semantics the disagg prefill queue rides on):
  `queue_pop` leases an item to the consumer under a visibility timeout;
  `queue_ack` settles it; an un-acked item (consumer died mid-prefill)
  is redelivered to the next popper by the reaper.  Items persist in the
  backend until acked, so a restarted store hands them out again.

Two transports share `ControlPlaneState` (the single source of truth):
`InProcessControlPlane` binds it directly (single-process serving, tests);
`ControlPlaneServer`/`ControlPlaneClient` expose it over TCP with
newline-delimited JSON frames for multi-process deployments.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

DEFAULT_LEASE_TTL = 10.0  # seconds; reference etcd default lease ~10s
# Reserved backend namespace for durable work-queue items (never visible
# through the kv surface).
_QUEUE_NS = "__queue__/"


@dataclass
class WatchEvent:
    kind: str          # "put" | "delete"
    key: str
    value: Optional[dict] = None


# ---------------------------------------------------------------------------
# State (transport-independent)


class ControlPlaneState:
    """The authoritative store.  All mutation methods are synchronous and
    must run on the owning event loop; notification fan-out is async-safe
    via call_soon."""

    def __init__(self, backend=None) -> None:
        # Pluggable persistence for UNLEASED keys (runtime/kv_store.py —
        # the reference's key_value_store backends); leased keys are
        # liveness records and never persist.
        from dynamo_tpu_torch.runtime.kv_store import MemoryBackend

        self._backend = backend or MemoryBackend()
        raw = self._backend.load()
        self._kv: Dict[str, Tuple[dict, Optional[int]]] = {
            k: (v, None) for k, v in raw.items()
            if not k.startswith(_QUEUE_NS)
        }  # key → (val, lease)
        self._leases: Dict[int, float] = {}                   # lease → deadline
        self._lease_ttl: Dict[int, float] = {}
        self._lease_seq = itertools.count(1)
        self._watchers: List[Tuple[str, asyncio.Queue]] = []  # (prefix, q)
        self._subs: Dict[str, List[asyncio.Queue]] = {}       # subject → qs
        self._queues: Dict[str, asyncio.Queue] = {}           # work queues
        # (queue, msg_id) → (payload, redelivery deadline)
        self._inflight_msgs: Dict[Tuple[str, int], Tuple[dict, float]] = {}
        self._reaper: Optional[asyncio.Task] = None
        # Durable queue items persisted and never acked (popped-but-unacked
        # ones included) re-enter their queue as pending.  Queue names may
        # contain '/', so the msg id splits from the right; restore order
        # is numeric msg id, so FIFO survives the restart.
        restored = []
        for k, payload in raw.items():
            if k.startswith(_QUEUE_NS):
                name, msg_id = k[len(_QUEUE_NS):].rsplit("/", 1)
                restored.append((int(msg_id), name, payload))
        restored.sort()
        for msg_id, name, payload in restored:
            self._queue(name).put_nowait((msg_id, payload))
        self._queue_msg_seq = itertools.count(
            (restored[-1][0] + 1) if restored else 1)
    # -- leases -----------------------------------------------------------

    def lease_grant(self, ttl: float = DEFAULT_LEASE_TTL) -> int:
        lease = next(self._lease_seq)
        self._leases[lease] = time.monotonic() + ttl
        self._lease_ttl[lease] = ttl
        return lease

    def lease_keepalive(self, lease: int) -> bool:
        if lease not in self._leases:
            return False
        self._leases[lease] = time.monotonic() + self._lease_ttl[lease]
        return True

    def lease_revoke(self, lease: int) -> None:
        self._leases.pop(lease, None)
        self._lease_ttl.pop(lease, None)
        dead = [k for k, (_, l) in self._kv.items() if l == lease]
        for k in dead:
            self.delete(k)

    def expire_leases(self) -> int:
        now = time.monotonic()
        expired = [l for l, dl in self._leases.items() if dl < now]
        for l in expired:
            logger.info("lease %d expired", l)
            self.lease_revoke(l)
        return len(expired)

    async def run_reaper(self, interval: float = 1.0) -> None:
        while True:
            await asyncio.sleep(interval)
            self.expire_leases()
            self.redeliver_expired()

    # -- kv ---------------------------------------------------------------

    def put(self, key: str, value: dict, lease: Optional[int] = None) -> None:
        if lease is not None and lease not in self._leases:
            raise KeyError(f"unknown lease {lease}")
        self._kv[key] = (value, lease)
        if lease is None:
            self._backend.put(key, value)
        self._notify(WatchEvent("put", key, value))

    def get(self, key: str) -> Optional[dict]:
        v = self._kv.get(key)
        return v[0] if v else None

    def get_prefix(self, prefix: str) -> Dict[str, dict]:
        return {k: v for k, (v, _) in self._kv.items() if k.startswith(prefix)}

    def delete(self, key: str) -> bool:
        if key in self._kv:
            _, lease = self._kv.pop(key)
            if lease is None:
                self._backend.delete(key)
            self._notify(WatchEvent("delete", key))
            return True
        return False

    # -- watches ----------------------------------------------------------

    def watch_prefix(self, prefix: str) -> asyncio.Queue:
        """Returns a queue of WatchEvents; caller gets current state as
        synthetic puts first (etcd kv_get_and_watch_prefix semantics)."""
        q: asyncio.Queue = asyncio.Queue()
        for k, (v, _) in sorted(self._kv.items()):
            if k.startswith(prefix):
                q.put_nowait(WatchEvent("put", k, v))
        self._watchers.append((prefix, q))
        return q

    def unwatch(self, q: asyncio.Queue) -> None:
        self._watchers = [(p, w) for (p, w) in self._watchers if w is not q]

    def _notify(self, ev: WatchEvent) -> None:
        for prefix, q in self._watchers:
            if ev.key.startswith(prefix):
                q.put_nowait(ev)

    # -- pub/sub ----------------------------------------------------------

    def subscribe(self, subject: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._subs.setdefault(subject, []).append(q)
        return q

    def unsubscribe(self, subject: str, q: asyncio.Queue) -> None:
        subs = self._subs.get(subject, [])
        if q in subs:
            subs.remove(q)

    def publish(self, subject: str, payload: dict) -> int:
        subs = self._subs.get(subject, [])
        for q in subs:
            q.put_nowait(payload)
        return len(subs)

    # -- work queues ------------------------------------------------------

    def _queue(self, name: str) -> asyncio.Queue:
        return self._queues.setdefault(name, asyncio.Queue())

    def queue_push(self, name: str, payload: dict) -> None:
        msg_id = next(self._queue_msg_seq)
        self._backend.put(f"{_QUEUE_NS}{name}/{msg_id}", payload)
        self._queue(name).put_nowait((msg_id, payload))

    async def queue_pop(self, name: str,
                        visibility_timeout: float = 30.0) -> Tuple[int, dict]:
        """Lease the next item: (msg_id, payload).  The caller must
        `queue_ack(name, msg_id)` before the visibility timeout or the
        item is redelivered (at-least-once)."""
        msg_id, payload = await self._queue(name).get()
        self._inflight_msgs[(name, msg_id)] = (
            payload, time.monotonic() + visibility_timeout)
        return msg_id, payload

    def queue_ack(self, name: str, msg_id: int) -> bool:
        acked = self._inflight_msgs.pop((name, msg_id), None) is not None
        if acked:
            self._backend.delete(f"{_QUEUE_NS}{name}/{msg_id}")
        return acked

    def redeliver_expired(self) -> int:
        now = time.monotonic()
        expired = [k for k, (_, dl) in self._inflight_msgs.items()
                   if dl < now]
        for name, msg_id in expired:
            payload, _ = self._inflight_msgs.pop((name, msg_id))
            logger.warning("queue %s: redelivering un-acked msg %d",
                           name, msg_id)
            self._queue(name).put_nowait((msg_id, payload))
        return len(expired)

    def queue_len(self, name: str) -> int:
        q = self._queues.get(name)
        return q.qsize() if q else 0

# ---------------------------------------------------------------------------
# Client interface (shared by in-process and TCP implementations)


class InProcessControlPlane:
    """Direct binding to a ControlPlaneState (single-process deployments,
    the analog of running etcd+NATS on localhost for tests)."""

    def __init__(self, state: Optional[ControlPlaneState] = None) -> None:
        self.state = state or ControlPlaneState()
        self._keepalive_tasks: Dict[int, asyncio.Task] = {}

    async def start(self) -> None:
        if self.state._reaper is None:
            self.state._reaper = asyncio.create_task(self.state.run_reaper())

    async def close(self) -> None:
        for t in self._keepalive_tasks.values():
            t.cancel()
        if self.state._reaper:
            self.state._reaper.cancel()
            try:
                await self.state._reaper
            except asyncio.CancelledError:
                pass
            self.state._reaper = None

    # Leases
    async def lease_grant(self, ttl: float = DEFAULT_LEASE_TTL,
                          auto_keepalive: bool = True) -> int:
        lease = self.state.lease_grant(ttl)
        if auto_keepalive:
            self._keepalive_tasks[lease] = asyncio.create_task(
                self._keepalive_loop(lease, ttl))
        return lease

    async def _keepalive_loop(self, lease: int, ttl: float) -> None:
        # Refresh at 1/3 TTL like the reference (`etcd/lease.rs:62`).
        try:
            while True:
                await asyncio.sleep(ttl / 3.0)
                if not self.state.lease_keepalive(lease):
                    return
        except asyncio.CancelledError:
            pass

    async def lease_revoke(self, lease: int) -> None:
        t = self._keepalive_tasks.pop(lease, None)
        if t:
            t.cancel()
        self.state.lease_revoke(lease)

    # KV
    async def put(self, key: str, value: dict,
                  lease: Optional[int] = None) -> None:
        self.state.put(key, value, lease)

    async def get(self, key: str) -> Optional[dict]:
        return self.state.get(key)

    async def get_prefix(self, prefix: str) -> Dict[str, dict]:
        return self.state.get_prefix(prefix)

    async def delete(self, key: str) -> bool:
        return self.state.delete(key)

    async def watch_prefix(self, prefix: str) -> "Watch":
        return Watch(self.state, self.state.watch_prefix(prefix))

    # Pub/sub
    async def publish(self, subject: str, payload: dict) -> None:
        self.state.publish(subject, payload)

    async def subscribe(self, subject: str) -> "Subscription":
        return Subscription(self.state, subject,
                            self.state.subscribe(subject))

    # Queues
    async def queue_push(self, name: str, payload: dict) -> None:
        self.state.queue_push(name, payload)

    async def queue_pop(self, name: str,
                        visibility_timeout: float = 30.0) -> Tuple[int, dict]:
        return await self.state.queue_pop(name, visibility_timeout)

    async def queue_ack(self, name: str, msg_id: int) -> bool:
        return self.state.queue_ack(name, msg_id)

    async def queue_len(self, name: str) -> int:
        return self.state.queue_len(name)

class Watch:
    def __init__(self, state: ControlPlaneState, q: asyncio.Queue) -> None:
        self._state, self._q = state, q

    async def next(self) -> WatchEvent:
        return await self._q.get()

    def cancel(self) -> None:
        self._state.unwatch(self._q)

    def __aiter__(self):
        return self

    async def __anext__(self) -> WatchEvent:
        return await self.next()


class Subscription:
    def __init__(self, state, subject: str, q: asyncio.Queue) -> None:
        self._state, self.subject, self._q = state, subject, q

    async def next(self) -> dict:
        return await self._q.get()

    def cancel(self) -> None:
        self._state.unsubscribe(self.subject, self._q)

    def __aiter__(self):
        return self

    async def __anext__(self) -> dict:
        return await self.next()
