"""TCP transport for the control plane (multi-process deployments).

Port of `dynamo_tpu/runtime/control_plane_tcp.py`.

`ControlPlaneServer` hosts a ControlPlaneState over asyncio TCP with
newline-delimited JSON frames; `ControlPlaneClient` implements the same
interface as InProcessControlPlane, so DistributedRuntime doesn't care
which it got.  The wire protocol is deliberately transport-simple
(line-delimited JSON) so alternative broker implementations can speak it
without sharing code.

Wire protocol (one JSON object per line):
  request:  {"op": <name>, "id": N, ...args}
  response: {"id": N, "ok": true, ...result} | {"id": N, "ok": false, "error": ...}
  pushed:   {"push": "watch"|"sub", "sid": S, ...payload}

Connection death cleans up that client's watches/subscriptions; leases die
by TTL (a dead worker's instance keys vanish within one lease TTL, the
reference's liveness model — `transports/etcd/lease.rs`).

A frame may be up to FRAME_LIMIT bytes: a model card carries its
checkpoint's tokenizer.json inline (a real Llama-3 one is about 9 MB),
past asyncio's default 64 KiB line limit.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
from typing import Dict, Optional

from dynamo_tpu_torch.runtime.control_plane import (
    ControlPlaneState,
    WatchEvent,
)


FRAME_LIMIT = 64 * 1024 * 1024     # bytes of one JSON line, either way
# How long an entry point (worker, frontend, router service, planner,
# metrics aggregator) started beside its control plane waits for it to
# listen.
STARTUP_WAIT_S = 60.0
logger = logging.getLogger(__name__)


class ControlPlaneServer:
    def __init__(self, state: Optional[ControlPlaneState] = None) -> None:
        self.state = state or ControlPlaneState()
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: set = set()
        self._handlers: set = set()   # live per-connection handler tasks
        self.port: Optional[int] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, host, port,
                                                  limit=FRAME_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.state._reaper is None:
            self.state._reaper = asyncio.create_task(self.state.run_reaper())
        logger.info("control plane on %s:%d", host, self.port)
        return self.port

    async def stop(self) -> None:
        if self.state._reaper:
            self.state._reaper.cancel()
            try:
                await self.state._reaper
            except asyncio.CancelledError:
                pass
            self.state._reaper = None
        if self._server:
            self._server.close()
            # Sever live client connections before wait_closed(): on
            # Python 3.12+ it blocks until every connection handler
            # returns, and handlers sit in blocking reads.
            for w in list(self._connections):
                w.close()
            await self._server.wait_closed()
        # Await the per-connection handler tasks: a handler still parked
        # in readline() at loop close is a "Task was destroyed but it is
        # pending!" warning in every test teardown that stops a server.
        for t in list(self._handlers):
            t.cancel()
        if self._handlers:
            await asyncio.gather(*self._handlers, return_exceptions=True)
        self._handlers.clear()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._connections.add(writer)
        task = asyncio.current_task()
        if task is not None:
            self._handlers.add(task)
        watches: Dict[int, asyncio.Queue] = {}
        subs: Dict[int, tuple] = {}     # sid → (subject, queue)
        pumps: list = []
        send_lock = asyncio.Lock()

        async def send(obj: dict) -> None:
            async with send_lock:
                writer.write(json.dumps(obj).encode() + b"\n")
                await writer.drain()

        async def pump_watch(sid: int, q: asyncio.Queue) -> None:
            while True:
                ev: WatchEvent = await q.get()
                await send({"push": "watch", "sid": sid, "kind": ev.kind,
                            "key": ev.key, "value": ev.value})

        async def pump_sub(sid: int, q: asyncio.Queue) -> None:
            while True:
                payload = await q.get()
                await send({"push": "sub", "sid": sid, "payload": payload})

        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    await send({"ok": False, "error": "bad json", "id": None})
                    continue
                op, mid = msg.get("op"), msg.get("id")
                st = self.state
                try:
                    if op == "lease_grant":
                        res = {"lease": st.lease_grant(msg.get("ttl", 10.0))}
                    elif op == "lease_keepalive":
                        res = {"alive": st.lease_keepalive(msg["lease"])}
                    elif op == "lease_revoke":
                        st.lease_revoke(msg["lease"])
                        res = {}
                    elif op == "put":
                        st.put(msg["key"], msg["value"], msg.get("lease"))
                        res = {}
                    elif op == "get":
                        res = {"value": st.get(msg["key"])}
                    elif op == "get_prefix":
                        res = {"values": st.get_prefix(msg["prefix"])}
                    elif op == "delete":
                        res = {"deleted": st.delete(msg["key"])}
                    elif op == "watch":
                        sid = msg["sid"]
                        q = st.watch_prefix(msg["prefix"])
                        watches[sid] = q
                        pumps.append(asyncio.create_task(pump_watch(sid, q)))
                        res = {}
                    elif op == "unwatch":
                        q = watches.pop(msg["sid"], None)
                        if q:
                            st.unwatch(q)
                        res = {}
                    elif op == "subscribe":
                        sid = msg["sid"]
                        q = st.subscribe(msg["subject"])
                        subs[sid] = (msg["subject"], q)
                        pumps.append(asyncio.create_task(pump_sub(sid, q)))
                        res = {}
                    elif op == "unsubscribe":
                        subj_q = subs.pop(msg["sid"], None)
                        if subj_q:
                            st.unsubscribe(*subj_q)
                        res = {}
                    elif op == "publish":
                        res = {"n": st.publish(msg["subject"], msg["payload"])}
                    elif op == "queue_push":
                        st.queue_push(msg["queue"], msg["payload"])
                        res = {}
                    elif op == "queue_pop":
                        # Async pop: the reply goes out when an item
                        # arrives; the connection keeps serving meanwhile.
                        async def do_pop(mid=mid, name=msg["queue"],
                                         vt=msg.get("visibility_timeout",
                                                    30.0)):
                            msg_id, item = await st.queue_pop(name, vt)
                            await send({"id": mid, "ok": True,
                                        "msg_id": msg_id, "payload": item})
                        pumps.append(asyncio.create_task(do_pop()))
                        continue
                    elif op == "queue_ack":
                        res = {"acked": st.queue_ack(msg["queue"],
                                                     msg["msg_id"])}
                    elif op == "queue_len":
                        res = {"n": st.queue_len(msg["queue"])}
                    else:
                        raise ValueError(f"unknown op {op!r}")
                    await send({"id": mid, "ok": True, **res})
                except Exception as e:  # per-op failure, connection survives
                    await send({"id": mid, "ok": False, "error": str(e)})
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            for t in pumps:
                t.cancel()
            # Await the cancellations: a cancelled-but-never-awaited pump
            # is destroyed pending at loop close (the asyncio teardown
            # warnings the HTTP-service tests leaked).
            if pumps:
                await asyncio.gather(*pumps, return_exceptions=True)
            for q in watches.values():
                self.state.unwatch(q)
            for subj, q in subs.values():
                self.state.unsubscribe(subj, q)
            self._connections.discard(writer)
            if task is not None:
                self._handlers.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                # dynamo-lint: disable=DL003 teardown: peer already gone
                pass  # nothing to salvage — the connection is history


_POISON = object()  # sentinel pushed into stream queues on connection death


class _RemoteWatch:
    def __init__(self, client: "ControlPlaneClient", sid: int,
                 prefix: str) -> None:
        self._client, self._sid = client, sid
        self.prefix = prefix  # re-established on client reconnect
        self.queue: asyncio.Queue = asyncio.Queue()

    async def next(self) -> WatchEvent:
        item = await self.queue.get()
        if item is _POISON:
            raise ConnectionError("control plane connection lost")
        return item

    def cancel(self) -> None:
        self._client._drop_watch(self._sid)

    def __aiter__(self):
        return self

    async def __anext__(self) -> WatchEvent:
        return await self.next()


class _RemoteSubscription:
    def __init__(self, client: "ControlPlaneClient", sid: int,
                 subject: str) -> None:
        self._client, self._sid, self.subject = client, sid, subject
        self.queue: asyncio.Queue = asyncio.Queue()

    async def next(self) -> dict:
        item = await self.queue.get()
        if item is _POISON:
            raise ConnectionError("control plane connection lost")
        return item

    def cancel(self) -> None:
        self._client._drop_sub(self._sid)

    def __aiter__(self):
        return self

    async def __anext__(self) -> dict:
        return await self.next()


class ControlPlaneClient:
    """TCP client with the InProcessControlPlane interface.

    Reconnects automatically: on connection loss the rx loop fails all
    pending calls, poisons stream queues ONCE (consumers see one
    ConnectionError per outage), then dials back with backoff and
    re-establishes every live watch/subscription under its original sid —
    the server replays watch state as synthetic puts
    (ControlPlaneState.watch_prefix), so watchers converge.  Leases are
    NOT restored (they expire server-side by TTL; the keepalive loop logs
    loudly — re-registration is the worker's job, the reference's
    etcd-lease model)."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._mid = itertools.count(1)
        self._sid = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watches: Dict[int, _RemoteWatch] = {}
        self._subs: Dict[int, _RemoteSubscription] = {}
        self._rx_task: Optional[asyncio.Task] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._keepalive_tasks: Dict[int, asyncio.Task] = {}
        self._send_lock = asyncio.Lock()
        self._closed = False
        self._reconnecting = False
        self._conn_gen = 0  # bumps per (re)connect; stale rx loops exit
        # Session-loss callbacks: fired (as tasks) after a successful
        # reconnect, and when a keepalive discovers its lease expired
        # server-side.  Both mean every lease this client held is gone —
        # registrations must be replayed (the reference's etcd-lease
        # model: `transports/etcd/lease.rs` recovery is the worker's
        # job).  Endpoint.serve installs the replay.
        self._session_callbacks: list = []
        # Tasks started from sync code (session-loss callbacks, unwatch /
        # unsubscribe calls), referenced until done: the loop holds tasks
        # weakly.
        self._background: set = set()

    def on_session_loss(self, cb) -> None:
        """Register an async callback fired when this client's server-side
        session state (leases + leased keys) is known to be lost."""
        self._session_callbacks.append(cb)

    def remove_session_callback(self, cb) -> None:
        if cb in self._session_callbacks:
            self._session_callbacks.remove(cb)

    def _spawn(self, coro, on_done) -> None:
        task = asyncio.ensure_future(coro)
        self._background.add(task)
        task.add_done_callback(self._background.discard)
        task.add_done_callback(on_done)

    def _fire_session_loss(self) -> None:
        for cb in list(self._session_callbacks):
            self._spawn(cb(), lambda t: t.cancelled() or (
                t.exception() and logger.error(
                    "session-loss callback failed: %s", t.exception())))

    async def start(self, wait_s: float = 0.0) -> None:
        """Connect; with `wait_s`, a refused connection is dialled again
        until the server listens or `wait_s` has passed (a process
        started beside its control plane)."""
        self._closed = False
        loop = asyncio.get_running_loop()
        deadline = loop.time() + wait_s
        while True:
            try:
                self._reader, self._writer = await asyncio.open_connection(
                    self.host, self.port, limit=FRAME_LIMIT)
                break
            except OSError:
                if loop.time() >= deadline:
                    raise
                await asyncio.sleep(0.1)
        self._rx_task = asyncio.create_task(self._rx_loop())

    async def close(self) -> None:
        self._closed = True
        for t in self._keepalive_tasks.values():
            t.cancel()
        for t in (self._rx_task, self._reconnect_task):
            if t:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
        self._fail_all(ConnectionError("control plane client closed"))
        if self._writer:
            self._writer.close()

    def _fail_pending(self, exc: Exception) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    def _fail_all(self, exc: Exception) -> None:
        """Connection is gone: fail pending calls AND poison stream queues
        ONCE, so watchers/subscribers surface the outage (one
        ConnectionError per outage, not per reconnect attempt) instead of
        waiting on a frozen queue forever."""
        self._fail_pending(exc)
        for w in self._watches.values():
            w.queue.put_nowait(_POISON)
        for s in self._subs.values():
            s.queue.put_nowait(_POISON)

    async def _rx_loop(self) -> None:
        # Capture this connection's identity: after a reconnect a stale rx
        # loop must neither read the NEW socket nor trigger another
        # reconnect (two live loops would clobber _reader/_writer and
        # double-register every sid).
        reader = self._reader
        gen = self._conn_gen
        assert reader is not None
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                msg = json.loads(line)
                push = msg.get("push")
                if push == "watch":
                    w = self._watches.get(msg["sid"])
                    if w:
                        w.queue.put_nowait(WatchEvent(
                            msg["kind"], msg["key"], msg.get("value")))
                elif push == "sub":
                    s = self._subs.get(msg["sid"])
                    if s:
                        s.queue.put_nowait(msg["payload"])
                else:
                    fut = self._pending.pop(msg.get("id"), None)
                    if fut and not fut.done():
                        fut.set_result(msg)
        except (ConnectionResetError, OSError):
            pass
        if self._closed or gen != self._conn_gen:
            return  # shut down, or a newer connection owns the client
        self._fail_all(ConnectionError("control plane gone"))
        self._writer = None  # _call fails fast until reconnected
        self._schedule_reconnect()

    def _schedule_reconnect(self) -> None:
        if self._closed or self._reconnecting:
            return
        self._reconnecting = True
        self._reconnect_task = asyncio.create_task(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        backoff = 0.5
        try:
            while not self._closed:
                # Each attempt owns a fresh generation, bumped BEFORE the
                # dial so the rx loop of any prior attempt exits silently
                # (a bump only after success would let a failed attempt's
                # rx re-poison every stream queue on its EOF — the
                # per-retry spam the gen guard exists to prevent).
                # Pending calls of the broken attempt are failed here
                # rather than left hanging.
                self._conn_gen += 1
                self._fail_pending(ConnectionError(
                    "control plane reconnecting"))
                try:
                    reader, writer = await asyncio.open_connection(
                        self.host, self.port, limit=FRAME_LIMIT)
                except OSError:
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, 15.0)
                    continue
                self._conn_gen += 1
                self._reader, self._writer = reader, writer
                self._rx_task = asyncio.create_task(self._rx_loop())
                try:
                    # Re-establish stream state under the original sids:
                    # the server replays watch state as synthetic puts;
                    # sub streams simply resume from now.
                    for sid, w in list(self._watches.items()):
                        await asyncio.wait_for(
                            self._call("watch", prefix=w.prefix, sid=sid),
                            10.0)
                    for sid, s in list(self._subs.items()):
                        await asyncio.wait_for(
                            self._call("subscribe", subject=s.subject,
                                       sid=sid), 10.0)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    continue  # connection died again: dial once more
                logger.info("control plane reconnected (%d watches, %d "
                            "subs restored)", len(self._watches),
                            len(self._subs))
                # Leases did not survive (server restart or TTL expiry
                # during the outage).  Cancel their keepalive loops FIRST
                # — a stale loop finding alive=False would fire a second
                # session-loss, double-registering every endpoint and
                # leaking the first replacement lease — then let owners
                # re-register (each grant starts a fresh keepalive).
                for t in self._keepalive_tasks.values():
                    t.cancel()
                self._keepalive_tasks.clear()
                self._fire_session_loss()
                return
        finally:
            self._reconnecting = False

    async def _call(self, op: str, **kw) -> dict:
        if self._writer is None or self._writer.is_closing():
            raise ConnectionError("control plane not connected")
        mid = next(self._mid)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[mid] = fut
        async with self._send_lock:
            self._writer.write(
                json.dumps({"op": op, "id": mid, **kw}).encode() + b"\n")
            await self._writer.drain()
        msg = await fut
        if not msg.get("ok"):
            raise RuntimeError(f"control plane {op} failed: {msg.get('error')}")
        return msg

    # -- leases -----------------------------------------------------------

    async def lease_grant(self, ttl: float = 10.0,
                          auto_keepalive: bool = True) -> int:
        lease = (await self._call("lease_grant", ttl=ttl))["lease"]
        if auto_keepalive:
            self._keepalive_tasks[lease] = asyncio.create_task(
                self._keepalive_loop(lease, ttl))
        return lease

    async def _keepalive_loop(self, lease: int, ttl: float) -> None:
        try:
            while True:
                await asyncio.sleep(ttl / 3.0)
                try:
                    msg = await self._call("lease_keepalive", lease=lease)
                except (RuntimeError, ConnectionError):
                    return
                if not msg.get("alive"):
                    # Lease expired server-side (stall > TTL; a restart
                    # drops the connection and goes through reconnect
                    # instead): registrations are gone.  Fire the
                    # session-loss path so owners re-register.
                    logger.error(
                        "lease %d expired server-side; replaying "
                        "registrations", lease)
                    self._keepalive_tasks.pop(lease, None)
                    self._fire_session_loss()
                    return
        except asyncio.CancelledError:
            pass

    async def lease_revoke(self, lease: int) -> None:
        t = self._keepalive_tasks.pop(lease, None)
        if t:
            t.cancel()
        await self._call("lease_revoke", lease=lease)

    # -- kv ---------------------------------------------------------------

    async def put(self, key: str, value: dict,
                  lease: Optional[int] = None) -> None:
        await self._call("put", key=key, value=value, lease=lease)

    async def get(self, key: str) -> Optional[dict]:
        return (await self._call("get", key=key))["value"]

    async def get_prefix(self, prefix: str) -> Dict[str, dict]:
        return (await self._call("get_prefix", prefix=prefix))["values"]

    async def delete(self, key: str) -> bool:
        return (await self._call("delete", key=key))["deleted"]

    async def watch_prefix(self, prefix: str) -> _RemoteWatch:
        sid = next(self._sid)
        w = _RemoteWatch(self, sid, prefix)
        self._watches[sid] = w
        await self._call("watch", prefix=prefix, sid=sid)
        return w

    def _call_soon(self, op: str, **kw) -> None:
        """Best-effort call from sync code (a watch or subscription being
        cancelled): its failure, e.g. the client closing first, is
        retrieved and dropped rather than logged as never retrieved."""
        self._spawn(self._call(op, **kw),
                    lambda t: t.cancelled() or t.exception())

    def _drop_watch(self, sid: int) -> None:
        self._watches.pop(sid, None)
        self._call_soon("unwatch", sid=sid)

    # -- pub/sub ----------------------------------------------------------

    async def publish(self, subject: str, payload: dict) -> None:
        await self._call("publish", subject=subject, payload=payload)

    async def subscribe(self, subject: str) -> _RemoteSubscription:
        sid = next(self._sid)
        s = _RemoteSubscription(self, sid, subject)
        self._subs[sid] = s
        await self._call("subscribe", subject=subject, sid=sid)
        return s

    def _drop_sub(self, sid: int) -> None:
        self._subs.pop(sid, None)
        self._call_soon("unsubscribe", sid=sid)

    # -- queues -----------------------------------------------------------

    async def queue_push(self, name: str, payload: dict) -> None:
        await self._call("queue_push", queue=name, payload=payload)

    async def queue_pop(self, name: str,
                        visibility_timeout: float = 30.0):
        msg = await self._call("queue_pop", queue=name,
                               visibility_timeout=visibility_timeout)
        return msg["msg_id"], msg["payload"]

    async def queue_ack(self, name: str, msg_id: int) -> bool:
        return (await self._call("queue_ack", queue=name,
                                 msg_id=msg_id))["acked"]

    async def queue_len(self, name: str) -> int:
        return (await self._call("queue_len", queue=name))["n"]
