"""Streaming RPC between processes: one request in → many responses out
(port of `dynamo_tpu/runtime/rpc.py`).

The reference implements this as a NATS publish to the instance's subject
plus a TCP "call-home" stream for responses (`egress/addressed_router.rs`,
`ingress/push_endpoint.rs:33`, `tcp/server.rs:74`).  Direct peer TCP does
both jobs here: the client connects to the worker's advertised address
(from control-plane discovery) and multiplexes request streams over that
connection — fewer hops, no broker on the data path.

Framing: 4-byte big-endian length + a `packb` body.
  client → server: {t:"req", sid, ep, payload, trace?} | {t:"cancel", sid}
  server → client: {t:"delta"|"end"|"err", sid, payload|error}

The optional `trace` field carries a serialized TraceContext
(runtime/tracing.py): the client stamps its `rpc.client:{endpoint}`
span's context on the request frame, the server extracts it, opens an
`rpc.server:{ep}` span parented to the client span, and makes it the
handler task's current span — so worker-side spans stitch into the
caller's trace.  Absent or malformed trace fields are ignored.

The body codec (`packb` / `unpackb`) is the port's own, on `struct`: it
carries what the reference's msgpack frames carry here — dict, list
(a tuple comes back as a list), str, bytes (kept apart from str), int
(signed 64-bit, and unsigned 64-bit block hashes), float, bool and None —
and decodes to the objects msgpack's `unpackb(raw=False)` gives.  Each
value is a one-byte tag, then its payload: 8 bytes for a number, a u32
length and the bytes for str/bytes, a u32 count and the items for
list/dict.

Cancellation propagates: client-side generator close sends `cancel`, the
server cancels the handler task (the reference's CancellationToken chain).
A vanished connection fails all its in-flight streams with ConnectionError
— the signal the migration operator retries on (`migration.rs:27-80`).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import struct
from typing import AsyncIterator, Callable, Dict, Optional

from dynamo_tpu_torch.runtime import tracing

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
_I64 = struct.Struct(">q")
_U64 = struct.Struct(">Q")
_F64 = struct.Struct(">d")
MAX_FRAME = 64 * 1024 * 1024


def _pack(obj, put) -> None:
    if obj is None:
        put(b"N")
    elif obj is True:
        put(b"T")
    elif obj is False:
        put(b"F")
    elif isinstance(obj, int):
        if -(1 << 63) <= obj < (1 << 63):
            put(b"i" + _I64.pack(obj))
        elif 0 <= obj < (1 << 64):
            put(b"u" + _U64.pack(obj))
        else:
            raise OverflowError(f"int {obj} does not fit 64 bits")
    elif isinstance(obj, float):
        put(b"f" + _F64.pack(obj))
    elif isinstance(obj, str):
        b = obj.encode()
        put(b"s" + _LEN.pack(len(b)))
        put(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        put(b"b" + _LEN.pack(len(b)))
        put(b)
    elif isinstance(obj, (list, tuple)):
        put(b"l" + _LEN.pack(len(obj)))
        for x in obj:
            _pack(x, put)
    elif isinstance(obj, dict):
        put(b"d" + _LEN.pack(len(obj)))
        for k, v in obj.items():
            _pack(k, put)
            _pack(v, put)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    parts: list = []
    _pack(obj, parts.append)
    return b"".join(parts)


def _unpack(buf: bytes, pos: int):
    tag = buf[pos]
    pos += 1
    if tag in b"ifu":
        codec = _I64 if tag == ord("i") else _F64 if tag == ord("f") else _U64
        return codec.unpack_from(buf, pos)[0], pos + 8
    if tag == ord("N"):
        return None, pos
    if tag == ord("T"):
        return True, pos
    if tag == ord("F"):
        return False, pos
    (n,) = _LEN.unpack_from(buf, pos)
    pos += 4
    if tag in b"sb":
        end = pos + n
        if end > len(buf):
            raise ValueError("truncated frame")
        raw = buf[pos:end]
        return (raw.decode() if tag == ord("s") else raw), end
    if tag == ord("l"):
        out = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            out.append(item)
        return out, pos
    if tag == ord("d"):
        d = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            d[k], pos = _unpack(buf, pos)
        return d, pos
    raise ValueError(f"bad tag {tag!r}")


def unpackb(data: bytes):
    try:
        obj, pos = _unpack(data, 0)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated frame: {e}") from None
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the value")
    return obj


_DRAIN_HIGH_WATER = 1 << 20  # 1 MiB of buffered frames before yielding


async def _send_frame(writer: asyncio.StreamWriter, obj: dict,
                      lock: asyncio.Lock) -> None:
    """One frame per message, but NOT one drain per message: write() is
    synchronous (the frame bytes go down in a single call, so no lock is
    needed for atomicity) and drain() only runs once the transport
    buffer passes the high-water mark.  A drain per token-delta awaited
    a lock + flow-control round per token and capped the worker's egress
    at ~2k msgs/s (frontend_bench); buffered writes let the event loop
    batch syscalls across every active stream."""
    body = packb(obj)
    writer.write(_LEN.pack(len(body)) + body)
    transport = writer.transport
    if (transport is not None
            and transport.get_write_buffer_size() > _DRAIN_HIGH_WATER):
        async with lock:
            await writer.drain()


async def _read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    try:
        body = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return unpackb(body)


# Handler: async generator taking a payload dict, yielding payload dicts.
Handler = Callable[[dict], AsyncIterator[dict]]


class RpcServer:
    """Hosts named endpoints; one instance per worker process."""

    def __init__(self) -> None:
        self._handlers: Dict[str, Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: set = set()
        self._conn_tasks: set = set()  # live per-connection handler tasks
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self.active_streams = 0

    def register(self, endpoint: str, handler: Handler) -> None:
        self._handlers[endpoint] = handler

    def unregister(self, endpoint: str) -> None:
        self._handlers.pop(endpoint, None)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.host = host
        self.port = self._server.sockets[0].getsockname()[1]
        return self.address

    async def stop(self) -> None:
        """Stop accepting AND sever live connections — a stopped server
        must look dead to clients (their in-flight streams fail with
        ConnectionError, triggering migration retries)."""
        if self._server:
            self._server.close()
            # Sever live connections BEFORE wait_closed(): on Python 3.12+
            # wait_closed blocks until every connection handler returns,
            # and handlers sit in blocking reads until their transport dies.
            for w in list(self._connections):
                w.close()
            await self._server.wait_closed()
        # Await per-connection handler tasks so none is destroyed pending
        # at loop close (asyncio teardown warnings in test fixtures).
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        self._conn_tasks.clear()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        tasks: Dict[int, asyncio.Task] = {}
        lock = asyncio.Lock()
        self._connections.add(writer)
        me = asyncio.current_task()
        if me is not None:
            self._conn_tasks.add(me)

        async def run_stream(sid: int, ep: str, payload: dict,
                             trace=None) -> None:
            self.active_streams += 1
            # Server-side span parented to the client's span (the `trace`
            # frame field); made current for the handler task so any span
            # the handler opens nests under it.
            tracer = tracing.get_tracer()
            span: object = tracing.NULL_SPAN
            token = None
            if tracer.enabled and trace is not None:
                ctx = tracing.TraceContext.from_wire(trace)
                if ctx is not None:
                    span = tracer.start_span(f"rpc.server:{ep}", ctx,
                                             attrs={"endpoint": ep})
                    token = tracing.use_span(span)
            try:
                handler = self._handlers.get(ep)
                if handler is None:
                    await _send_frame(writer,
                                      {"t": "err", "sid": sid,
                                       "error": f"no such endpoint {ep!r}"},
                                      lock)
                    return
                async for delta in handler(payload):
                    await _send_frame(writer,
                                      {"t": "delta", "sid": sid,
                                       "payload": delta}, lock)
                await _send_frame(writer, {"t": "end", "sid": sid}, lock)
            except asyncio.CancelledError:
                raise
            except ConnectionResetError:
                pass
            except Exception as e:
                logger.exception("handler error on %s", ep)
                span.set_attr(error=type(e).__name__)
                try:
                    await _send_frame(writer, {"t": "err", "sid": sid,
                                               "error": str(e)}, lock)
                except ConnectionResetError:
                    pass
            finally:
                span.end()
                if token is not None:
                    tracing.restore(token)
                self.active_streams -= 1
                tasks.pop(sid, None)

        try:
            while True:
                msg = await _read_frame(reader)
                if msg is None:
                    break
                t = msg.get("t")
                if t == "req":
                    sid = msg["sid"]
                    tasks[sid] = asyncio.create_task(
                        run_stream(sid, msg["ep"], msg.get("payload", {}),
                                   msg.get("trace")))
                elif t == "cancel":
                    task = tasks.pop(msg["sid"], None)
                    if task:
                        task.cancel()
        finally:
            for task in tasks.values():
                task.cancel()
            if tasks:
                await asyncio.gather(*tasks.values(),
                                     return_exceptions=True)
            self._connections.discard(writer)
            if me is not None:
                self._conn_tasks.discard(me)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                # dynamo-lint: disable=DL003 teardown: peer already gone
                pass  # nothing to salvage — the connection is history


class RpcClient:
    """Multiplexed client to one worker address.  Reconnects lazily; a dead
    connection fails in-flight streams (callers retry via migration)."""

    def __init__(self, address: str) -> None:
        self.address = address
        host, port = address.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._rx: Optional[asyncio.Task] = None
        self._sid = itertools.count(1)
        self._streams: Dict[int, asyncio.Queue] = {}
        self._lock = asyncio.Lock()
        self._conn_lock = asyncio.Lock()

    async def _ensure_connected(self) -> None:
        async with self._conn_lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            self._reader, self._writer = await asyncio.open_connection(
                self._host, self._port)
            self._rx = asyncio.create_task(self._rx_loop())

    async def close(self) -> None:
        if self._rx:
            self._rx.cancel()
            try:
                await self._rx
            except asyncio.CancelledError:
                pass
        if self._writer:
            self._writer.close()
            self._writer = None

    async def _rx_loop(self) -> None:
        assert self._reader is not None
        while True:
            msg = await _read_frame(self._reader)
            if msg is None:
                # Connection died: poison all in-flight streams.
                for q in self._streams.values():
                    q.put_nowait({"t": "err", "error": "connection lost",
                                  "_conn": True})
                self._streams.clear()
                if self._writer:
                    self._writer.close()
                    self._writer = None
                return
            q = self._streams.get(msg.get("sid"))
            if q is not None:
                q.put_nowait(msg)

    async def call(self, endpoint: str, payload: dict) -> AsyncIterator[dict]:
        """Issue a streaming request; yields response payloads."""
        await self._ensure_connected()
        sid = next(self._sid)
        q: asyncio.Queue = asyncio.Queue()
        self._streams[sid] = q
        # Client-side span; its context rides the request frame so the
        # server span parents under it.
        span = tracing.get_tracer().start_span(
            f"rpc.client:{endpoint}",
            attrs={"endpoint": endpoint, "address": self.address})
        frame = {"t": "req", "sid": sid, "ep": endpoint, "payload": payload}
        if span.ctx is not None:
            frame["trace"] = span.ctx.to_wire()
        done = False
        try:
            # Inside the try: a send failure (peer died mid-write) must
            # still end the span and drop the stream entry in finally.
            await _send_frame(self._writer, frame, self._lock)
            while True:
                msg = await q.get()
                t = msg["t"]
                if t == "delta":
                    yield msg["payload"]
                elif t == "end":
                    done = True
                    return
                elif t == "err":
                    done = True
                    if msg.get("_conn"):
                        raise ConnectionError(msg["error"])
                    raise RpcError(msg["error"])
        finally:
            span.end(clean=done)
            self._streams.pop(sid, None)
            # Best-effort cancel only if the stream didn't finish cleanly
            # (client walked away mid-stream).
            if (not done and self._writer is not None
                    and not self._writer.is_closing()):
                try:
                    await _send_frame(self._writer,
                                      {"t": "cancel", "sid": sid}, self._lock)
                except (ConnectionError, ConnectionResetError):
                    pass


class RpcError(RuntimeError):
    """Remote handler raised; message carries the remote error string."""
