"""Per-process status server: /live, /health and the engine's stats
(port of `dynamo_tpu/runtime/status.py` on the standard library).

Role of the reference's `system_status_server.rs`: a worker has no HTTP
ingress of its own, so it exposes liveness and readiness on a port of its
own (`--health-port`).  Beside them it serves the same `/debug/stats`
reply and `POST /debug/stats/reset` action as the port's single-process
frontend (`frontend/main.py:stats_hooks`) for the worker's engine: kernel
launch counts, engine counters and prefix-cache hits.

    GET  /live               {"status": "live"}
    GET  /health             {"status": "ready"} (200) or "starting" (503)
    GET  /debug/stats        the stats hook's reply
    POST /debug/stats/reset  the reset hook, then {"ok": true}

One request per connection (the reply closes it).  Not ported yet:
`/metrics` (it needs `runtime/metrics.py`) and the HBM poller.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from typing import Callable, Optional

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 404: "Not Found", 503: "Service Unavailable"}


class StatusServer:
    def __init__(self,
                 ready_fn: Optional[Callable[[], bool]] = None,
                 stats_fn: Optional[Callable[[], dict]] = None,
                 reset_fn: Optional[Callable[[], None]] = None) -> None:
        """`ready_fn`: readiness probe (default: ready once serving)."""
        self.ready_fn = ready_fn or (lambda: True)
        self.stats_fn = stats_fn
        self.reset_fn = reset_fn
        self._server: Optional[asyncio.base_events.Server] = None
        self.port: Optional[int] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("status server on %s:%d", host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            with contextlib.suppress(Exception):
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            self._server = None

    def _reply(self, method: str, path: str):
        if (method, path) == ("GET", "/live"):
            return 200, {"status": "live"}
        if (method, path) == ("GET", "/health"):
            ok = bool(self.ready_fn())
            return (200 if ok else 503), {
                "status": "ready" if ok else "starting"}
        if (method, path) == ("GET", "/debug/stats") and self.stats_fn:
            return 200, self.stats_fn()
        if (method, path) == ("POST", "/debug/stats/reset") and self.reset_fn:
            self.reset_fn()
            return 200, {"ok": True}
        return 404, {"error": f"{method} {path} not served"}

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            parts = (await reader.readline()).decode("latin-1").split()
            length = 0
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                if k.strip().lower() == "content-length":
                    length = int(v.strip() or 0)
            if length:
                await reader.readexactly(length)  # no route reads a body
            if len(parts) != 3:
                return
            status, obj = self._reply(parts[0], parts[1].split("?", 1)[0])
            data = json.dumps(obj).encode()
            writer.write(
                f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(data)}\r\n"
                "Connection: close\r\n\r\n".encode() + data)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()
