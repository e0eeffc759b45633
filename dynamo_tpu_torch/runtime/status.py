"""Per-process status server: /live, /health, /metrics, the debug routes
and the engine's stats (port of `dynamo_tpu/runtime/status.py` on the
standard library).

Role of the reference's `system_status_server.rs`: a worker has no HTTP
ingress of its own, so it exposes liveness, readiness and Prometheus
text on a port of its own (`--health-port`).  Beside JAX's routes it
serves the same `/debug/stats` reply and `POST /debug/stats/reset`
action as the port's single-process frontend
(`frontend/main.py:stats_hooks`) for the worker's engine: kernel launch
counts, engine counters and prefix-cache hits.

    GET  /live                    {"status": "live"}
    GET  /health                  {"status": "ready"} (200) or "starting" (503)
    GET  /metrics                 the registry's Prometheus text + extra_text_fn
    GET  /debug/traces?n=K        this process's completed traces
    GET  /debug/slo               the SLO monitor's evaluation (or disabled)
    GET  /debug/flightrecorder?n=K  the flight recorder's ring
    GET  /debug/deviceprofile[?ms=N]  the device profiler's state, or one
                                  bounded capture (off the event loop)
    GET  /debug/stats             the stats hook's reply
    POST /debug/stats/reset       the reset hook, then {"ok": true}

The debug payloads have JAX's shapes.  One request per connection (the
reply closes it).

`register_status_endpoint` / `register_status_endpoint_task` advertise
a status port (with the owning pid) under `STATUS_ENDPOINTS_PREFIX` on
the control plane: the metrics aggregator scrapes it and the planner
and `dynamo top` read it; `registration_pid_dead` lets scrapers reap a
killed process's stale entry.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from typing import Callable, Optional
from urllib.parse import parse_qs

from dynamo_tpu_torch.runtime import device_profiler, flight_recorder, tracing
from dynamo_tpu_torch.runtime import slo as slo_mod
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

logger = logging.getLogger(__name__)

# Control-plane prefix where processes advertise their status servers so
# the metrics_aggregator can scrape /metrics from components that are not
# workers (router_service, planner) — the reference's Prometheus
# service-discovery analog, over our own control plane.
STATUS_ENDPOINTS_PREFIX = "status_endpoints"


async def register_status_endpoint(cp, component: str, port: int,
                                   host: str = "127.0.0.1",
                                   extra: Optional[dict] = None) -> str:
    """Advertise a status server for aggregator scraping; returns the
    key written.  Unleased on purpose: the aggregator treats unreachable
    targets as gone, and the registration carries the owning
    PID, so scrapers (`dynamo top`, metrics_aggregator) can REAP
    a kill -9'd worker's stale entry instead of rendering it
    unreachable forever.  `host` must be a cross-host-routable address
    when the aggregator runs on another machine (same rule as the
    worker's --rpc-host).

    `extra`: additional registration fields (workers attach
    their SliceSpec wire dict under "slice" so `dynamo top` can render
    a MESH column without scraping anything new).  Reserved keys
    (address/component/pid) cannot be overridden."""
    import os

    key = f"{STATUS_ENDPOINTS_PREFIX}/{component}/{os.getpid()}"
    entry = dict(extra or {})
    entry.update({"address": f"{host}:{port}", "component": component,
                  "pid": os.getpid()})
    await cp.put(key, entry)
    return key


def registration_pid_dead(entry) -> bool:
    """True only when a status-endpoint registration names a pid that is
    PROVABLY gone: the entry carries a pid, its address is loopback
    (pid liveness is only decidable same-host — a loopback address from
    another machine was never scrapeable by us anyway), and signal-0
    probing reports no such process.  Everything ambiguous — foreign
    hosts, permission errors, malformed entries — reads as alive, so
    reaping can never take down a live worker's discovery entry."""
    import os

    if not isinstance(entry, dict):
        return False
    pid = entry.get("pid")
    addr = entry.get("address") or ""
    host = addr.rsplit(":", 1)[0] if ":" in addr else ""
    if not pid or host not in ("127.0.0.1", "localhost", "::1", "[::1]"):
        return False
    try:
        os.kill(int(pid), 0)
        return False
    except ProcessLookupError:
        return True
    except (PermissionError, OSError, ValueError, TypeError):
        return False


def register_status_endpoint_task(cp, component: str, port: int,
                                  host: str = "127.0.0.1",
                                  retry_interval: float = 1.0,
                                  extra: Optional[dict] = None):
    """Best-effort registration as a background task: retries until the
    put lands (the control-plane client reconnects underneath), so a
    control plane that is briefly down at process startup neither
    crashes the process nor silently loses its discovery entry.  Returns
    the task (cancel at shutdown)."""
    import asyncio

    async def register():
        while True:
            try:
                await register_status_endpoint(cp, component, port,
                                               host=host, extra=extra)
                return
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # ANY failure retries (ConnectionError while down,
                # RuntimeError from an error reply mid-restart, …): a
                # dead registration task would silently drop this
                # process from fleet discovery forever.
                logger.warning(
                    "status-endpoint registration for %s failed (%s); "
                    "retrying", component, e)
                await asyncio.sleep(retry_interval)

    return asyncio.get_running_loop().create_task(register())


_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            503: "Service Unavailable"}


def query_int(query: dict, name: str, default: int) -> Optional[int]:
    """An integer query parameter; None when malformed."""
    try:
        return int(query.get(name, [str(default)])[0])
    except ValueError:
        return None


BAD_N = 400, {"error": "n must be an integer"}


async def debug_deviceprofile(query: dict):
    """(status, body) of `/debug/deviceprofile`: the profiler's state
    without `?ms=`, one bounded capture with `?ms=N` — run in a thread,
    since it sleeps for its bound while the serving threads dispatch."""
    prof = device_profiler.get_profiler()
    if "ms" not in query:
        return 200, prof.debug_payload()
    try:
        ms = int(query["ms"][0])
        if ms <= 0:
            raise ValueError
    except ValueError:
        return 400, {"error": "ms must be a positive integer"}
    res = await asyncio.to_thread(prof.capture, ms)
    return (200 if res.get("ok") else 503), res


class StatusServer:
    def __init__(self,
                 registry: Optional[MetricsRegistry] = None,
                 ready_fn: Optional[Callable[[], bool]] = None,
                 extra_text_fn: Optional[Callable[[], str]] = None,
                 slo_fn: Optional[Callable[[], dict]] = None,
                 stats_fn: Optional[Callable[[], dict]] = None,
                 reset_fn: Optional[Callable[[], None]] = None) -> None:
        """`ready_fn`: readiness probe (default: ready once serving).
        `extra_text_fn`: extra Prometheus text appended to the registry
        exposition (the worker's engine series).  `slo_fn`: /debug/slo
        payload provider (an SloMonitor's `payload`; None reports the
        monitor as disabled)."""
        self.registry = registry or MetricsRegistry()
        self.ready_fn = ready_fn or (lambda: True)
        self.extra_text_fn = extra_text_fn
        self.slo_fn = slo_fn
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

    def metrics_text(self) -> str:
        text = self.registry.expose()
        if self.extra_text_fn:
            text += self.extra_text_fn()
        return text

    async def _reply(self, method: str, path: str, query: dict):
        """(status, body): a dict is sent as JSON, a str as Prometheus
        text."""
        route = (method, path)
        if route == ("GET", "/live"):
            return 200, {"status": "live"}
        if route == ("GET", "/health"):
            ok = bool(self.ready_fn())
            return (200 if ok else 503), {
                "status": "ready" if ok else "starting"}
        if route == ("GET", "/metrics"):
            return 200, self.metrics_text()
        if route == ("GET", "/debug/traces"):
            n = query_int(query, "n", 32)
            return BAD_N if n is None else (
                200, tracing.debug_traces_payload(n))
        if route == ("GET", "/debug/flightrecorder"):
            n = query_int(query, "n", 256)
            return BAD_N if n is None else (
                200, flight_recorder.get_recorder().debug_payload(n))
        if route == ("GET", "/debug/slo"):
            return 200, (self.slo_fn() if self.slo_fn is not None
                         else slo_mod.disabled_payload())
        if route == ("GET", "/debug/deviceprofile"):
            return await debug_deviceprofile(query)
        if route == ("GET", "/debug/stats") and self.stats_fn:
            return 200, self.stats_fn()
        if route == ("POST", "/debug/stats/reset") and self.reset_fn:
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
            path, _, qs = parts[1].partition("?")
            status, obj = await self._reply(parts[0], path, parse_qs(qs))
            if isinstance(obj, str):
                data, ctype = obj.encode(), "text/plain; version=0.0.4"
            else:
                data, ctype = json.dumps(obj).encode(), "application/json"
            writer.write(
                f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(data)}\r\n"
                "Connection: close\r\n\r\n".encode() + data)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()
