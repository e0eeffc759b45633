"""Namespace-wide metrics aggregator service (port of
`dynamo_tpu/metrics_aggregator/` on the standard library: the scrape is
`urllib` in worker threads, the exposition the port's status server).

Role of the reference's `components/metrics` Rust binary
(`components/metrics/src/main.rs:15-28`): subscribe to every worker's
`load_metrics` publications and the routers' `kv_hit_rate` events, keep
the latest snapshot per worker, and expose the aggregate as Prometheus
text over HTTP — the series the planner and dashboards scrape.

Additionally scrapes the `/metrics` of any process advertised under the
control plane's `status_endpoints/` prefix (router_service, planner —
components with a status server but no pub/sub metrics stream) and
appends their exposition verbatim, so one aggregator URL covers the whole
namespace.

    python -m dynamo_tpu_torch.metrics_aggregator --control-plane HOST:PORT \
        [--http-port 8081]
"""

from __future__ import annotations

import asyncio
import logging
import re
import time
import urllib.request
from typing import Dict, Optional

from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.llm.kv_router.watcher import LoadMetricsWatcher
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.status import (
    STATUS_ENDPOINTS_PREFIX,
    StatusServer,
    registration_pid_dead,
)

logger = logging.getLogger(__name__)

HIT_RATE_SUBJECT = "kv_hit_rate"
STALE_SECS = 30.0
SCRAPE_INTERVAL = 5.0
SCRAPE_TIMEOUT = 2.0
# A target that keeps failing is carried (marked stale) this long after
# its last success, then dropped entirely.
STALE_DROP_SECS = 60.0

# Request-ledger series scraped from frontends: per-phase histogram
# components and the goodput token counters.
_PHASE_RE = re.compile(
    r'^dynamo_request_phase_seconds_(sum|count)'
    r'\{[^}]*phase="([^"]+)"[^}]*\}\s+([0-9.eE+-]+)')

# Device-truth drift series scraped from workers: the per-series
# modeled-vs-measured ratio and the program-registry size.
_DRIFT_RE = re.compile(
    r'^dynamo_modeled_vs_measured_ratio'
    r'\{[^}]*series="([^"]+)"[^}]*\}\s+([0-9.eE+-]+)')
_REGISTRY_SIZE_RE = re.compile(
    r'^dynamo_program_registry_size\s+([0-9.eE+-]+)')


class MetricsAggregator:
    """Subscribes, aggregates, exposes — and scrapes advertised status
    servers (workers, frontend, router_service, planner)."""

    def __init__(self, cp, scrape_interval: float = SCRAPE_INTERVAL,
                 scrape_timeout: float = SCRAPE_TIMEOUT,
                 stale_drop_secs: float = STALE_DROP_SECS) -> None:
        self.cp = cp
        self.scrape_interval = scrape_interval
        self.scrape_timeout = scrape_timeout
        self.stale_drop_secs = stale_drop_secs
        # address → {"text": last /metrics text, "last_ok": ts,
        #            "stale": last attempt failed}
        self._scraped: Dict[str, dict] = {}
        self.registry = MetricsRegistry(prefix="dynamo_aggregate")
        self._scrape_failures = self.registry.counter(
            "scrape_failures_total",
            "Failed /metrics scrapes of advertised status endpoints")
        self._endpoint_reaps = self.registry.counter(
            "endpoint_reaps_total",
            "Stale status-endpoint registrations deleted because their "
            "recorded pid is provably dead (kill -9'd worker cleanup)")
        self._watcher = LoadMetricsWatcher(cp, stale_secs=STALE_SECS,
                                           name="aggregator")
        self._tasks = []
        self._subs = []
        # Router-side KV hit telemetry.
        self._hit_isl = self.registry.counter(
            "kv_hit_isl_blocks_total", "request prefix blocks seen by router")
        self._hit_overlap = self.registry.counter(
            "kv_hit_overlap_blocks_total", "blocks already cached on the "
            "chosen worker")
        self._g_workers = self.registry.gauge(
            "workers", "workers with fresh load_metrics")
        self._g_active = self.registry.gauge(
            "request_active_slots", "active request slots across workers")
        self._g_waiting = self.registry.gauge(
            "requests_waiting", "queued requests across workers")
        self._g_blocks = self.registry.gauge(
            "kv_active_blocks", "active KV blocks across workers")
        self._g_usage = self.registry.gauge(
            "kv_usage_mean", "mean device cache usage across workers")
        # Fleet goodput attribution: every frontend folds its
        # completed request ledgers into
        # dynamo_request_phase_seconds{phase=} + the goodput counter
        # pair; the aggregator re-exposes them pre-summed.  Merge
        # semantics are SUM: a phase's fleet mean is
        # sum(_sum)/sum(_count) across frontends, and goodput is the
        # summed token counters' ratio — both hold because every
        # underlying series is a monotone per-instance total.
        self._g_phase_sum = self.registry.gauge(
            "request_phase_seconds_sum",
            "summed ledger phase seconds across frontends (label phase=)")
        self._g_phase_count = self.registry.gauge(
            "request_phase_seconds_count",
            "summed ledger phase observations across frontends "
            "(label phase=)")
        self._g_goodput_good = self.registry.gauge(
            "goodput_good_tokens",
            "output tokens from SLO-good requests across frontends")
        self._g_goodput_total = self.registry.gauge(
            "goodput_tokens",
            "output tokens from all finished requests across frontends")
        self._g_goodput = self.registry.gauge(
            "goodput_ratio",
            "fleet goodput: SLO-good tokens / total tokens (0 when no "
            "tokens yet)")
        # Device-truth drift: workers audit their analytical model
        # (KV-byte accounting, roofline time) against the measured
        # program costs and expose
        # dynamo_modeled_vs_measured_ratio{series=}.  Merge semantics
        # are MEAN per series: the ratio is already a normalized
        # per-worker quantity (modeled/measured), so summing would scale
        # with fleet size while a mean stays comparable to the
        # per-worker drift band.  Registry sizes SUM — distinct workers
        # compile distinct program sets.
        self._g_drift_ratio = self.registry.gauge(
            "modeled_vs_measured_ratio",
            "mean modeled-vs-measured drift ratio across workers "
            "(label series=; >1 = the analytical model over-claims)")
        self._g_registry_size = self.registry.gauge(
            "program_registry_size",
            "program cost-registry entries summed across workers")

    async def start(self) -> None:
        await self._watcher.start()
        sub = await self.cp.subscribe(HIT_RATE_SUBJECT)
        self._subs.append(sub)
        self._tasks.append(asyncio.create_task(self._pump_hits(sub)))
        self._tasks.append(asyncio.create_task(self._scrape_loop()))

    async def stop(self) -> None:
        await self._watcher.stop()
        for s in self._subs:
            s.cancel()
        for t in self._tasks:
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass

    async def _pump_hits(self, sub) -> None:
        backoff = 1.0
        while True:
            try:
                payload = await sub.next()
                backoff = 1.0
            except asyncio.CancelledError:
                raise
            except ConnectionError:
                # Don't go silently dark until restart: the control-plane
                # client reconnects and restores this SAME subscription;
                # keep draining after a pause.
                logger.warning("kv_hit_rate subscription lost; waiting "
                               "%.0fs for reconnect", backoff)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 30.0)
                continue
            try:
                self._hit_isl.inc(float(payload["isl_blocks"]))
                self._hit_overlap.inc(float(payload["overlap_blocks"]))
            except Exception:
                logger.exception("bad kv_hit_rate payload")

    async def _scrape_once(self) -> None:
        """One sweep of `/metrics` from every status server advertised
        under `status_endpoints/` (runtime/status.register_status_endpoint).

        Failure policy (a crashed worker must be VISIBLE, not silently
        flat): a failed target increments
        `dynamo_aggregate_scrape_failures_total`, its last-good series
        stay in the exposition behind a STALE comment for
        `stale_drop_secs` after the last success, and only then drop.
        Targets no longer advertised drop immediately.  A failed target
        whose registration pid is provably dead
        (`runtime/status.registration_pid_dead` — loopback address +
        signal-0 probe) is REAPED: its key is deleted from the control
        plane and `dynamo_aggregate_endpoint_reaps_total` counts it, so
        kill -9'd workers stop haunting discovery forever."""
        entries = await self.cp.get_prefix(f"{STATUS_ENDPOINTS_PREFIX}/")
        # addr → (key, entry): the reap path needs the key to delete and
        # the entry's pid to probe (first registration per address wins).
        by_addr: Dict[str, tuple] = {}
        for key, entry in sorted(entries.items()):
            if isinstance(entry, dict) and entry.get("address"):
                by_addr.setdefault(entry["address"], (key, entry))
        addrs = sorted(by_addr)
        results = []
        if addrs:
            # Per-endpoint timeout: one hung target must not consume the
            # sweep's whole budget and starve the others.
            def get(addr):
                with urllib.request.urlopen(
                        f"http://{addr}/metrics",
                        timeout=self.scrape_timeout) as resp:
                    return resp.read().decode()

            async def fetch(addr):
                try:
                    return addr, await asyncio.to_thread(get, addr)
                except (OSError, ValueError):
                    return addr, None

            # Concurrent fetches: registration keys are unleased
            # (stale ones accumulate across restarts), so one sweep must
            # cost ~one timeout total, not one per dead address serially.
            results = await asyncio.gather(*(fetch(a) for a in addrs))
        now = time.monotonic()
        fresh: Dict[str, dict] = {}
        for addr, text in results:
            if text is not None:
                fresh[addr] = {"text": text, "last_ok": now,
                               "stale": False}
                continue
            key, entry = by_addr[addr]
            if registration_pid_dead(entry):
                # Dead process, stale registration: reap the key so the
                # fleet view (and every future sweep) stops carrying it.
                try:
                    await self.cp.delete(key)
                    self._endpoint_reaps.inc(labels={"endpoint": addr})
                    logger.info(
                        "reaped stale status endpoint %s (%s, pid %s "
                        "dead)", key, addr, entry.get("pid"))
                    continue  # no STALE carry: the target is gone
                except Exception:
                    logger.warning("failed to reap stale endpoint %s",
                                   key, exc_info=True)
            self._scrape_failures.inc(labels={"endpoint": addr})
            prev = self._scraped.get(addr)
            if prev is not None and (now - prev["last_ok"]
                                     <= self.stale_drop_secs):
                fresh[addr] = dict(prev, stale=True)
        self._scraped = fresh

    async def _scrape_loop(self) -> None:
        while True:
            # The whole iteration is guarded (like _pump_hits): one
            # malformed status_endpoints entry or transient session
            # error must not silently kill scraping forever.
            try:
                await self._scrape_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("status-endpoint scrape failed; retrying")
            await asyncio.sleep(self.scrape_interval)

    def fresh_workers(self) -> Dict[int, ForwardPassMetrics]:
        return self._watcher.fresh()

    def _refresh_gauges(self) -> None:
        fresh = self.fresh_workers()
        self._g_workers.set(len(fresh))
        self._g_active.set(sum(
            m.worker_stats.request_active_slots for m in fresh.values()))
        self._g_waiting.set(sum(
            m.worker_stats.num_requests_waiting for m in fresh.values()))
        self._g_blocks.set(sum(
            m.kv_stats.kv_active_blocks for m in fresh.values()))
        usages = [m.kv_stats.gpu_cache_usage_perc for m in fresh.values()]
        self._g_usage.set(sum(usages) / len(usages) if usages else 0.0)
        self._refresh_ledger_gauges()
        self._refresh_drift_gauges()

    def _refresh_ledger_gauges(self) -> None:
        """Sum the frontends' ledger series into the fleet aggregates.

        Works off the raw scraped texts (not the watcher) because the
        phase histograms and goodput counters live on the FRONTEND
        registries, which only reach the aggregator as scrape targets.
        """
        sums: Dict[str, float] = {}
        counts: Dict[str, float] = {}
        good = total = 0.0
        for entry in self._scraped.values():
            for line in entry["text"].splitlines():
                if line.startswith("dynamo_request_phase_seconds_"):
                    m = _PHASE_RE.match(line)
                    if not m:
                        continue
                    kind, phase = m.group(1), m.group(2)
                    try:
                        val = float(m.group(3))
                    except ValueError:
                        continue
                    bucket = sums if kind == "sum" else counts
                    bucket[phase] = bucket.get(phase, 0.0) + val
                elif line.startswith("dynamo_goodput_"):
                    name_labels, _, raw = line.rpartition(" ")
                    try:
                        val = float(raw)
                    except ValueError:
                        continue
                    if name_labels.startswith(
                            "dynamo_goodput_good_tokens_total"):
                        good += val
                    elif name_labels.startswith(
                            "dynamo_goodput_tokens_total"):
                        total += val
        for phase, val in sums.items():
            self._g_phase_sum.set(val, labels={"phase": phase})
        for phase, val in counts.items():
            self._g_phase_count.set(val, labels={"phase": phase})
        self._g_goodput_good.set(good)
        self._g_goodput_total.set(total)
        self._g_goodput.set(good / total if total > 0 else 0.0)

    def _refresh_drift_gauges(self) -> None:
        """Pre-sum the workers' device-truth drift series into fleet
        aggregates (dashboards alert on ONE series, not per-worker
        fan-out).  Ratios average per series; registry sizes sum.  Works
        off the raw scraped texts like the ledger gauges — the drift
        series live on the WORKER registries."""
        ratios: Dict[str, list] = {}
        registry_total = 0.0
        for entry in self._scraped.values():
            for line in entry["text"].splitlines():
                m = _DRIFT_RE.match(line)
                if m:
                    try:
                        ratios.setdefault(m.group(1), []).append(
                            float(m.group(2)))
                    except ValueError:
                        continue
                    continue
                m = _REGISTRY_SIZE_RE.match(line)
                if m:
                    try:
                        registry_total += float(m.group(1))
                    except ValueError:
                        continue
        for series, vals in ratios.items():
            self._g_drift_ratio.set(sum(vals) / len(vals),
                                    labels={"series": series})
        self._g_registry_size.set(registry_total)

    @staticmethod
    def _relabel(text: str, addr: str, seen_meta: set) -> str:
        """Stamp an `instance` label on every scraped sample so two
        processes of the same component (both exposing, say, an
        unlabeled dynamo_router_requests_total) stay distinct series —
        verbatim concatenation made Prometheus reject the whole
        exposition as duplicate samples.  # HELP/# TYPE lines pass
        through once per metric name across all targets."""
        out = []
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split(None, 2)   # '#', 'HELP|TYPE', 'name...'
                key = tuple(parts[:3])
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                out.append(line)
                continue
            name_labels, _, value = line.rpartition(" ")
            if not name_labels:
                out.append(line)
                continue
            if name_labels.endswith("}"):
                out.append(f'{name_labels[:-1]},instance="{addr}"}} {value}')
            else:
                out.append(f'{name_labels}{{instance="{addr}"}} {value}')
        return "\n".join(out) + "\n" if out else ""

    def expose(self) -> str:
        self._refresh_gauges()
        text = self.registry.expose()
        seen_meta: set = set()
        now = time.monotonic()
        for addr in sorted(self._scraped):
            entry = self._scraped[addr]
            header = f"# scraped from {addr}\n"
            if entry.get("stale"):
                age = now - entry["last_ok"]
                header = (f"# scraped from {addr} "
                          f"(STALE: last success {age:.1f}s ago)\n")
            text += header + self._relabel(entry["text"], addr, seen_meta)
        return text


async def serve(cp, host: str = "127.0.0.1", port: int = 0):
    """Start aggregator + HTTP /metrics; returns (aggregator, server,
    port).  Stop with `await aggregator.stop()` and `await
    server.stop()`."""
    agg = MetricsAggregator(cp)
    await agg.start()
    server = StatusServer(extra_text_fn=agg.expose)
    bound = await server.start(host, port)
    logger.info("metrics aggregator on %s:%d", host, bound)
    return agg, server, bound
