"""Shared load-metrics watcher: one subscription, freshness-pruned view
(port of `dynamo_tpu/llm/kv_router/watcher.py`).

The KV router's cost merge (client.py) consumes it here; in the
reference the namespace metrics aggregator and the planner share it too.
It subscribes to the `load_metrics` subject, keeps the latest
ForwardPassMetrics per worker, and serves a freshness-filtered snapshot.
`fresh()` also PRUNES stale entries so worker churn (each restart is a
new instance id) can't grow the map without bound.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Optional

from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics, WorkerId

logger = logging.getLogger(__name__)

METRICS_SUBJECT = "load_metrics"


class LoadMetricsWatcher:
    def __init__(self, cp, stale_secs: float = 10.0,
                 name: str = "load-metrics") -> None:
        self.cp = cp
        self.stale_secs = stale_secs
        self.name = name
        self._metrics: Dict[WorkerId, tuple] = {}   # id → (metrics, ts)
        self._sub = None
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._sub = await self.cp.subscribe(METRICS_SUBJECT)
        self._task = asyncio.create_task(self._pump())

    async def stop(self) -> None:
        if self._sub:
            self._sub.cancel()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _pump(self) -> None:
        backoff = 1.0
        while True:
            try:
                payload = await self._sub.next()
                backoff = 1.0
            except asyncio.CancelledError:
                raise
            except ConnectionError:
                # Returning here would leave the consumer blind to load
                # metrics until process restart.  The control-plane
                # client reconnects underneath and restores this SAME
                # subscription (a fresh subscribe() here would
                # double-deliver); keep draining it after a pause.
                logger.warning(
                    "%s: load_metrics subscription lost; waiting %.0fs "
                    "for reconnect", self.name, backoff)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 30.0)
                continue
            try:
                self._metrics[payload["worker_id"]] = (
                    ForwardPassMetrics.from_dict(payload["metrics"]),
                    time.monotonic())
            except Exception:
                logger.exception("%s: bad load_metrics payload", self.name)

    def fresh(self) -> Dict[WorkerId, ForwardPassMetrics]:
        """Snapshot of workers heard from within `stale_secs`; prunes the
        rest from the map."""
        cutoff = time.monotonic() - self.stale_secs
        stale = [w for w, (_, ts) in self._metrics.items() if ts <= cutoff]
        for w in stale:
            del self._metrics[w]
        return {w: m for w, (m, _) in self._metrics.items()}
