"""LoadPlanner: observe → predict → target → converge (port of
`dynamo_tpu/planner/core.py`).

The decision skeleton of the reference's `planner_core.py:241-318`
specialised to load-based scaling (its SLA variant swaps the target
formula for TTFT/ITL interpolation; same loop).

Not ported: the heterogeneous-cell mode (`PlannerConfig.roles`, a pool a
role with its own `--slice` mesh).  It needs the worker's `--slice` and
`fleet.topology.place_role`, which come with tp/dp/ep/pp; the port's
planner scales one aggregated pool.  A worker spawns in 15-25 s on a
card (model build plus kernel load), so give `adjustment_interval` and
the connector's drain budget room for it."""

from __future__ import annotations

import asyncio
import json
import logging
import time
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from dynamo_tpu_torch.fleet.topology import SliceSpec, validate_placement
from dynamo_tpu_torch.llm.kv_router.watcher import LoadMetricsWatcher
from dynamo_tpu_torch.planner.predictor import make_predictor
from dynamo_tpu_torch.runtime.slo import max_burn

logger = logging.getLogger(__name__)


@dataclass
class PlannerConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    kv_high: float = 0.8        # predicted usage above → scale up
    kv_low: float = 0.3         # redistributable usage below → scale down
    adjustment_interval: float = 5.0
    metrics_stale_secs: float = 10.0
    predictor: str = "moving_average"
    # SLO bias (runtime/slo.py): when a watched /debug/slo reports a
    # fast-window burn rate at or above this, scale up even though KV
    # usage looks fine — latency SLOs burn before memory fills (the
    # AIBrix-style signal the load moving-average can't see).  Scale-
    # DOWN is additionally vetoed while any burn is >= 1.0 (actively
    # consuming budget is the wrong moment to shed capacity).
    slo_burn_scale_up: float = 2.0
    # A /debug/slo payload older than this exerts no pressure: a crashed
    # SLO source must not pin the fleet at max_replicas forever on its
    # last (possibly mid-incident) reading.
    slo_stale_secs: float = 60.0


class LoadPlanner:
    """Watches `load_metrics`, steps a replica target, drives a connector.

    `connector` contract: `replicas() -> int` (current), plus
    `add_worker()` / `remove_worker()` (one step each, async).

    `slo_url`: a /debug/slo endpoint (frontend or worker) polled each
    adjustment interval; its burn rates bias scaling per
    PlannerConfig.slo_burn_scale_up."""

    def __init__(self, cp, connector,
                 config: Optional[PlannerConfig] = None,
                 slo_url: Optional[str] = None,
                 slices_fn: Optional[Callable[[], Dict]] = None) -> None:
        self.cp = cp
        self.connector = connector
        self.config = config or PlannerConfig()
        self.slo_url = slo_url
        # Topology source: worker id → published SliceSpec (or its wire
        # dict), usually wired to the runtime client's instance records.
        # None = no topology view; role decisions fall back to replica
        # counts alone.
        self._slices_fn = slices_fn
        self._slo: Optional[dict] = None       # last /debug/slo payload
        self._slo_ts: float = 0.0              # when it was fetched
        self._watcher = LoadMetricsWatcher(
            cp, stale_secs=self.config.metrics_stale_secs, name="planner")
        self._usage_pred = make_predictor(self.config.predictor)
        self._waiting_pred = make_predictor(self.config.predictor)
        self._tasks = []
        # In-flight scale-down: remove_worker waits out the worker's
        # KV-migrating drain (up to the connector's drain_timeout_s), so
        # it runs as a background task — the adjustment loop must stay
        # responsive to scale-UP pressure mid-drain.
        self._drain_task: Optional[asyncio.Task] = None
        self.decisions: list = []              # (ts, kind, reason) log

    async def start(self) -> None:
        await self._watcher.start()
        self._tasks = [asyncio.create_task(self._loop())]

    async def stop(self) -> None:
        await self._watcher.stop()
        if self._drain_task is not None and not self._drain_task.done():
            # Let an in-flight drain finish (bounded by the connector's
            # own timeout) rather than orphan a half-drained worker.
            try:
                await self._drain_task
            except Exception:
                logger.exception("planner: in-flight drain failed at stop")
        for t in self._tasks:
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass

    def _observe(self):
        fresh = list(self._watcher.fresh().values())
        if not fresh:
            return None
        usage = sum(m.kv_stats.gpu_cache_usage_perc
                    for m in fresh) / len(fresh)
        waiting = sum(m.worker_stats.num_requests_waiting for m in fresh)
        return len(fresh), usage, waiting

    def slo_pressure(self) -> float:
        """Worst fast-window burn rate from the last /debug/slo poll
        (0.0 with no SLO source configured, monitor disabled, or a
        payload past slo_stale_secs — dead sources stop steering)."""
        if (self._slo is not None
                and time.monotonic() - self._slo_ts
                > self.config.slo_stale_secs):
            return 0.0
        return max_burn(self._slo)

    # -- topology reads ----------------------------------------------------

    def topology(self) -> Dict[object, Optional[SliceSpec]]:
        """Published slice topology: worker id → SliceSpec (None for
        workers that publish nothing).  Tolerant of a failing source —
        the planner must keep scaling a fleet whose discovery hiccups."""
        if self._slices_fn is None:
            return {}
        try:
            raw = self._slices_fn() or {}
        except Exception:
            logger.exception("planner: topology source failed; planning "
                             "topology-blind this step")
            return {}
        return {
            w: (s if isinstance(s, SliceSpec) or s is None
                else SliceSpec.from_dict(s))
            for w, s in raw.items()
        }

    def placement_ok(self, role: str, worker_id=None,
                     spec: Optional[SliceSpec] = None) -> Tuple[bool, str]:
        """Is assigning `role` work to this worker topology-sane?  The
        planner's SliceSpec consult (fleet.topology.validate_placement):
        a mesh-blind decision — decode role on a dedicated prefill
        slice — is refused here."""
        if spec is None and worker_id is not None:
            spec = self.topology().get(worker_id)
        return validate_placement(role, spec)

    def plan_step(self) -> Optional[str]:
        """One planning decision from current predictions; returns
        "up" | "down" | None.  Synchronous and side-effect-free on the
        connector (unit-testable; the loop applies it)."""
        draining = (self._drain_task is not None
                    and not self._drain_task.done())
        replicas = self.connector.replicas()
        if replicas < self.config.min_replicas:
            # Floor check needs no observations — it's how the fleet
            # bootstraps (no worker yet → no metrics yet).
            return "up"
        burn = self.slo_pressure()
        if (burn >= self.config.slo_burn_scale_up
                and replicas < self.config.max_replicas):
            # SLO bias: budget is burning NOW; don't wait for the KV
            # moving-average to catch up.
            return "up"
        obs = self._observe()
        if obs is None:
            return None
        n_reporting, usage, waiting = obs
        self._usage_pred.add_data_point(usage)
        self._waiting_pred.add_data_point(waiting)
        p_usage = self._usage_pred.predict_next()
        p_waiting = self._waiting_pred.predict_next()
        if ((p_usage > self.config.kv_high or p_waiting >= 1.0)
                and replicas < self.config.max_replicas):
            return "up"
        # Scale down only if the survivors could absorb the load under
        # kv_low: usage*n / (n-1) stays below the low-water mark — never
        # while an SLO is actively burning budget, and one drain at a
        # time (a scale-down is committed until its background
        # remove_worker lands; stacking removals would over-shed).
        if (not draining
                and replicas > self.config.min_replicas and p_waiting < 1.0
                and n_reporting > 1 and burn < 1.0
                and p_usage * n_reporting / (n_reporting - 1)
                < self.config.kv_low):
            return "down"
        return None

    async def _fetch_slo(self) -> None:
        """Refresh the /debug/slo view; keeps the last payload on
        transient fetch errors (stale pressure beats none mid-incident)."""
        if not self.slo_url:
            return

        def fetch() -> dict:
            with urllib.request.urlopen(self.slo_url, timeout=2.0) as resp:
                return json.loads(resp.read())

        try:
            self._slo = await asyncio.to_thread(fetch)
            self._slo_ts = time.monotonic()
        except (OSError, ValueError):
            logger.debug("slo poll of %s failed; keeping last payload",
                         self.slo_url)

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.adjustment_interval)
            try:
                await self._fetch_slo()
                decision = self.plan_step()
                if decision == "up":
                    self.decisions.append((time.monotonic(), "up",
                                           self._reason()))
                    logger.info("planner: scaling UP (%s)", self._reason())
                    await self.connector.add_worker()
                elif decision == "down":
                    self.decisions.append((time.monotonic(), "down",
                                           self._reason()))
                    logger.info("planner: scaling DOWN (%s)",
                                self._reason())
                    # Background: remove_worker waits out the drain
                    # (plan_step holds further decisions off until it
                    # lands; scale-up pressure still gets polled).
                    self._drain_task = asyncio.create_task(
                        self.connector.remove_worker())
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("planner: adjustment failed; continuing")

    def _reason(self) -> str:
        reason = (f"usage~{self._usage_pred.predict_next():.2f} "
                  f"waiting~{self._waiting_pred.predict_next():.1f} "
                  f"replicas={self.connector.replicas()}")
        burn = self.slo_pressure()
        if burn > 0:
            reason += f" slo_burn~{burn:.1f}"
        return reason


def planner_metrics_text(planner, connector) -> str:
    """Prometheus text for the planner's status server (`/metrics` on
    `python -m dynamo_tpu_torch.planner --metrics-port`): replica count,
    scaling-decision tallies, and the predictors' next-step view.  Works
    for both LoadPlanner and SlaPlanner (fields read defensively — the
    SLA variant keeps its own predictor names)."""
    lines = []
    try:
        lines.append(f"dynamo_planner_replicas {connector.replicas()}")
    except Exception:
        pass  # connector variant without replicas(): omit the series
    decisions = getattr(planner, "decisions", []) or []
    ups = sum(1 for d in decisions if len(d) > 1 and d[1] == "up")
    downs = sum(1 for d in decisions if len(d) > 1 and d[1] == "down")
    lines.append('dynamo_planner_decisions_total{direction="up"} %d' % ups)
    lines.append('dynamo_planner_decisions_total{direction="down"} %d'
                 % downs)
    # Scale-down outcomes: clean KV-migrating drains vs drain-timeout
    # force-kills — a rising force_kill count is the "drains are
    # broken" alarm.
    for attr, outcome in (("clean_drains", "clean"),
                          ("force_kills", "force_kill")):
        n = getattr(connector, attr, None)
        if n is not None:
            lines.append(
                'dynamo_planner_drains_total{outcome="%s"} %d'
                % (outcome, n))
    for attr, name in (("_usage_pred", "kv_usage"),
                       ("_waiting_pred", "requests_waiting")):
        pred = getattr(planner, attr, None)
        if pred is None:
            continue
        try:
            lines.append('dynamo_planner_predicted{metric="%s"} %s'
                         % (name, pred.predict_next()))
        except Exception:
            pass  # predictor not warmed up yet: omit the series
    return "\n".join(lines) + "\n"
