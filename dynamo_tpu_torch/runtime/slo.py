"""Multi-window burn-rate SLO monitor (port of `dynamo_tpu/runtime/slo.py`).

Answers "are we meeting our TTFT/TPOT/error-rate SLOs right now?" —
the `/debug/slo` operator surface and the `dynamo_slo_*` gauges.

Mechanics (Google SRE multiwindow multi-burn-rate alerting, specialised
to our self-contained Prometheus registry):

- An *objective* states a good-fraction target over an event stream:
  "99% of requests have TTFT <= 0.5 s" (latency objective over a
  `Histogram`), or "99% of requests finish ok" (error-rate objective
  over the `dynamo_request_outcomes_total` counter).
- Each tick samples the cumulative (total, bad) counts and appends them
  to a timestamped series; the *burn rate* over a window is the window's
  bad fraction divided by the error budget (1 - objective).  Burn 1.0 =
  exactly consuming budget; burn 14.4 over the fast window = an
  incident.
- Two windows (fast 5 m / slow 1 h, configurable): PAGE requires BOTH
  windows over the page threshold (the fast window confirms the problem
  is still happening, the slow one that it is significant); WARN
  likewise at the warn threshold.  No traffic burns no budget.

Everything is sampled host-side from counters the serving path already
maintains — zero cost on the engine thread.  `tick()` takes an explicit
`now` for deterministic tests.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime import flight_recorder
from dynamo_tpu_torch.runtime.contracts import never_engine_thread
from dynamo_tpu_torch.runtime.logutil import warn_rate_limited
from dynamo_tpu_torch.runtime.metrics import (
    Counter, Histogram, MetricsRegistry, RequestMetrics)

_logger = logging.getLogger(__name__)

OK, WARN, PAGE = "OK", "WARN", "PAGE"
_STATE_NUM = {OK: 0, WARN: 1, PAGE: 2}


def _num(x) -> Optional[float]:
    """JSON-safe float: NaN/inf (e.g. Histogram.mean on no data)
    propagate as None — `json.dumps(float('nan'))` emits invalid JSON
    and every /debug/slo consumer would choke on it."""
    if x is None:
        return None
    x = float(x)
    return None if (math.isnan(x) or math.isinf(x)) else x


@dataclass(frozen=True)
class SloObjective:
    """One service-level objective: `objective` fraction of events must
    be good.  For latency objectives `threshold_s` defines good
    (observation <= threshold); error-rate objectives take good/bad
    straight from their source."""

    name: str                       # "ttft_p99", "error_rate", ...
    objective: float = 0.99         # target good fraction
    threshold_s: Optional[float] = None

    @property
    def budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


def latency_source(hist: Histogram, threshold_s: float) -> Callable:
    """Cumulative (total, bad) over a latency histogram: bad =
    observations above `threshold_s` (bucket-granular, see
    Histogram.count_le — mid-bucket thresholds count the containing
    bucket as bad, the conservative direction)."""

    def read() -> Tuple[float, float]:
        total = hist.total_count()
        return float(total), float(total - hist.count_le(threshold_s))

    return read


def error_source(outcomes: Counter) -> Callable:
    """Cumulative (total, bad) over the request-outcome counter
    (RequestMetrics.outcomes: status="ok"|"error")."""

    def read() -> Tuple[float, float]:
        ok = outcomes.value({"status": "ok"})
        bad = outcomes.value({"status": "error"})
        return ok + bad, bad

    return read


class SloMonitor:
    """Evaluates objectives over fast/slow windows; exports
    `dynamo_slo_burn_rate{objective,window}`,
    `dynamo_slo_compliant{objective}` and `dynamo_slo_state`, and
    serves the `/debug/slo` payload."""

    def __init__(
        self,
        objectives: List[Tuple[SloObjective, Callable]],
        fast_window: float = 300.0,
        slow_window: float = 3600.0,
        warn_burn: float = 3.0,
        page_burn: float = 14.4,
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
        attribution_fn: Optional[Callable[[], Optional[str]]] = None,
    ) -> None:
        """`attribution_fn`: () -> dominant ledger phase over the recent
        window (LedgerSink.dominant_phase) — PAGE transitions then NAME
        the hop burning the budget instead of just reporting that budget
        burns."""
        self.objectives = list(objectives)
        self.attribution_fn = attribution_fn
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.warn_burn = warn_burn
        self.page_burn = page_burn
        self._clock = clock
        # Per-objective ring of (ts, cum_total, cum_bad).
        self._series: Dict[str, Deque[Tuple[float, float, float]]] = {
            obj.name: deque() for obj, _ in self.objectives}
        self._g_burn = self._g_compliant = self._g_state = None
        if registry is not None:
            self._g_burn = registry.gauge(
                "slo_burn_rate",
                "Error-budget burn rate (bad fraction / budget) per "
                "objective and window")
            self._g_compliant = registry.gauge(
                "slo_compliant",
                "1 when the objective's slow-window bad fraction is "
                "within budget")
            self._g_state = registry.gauge(
                "slo_state", "Overall SLO state: 0 OK, 1 WARN, 2 PAGE")
        self.state = OK
        # Worst fast-window burn across objectives at the last tick —
        # a cheap attribute read for hot-path consumers.
        self.last_max_burn = 0.0
        self._task: Optional[asyncio.Task] = None

    # -- evaluation -------------------------------------------------------

    def _prune(self, dq: Deque, now: float) -> None:
        """Drop samples older than the slow window, KEEPING the newest
        such sample — it is the slow window's left-edge baseline (a
        series pruned flush to the window edge would shrink the window
        it claims to measure)."""
        cutoff = now - self.slow_window
        while len(dq) >= 2 and dq[1][0] <= cutoff:
            dq.popleft()

    def _window(self, dq: Deque, now: float,
                window: float) -> Tuple[float, Optional[float]]:
        """(events, bad_fraction) over [now - window, now].  Baseline is
        the newest sample at or before the window's left edge; a series
        younger than the window measures from its oldest sample (partial
        window).  bad_fraction None when the window saw no events or a
        source reset (counter went backwards)."""
        if len(dq) < 2:
            return 0.0, None
        edge = now - window
        base = dq[0]
        for sample in dq:
            if sample[0] <= edge:
                base = sample
            else:
                break
        newest = dq[-1]
        d_total = newest[1] - base[1]
        d_bad = newest[2] - base[2]
        if d_total <= 0 or d_bad < 0:
            return 0.0, None
        return d_total, d_bad / d_total

    @never_engine_thread
    def tick(self, now: Optional[float] = None) -> dict:
        """Sample every objective, update burn rates + state, return the
        /debug/slo payload.  Deterministic given explicit `now`.

        Never the engine thread: a tick walks every objective's sample
        ring."""
        now = self._clock() if now is None else now
        rows = []
        worst = OK
        worst_burn = 0.0
        for obj, source in self.objectives:
            total, bad = source()
            dq = self._series[obj.name]
            dq.append((now, float(total), float(bad)))
            self._prune(dq, now)
            n_fast, frac_fast = self._window(dq, now, self.fast_window)
            n_slow, frac_slow = self._window(dq, now, self.slow_window)
            burn_fast = (frac_fast / obj.budget) if frac_fast is not None \
                else 0.0
            burn_slow = (frac_slow / obj.budget) if frac_slow is not None \
                else 0.0
            # No events → vacuously compliant (an idle fleet is not out
            # of SLO; NaN-style unknowns must not page).
            compliant = frac_slow is None or frac_slow <= obj.budget
            if burn_fast >= self.page_burn and burn_slow >= self.page_burn:
                state = PAGE
            elif burn_fast >= self.warn_burn and burn_slow >= self.warn_burn:
                state = WARN
            else:
                state = OK
            if _STATE_NUM[state] > _STATE_NUM[worst]:
                worst = state
            worst_burn = max(worst_burn, burn_fast)
            if self._g_burn is not None:
                self._g_burn.set(burn_fast, labels={
                    "objective": obj.name, "window": "fast"})
                self._g_burn.set(burn_slow, labels={
                    "objective": obj.name, "window": "slow"})
                self._g_compliant.set(
                    1.0 if compliant else 0.0,
                    labels={"objective": obj.name})
            rows.append({
                "name": obj.name,
                "objective": obj.objective,
                "threshold_s": obj.threshold_s,
                "events_total": _num(total),
                "events_bad": _num(bad),
                "window_events_fast": _num(n_fast),
                "window_events_slow": _num(n_slow),
                "bad_frac_fast": _num(frac_fast),
                "bad_frac_slow": _num(frac_slow),
                "burn_fast": _num(burn_fast),
                "burn_slow": _num(burn_slow),
                "compliant": compliant,
                "state": state,
            })
        dominant = None
        if self.attribution_fn is not None:
            try:
                dominant = self.attribution_fn()
            except Exception:
                dominant = None     # attribution must never kill the tick
        if worst != self.state:
            # SLO state transition → flight-recorder event; a transition
            # INTO PAGE additionally dumps the ring — the black box's
            # "what led up to the page" trigger (throttled per reason so
            # a burn rate flapping at the threshold can't grind disk).
            # The ledger's dominant phase rides along, so the PAGE names
            # WHERE the budget went (queue, kv_transfer, migration, ...).
            rec = flight_recorder.get_recorder()
            rec.record("slo_state", prev=self.state, state=worst,
                       burn=round(worst_burn, 3),
                       dominant_phase=dominant)
            if worst == PAGE and rec.enabled:
                # Async: tick may run on the serving event loop, which
                # must not stall behind ring serialization + file I/O.
                rec.dump_async("slo_page")
        self.state = worst
        self.last_max_burn = worst_burn
        if self._g_state is not None:
            self._g_state.set(float(_STATE_NUM[worst]))
        return {
            "enabled": True,
            "state": worst,
            "dominant_phase": dominant,
            "windows": {"fast_s": self.fast_window,
                        "slow_s": self.slow_window},
            "thresholds": {"warn_burn": self.warn_burn,
                           "page_burn": self.page_burn},
            "objectives": rows,
        }

    def payload(self) -> dict:
        """Fresh /debug/slo payload (ticks on demand — a scrape is as
        good a sample point as a timer)."""
        return self.tick()

    # -- background ticking ------------------------------------------------

    def start(self, interval: float = 5.0) -> None:
        """Periodic ticking so the burn gauges stay fresh on /metrics
        even when nobody hits /debug/slo.  Call from a running loop."""
        if self._task is not None:
            return

        async def loop():
            while True:
                await asyncio.sleep(interval)
                try:
                    self.tick()
                except Exception as e:  # telemetry must never kill serving
                    warn_rate_limited(
                        _logger, "slo_tick", 60.0,
                        "SLO tick failed (burn gauges go stale): %s", e)

        self._task = asyncio.get_running_loop().create_task(loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


def disabled_payload() -> dict:
    return {"enabled": False, "state": OK, "objectives": []}


def max_burn(payload: Optional[dict]) -> float:
    """Worst fast-window burn rate across a /debug/slo payload's
    objectives (0.0 for missing/disabled payloads)."""
    if not payload or not payload.get("enabled"):
        return 0.0
    burns = [o.get("burn_fast") or 0.0
             for o in payload.get("objectives", [])]
    return max(burns) if burns else 0.0


# -- flag surface (worker + frontend) ------------------------------------


def add_slo_args(p) -> None:
    p.add_argument("--slo-ttft-p99", type=float, default=None,
                   help="TTFT objective threshold (seconds): "
                        "--slo-target fraction of requests must see "
                        "first token within this (None disables)")
    p.add_argument("--slo-tpot-p99", type=float, default=None,
                   help="TPOT objective threshold (seconds per output "
                        "token after the first)")
    p.add_argument("--slo-error-rate", type=float, default=None,
                   help="error budget fraction (0.01 = 99%% of requests "
                        "must finish ok)")
    p.add_argument("--slo-target", type=float, default=0.99,
                   help="good-fraction target for the latency "
                        "objectives (0.99 = p99)")
    p.add_argument("--slo-fast-window", type=float, default=300.0,
                   help="fast burn-rate window (seconds)")
    p.add_argument("--slo-slow-window", type=float, default=3600.0,
                   help="slow burn-rate window (seconds)")
    p.add_argument("--slo-warn-burn", type=float, default=3.0,
                   help="WARN when both windows burn at or above this")
    p.add_argument("--slo-page-burn", type=float, default=14.4,
                   help="PAGE when both windows burn at or above this")
    p.add_argument("--slo-tick", type=float, default=5.0,
                   help="background evaluation interval (seconds)")


def monitor_from_args(args, request_metrics: RequestMetrics,
                      registry: Optional[MetricsRegistry] = None,
                      attribution_fn: Optional[Callable] = None,
                      ) -> Optional[SloMonitor]:
    """Build the monitor the flags describe over the process's
    RequestMetrics histograms; None when no objective is configured
    (the /debug/slo route then reports enabled=false)."""
    objectives: List[Tuple[SloObjective, Callable]] = []
    if args.slo_ttft_p99 is not None:
        objectives.append((
            SloObjective("ttft_p99", objective=args.slo_target,
                         threshold_s=args.slo_ttft_p99),
            latency_source(request_metrics.ttft, args.slo_ttft_p99)))
    if args.slo_tpot_p99 is not None:
        objectives.append((
            SloObjective("tpot_p99", objective=args.slo_target,
                         threshold_s=args.slo_tpot_p99),
            latency_source(request_metrics.tpot, args.slo_tpot_p99)))
    if args.slo_error_rate is not None:
        objectives.append((
            SloObjective("error_rate",
                         objective=1.0 - args.slo_error_rate),
            error_source(request_metrics.outcomes)))
    if not objectives:
        return None
    return SloMonitor(
        objectives,
        fast_window=args.slo_fast_window,
        slow_window=args.slo_slow_window,
        warn_burn=args.slo_warn_burn,
        page_burn=args.slo_page_burn,
        registry=registry,
        attribution_fn=attribution_fn)
