"""SLA planner: profiled-perf interpolation → P/D replica targets (port
of `dynamo_tpu/planner/sla.py`).

The decision loop of the reference's SLA planner
(`planner/utils/planner_core.py:241-276`), re-hosted on our metrics
plane and card-granular engines (the profile's "chip" is one card):

1. observe the last interval: request count, avg ISL/OSL, measured
   TTFT/ITL (scraped from the frontend's Prometheus exposition —
   `frontend_time_to_first_token_seconds` etc., runtime/metrics.py);
2. correction factors: measured TTFT/ITL over the profile's expected
   values absorb everything the interpolation doesn't model (queueing,
   prefix-cache hits) — `planner_core.py:208-219`;
3. predict next-interval load with pluggable predictors (constant /
   moving-average / trend — the reference's constant/ARIMA/Prophet
   ladder, predictor.py);
4. prefill replicas from interpolated prefill throughput/chip at the
   predicted ISL (queueing-corrected), decode replicas from the highest
   profiled throughput/chip whose ITL meets the corrected SLA at the
   predicted context (`find_best_throughput_per_chip`);
5. clamp to the chip budget proportionally, then converge connectors.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.planner.interpolation import (
    DecodeInterpolator,
    PrefillInterpolator,
)
from dynamo_tpu_torch.planner.predictor import make_predictor

logger = logging.getLogger(__name__)


@dataclass
class SlaObservation:
    """One adjustment-interval's aggregate load + latency."""

    num_requests: float = 0.0
    avg_isl: float = 0.0
    avg_osl: float = 0.0
    ttft_s: float = 0.0      # 0 = no data this interval
    itl_s: float = 0.0


@dataclass
class SlaPlannerConfig:
    ttft_s: float = 0.5                 # the SLA targets
    itl_s: float = 0.05
    adjustment_interval_s: float = 10.0
    chips_per_prefill_engine: int = 1
    chips_per_decode_engine: int = 1
    min_replicas: int = 1
    max_replicas: int = 8
    max_chip_budget: int = 16
    predictor: str = "moving_average"


class PrometheusScraper:
    """Interval observations from the frontend's /metrics exposition.

    Histogram `_sum`/`_count` series are cumulative; the scraper diffs
    successive scrapes to get per-interval averages (the reference's
    Prometheus-range-query analog, `utils/prometheus.py`)."""

    def __init__(self, url: str) -> None:
        self.url = url
        self._prev: dict = {}
        self._primed = False

    def _fetch(self) -> dict:
        out = {}
        with urllib.request.urlopen(self.url, timeout=5.0) as r:
            for line in r.read().decode().splitlines():
                if line.startswith("#") or not line.strip():
                    continue
                name, _, value = line.rpartition(" ")
                base = name.split("{")[0].strip()
                try:
                    out[base] = out.get(base, 0.0) + float(value)
                except ValueError:
                    continue
        return out

    def observe(self) -> SlaObservation:
        cur = self._fetch()
        prev, self._prev = self._prev, cur
        if not self._primed:
            # First scrape sees the frontend's ALL-TIME counters; diffing
            # them against nothing would report the process lifetime as
            # one interval's load and spike the fleet to max_replicas on
            # every planner restart.  Prime and report an idle interval.
            self._primed = True
            return SlaObservation()

        def delta(name):
            return max(0.0, cur.get(name, 0.0) - prev.get(name, 0.0))

        pre = "dynamo_frontend_"
        n_req = delta(pre + "requests_total")
        in_sum = delta(pre + "input_sequence_tokens_sum")
        in_cnt = delta(pre + "input_sequence_tokens_count")
        out_sum = delta(pre + "output_sequence_tokens_sum")
        out_cnt = delta(pre + "output_sequence_tokens_count")
        ttft_sum = delta(pre + "time_to_first_token_seconds_sum")
        ttft_cnt = delta(pre + "time_to_first_token_seconds_count")
        itl_sum = delta(pre + "inter_token_latency_seconds_sum")
        itl_cnt = delta(pre + "inter_token_latency_seconds_count")
        return SlaObservation(
            num_requests=n_req,
            avg_isl=in_sum / in_cnt if in_cnt else 0.0,
            avg_osl=out_sum / out_cnt if out_cnt else 0.0,
            ttft_s=ttft_sum / ttft_cnt if ttft_cnt else 0.0,
            itl_s=itl_sum / itl_cnt if itl_cnt else 0.0,
        )


@dataclass
class SlaDecision:
    num_prefill: int
    num_decode: int
    p_correction: float
    d_correction: float
    predicted: SlaObservation = field(default_factory=SlaObservation)


class SlaPlanner:
    """observe → correct → predict → interpolate → converge.

    `observe`: callable returning an SlaObservation for the last interval
    (PrometheusScraper.observe, or a test stub).  `prefill_connector` /
    `decode_connector`: the LoadPlanner connector contract; either may be
    None (aggregated deployments scale only the decode pool)."""

    def __init__(self, profile: dict, observe: Callable[[], SlaObservation],
                 decode_connector, prefill_connector=None,
                 config: Optional[SlaPlannerConfig] = None) -> None:
        self.config = config or SlaPlannerConfig()
        self.observe = observe
        self.prefill_connector = prefill_connector
        self.decode_connector = decode_connector
        self.prefill_interp = PrefillInterpolator(profile)
        self.decode_interp = DecodeInterpolator(profile)
        self._pred_req = make_predictor(self.config.predictor)
        self._pred_isl = make_predictor(self.config.predictor)
        self._pred_osl = make_predictor(self.config.predictor)
        self.p_correction = 1.0
        self.d_correction = 1.0
        self.decisions: list = []
        self._task: Optional[asyncio.Task] = None

    # -- the decision function (pure; unit-testable) -----------------------

    def decide(self, obs: SlaObservation) -> SlaDecision:
        cfg = self.config
        # Correction factors: how far reality runs from the profile
        # (queueing, prefix hits, interference) — planner_core.py:208-219.
        if obs.ttft_s > 0 and obs.avg_isl > 0:
            expect = self.prefill_interp.interpolate_ttft(obs.avg_isl)
            if expect > 0:
                self.p_correction = obs.ttft_s / expect
        if obs.itl_s > 0 and obs.avg_isl > 0:
            expect = self.decode_interp.interpolate_itl(
                0.5, obs.avg_isl + obs.avg_osl / 2)
            if expect > 0:
                self.d_correction = obs.itl_s / expect

        for pred, val in ((self._pred_req, obs.num_requests),
                          (self._pred_isl, obs.avg_isl),
                          (self._pred_osl, obs.avg_osl)):
            pred.add_data_point(val)
        nxt = SlaObservation(
            num_requests=self._pred_req.predict_next(),
            avg_isl=self._pred_isl.predict_next(),
            avg_osl=self._pred_osl.predict_next(),
        )

        if nxt.num_requests <= 0 or nxt.avg_isl <= 0:
            return SlaDecision(cfg.min_replicas, cfg.min_replicas,
                               self.p_correction, self.d_correction, nxt)

        # Prefill: tokens/s the fleet must prefill; the correction's
        # min(1, ·) treats a better-than-profile TTFT as queueing headroom
        # only, never as licence to under-provision.
        prefill_load = (nxt.num_requests * nxt.avg_isl
                        / cfg.adjustment_interval_s
                        * min(1.0, self.p_correction))
        num_p = math.ceil(
            prefill_load
            / max(self.prefill_interp.interpolate_thpt_per_chip(nxt.avg_isl),
                  1e-9)
            / cfg.chips_per_prefill_engine)

        # Decode: highest profiled per-chip throughput whose ITL meets the
        # corrected SLA at the predicted average context.
        corrected_itl = (cfg.itl_s / self.d_correction
                         if self.d_correction > 0 else cfg.itl_s)
        ctx = nxt.avg_isl + nxt.avg_osl / 2
        thpt = self.decode_interp.find_best_throughput_per_chip(
            corrected_itl, ctx)
        num_d = math.ceil(
            nxt.num_requests * nxt.avg_osl / cfg.adjustment_interval_s
            / max(thpt, 1e-9) / cfg.chips_per_decode_engine)

        num_p = min(max(num_p, cfg.min_replicas), cfg.max_replicas)
        num_d = min(max(num_d, cfg.min_replicas), cfg.max_replicas)
        total = (num_p * cfg.chips_per_prefill_engine
                 + num_d * cfg.chips_per_decode_engine)
        if total > cfg.max_chip_budget:
            scale = cfg.max_chip_budget / total
            num_p = max(cfg.min_replicas, int(num_p * scale))
            num_d = max(cfg.min_replicas, int(num_d * scale))
            floored = (num_p * cfg.chips_per_prefill_engine
                       + num_d * cfg.chips_per_decode_engine)
            if floored > cfg.max_chip_budget:
                # min_replicas floors can make the budget unsatisfiable;
                # deploying over budget silently would hide a config bug.
                logger.warning(
                    "sla: min_replicas floor forces %d chips against a "
                    "budget of %d", floored, cfg.max_chip_budget)
        return SlaDecision(num_p, num_d, self.p_correction,
                           self.d_correction, nxt)

    # -- loop --------------------------------------------------------------

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.adjustment_interval_s)
            try:
                await self.step()
            except Exception:
                logger.exception("sla planner step failed")

    async def step(self) -> SlaDecision:
        # The scraper is synchronous urllib (5 s timeout); off the loop so
        # a slow/dead frontend can't stall connector IO every interval.
        obs = await asyncio.to_thread(self.observe)
        decision = self.decide(obs)
        self.decisions.append((time.monotonic(), decision))
        logger.info(
            "sla decision: P=%d D=%d (corr p=%.2f d=%.2f, pred "
            "req=%.1f isl=%.0f osl=%.0f)", decision.num_prefill,
            decision.num_decode, decision.p_correction,
            decision.d_correction, decision.predicted.num_requests,
            decision.predicted.avg_isl, decision.predicted.avg_osl)
        if self.prefill_connector is not None:
            await self._converge(self.prefill_connector,
                                 decision.num_prefill)
        await self._converge(self.decode_connector, decision.num_decode)
        return decision

    @staticmethod
    async def _converge(connector, target: int, max_moves: int = 4) -> None:
        """Step the fleet toward `target`, at most `max_moves` spawns or
        drains per tick: an instantly-crashing worker otherwise turns
        this into an unbounded spawn loop (replicas() reaps the corpse,
        the loop spawns another, forever)."""
        moves = 0
        while connector.replicas() < target and moves < max_moves:
            await connector.add_worker()
            moves += 1
        while connector.replicas() > target and moves < max_moves:
            await connector.remove_worker()
            moves += 1
        if connector.replicas() != target:
            logger.info("sla: fleet at %d of target %d (max %d moves per "
                        "tick)", connector.replicas(), target, max_moves)
