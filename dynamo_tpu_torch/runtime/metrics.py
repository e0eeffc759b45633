"""Prometheus-format metrics registry (port of
`dynamo_tpu/runtime/metrics.py`: the same series names and exposition
text).

Role of the reference's `lib/runtime/src/metrics.rs` (hierarchical names
drt→namespace→component→endpoint) and `lib/llm/src/http/service/metrics.rs`
(the TTFT/ITL histograms the SLA planner scrapes —
`*_time_to_first_token_seconds`, `*_inter_token_latency_seconds`).  Those
exact series names are load-bearing: the planner's Prometheus queries key
on them (reference `planner/utils/prometheus.py`), so our planner does too.

Self-contained text-format exposition (no prometheus_client dependency);
thread-safe; histograms use fixed buckets chosen for LLM latencies.
"""

from __future__ import annotations

import logging
import math
import threading
from bisect import bisect_right
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.runtime import flight_recorder
from dynamo_tpu_torch.runtime.contracts import never_engine_thread
from dynamo_tpu_torch.runtime.logutil import warn_rate_limited

_logger = logging.getLogger(__name__)

# Buckets tuned for token-level latencies (seconds): sub-ms resolution at
# the bottom (a routing decision or in-process TPOT at speedup is ~100 µs)
# through 60 s at the top (a cold-compile TTFT).
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    return tuple(sorted((labels or {}).items()))


def _escape_label_value(v: str) -> str:
    """Prometheus text-exposition escaping: inside a label value, `\\`,
    `"` and newline must be escaped or the whole exposition is invalid
    (a scraper rejects every series, not just the bad one)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    def __init__(self, name: str, help_: str) -> None:
        self.name, self.help = name, help_
        self._values: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None):
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:  # concurrent inc() must not tear the snapshot
            values = sorted(self._values.items())
        for k, v in values:
            out.append(f"{self.name}{_fmt_labels(k)} {v}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str) -> None:
        self.name, self.help = name, help_
        self._values: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def add(self, amount: float, labels: Optional[Dict[str, str]] = None):
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:  # concurrent set()/add() must not tear the snapshot
            values = sorted(self._values.items())
        for k, v in values:
            out.append(f"{self.name}{_fmt_labels(k)} {v}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS) -> None:
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sum: Dict[LabelKey, float] = {}
        self._total: Dict[LabelKey, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None):
        k = _label_key(labels)
        idx = bisect_right(self.buckets, value)
        with self._lock:
            if k not in self._counts:
                self._counts[k] = [0] * (len(self.buckets) + 1)
                self._sum[k] = 0.0
                self._total[k] = 0
            self._counts[k][idx] += 1
            self._sum[k] += value
            self._total[k] += 1

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return self._total.get(_label_key(labels), 0)

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._sum.get(_label_key(labels), 0.0)

    def mean(self, labels: Optional[Dict[str, str]] = None) -> float:
        """NaN on an empty label set (never raises): 0.0 read as "zero
        latency" by the SLA planner's arithmetic; NaN propagates as
        "no data" and comparisons against it are False."""
        k = _label_key(labels)
        with self._lock:  # count and sum must come from one snapshot
            n = self._total.get(k, 0)
            s = self._sum.get(k, 0.0)
        return s / n if n else float("nan")

    # -- label-aggregated views (SLO burn-rate sources) --------------------

    def total_count(self) -> int:
        """Observations across ALL label sets."""
        with self._lock:
            return sum(self._total.values())

    def total_sum(self) -> float:
        with self._lock:
            return sum(self._sum.values())

    def total_mean(self) -> float:
        """Mean across all label sets; NaN when empty (same "no data"
        propagation contract as `mean`)."""
        with self._lock:
            n = sum(self._total.values())
            s = sum(self._sum.values())
        return s / n if n else float("nan")

    def count_le(self, value: float) -> int:
        """Observations known to be <= `value`, across all label sets —
        the cumulative count at the largest bucket bound <= `value`
        (matching the `le` cumulative the exposition prints).  Bucket
        granularity: observations in the bucket CONTAINING a mid-bucket
        `value` are excluded (conservative for SLO accounting — they
        count as bad); pick thresholds at bucket bounds for exactness."""
        idx = bisect_right(self.buckets, value)
        with self._lock:
            return sum(sum(c[:idx]) for c in self._counts.values())

    def quantile(self, q: float, labels: Optional[Dict[str, str]] = None) -> float:
        """Approximate quantile from bucket counts (upper bound of the
        bucket containing the q-th observation).  Edge behavior: NaN on
        an empty/unknown label set; q clamps to [0, 1]; q=0 returns the
        first non-empty bucket's bound (a single observation answers
        every quantile with its own bucket); +Inf past the last bucket.
        Never raises."""
        k = _label_key(labels)
        with self._lock:
            counts = list(self._counts.get(k, ()))
            total = self._total.get(k, 0)
        if not counts or total <= 0:
            return float("nan")
        q = min(max(q, 0.0), 1.0)
        # At least the first observation: q=0 must land in a non-empty
        # bucket, not the (possibly empty) first one.
        target = max(1, math.ceil(q * total))
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                return self.buckets[i] if i < len(self.buckets) else float("inf")
        return float("inf")

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            # Snapshot under the lock: a concurrent observe() between
            # reading _counts and _sum would emit torn cumulative counts
            # (bucket cum > _count, or _sum missing the observation).
            snap = {k: (list(self._counts[k]), self._sum[k])
                    for k in self._counts}
        for k in sorted(snap):
            counts, total_sum = snap[k]
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[i]
                le = _fmt_labels(k, 'le="%s"' % b)
                out.append(f"{self.name}_bucket{le} {cum}")
            cum += counts[-1]
            le_inf = _fmt_labels(k, 'le="+Inf"')
            out.append(f"{self.name}_bucket{le_inf} {cum}")
            out.append(f"{self.name}_sum{_fmt_labels(k)} {total_sum}")
            out.append(f"{self.name}_count{_fmt_labels(k)} {cum}")
        return out


class EngineStepCounters:
    """Serving-loop overhead counters the engine increments in-line (port
    of the JAX class: the same names, `to_dict()` keys and rules).

    Counted on the engine thread only (no locking), cheap enough for the
    per-step hot path:

    - `host_syncs` — blocking device→host reads the step loop performed
      (window token copies, single-step sample reads, blocking
      first-token settles).  Steady-state window decode must pay at most
      ONE per window; anything above that is a pipeline bug.
    - `xla_cache_misses` — first-seen (program, shape-signature) pairs
      via `note_dispatch`.  The name is the JAX package's metric name; in
      this package it counts the shapes a dispatch site meets for the
      first time (a kernel library's first use builds it, and a shape's
      first dispatch pays the allocator's and cuBLAS's first use), so a
      nonzero delta after warmup means the engine is churning shapes.
    - dispatch tallies (`window_dispatches`, `single_step_dispatches`,
      `prefill_dispatches`, `packed_prefill_dispatches`,
      `spec_dispatches`, `h2d_uploads`) — denominators for the two
      above (syncs *per window*, uploads *per dispatch*).
    - `kv_read_bytes_modeled` / `decode_tokens_emitted` (via
      `note_kv_read`) — the MODELED KV bytes decode attention swept and
      the tokens those sweeps emitted; their ratio is
      `effective_bytes_per_token` (int8 KV roughly halves the numerator,
      speculative decoding grows the denominator per sweep).
    - `ring_exchange_bytes_modeled` / `ring_kernel_prefills` — the sp
      ring's modeled bytes a rank sent (its resident chunk rides sp - 1
      hops a layer, the same for both rings) and the prefills whose ring
      ran the flash-fold kernel.

    Counters of this package only, kept out of `to_dict()` (which holds
    JAX's keys) and in `as_dict()`: `model_rows` (token rows the model
    ran, padding included: each is routed to k experts in every MoE
    layer), `sp_prefill_dispatches` and `sp_prefill_count` (ring prefill
    dispatches and the prompts they prefilled).
    """

    PORT_COUNTERS = ("model_rows", "sp_prefill_dispatches",
                     "sp_prefill_count")

    def __init__(self) -> None:
        self.host_syncs = 0
        self.xla_cache_misses = 0
        self.window_dispatches = 0
        self.window_syncs = 0
        self.single_step_dispatches = 0
        self.prefill_dispatches = 0
        self.packed_prefill_dispatches = 0
        self.spec_dispatches = 0
        self.h2d_uploads = 0
        self.kv_read_bytes_modeled = 0
        self.decode_tokens_emitted = 0
        self.ring_exchange_bytes_modeled = 0
        self.ring_kernel_prefills = 0
        self.model_rows = 0
        self.sp_prefill_dispatches = 0
        self.sp_prefill_count = 0
        # Mixed-prefill cost calibration: EWMAs of engine-thread wall
        # seconds per window-decode token (plain windows) and per
        # concurrently-dispatched prefill token (the excess on windows
        # with a chunk riding behind them), fed by note_window_interval
        # at the window sync.  Deliberately NOT in to_dict(): delta-pinned
        # counter tests compare exact ints.  None = no sample yet — a
        # measured cost of exactly 0.0 is a real sample.
        self.decode_token_cost_ewma: Optional[float] = None
        self.prefill_token_cost_ewma: Optional[float] = None
        self.prefill_cost_samples = 0
        self._cost_ewma_alpha = 0.25
        # A window's span on its stream (CUDA events around the dispatch,
        # read at the window's sync; only on a card with the device
        # profiler on): the measured side of the device profiler's
        # window_time series.  Out of to_dict() like the EWMAs above.
        self.window_device_s_ewma: Optional[float] = None
        self._seen_shapes: set = set()
        # Optional first-seen-shape hook (the engine points this at its
        # flight recorder so every first dispatch leaves a postmortem
        # event); called ONLY on misses, so the steady window never pays
        # for it.
        self.on_recompile: Optional[Callable] = None

    def note_dispatch(self, tag: str, *sig) -> bool:
        """Record a dispatch; a first-seen (tag, sig) counts as a cache
        miss.  Returns True exactly on first-seen — the dispatch site uses
        it to feed the device profiler's cost harvest without any
        steady-state branch cost."""
        key = (tag,) + sig
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            self.xla_cache_misses += 1
            cb = self.on_recompile
            if cb is not None:
                cb(key)
            return True
        return False

    def note_kv_read(self, nbytes: int, tokens: int) -> None:
        """Tally modeled decode KV traffic (bytes swept) and the tokens
        it emitted; host-int arithmetic only."""
        self.kv_read_bytes_modeled += int(nbytes)
        self.decode_tokens_emitted += int(tokens)

    def note_ring_exchange(self, nbytes: int) -> None:
        """Tally modeled per-rank ring exchange bytes (sp prefill
        dispatches only); host-int arithmetic only."""
        self.ring_exchange_bytes_modeled += int(nbytes)

    def note_window_interval(self, wall_s: float, window_tokens: int,
                             prefill_tokens: int) -> None:
        """Wall time between consecutive steady window syncs.  Plain
        windows (no chunk behind them) calibrate the per-decode-token
        cost; windows with `prefill_tokens` dispatched behind them
        attribute the excess over the calibrated decode cost to the
        chunk."""
        if wall_s <= 0 or window_tokens <= 0:
            return
        a = self._cost_ewma_alpha
        if prefill_tokens <= 0:
            per = wall_s / window_tokens
            self.decode_token_cost_ewma = (
                per if self.decode_token_cost_ewma is None
                else (1.0 - a) * self.decode_token_cost_ewma + a * per)
        elif self.decode_token_cost_ewma is not None:
            excess = wall_s - window_tokens * self.decode_token_cost_ewma
            per = max(excess, 0.0) / prefill_tokens
            self.prefill_token_cost_ewma = (
                per if self.prefill_token_cost_ewma is None
                else (1.0 - a) * self.prefill_token_cost_ewma + a * per)
            self.prefill_cost_samples += 1

    def note_window_device_time(self, seconds: float) -> None:
        """Fold one window's measured device span into its EWMA."""
        a = self._cost_ewma_alpha
        self.window_device_s_ewma = (
            seconds if self.window_device_s_ewma is None
            else (1.0 - a) * self.window_device_s_ewma + a * seconds)

    @property
    def measured_prefill_cost_ratio(self):
        """Measured chunked-prefill-token / window-decode-token cost, or
        None before both EWMAs have samples (MixedPrefillController
        clamps it)."""
        if (self.decode_token_cost_ewma is None
                or self.prefill_token_cost_ewma is None):
            return None
        return self.prefill_token_cost_ewma / self.decode_token_cost_ewma

    @property
    def effective_bytes_per_token(self) -> float:
        """Modeled KV bytes per emitted decode token (0 before any
        decode work)."""
        if not self.decode_tokens_emitted:
            return 0.0
        return self.kv_read_bytes_modeled / self.decode_tokens_emitted

    def to_dict(self) -> Dict[str, int]:
        return {
            "host_syncs": self.host_syncs,
            "xla_cache_misses": self.xla_cache_misses,
            "window_dispatches": self.window_dispatches,
            "window_syncs": self.window_syncs,
            "single_step_dispatches": self.single_step_dispatches,
            "prefill_dispatches": self.prefill_dispatches,
            "packed_prefill_dispatches": self.packed_prefill_dispatches,
            "spec_dispatches": self.spec_dispatches,
            "h2d_uploads": self.h2d_uploads,
            "kv_read_bytes_modeled": self.kv_read_bytes_modeled,
            "decode_tokens_emitted": self.decode_tokens_emitted,
            "ring_exchange_bytes_modeled": self.ring_exchange_bytes_modeled,
            "ring_kernel_prefills": self.ring_kernel_prefills,
        }

    def as_dict(self) -> Dict[str, int]:
        """`to_dict()` and this package's own counters (`/debug/stats`)."""
        out = self.to_dict()
        out.update((k, getattr(self, k)) for k in self.PORT_COUNTERS)
        return out

    def reset_counts(self) -> None:
        """Zero every count in place (`/debug/stats/reset`).  The shapes
        already seen, the recompile hook and the cost calibration are
        engine state, not statistics: they carry over."""
        for k in self.as_dict():
            setattr(self, k, 0)

    def snapshot(self) -> "EngineStepCounters":
        """Point-in-time copy (delta assertions across a step range)."""
        c = EngineStepCounters()
        c.__dict__.update({k: v for k, v in self.__dict__.items()
                           if k != "_seen_shapes"})
        c._seen_shapes = set()
        return c

    def delta(self, since: "EngineStepCounters") -> Dict[str, int]:
        now, then = self.to_dict(), since.to_dict()
        return {k: now[k] - then[k] for k in now}


class MetricsRegistry:
    """Named registry with hierarchical prefixes (reference
    `MetricsRegistry`, `lib/runtime/src/metrics.rs`)."""

    def __init__(self, prefix: str = "dynamo") -> None:
        self.prefix = prefix
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_: str, **kw):
        full = f"{self.prefix}_{name}" if self.prefix else name
        with self._lock:
            m = self._metrics.get(full)
            if m is None:
                m = cls(full, help_, **kw)
                self._metrics[full] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {full} already registered as {type(m)}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def expose(self) -> str:
        lines: List[str] = []
        with self._lock:
            for m in self._metrics.values():
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"


class RequestMetrics:
    """Per-request lifecycle histograms (`dynamo_request_*`): the series
    the distributed-tracing work surfaces on every process that touches a
    request — frontend `/metrics` observes TTFT / TPOT / queue wait,
    disagg decode workers observe KV-transfer time.  Distinct from
    FrontendMetrics (whose exact series names the SLA planner's queries
    key on): these are the triage-oriented family `/debug/traces`
    complements."""

    def __init__(self, registry: MetricsRegistry) -> None:
        self.ttft = registry.histogram(
            "request_ttft_seconds", "Request time to first token")
        self.tpot = registry.histogram(
            "request_tpot_seconds", "Per-output-token interval "
            "(time per output token after the first)")
        self.queue_wait = registry.histogram(
            "request_queue_wait_seconds",
            "Arrival to generation-stream start")
        self.kv_transfer = registry.histogram(
            "request_kv_transfer_seconds",
            "Disaggregated KV-block onboard time (remote prefill pull)")
        self.kv_transfer_overlap = registry.histogram(
            "kv_transfer_overlap",
            "Fraction of the disagg KV prefix streamed before "
            "prefill-done (eager-streaming overlap ratio, 0-1)",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
        # status="ok"|"error" — the SLO monitor's error-rate objective
        # source (runtime/slo.py), observed where the stream finishes
        # (frontend token stream; worker engine_wire_handler).
        self.outcomes = registry.counter(
            "request_outcomes_total",
            "Finished requests by terminal status (ok|error)")

    def observe_outcome(self, ok: bool) -> None:
        self.outcomes.inc(labels={"status": "ok" if ok else "error"})


class FrontendMetrics:
    """The HTTP-service metric family the SLA planner consumes (reference
    `http/service/metrics.rs:61-65,139-142`)."""

    def __init__(self, registry: MetricsRegistry) -> None:
        self.requests_total = registry.counter(
            "frontend_requests_total", "Requests received")
        self.requests_in_flight = registry.gauge(
            "frontend_inflight_requests", "Requests currently being served")
        self.queued_requests = registry.gauge(
            "frontend_queued_requests", "Requests queued before engine entry")
        self.ttft = registry.histogram(
            "frontend_time_to_first_token_seconds", "Time to first token")
        self.itl = registry.histogram(
            "frontend_inter_token_latency_seconds", "Inter-token latency")
        self.request_duration = registry.histogram(
            "frontend_request_duration_seconds", "Full request duration")
        self.input_tokens = registry.histogram(
            "frontend_input_sequence_tokens", "Prompt tokens per request",
            buckets=(16, 64, 256, 1024, 4096, 16384, 65536))
        self.output_tokens = registry.histogram(
            "frontend_output_sequence_tokens", "Output tokens per request",
            buckets=(1, 4, 16, 64, 256, 1024, 4096))


class KvCacheMetrics:
    """Memory-plane telemetry: the capacity-side series KVCache-centric
    schedulers and SLO-driven autoscalers treat as first-class inputs.

    Series (labels `tier` = device|host|disk, `pool` = pool name):

    - `dynamo_kv_pool_{capacity,active,reusable,free}_blocks` — gauges
      sampled from `BlockPool` occupancy views;
    - `dynamo_kv_evictions_total` — LRU evictions per pool;
    - `dynamo_kv_prefix_cache_{hits,misses}_tokens` — prompt tokens
      served from / missed by the prefix cache at admission;
    - `dynamo_hbm_{used,limit}_bytes` (labels `device`, `kind`) —
      per-card memory occupancy, fed by `HbmPoller`.

    Pull-based: `observe_*` SAMPLES host-side integers the pools and
    scheduler already maintain — called at scrape/pump time off the
    engine thread, so the steady decode window pays zero added host
    syncs and zero dispatches for the telemetry existing."""

    def __init__(self, registry: MetricsRegistry) -> None:
        self.pool_capacity = registry.gauge(
            "kv_pool_capacity_blocks", "KV pool slot capacity")
        self.pool_active = registry.gauge(
            "kv_pool_active_blocks", "KV slots pinned by live sequences")
        self.pool_reusable = registry.gauge(
            "kv_pool_reusable_blocks",
            "Allocatable slots (free + evictable inactive)")
        self.pool_free = registry.gauge(
            "kv_pool_free_blocks", "Slots on the free list")
        self.evictions = registry.counter(
            "kv_evictions_total", "Registered blocks LRU-evicted")
        self.prefix_hits = registry.counter(
            "kv_prefix_cache_hits_tokens",
            "Prompt tokens served from the prefix cache at admission")
        self.prefix_misses = registry.counter(
            "kv_prefix_cache_misses_tokens",
            "Prompt tokens that missed the prefix cache at admission")
        # Fleet-wide prefix reuse (block_manager/prefix_share.py):
        # peer-to-peer prefix pulls driven by router remote-prefix hints.
        self.prefix_remote_hits = registry.counter(
            "prefix_remote_hits_total",
            "Requests whose prefix was pulled from a peer worker")
        self.prefix_remote_pulled = registry.counter(
            "prefix_remote_pulled_blocks_total",
            "KV blocks injected from peer workers via prefix-share pulls")
        self.prefix_remote_fallbacks = registry.counter(
            "prefix_remote_fallbacks_total",
            "Remote-prefix pulls that failed or were refused "
            "(request fell back to local prefill)")
        # Which data plane bulk KV pulls rode: plane=device
        # batches crossed device-to-device (reason names the pull site:
        # eager|prefix|disagg); plane=host names WHY the device plane
        # was not used (no_plane, offer_cap, transport, not_resident,
        # pull_failed, quant_mismatch, ...) — a fleet silently degraded
        # to host staging is visible here.
        self.transfer_plane_choices = registry.counter(
            "kv_transfer_plane_total",
            "Batched bulk-KV pull rounds by data plane (one increment "
            "per pull round on BOTH planes, so device/host reflects "
            "traffic; reason = pull site for device, fallback cause "
            "for host)")
        self.hbm_used = registry.gauge(
            "hbm_used_bytes", "Accelerator memory in use")
        self.hbm_limit = registry.gauge(
            "hbm_limit_bytes", "Accelerator memory capacity")
        # Decode-bandwidth-wall series: KV bytes per block as
        # actually stored (incl. int8 scales), modeled KV bytes swept per
        # emitted token, and the speculative-decoding accept telemetry.
        self.kv_bytes_per_block = registry.gauge(
            "kv_bytes_per_block",
            "True PER-CHIP bytes of one KV block across layers, "
            "including quantization scales in int8 mode and divided by "
            "the mesh's KV shard count on sharded pools")
        self.kv_effective_bytes_per_token = registry.gauge(
            "kv_effective_bytes_per_token",
            "Modeled decode-attention HBM bytes per emitted token, "
            "per chip under meshes")
        self.spec_drafted = registry.counter(
            "spec_decode_drafted_tokens_total",
            "Draft tokens proposed to the batched verify step")
        self.spec_accepted = registry.counter(
            "spec_decode_accepted_tokens_total",
            "Draft tokens the verify step accepted")
        self.spec_acceptance_rate = registry.gauge(
            "spec_decode_acceptance_rate",
            "Cumulative accepted/drafted ratio (0 when spec decode off)")
        # Cumulative-source high-water marks: counters can only inc, so
        # sampled monotonic ints (pool.evictions, scheduler token
        # counters) convert to increments by delta from the last sample.
        self._last: Dict[tuple, float] = {}

    def _inc_to(self, counter: Counter, labels: Dict[str, str],
                cum: float) -> None:
        key = (counter.name, _label_key(labels))
        prev = self._last.get(key, 0.0)
        if cum < prev:
            prev = 0.0  # source restarted (fresh pool/engine)
        if cum > prev:
            counter.inc(cum - prev, labels=labels)
        self._last[key] = cum

    @never_engine_thread
    def observe_prefix_share(self, fetcher) -> None:
        """Sample a PrefixFetcher's cumulative pull accounting into the
        dynamo_prefix_remote_* counters (same pull-style delta
        conversion as the pool counters)."""
        self._inc_to(self.prefix_remote_hits, {}, fetcher.remote_hits)
        self._inc_to(self.prefix_remote_pulled, {}, fetcher.pulled_blocks)
        self._inc_to(self.prefix_remote_fallbacks, {}, fetcher.fallbacks)

    @never_engine_thread
    def observe_transfer_plane(self, counts=None) -> None:
        """Sample the device-transfer plane-choice tallies
        (device_transfer.plane_counts — process-wide host ints) into the
        dynamo_kv_transfer_plane_total counter family.  `counts` may be
        passed explicitly (tests)."""
        if counts is None:
            from dynamo_tpu_torch.llm.block_manager.device_transfer import (
                plane_counts)

            counts = plane_counts()
        for (plane, reason), n in counts.items():
            self._inc_to(self.transfer_plane_choices,
                         {"plane": plane, "reason": reason}, n)

    @never_engine_thread
    def observe_pool(self, pool, tier: str) -> None:
        """Sample one BlockPool's occupancy + eviction counters."""
        labels = {"tier": tier, "pool": pool.name}
        self.pool_capacity.set(pool.capacity, labels=labels)
        self.pool_active.set(pool.active_slots, labels=labels)
        self.pool_reusable.set(pool.reusable_slots, labels=labels)
        self.pool_free.set(pool.free_slots, labels=labels)
        self._inc_to(self.evictions, labels, pool.evictions)

    @never_engine_thread
    def observe_engine(self, core) -> None:
        """Sample an EngineCore's block source (all tiers) and the
        scheduler's admission prefix-match counters.  Reads host-side
        ints only — never device arrays — so it is safe to call from a
        scrape thread while the engine steps (and must never BE the
        engine thread: sampling on the step loop would charge the
        steady window for its own telemetry)."""
        alloc = core.allocator
        manager = getattr(alloc, "manager", None)
        if manager is not None:
            # Only the device tier is ported (no host or disk pool).
            self.observe_pool(manager.device, "device")
            device_pool = manager.device.name
        else:
            # Plain free-list allocator: no pool object, synthesize the
            # device-tier gauges from its counts (no reuse → active =
            # allocated, reusable = free).
            labels = {"tier": "device", "pool": "plain"}
            cap = alloc.num_blocks - 1
            free = alloc.free_blocks
            self.pool_capacity.set(cap, labels=labels)
            self.pool_active.set(cap - free, labels=labels)
            self.pool_reusable.set(free, labels=labels)
            self.pool_free.set(free, labels=labels)
            device_pool = "plain"
        sched = getattr(core, "scheduler", None)
        if sched is not None:
            labels = {"tier": "device", "pool": device_pool}
            self._inc_to(self.prefix_hits, labels,
                         getattr(sched, "prefix_hit_tokens", 0))
            self._inc_to(self.prefix_misses, labels,
                         getattr(sched, "prefix_miss_tokens", 0))
        cache_cfg = getattr(core, "cache_cfg", None)
        if cache_cfg is not None:
            # Per-CHIP bytes: a tp/dp-sharded pool splits every block
            # over kv_shard_count chips, and the HBM-residency math the
            # planner does against dynamo_hbm_* would double-count a
            # whole-block figure.
            shards = getattr(core, "kv_shard_count", 1)
            self.kv_bytes_per_block.set(
                cache_cfg.bytes_per_block / max(shards, 1),
                labels={"kv_quant": cache_cfg.kv_quant})
        counters = getattr(core, "counters", None)
        if counters is not None:
            self.kv_effective_bytes_per_token.set(
                counters.effective_bytes_per_token)
        stats = getattr(getattr(core, "metrics", None),
                        "spec_decode_stats", None)
        if stats is not None:
            self._inc_to(self.spec_drafted, {}, stats.num_drafts)
            self._inc_to(self.spec_accepted, {}, stats.num_accepted_tokens)
            self.spec_acceptance_rate.set(
                stats.num_accepted_tokens / stats.num_drafts
                if stats.num_drafts else 0.0)


class HbmPoller:
    """Slow-poll thread feeding `dynamo_hbm_{used,limit}_bytes` from
    `torch.cuda.mem_get_info` of the process's card(s).

    Off the engine thread by construction (its own daemon thread), and
    `mem_get_info` is a driver query: no kernel, no sync injected into
    the step loop.  Without a card (CPU) it falls back to process RSS /
    system RAM under `device="host", kind="cpu"`, as the JAX poller does
    on a backend without memory stats, so the series family exists
    everywhere.  `devices`: the card indices to poll (default: the
    current one — querying another card would open a context there)."""

    def __init__(self, metrics: KvCacheMetrics,
                 interval: float = 10.0,
                 devices: Optional[Sequence[int]] = None) -> None:
        self.metrics = metrics
        self.interval = interval
        self.devices = None if devices is None else list(devices)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @never_engine_thread
    def poll_once(self) -> int:
        """One sample of every polled card; returns the number of cards
        that reported (0 → fallback used)."""
        import torch

        devices = self.devices
        if devices is None:
            devices = ([torch.cuda.current_device()]
                       if torch.cuda.is_available() else [])
        reported = 0
        used_total = limit_total = 0
        for i in devices:
            try:
                free, total = torch.cuda.mem_get_info(i)
            except (RuntimeError, AssertionError):
                continue
            labels = {"device": str(i), "kind": "gpu"}
            used = int(total) - int(free)
            self.metrics.hbm_used.set(used, labels=labels)
            self.metrics.hbm_limit.set(total, labels=labels)
            used_total += used
            limit_total += int(total)
            reported += 1
        if not reported:
            self._poll_host_fallback()
        else:
            # Flight-recorder HBM sample: one aggregate event per poll —
            # the "was HBM climbing before the death" postmortem series.
            flight_recorder.get_recorder().record(
                "hbm", devices=reported, used_bytes=used_total,
                limit_bytes=limit_total)
        return reported

    @staticmethod
    def _current_rss_bytes() -> Optional[int]:
        """CURRENT resident set, not getrusage's lifetime high-water
        mark (a gauge fed by ru_maxrss could never decrease — one model-
        load spike would read as a permanently full host; and ru_maxrss
        units are platform-dependent: KB on Linux, bytes on macOS)."""
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            import os

            return pages * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            pass  # non-Linux: try getrusage next
        try:  # non-Linux fallback: the peak is better than nothing
            import resource
            import sys

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return rss if sys.platform == "darwin" else rss * 1024
        except Exception:
            return None

    def _poll_host_fallback(self) -> None:
        labels = {"device": "host", "kind": "cpu"}
        rss = self._current_rss_bytes()
        if rss is None:
            return
        self.metrics.hbm_used.set(rss, labels=labels)
        try:
            import os

            total = (os.sysconf("SC_PHYS_PAGES")
                     * os.sysconf("SC_PAGE_SIZE"))
            self.metrics.hbm_limit.set(total, labels=labels)
        except (ValueError, OSError, AttributeError):
            pass

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="hbm-poll", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # telemetry must never kill the process
                warn_rate_limited(
                    _logger, "hbm_poll", 60.0,
                    "HBM poll failed (series go stale): %s", e)
            self._stop.wait(self.interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
