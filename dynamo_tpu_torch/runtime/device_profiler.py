"""Device-truth profiling plane: what the card did (port of
`dynamo_tpu/runtime/device_profiler.py`).

Every performance claim of the serving path — `kv_read_bytes_modeled`,
`ring_exchange_bytes_modeled`, transfer rates — is modeled arithmetic.
This module holds it against the card, in three legs:

- **ProgramCostRegistry** (cost harvest) — the engine's dispatch sites
  classify every step program by the same (tag, shape-signature)
  identity `EngineStepCounters.note_dispatch` and the flight recorder
  stamp; on a FIRST-SEEN shape the engine calls
  :meth:`DeviceProfiler.harvest` with the MODELED cost of that dispatch
  class (:func:`modeled_step_cost`: flops and bytes from the model
  config and the shape signature).  The JAX package reads XLA's
  `Lowered.cost_analysis()` there; eager PyTorch has no counterpart, so
  the port models it, and the metric HELP says so.  The harvest runs on
  the first-seen edge only: steady-window `EngineStepCounters` deltas
  are byte-identical plane-on vs plane-off.
- **DriftAuditor** (modeled-vs-measured audit) — folds the engine's
  modeled per-step KV bytes against the registry's bytes per dispatch
  class (`kv_decode`), and the registry's roofline time of a window
  against the window's measured time (`window_time`), as
  `dynamo_modeled_vs_measured_ratio{series=}`.  The invariant is
  ONE-SIDED: modeled KV bytes are a component of what a step moves
  (weights ride every dispatch too), so ratio = modeled/measured must
  stay ≤ band_hi (default 1.25).  Three consecutive out-of-band
  observations PAGE: a `drift_page` event via
  ``FlightRecorder.record_always`` + an async ring dump.  On a card the
  measured side of `window_time` is the window's span on its stream
  (CUDA events recorded around each window dispatch, read at the
  window's existing sync); without a card it is JAX's rule (the decode
  cost EWMA times the tokens a window emits).
- **On-demand device capture** — a bounded ``torch.profiler`` capture
  (CPU and CUDA activities) on a LIVE worker
  (``/debug/deviceprofile?ms=500`` on the StatusServer and the frontend,
  and the control-plane ``profile/<pid>`` command key), writing a Chrome
  trace and a ``capture_meta.json`` sidecar under ``--flight-dump-dir``
  in a ``deviceprofile_<service>_<pid>`` directory.  On a card a capture
  that recorded no kernel is a failure (``ok: false``).

Surfaces: `dynamo_program_flops{program=}` /
`dynamo_program_bytes_accessed{program=}` /
`dynamo_program_registry_size` /
`dynamo_modeled_vs_measured_ratio{series=}` on worker `/metrics`, and
`/debug/deviceprofile` on every status surface.

Stdlib-only at import time (torch is imported inside capture): the
engine and worker main import this module unconditionally.
"""

from __future__ import annotations

import glob as _glob
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime import flight_recorder

logger = logging.getLogger(__name__)

# Capture bound: a device trace buffers in host RAM; an unbounded
# capture on a serving worker is an incident, not a feature.
DEFAULT_MAX_CAPTURE_MS = 2000

# Drift band (modeled / measured), one-sided as in the JAX package: the
# HIGH edge is the honesty gate — modeled traffic claiming more than the
# card moved means the accounting double-counts.
DEFAULT_BAND_HI = 1.25
DEFAULT_BAND_LO = 0.0
# Consecutive out-of-band observations before a series PAGEs.
PAGE_STRIKES = 3

# Control-plane capture command prefix: `profile/{pid}` or
# `profile/instance/{instance_id}` (value: optional capture ms).
PROFILE_PREFIX = "profile/"

# NVIDIA's H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor
# rate, the peaks the modeled roofline time divides by.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = 989e12


def profile_key_pid(pid: int) -> str:
    return f"{PROFILE_PREFIX}{pid}"


def profile_key_instance(instance_id: int) -> str:
    return f"{PROFILE_PREFIX}instance/{instance_id}"


def program_label(tag: str, sig: Tuple) -> str:
    """The registry/metrics identity of a program — the same
    (tag, shape-signature) key note_dispatch/flight stamps use."""
    return tag + ":" + ",".join(str(x) for x in sig)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM rate and flops over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_PER_S)


def modeled_step_cost(cfg, *, steps: int, tokens: int, kv_tokens: int,
                      kv_bytes_per_token: int,
                      shards: int = 1) -> Tuple[float, float]:
    """(flops, bytes) of one dispatch of a step program, modeled from the
    model config: `steps` forwards (a window's K, else 1), each over
    `tokens` token rows (padding included) attending `kv_tokens` cached
    tokens in all (the page bucket's width over every row).

    Bytes: every weight read once a step (the tied or untied lm head
    included; the embedding gather's rows are activations), the KV
    pages at the page bucket once a step, and the activations (the
    hidden state in and out of each layer, the f32 logits).  Flops: two
    a multiply-add of every matmul weight a token row, plus the
    attention products over the cached tokens.

    Per chip of a tp group of `shards` ranks, or of a pipeline of
    `shards` stages, JAX's per-chip divisor (`kv_bytes_per_token` is
    already per chip): each reads 1/shards of the weights, does 1/shards
    of the flops and writes its 1/shards of the logits; the hidden state
    is every rank's."""
    h, v = cfg.hidden_size, cfg.vocab_size
    wbytes = cfg.dtype.itemsize
    weights = cfg.param_count() - (0 if cfg.tie_embeddings else v * h)
    matmul = cfg.param_count() - v * h * (0 if cfg.tie_embeddings else 1)
    if cfg.is_moe:
        # Routed rows touch k of E experts: the flops are k experts'.
        expert = 3 * h * cfg.intermediate_size
        matmul -= cfg.num_layers * expert * (cfg.num_experts
                                             - cfg.num_experts_per_token)
    activations = tokens * (2 * cfg.num_layers * h * wbytes + v * 4 / shards)
    attn_flops = 4 * kv_tokens * cfg.num_heads * cfg.head_dim * cfg.num_layers
    nbytes = steps * (weights * wbytes / shards
                      + kv_tokens * kv_bytes_per_token + activations)
    flops = steps * (2.0 * matmul * tokens + attn_flops) / shards
    return float(flops), float(nbytes)


class ProgramCostRegistry:
    """Host-side map of program label → modeled cost.

    Written only on first-seen shapes (a handful per process lifetime),
    read at scrape time; plain dict under the GIL, iterated via
    snapshot."""

    def __init__(self) -> None:
        self._programs: Dict[str, Dict[str, Optional[float]]] = {}

    def record(self, label: str, *, flops: float, bytes_accessed: float,
               optimal_s: Optional[float] = None) -> None:
        self._programs[label] = {
            "flops": float(flops),
            "bytes_accessed": float(bytes_accessed),
            "optimal_s": (float(optimal_s)
                          if optimal_s is not None else None),
        }

    def size(self) -> int:
        return len(self._programs)

    def items(self) -> List[Tuple[str, Dict[str, Optional[float]]]]:
        return sorted(self._programs.items())

    def tag_values(self, key: str, *tags: str) -> List[float]:
        """All recorded `key` values for programs whose tag is one of
        `tags` (label prefix before the first ':')."""
        out: List[float] = []
        for label, costs in list(self._programs.items()):
            if label.split(":", 1)[0] in tags:
                v = costs.get(key)
                if v is not None:
                    out.append(v)
        return out

    def mean_for_tags(self, key: str, *tags: str) -> Optional[float]:
        vals = self.tag_values(key, *tags)
        return sum(vals) / len(vals) if vals else None

    def reset(self) -> None:
        self._programs.clear()


class DriftAuditor:
    """Band state machine over modeled/measured ratios, one per series.

    `observe` is called at SCRAPE time (worker_metrics_text →
    audit_engine), never on the engine hot path.  A series that stays
    out of band for PAGE_STRIKES consecutive observations transitions
    to PAGE: one `drift_page` flight event (record_always — drift
    evidence must land even on a recorder that never opted in) plus an
    async ring dump; returning in band resets the episode."""

    def __init__(self, band_hi: float = DEFAULT_BAND_HI,
                 band_lo: float = DEFAULT_BAND_LO) -> None:
        self.band_hi = band_hi
        self.band_lo = band_lo
        self._series: Dict[str, Dict] = {}

    def observe(self, series: str, modeled: float,
                measured: float) -> Optional[float]:
        """Fold one modeled/measured pair; returns the ratio, or None
        when the pair is unobservable (no measured denominator yet)."""
        if measured <= 0 or modeled < 0:
            return None
        ratio = modeled / measured
        st = self._series.setdefault(
            series, {"ratio": None, "state": "ok", "strikes": 0})
        st["ratio"] = ratio
        in_band = self.band_lo <= ratio <= self.band_hi
        if in_band:
            if st["state"] == "page":
                rec = flight_recorder.get_recorder()
                rec.record_always("drift_ok", series=series,
                                  ratio=round(ratio, 4))
            st["state"] = "ok"
            st["strikes"] = 0
            return ratio
        st["strikes"] += 1
        if st["strikes"] >= PAGE_STRIKES and st["state"] != "page":
            st["state"] = "page"
            rec = flight_recorder.get_recorder()
            rec.record_always(
                "drift_page", series=series, ratio=round(ratio, 4),
                band_lo=self.band_lo, band_hi=self.band_hi,
                strikes=st["strikes"])
            logger.error(
                "modeled-vs-measured drift PAGE: series=%s ratio=%.4f "
                "outside [%s, %s] for %d consecutive observations — "
                "modeled accounting is over-claiming; dumping flight "
                "recorder", series, ratio, self.band_lo, self.band_hi,
                st["strikes"])
            rec.dump_async("drift_page")
        return ratio

    def ratios(self) -> Dict[str, float]:
        return {s: st["ratio"] for s, st in self._series.items()
                if st["ratio"] is not None}

    def states(self) -> Dict[str, Dict]:
        return {s: dict(st) for s, st in self._series.items()}

    def paged(self) -> bool:
        return any(st["state"] == "page"
                   for st in self._series.values())

    def reset(self) -> None:
        self._series.clear()


class DeviceProfiler:
    """The per-process device-truth plane: registry + auditor + capture.

    Disabled by default (module singleton — tests and libraries that
    import the engine must not pay for it); the worker flag
    ``--device-profiler on`` enables it at process startup."""

    def __init__(self, service: str = "dynamo", *, enabled: bool = False,
                 max_capture_ms: int = DEFAULT_MAX_CAPTURE_MS,
                 dump_dir: Optional[str] = None,
                 band_hi: float = DEFAULT_BAND_HI,
                 band_lo: float = DEFAULT_BAND_LO) -> None:
        self.service = service
        self.enabled = enabled
        self.max_capture_ms = max_capture_ms
        self.dump_dir = dump_dir
        self.registry = ProgramCostRegistry()
        self.auditor = DriftAuditor(band_hi=band_hi, band_lo=band_lo)
        self.harvests = 0
        self.harvest_failures = 0
        self.captures = 0
        self.last_capture_dir: Optional[str] = None
        # One capture at a time: the profiler's state is process-global.
        self._capture_lock = threading.Lock()

    # -- configuration -----------------------------------------------------

    def configure(self, *, service: Optional[str] = None,
                  enabled: Optional[bool] = None,
                  max_capture_ms: Optional[int] = None,
                  dump_dir: Optional[str] = None,
                  band_hi: Optional[float] = None,
                  band_lo: Optional[float] = None) -> "DeviceProfiler":
        """In-place reconfiguration — the module singleton is shared by
        reference (the engine captured it at __init__); identity must
        survive."""
        if service is not None:
            self.service = service
        if enabled is not None:
            self.enabled = enabled
        if max_capture_ms is not None:
            self.max_capture_ms = int(max_capture_ms)
        if dump_dir is not None:
            self.dump_dir = dump_dir
        if band_hi is not None:
            self.auditor.band_hi = band_hi
        if band_lo is not None:
            self.auditor.band_lo = band_lo
        return self

    def reset(self) -> None:
        """Drop all state (test isolation)."""
        self.registry.reset()
        self.auditor.reset()
        self.harvests = 0
        self.harvest_failures = 0
        self.captures = 0
        self.last_capture_dir = None

    # -- leg 1: modeled cost harvest (first-seen shapes only) --------------

    def harvest(self, tag: str, sig: Tuple, flops: float,
                bytes_accessed: float) -> bool:
        """Record the modeled cost of a program's first-seen shape, its
        roofline time beside it (:func:`roofline_s`).  Returns True when
        a record landed."""
        if not self.enabled:
            return False
        self.registry.record(
            program_label(tag, sig), flops=flops,
            bytes_accessed=bytes_accessed,
            optimal_s=roofline_s(flops, bytes_accessed))
        self.harvests += 1
        return True

    # -- leg 2: drift audit (scrape-time only) -----------------------------

    def audit_engine(self, core) -> Dict[str, float]:
        """Fold the engine's modeled counters against the registry's
        costs; returns the current ratios.  Scrape-time only — reads
        counters the engine thread increments, never blocks it.

        Series:
        - ``kv_decode`` — modeled KV bytes swept (kv_read_bytes_modeled)
          vs the registry's bytes summed over the decode dispatch
          classes (window × window_dispatches, decode1 mean ×
          single_step_dispatches, spec mean × spec_dispatches).
        - ``window_time`` — the registry's roofline seconds per window
          vs the window's measured seconds: the CUDA-event EWMA of the
          window's span on its stream on a card, else the decode cost
          EWMA times the tokens a window emits (the JAX rule).
        """
        if not self.enabled:
            return {}
        c = getattr(core, "counters", None)
        if c is None:
            return {}
        reg = self.registry
        measured = 0.0
        win_bytes = reg.mean_for_tags("bytes_accessed", "window")
        if win_bytes is not None:
            measured += win_bytes * c.window_dispatches
        d1_bytes = reg.mean_for_tags("bytes_accessed",
                                     "decode1", "decode1g")
        if d1_bytes is not None:
            measured += d1_bytes * c.single_step_dispatches
        spec_bytes = reg.mean_for_tags("bytes_accessed", "spec")
        if spec_bytes is not None:
            measured += spec_bytes * c.spec_dispatches
        if measured > 0:
            self.auditor.observe("kv_decode",
                                 float(c.kv_read_bytes_modeled), measured)
        opt_s = reg.mean_for_tags("optimal_s", "window")
        per_window = c.window_device_s_ewma
        if (per_window is None and c.decode_token_cost_ewma is not None
                and c.window_dispatches > 0 and c.decode_tokens_emitted):
            per_window = c.decode_token_cost_ewma * (
                c.decode_tokens_emitted / c.window_dispatches)
        if opt_s is not None and per_window is not None:
            self.auditor.observe("window_time", opt_s, per_window)
        return self.auditor.ratios()

    # -- leg 3: on-demand bounded device capture ---------------------------

    def capture_dir(self) -> str:
        import tempfile

        d = self.dump_dir or tempfile.gettempdir()
        return os.path.join(
            d, "deviceprofile_"
               f"{self.service.replace('/', '_')}_{os.getpid()}")

    def capture(self, ms: int) -> dict:
        """Bounded torch.profiler capture on the live process: profile
        the CPU (and, with a card, CUDA) activity for `ms` (clamped to
        max_capture_ms) while the serving threads keep dispatching, then
        write the Chrome trace and the sidecar.  Runs OFF the engine
        thread (status-server executor / control-plane watcher), so the
        CPU ops of the other threads are asked for
        (`profile_all_threads`, where this torch has it; kernels are
        recorded whatever thread launched them); serialized — the
        profiler's state is process-global."""
        ms = max(1, min(int(ms), self.max_capture_ms))
        if not self.enabled:
            return {"ok": False, "error": "device profiler disabled "
                                          "(--device-profiler off)"}
        if not self._capture_lock.acquire(blocking=False):
            return {"ok": False, "error": "capture already in progress"}
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            on_card = torch.cuda.is_available()
            activities = [ProfilerActivity.CPU]
            if on_card:
                activities.append(ProfilerActivity.CUDA)
            out_dir = self.capture_dir()
            os.makedirs(out_dir, exist_ok=True)
            try:
                config = torch.profiler._ExperimentalConfig(
                    profile_all_threads=True)
            except TypeError:   # an older torch: this thread's ops only
                config = None
            wall_start = time.time()
            with profile(activities=activities,
                         experimental_config=config) as prof:
                time.sleep(ms / 1000.0)
            wall_end = time.time()
            trace = os.path.join(
                out_dir, f"{int(wall_start * 1000)}.trace.json")
            prof.export_chrome_trace(trace)
            kernels = sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            # Sidecar: the trace's timestamps are the profiler's own; the
            # wall anchor lets a merge tool align device activity under
            # this process's host spans.
            with open(os.path.join(out_dir, "capture_meta.json"), "w") as f:
                json.dump({"service": self.service, "pid": os.getpid(),
                           "ms": ms, "wall_start": wall_start,
                           "wall_end": wall_end, "trace": trace,
                           "device_events": kernels}, f)
            files = sorted(os.path.relpath(p, out_dir) for p in _glob.glob(
                os.path.join(out_dir, "*.trace.json")))
            self.captures += 1
            self.last_capture_dir = out_dir
            logger.warning("device capture: %d ms → %s (%d device "
                           "event(s))", ms, trace, kernels)
            error = None
            if not os.path.exists(trace):
                error = "capture produced no trace output"
            elif on_card and not kernels:
                error = "capture recorded no device activity"
            return {"ok": error is None, "ms": ms, "dir": out_dir,
                    "files": files, "trace": trace,
                    "device_events": kernels, "pid": os.getpid(),
                    "service": self.service,
                    **({} if error is None else {"error": error})}
        except Exception as e:
            logger.warning("device capture failed: %s: %s",
                           type(e).__name__, e)
            return {"ok": False, "ms": ms,
                    "error": f"{type(e).__name__}: {e}"}
        finally:
            self._capture_lock.release()

    # -- surfaces ----------------------------------------------------------

    def metrics_lines(self) -> List[str]:
        """Prometheus text lines for worker /metrics (scrape-time)."""
        out = [
            "# HELP dynamo_program_registry_size step programs with a "
            "modeled cost (first-seen dispatch shapes)",
            "# TYPE dynamo_program_registry_size gauge",
            f"dynamo_program_registry_size {self.registry.size()}",
        ]
        items = self.registry.items()
        if items:
            out.append("# HELP dynamo_program_flops modeled flops per "
                       "program dispatch (model config and shape "
                       "signature)")
            out.append("# TYPE dynamo_program_flops gauge")
            for label, costs in items:
                out.append(f'dynamo_program_flops{{program="{label}"}} '
                           f'{costs["flops"]}')
            out.append("# HELP dynamo_program_bytes_accessed modeled "
                       "bytes moved per program dispatch (weights, KV "
                       "pages at the page bucket, activations)")
            out.append("# TYPE dynamo_program_bytes_accessed gauge")
            for label, costs in items:
                out.append(
                    f'dynamo_program_bytes_accessed{{program="{label}"}} '
                    f'{costs["bytes_accessed"]}')
        ratios = self.auditor.ratios()
        if ratios:
            out.append("# HELP dynamo_modeled_vs_measured_ratio modeled "
                       "accounting vs the modeled program cost (kv_decode)"
                       " or the measured window time (window_time) per "
                       "series (honest: <= band_hi)")
            out.append("# TYPE dynamo_modeled_vs_measured_ratio gauge")
            for series in sorted(ratios):
                out.append(
                    "dynamo_modeled_vs_measured_ratio"
                    f'{{series="{series}"}} {round(ratios[series], 6)}')
        return out

    def debug_payload(self) -> dict:
        """The `/debug/deviceprofile` GET (no ms param) / status body."""
        return {
            "service": self.service,
            "enabled": self.enabled,
            "pid": os.getpid(),
            "max_capture_ms": self.max_capture_ms,
            "registry_size": self.registry.size(),
            "programs": dict(self.registry.items()),
            "drift": self.auditor.states(),
            "harvests": self.harvests,
            "harvest_failures": self.harvest_failures,
            "captures": self.captures,
            "last_capture_dir": self.last_capture_dir,
        }


# ---------------------------------------------------------------------------
# Reading a capture

# Chrome-trace categories of device work (kernels, copies, fills) and of
# host work on the CPU lanes.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")


def summarize_trace(trace: dict, top: int = 10, gaps: int = 5) -> dict:
    """What a capture's Chrome trace says of the device: the busy share
    of the capture window (the union of device intervals over the
    profiler's own session span, else over the span of every recorded
    event), the `top` kernels by total time with their counts, and the
    `gaps` longest idle gaps between device intervals, each with the
    innermost host event that spans it where the trace has one (None
    else) and the first host event that starts inside it.  Also the
    events a category.  Times in microseconds, as the trace's."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    cats: Dict[str, int] = {}
    for e in events:
        cats[str(e.get("cat"))] = cats.get(str(e.get("cat")), 0) + 1
    if not events:
        return {"window_us": 0.0, "busy_us": 0.0, "busy_share": None,
                "kernels": [], "kernel_names": [], "gaps": [],
                "device_events": 0, "categories": cats}
    session = [e for e in events if e.get("cat") == "Trace"]
    if session:
        start = session[0]["ts"]
        end = start + session[0]["dur"]
    else:
        start = min(e["ts"] for e in events)
        end = max(e["ts"] + e["dur"] for e in events)
    device = sorted((max(e["ts"], start), min(e["ts"] + e["dur"], end))
                    for e in events if e.get("cat") in DEVICE_CATS
                    and e["ts"] < end and e["ts"] + e["dur"] > start)
    merged: List[List[float]] = []
    for a, b in device:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    by_name: Dict[str, List[float]] = {}
    for e in events:
        if e.get("cat") == "kernel":
            acc = by_name.setdefault(e["name"], [0, 0.0])
            acc[0] += 1
            acc[1] += e["dur"]
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    host = [e for e in events if e.get("cat") in HOST_CATS]
    idle = sorted(((b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])),
                  key=lambda g: g[0] - g[1])[:gaps]
    def brief(e):
        return None if e is None else {"name": e["name"], "cat": e.get("cat"),
                                       "tid": e.get("tid"),
                                       "dur_us": e["dur"]}

    out_gaps = []
    for g0, g1 in idle:
        spans = [e for e in host if e["ts"] <= g0 and e["ts"] + e["dur"] >= g1]
        inside = [e for e in host if g0 <= e["ts"] < g1]
        out_gaps.append({
            "gap_us": g1 - g0, "at_us": g0 - start,
            "host_event": brief(min(spans, key=lambda e: e["dur"])
                                if spans else None),
            "host_next": brief(min(inside, key=lambda e: e["ts"])
                               if inside else None)})
    return {"window_us": end - start, "busy_us": busy,
            "busy_share": busy / (end - start) if end > start else None,
            "kernels": [{"name": n, "count": c, "total_us": t}
                        for n, (c, t) in kernels[:top]],
            "kernel_names": sorted(by_name),
            "gaps": out_gaps, "device_events": len(device),
            "categories": cats}


# ---------------------------------------------------------------------------
# Process singleton (same pattern as flight_recorder.get_recorder)

_profiler = DeviceProfiler()


def get_profiler() -> DeviceProfiler:
    return _profiler


def configure(**kwargs) -> DeviceProfiler:
    return _profiler.configure(**kwargs)


def add_device_profiler_args(parser) -> None:
    """The shared --device-profiler CLI surface (worker)."""
    parser.add_argument("--device-profiler", choices=("on", "off"),
                        default="on",
                        help="device-truth plane: modeled program costs "
                             "on first-seen dispatch shapes "
                             "(dynamo_program_* metrics), the "
                             "modeled-vs-measured drift audit, and "
                             "on-demand bounded torch.profiler captures "
                             "(/debug/deviceprofile?ms=N, control-plane "
                             "profile/<pid>)")
    parser.add_argument("--device-profile-max-ms", type=int,
                        default=DEFAULT_MAX_CAPTURE_MS,
                        help="upper bound on one on-demand device "
                             "capture (requests above it are clamped)")
    parser.add_argument("--drift-band-hi", type=float,
                        default=DEFAULT_BAND_HI,
                        help="modeled/measured ratio above which the "
                             "drift auditor strikes (3 consecutive "
                             "out-of-band scrapes PAGE + dump the "
                             "flight recorder)")
    parser.add_argument("--drift-band-lo", type=float,
                        default=DEFAULT_BAND_LO,
                        help="modeled/measured ratio below which the "
                             "drift auditor strikes (default 0: "
                             "under-claiming is not an error — modeled "
                             "series are components of the totals)")


def configure_from_args(args, service: str) -> DeviceProfiler:
    """Apply the add_device_profiler_args flags (plus the shared
    --flight-dump-dir capture destination) to the process profiler."""
    return configure(
        service=service,
        enabled=getattr(args, "device_profiler", "on") != "off",
        max_capture_ms=getattr(args, "device_profile_max_ms",
                               DEFAULT_MAX_CAPTURE_MS),
        dump_dir=getattr(args, "flight_dump_dir", None),
        band_hi=getattr(args, "drift_band_hi", DEFAULT_BAND_HI),
        band_lo=getattr(args, "drift_band_lo", DEFAULT_BAND_LO))
