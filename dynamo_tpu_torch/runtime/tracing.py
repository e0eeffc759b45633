"""End-to-end distributed request tracing, Dapper-style, with a Perfetto
export (port of `dynamo_tpu/runtime/tracing.py`; the same wire form and
sampling rule, so a trace id samples alike in both packages).

One request crossing frontend → KV-router → RPC → worker → engine gets ONE
trace id; every hop records spans that parent correctly across process
boundaries, so `tools/trace_merge.py` can stitch the per-process buffers
into a single timeline loadable in Perfetto / chrome://tracing.  The
reference stack leans on per-hop metrics plus a grep-able request id
(`logging.rs:73-79`); this module upgrades that id into a real trace
context carried on the RPC frame (`runtime/rpc.py` `trace` field).

Design constraints, in order:

1. **Zero cost when disabled** (the default).  `start_span` returns a
   shared no-op span; hot paths guard on `tracer.enabled`; nothing here
   ever touches a device or blocks.
2. **Bounded memory.**  Completed traces live in a ring buffer
   (`ring_size` traces); in-flight spans are capped per trace
   (`max_spans_per_trace`) and across traces (`max_pending`).
3. **Production triage at low sampling.**  Sampling is decided once at
   the root (deterministic hash of the trace id, so retries of the same
   id sample identically) and propagated on the wire.  A local root that
   finishes slower than `slow_ms` is force-kept and logged as one
   structured JSONL line even when unsampled.

Span model: a span is identified by (trace_id, span_id) with an optional
parent_id.  "Local roots" — spans whose parent is remote (a wire-extracted
TraceContext) or absent — own trace finalization in their process: when
the last open local root of a trace ends, the trace's spans move from the
pending buffer to the ring (or are dropped if unsampled and fast).

Timestamps: wall-clock (`time.time()`) for cross-process alignment in the
merged view, monotonic deltas for durations.
"""

from __future__ import annotations

import contextvars
import json
import logging
import threading
import time
import uuid
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)
slow_logger = logging.getLogger("dynamo_tpu_torch.trace.slow")


def _gen_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """Propagatable identity of one span: inject with `to_wire`, extract
    with `from_wire`, derive a child span's context with `child`."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    sampled: bool = True

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _gen_id(), self.span_id,
                            self.sampled)

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": self.sampled}

    @staticmethod
    def from_wire(d) -> Optional["TraceContext"]:
        """None on anything malformed — a bad peer must never break the
        request path for the sake of telemetry."""
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not tid or not sid:
            return None
        return TraceContext(str(tid), str(sid), None,
                            bool(d.get("sampled", True)))


class Span:
    """An open span; `end()` (or `with`) records it on its tracer."""

    __slots__ = ("tracer", "name", "ctx", "attrs", "local_root",
                 "start_wall", "start_mono", "_ended", "_cv_token")

    def __init__(self, tracer: "Tracer", name: str, ctx: TraceContext,
                 local_root: bool, attrs: Optional[dict] = None) -> None:
        self.tracer = tracer
        self.name = name
        self.ctx = ctx
        self.attrs = dict(attrs) if attrs else {}
        self.local_root = local_root
        self.start_wall = time.time()
        self.start_mono = time.monotonic()
        self._ended = False
        self._cv_token = None

    def set_attr(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def duration_s(self) -> float:
        return time.monotonic() - self.start_mono

    def end(self, **attrs) -> None:
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        self.tracer._finish_span(self)

    def __enter__(self) -> "Span":
        # `with` makes the span task-current, so spans opened inside the
        # block (including rpc.client spans several calls down) nest
        # under it rather than under whatever was current outside.
        self._cv_token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._cv_token is not None:
            _current_span.reset(self._cv_token)
            self._cv_token = None
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()


class _NullSpan:
    """Shared no-op span: the disabled/unsampled fast path."""

    __slots__ = ()
    ctx = None
    local_root = False
    name = ""
    attrs: dict = {}

    def set_attr(self, **attrs) -> None:
        pass

    @property
    def duration_s(self) -> float:
        return 0.0

    def end(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()

# The task-local current span (set by the HTTP root and the RPC server
# span); asyncio.create_task snapshots it, so pump tasks spawned by a
# request handler inherit the request's context automatically.
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "dynamo_trace_span", default=None)


def current_span():
    """The task's active span (a Span), or None."""
    return _current_span.get()


def use_span(span):
    """Make `span` the task-local current span; returns a token for
    `restore`."""
    return _current_span.set(span if span is not NULL_SPAN else None)


def restore(token) -> None:
    _current_span.reset(token)


def _sample_decision(trace_id: str, rate: float) -> bool:
    """Deterministic per-trace sampling: the same trace id samples the
    same way in every process and across retries."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = zlib.crc32(trace_id.encode("utf-8", "replace")) & 0xFFFFFFFF
    return (h / 2**32) < rate


class Tracer:
    """Process-local span collector: bounded pending buffer for in-flight
    traces, ring buffer of completed traces, per-request-id context
    binding for the engine thread."""

    def __init__(self, service: str = "dynamo", *, enabled: bool = False,
                 sampling: float = 1.0, ring_size: int = 256,
                 slow_ms: Optional[float] = None,
                 slow_log_path: Optional[str] = None,
                 max_spans_per_trace: int = 256,
                 max_pending: int = 1024) -> None:
        self.service = service
        self.enabled = enabled
        self.sampling = sampling
        self.slow_ms = slow_ms
        self.slow_log_path = slow_log_path
        self.max_spans_per_trace = max_spans_per_trace
        self.max_pending = max_pending
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring_size)
        self._pending: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._open_roots: Dict[str, int] = {}       # trace_id → open count
        self._dropped: Dict[str, int] = {}          # trace_id → span drops
        self._finalized: deque = deque(maxlen=512)  # recent trace ids
        self._finalized_set: set = set()
        # Open (sampled) spans per trace: spans still running when their
        # trace finalizes are materialized with partial duration and an
        # `unfinished` attr — an abandoned streaming generator's span
        # (whose `finally` only runs at async-gen GC) must not vanish
        # from the timeline.
        self._open: "OrderedDict[str, Dict[str, Span]]" = OrderedDict()
        self._bindings: "OrderedDict[str, TraceContext]" = OrderedDict()
        # Telemetry about the telemetry (tests + overhead accounting).
        self.spans_recorded = 0
        self.traces_dropped_unsampled = 0
        self.traces_forced_slow = 0

    # -- configuration -----------------------------------------------------

    def configure(self, *, service: Optional[str] = None,
                  enabled: Optional[bool] = None,
                  sampling: Optional[float] = None,
                  ring_size: Optional[int] = None,
                  slow_ms: Optional[float] = None,
                  slow_log_path: Optional[str] = None) -> "Tracer":
        """In-place reconfiguration (the module singleton is shared by
        reference; identity must survive)."""
        with self._lock:
            if service is not None:
                self.service = service
            if enabled is not None:
                self.enabled = enabled
            if sampling is not None:
                self.sampling = sampling
            if ring_size is not None:
                self._ring = deque(self._ring, maxlen=ring_size)
            if slow_ms is not None:
                self.slow_ms = slow_ms
            if slow_log_path is not None:
                self.slow_log_path = slow_log_path
        return self

    def reset(self) -> None:
        """Drop all state (test isolation)."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self._open_roots.clear()
            self._dropped.clear()
            self._finalized.clear()
            self._finalized_set.clear()
            self._open.clear()
            self._bindings.clear()
            self.spans_recorded = 0
            self.traces_dropped_unsampled = 0
            self.traces_forced_slow = 0

    # -- span creation -----------------------------------------------------

    def start_span(self, name: str, parent=None, *,
                   trace_id: Optional[str] = None,
                   attrs: Optional[dict] = None):
        """Open a span.

        `parent`: a Span (same-process child), a TraceContext (remote
        parent — this span becomes a local root), or None (parent from
        the task-local current span; if none, a NEW trace starts here,
        with `trace_id` reused if given — e.g. the request id).
        Returns NULL_SPAN when tracing is disabled or the trace is
        unsampled (local roots of unsampled traces stay real so the
        slow-request force-sample can fire)."""
        if not self.enabled:
            return NULL_SPAN
        if parent is None:
            parent = current_span()
        if isinstance(parent, _NullSpan):
            parent = None
        local_root = not isinstance(parent, Span)
        if parent is None:
            tid = trace_id or _gen_id()
            ctx = TraceContext(tid, _gen_id(), None,
                               _sample_decision(tid, self.sampling))
        else:
            pctx = parent.ctx if isinstance(parent, Span) else parent
            if pctx is None:
                return NULL_SPAN
            ctx = pctx.child()
        if not ctx.sampled and not local_root:
            return NULL_SPAN  # sub-spans of unsampled traces cost nothing
        span = Span(self, name, ctx, local_root, attrs)
        with self._lock:
            if local_root:
                self._open_roots[ctx.trace_id] = \
                    self._open_roots.get(ctx.trace_id, 0) + 1
            if ctx.sampled:
                per_trace = self._open.get(ctx.trace_id)
                if per_trace is None:
                    while len(self._open) >= self.max_pending:
                        self._open.popitem(last=False)
                    per_trace = self._open[ctx.trace_id] = {}
                per_trace[ctx.span_id] = span
        return span

    def record_span(self, name: str, parent, start_mono: float,
                    end_mono: Optional[float] = None,
                    attrs: Optional[dict] = None) -> None:
        """Record an already-measured span from monotonic timestamps (the
        engine thread's admission→first-token spans: the interval was
        measured before anyone knew it would be traced)."""
        if not self.enabled or parent is None:
            return
        pctx = parent.ctx if isinstance(parent, Span) else parent
        if pctx is None or not pctx.sampled:
            return
        ctx = pctx.child()
        now_mono = time.monotonic()
        end_mono = now_mono if end_mono is None else end_mono
        wall_start = time.time() - (now_mono - start_mono)
        self._record(ctx, name, wall_start, max(0.0, end_mono - start_mono),
                     dict(attrs) if attrs else {})

    # -- request-id binding (engine thread) --------------------------------

    def bind(self, request_id: str, ctx: Optional[TraceContext]) -> None:
        """Associate a request id with its serving span's context so
        engine-side spans (emitted on the engine thread, which has no
        contextvars from the serving task) parent correctly."""
        if not self.enabled or ctx is None:
            return
        with self._lock:
            self._bindings[request_id] = ctx
            self._bindings.move_to_end(request_id)
            while len(self._bindings) > self.max_pending:
                self._bindings.popitem(last=False)

    def unbind(self, request_id: str) -> None:
        with self._lock:
            self._bindings.pop(request_id, None)

    def ctx_for(self, request_id: str) -> Optional[TraceContext]:
        with self._lock:
            return self._bindings.get(request_id)

    # -- recording / finalization ------------------------------------------

    def _span_dict(self, ctx: TraceContext, name: str, wall_start: float,
                   dur_s: float, attrs: dict) -> dict:
        return {"name": name, "trace_id": ctx.trace_id,
                "span_id": ctx.span_id, "parent_id": ctx.parent_id,
                "service": self.service, "ts": wall_start, "dur": dur_s,
                "attrs": attrs}

    def _record(self, ctx: TraceContext, name: str, wall_start: float,
                dur_s: float, attrs: dict) -> None:
        d = self._span_dict(ctx, name, wall_start, dur_s, attrs)
        with self._lock:
            if ctx.trace_id in self._finalized_set:
                return  # late engine span after the trace shipped
            spans = self._pending.get(ctx.trace_id)
            if spans is None:
                if len(self._pending) >= self.max_pending:
                    # Evict the oldest in-flight trace wholesale: a leak
                    # here (crashed peers, abandoned streams) must never
                    # grow without bound.
                    self._pending.popitem(last=False)
                spans = self._pending[ctx.trace_id] = []
            if len(spans) >= self.max_spans_per_trace:
                self._dropped[ctx.trace_id] = \
                    self._dropped.get(ctx.trace_id, 0) + 1
                return
            spans.append(d)
            self.spans_recorded += 1

    def _finish_span(self, span: Span) -> None:
        dur = time.monotonic() - span.start_mono
        with self._lock:
            per_trace = self._open.get(span.ctx.trace_id)
            if per_trace is not None:
                per_trace.pop(span.ctx.span_id, None)
        slow = (self.slow_ms is not None
                and dur * 1000.0 > self.slow_ms)
        if span.ctx.sampled or (span.local_root and slow):
            if slow:
                span.attrs.setdefault("forced_slow_sample", True)
            self._record(span.ctx, span.name, span.start_wall, dur,
                         span.attrs)
        if not span.local_root:
            return
        tid = span.ctx.trace_id
        finalize = False
        with self._lock:
            n = self._open_roots.get(tid, 1) - 1
            if n <= 0:
                self._open_roots.pop(tid, None)
                finalize = True
            else:
                self._open_roots[tid] = n
        if finalize:
            self._finalize(tid, keep=span.ctx.sampled or slow, slow=slow,
                           root_span=span, dur_s=dur)

    def _finalize(self, trace_id: str, keep: bool, slow: bool,
                  root_span: Optional[Span] = None,
                  dur_s: float = 0.0) -> None:
        now_mono = time.monotonic()
        with self._lock:
            spans = self._pending.pop(trace_id, [])
            dropped = self._dropped.pop(trace_id, 0)
            # Still-open spans (abandoned streaming generators): ship
            # them with the duration they reached; their eventual end()
            # is a no-op against the finalized trace.
            for sp in (self._open.pop(trace_id, None) or {}).values():
                if keep and len(spans) < self.max_spans_per_trace:
                    attrs = dict(sp.attrs)
                    attrs["unfinished"] = True
                    spans.append(self._span_dict(
                        sp.ctx, sp.name, sp.start_wall,
                        max(0.0, now_mono - sp.start_mono), attrs))
                    self.spans_recorded += 1
            if len(self._finalized) == self._finalized.maxlen:
                # The deque is about to evict its oldest id; keep the
                # membership set in lockstep.
                self._finalized_set.discard(self._finalized[0])
            self._finalized.append(trace_id)
            self._finalized_set.add(trace_id)
            if not keep or not spans:
                if not keep:
                    self.traces_dropped_unsampled += 1
                spans = None
            else:
                trace = {"trace_id": trace_id, "service": self.service,
                         "spans": spans}
                if dropped:
                    trace["spans_dropped"] = dropped
                if slow:
                    trace["forced_slow_sample"] = True
                    self.traces_forced_slow += 1
                self._ring.append(trace)
        if slow and root_span is not None:
            self._log_slow(trace_id, root_span, dur_s)

    def _log_slow(self, trace_id: str, root_span: Span,
                  dur_s: float) -> None:
        """One structured JSONL line per slow request — the low-sampling
        triage hook (grep the trace_id, then pull /debug/traces)."""
        line = json.dumps({
            "event": "slow_request", "service": self.service,
            "trace_id": trace_id, "span": root_span.name,
            "duration_ms": round(dur_s * 1000.0, 3),
            "slow_ms": self.slow_ms, "ts": time.time(),
            "attrs": root_span.attrs,
        }, default=str)
        if self.slow_log_path:
            try:
                with open(self.slow_log_path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                logger.exception("slow-trace JSONL write failed")
        slow_logger.warning("%s", line)
        # Slow-request force-sample is also a flight-recorder trigger:
        # the ring at the moment of the slow request is the
        # "what was the engine doing" half the trace alone can't show.
        # Per-reason throttled dump — sustained overload produces many
        # slow requests but the ring only needs snapshotting so often.
        from dynamo_tpu_torch.runtime import flight_recorder

        rec = flight_recorder.get_recorder()
        if rec.enabled:
            rec.record("slow_request", trace_id=trace_id,
                       span=root_span.name,
                       duration_ms=round(dur_s * 1000.0, 3))
            # Async: _finish_span runs on whatever thread ended the
            # root span — often the serving event loop.
            rec.dump_async("slow_request")

    # -- export ------------------------------------------------------------

    def completed(self, n: Optional[int] = None) -> List[dict]:
        """Most recent completed traces, newest first."""
        with self._lock:
            traces = list(self._ring)
        traces.reverse()
        return traces if n is None else traces[:max(0, n)]


def chrome_trace(traces: List[dict]) -> dict:
    """Chrome trace-event JSON (the `traceEvents` array format Perfetto
    and chrome://tracing load): one complete ("ph":"X") event per span,
    one process per originating service, one thread lane per trace.

    Accepts the trace dicts `Tracer.completed` / `/debug/traces` return —
    possibly from several processes; spans duplicated across payloads
    (shared in-process tracers) dedupe by (trace_id, span_id)."""
    pids: Dict[str, int] = {}
    tids: Dict[str, int] = {}
    events: List[dict] = []
    seen: set = set()
    for trace in traces:
        for span in trace.get("spans", []):
            key = (span["trace_id"], span["span_id"])
            if key in seen:
                continue
            seen.add(key)
            service = span.get("service", "dynamo")
            pid = pids.setdefault(service, len(pids) + 1)
            tid = tids.setdefault(span["trace_id"], len(tids) + 1)
            args = dict(span.get("attrs", {}))
            args.update(trace_id=span["trace_id"],
                        span_id=span["span_id"],
                        parent_id=span.get("parent_id"))
            events.append({
                "name": span["name"], "cat": "dynamo", "ph": "X",
                "ts": round(span["ts"] * 1e6, 3),
                "dur": round(span["dur"] * 1e6, 3),
                "pid": pid, "tid": tid, "args": args,
            })
    for service, pid in pids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": service}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def debug_traces_payload(n: int, tracer: Optional[Tracer] = None) -> dict:
    """The `/debug/traces` response body — ONE shape for every process
    (frontend HttpService, worker StatusServer), so
    tools/trace_merge.py treats all sources uniformly."""
    t = tracer or get_tracer()
    return {"service": t.service, "enabled": t.enabled,
            "traces": t.completed(n)}


# ---------------------------------------------------------------------------
# Process singleton

_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def configure(**kwargs) -> Tracer:
    """Configure the process tracer (see Tracer.configure)."""
    return _tracer.configure(**kwargs)


def add_trace_args(parser) -> None:
    """The shared --trace* CLI surface (frontend, worker)."""
    parser.add_argument("--trace", action="store_true",
                        help="enable distributed request tracing "
                             "(spans in a bounded ring, /debug/traces)")
    parser.add_argument("--trace-sample", type=float, default=1.0,
                        help="trace sampling rate in [0,1] (per trace id, "
                             "deterministic across processes)")
    parser.add_argument("--trace-slow-ms", type=float, default=None,
                        help="force-sample + JSONL-log any request slower "
                             "than this many ms, regardless of sampling")
    parser.add_argument("--trace-ring", type=int, default=256,
                        help="completed traces kept per process")
    parser.add_argument("--trace-slow-log", default=None,
                        help="append slow-request JSONL lines to this file "
                             "(default: python logging only)")


def configure_from_args(args, service: str) -> Tracer:
    """Apply the add_trace_args flags to the process tracer."""
    return configure(
        service=service, enabled=bool(getattr(args, "trace", False)),
        sampling=getattr(args, "trace_sample", 1.0),
        ring_size=getattr(args, "trace_ring", 256),
        slow_ms=getattr(args, "trace_slow_ms", None),
        slow_log_path=getattr(args, "trace_slow_log", None))
