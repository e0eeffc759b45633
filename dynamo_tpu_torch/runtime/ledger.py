"""Per-request latency ledger + fleet goodput attribution (port of
`dynamo_tpu/runtime/ledger.py`; the same wire form both ways).

Disaggregated serving assembles ONE request's latency out of many
processes — frontend, router, prefill slice, KV transfer plane, decode
slice — and the process-centric planes (traces, gauges, flight recorder)
answer "is this process healthy", never "which hop ate THIS request's
TTFT".  The ledger is the request-centric complement: a compact,
wire-carried list of `(phase, t_mono_delta, dur, scalar_attrs)` stamps
accumulated as the request crosses the fleet, merged back at the
frontend when the stream finishes.

Topology
--------
- The frontend `begin()`s a live `RequestLedger` on the preprocessed
  request (a plain attribute — never serialized as-is) and marks the
  request's `annotations[LEDGER_ANNOTATION]` so remote hops opt in.
- Every component on the path stamps phases onto `ledger_of(request)`:
  receive/tokenize (frontend), route (+donor hint), queue/prefill/
  first_token (engine timings, recorded at first-token time), kv_transfer
  rounds (plane device|host, blocks, tokens), remote-prefill waits,
  migration stalls, drain handoffs, and a per-token decode interval
  summary.
- A worker hop builds its OWN ledger (`begin_hop`, its own monotonic
  anchor) and returns it on the final — or migrate — `TokenDelta` via
  the delta codec's optional `ledger` key; the frontend-side wire
  clients `absorb_delta()` it into the live ledger.  Old peers ignore
  the key; garbage is tolerated (see below).
- The hop stamps its own intake (`receive`: the request's frame decoded
  to the engine's submission), and the wire client that delivered the
  request's first token stamps `rpc`: its round trip from sending the
  request to receiving that token, less the hop's time from its anchor
  to emitting it (the hop's `first_token` end).  That is the wire both
  ways; each side's span is on its own clock, so an offset between
  hosts cancels.  JAX stamps neither, and leaves that time dark.
- The frontend folds completed ledgers into `LedgerSink`:
  `dynamo_request_phase_seconds{phase=}` histograms, the goodput counter
  pair (SLO-good vs total tokens), a slowest-N ring behind
  `/debug/requests?n=K`, and a recent-window dominant-phase attribution
  consumed by `SloMonitor` PAGEs.

Overhead contract (flight-recorder discipline)
----------------------------------------------
Stamp sites are scalar-cheap behind the module `enabled()` guard: one
monotonic read + one tuple append, no containers built in hot paths,
zero added host syncs — steady-decode `EngineStepCounters` deltas are
byte-identical ledger-on vs ledger-off (pinned by tests).

Tolerance contract
------------------
A bad peer must never break the request path for the sake of telemetry
(same rule as `TraceContext.from_wire`): any truncated/garbage ledger
payload at any hop is dropped with a rate-limited warn
(`runtime.logutil.warn_rate_limited`) and the request proceeds
ledger-less.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime.logutil import warn_rate_limited

logger = logging.getLogger(__name__)

LEDGER_VERSION = 1
# Annotation key marking "this request wants a ledger" on the request
# leg of the wire (annotations are Dict[str, str]; any truthy value
# opts the hop in — tolerant by construction).
LEDGER_ANNOTATION = "x-dynamo-ledger"
# Per-hop stamp bound: a runaway stamper degrades to a drop counter,
# never an unbounded wire payload.
MAX_STAMPS = 64
# Attr values must be scalars on the wire; anything else is dropped at
# decode (never the request).
_SCALAR_TYPES = (str, int, float, bool)

_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def add_ledger_args(p) -> None:
    p.add_argument(
        "--request-ledger", choices=("on", "off"), default="on",
        help="per-request latency ledger: wire-carried phase "
             "stamps folded into dynamo_request_phase_seconds{phase=}, "
             "the goodput counter pair, /debug/requests?n=K and SLO burn "
             "attribution.  Scalar-cheap stamps; steady-decode engine "
             "counters are byte-identical on vs off")


def configure_from_args(args) -> None:
    set_enabled(getattr(args, "request_ledger", "on") != "off")


# ---------------------------------------------------------------------------
# The ledger itself


class RequestLedger:
    """Phase stamps for one request on one hop (or the frontend's merged
    view).  Stamps are `(phase, t_rel, dur, attrs)` where `t_rel` is the
    monotonic offset of the stamp (phase END) from this ledger's anchor.
    NOT thread-safe by design: each hop's ledger is owned by that hop's
    event loop; the engine thread never touches one (engine timings are
    popped onto the loop by LocalEngineClient)."""

    __slots__ = ("request_id", "anchor", "stamps", "dropped")

    def __init__(self, request_id: str,
                 anchor: Optional[float] = None) -> None:
        self.request_id = request_id
        self.anchor = time.monotonic() if anchor is None else anchor
        self.stamps: List[Tuple[str, float, float, Optional[dict]]] = []
        self.dropped = 0

    def stamp(self, phase: str, dur: float = 0.0,
              t: Optional[float] = None, **attrs) -> None:
        """Record one phase: `dur` seconds ending at `t` (now when
        omitted).  Scalar-cheap: one monotonic read + one append; attrs
        must be scalars."""
        if len(self.stamps) >= MAX_STAMPS:
            self.dropped += 1
            return
        now = time.monotonic() if t is None else t
        self.stamps.append((phase, now - self.anchor, float(dur),
                            attrs or None))

    # -- aggregation -------------------------------------------------------

    def phase_totals(self) -> Dict[str, float]:
        """Summed duration per phase (merged hops included)."""
        totals: Dict[str, float] = {}
        for phase, _t, dur, _a in self.stamps:
            totals[phase] = totals.get(phase, 0.0) + dur
        return totals

    # -- wire --------------------------------------------------------------

    def to_wire(self) -> dict:
        """Compact wire form: rides the delta codec's optional `ledger`
        key (worker → frontend) — old peers never read it."""
        return {
            "v": LEDGER_VERSION,
            "rid": self.request_id,
            "anchor": self.anchor,
            "stamps": [[p, round(t, 6), round(d, 6), a]
                       for p, t, d, a in self.stamps],
            "dropped": self.dropped,
        }

    def merge_wire(self, obj, where: str = "wire") -> bool:
        """Fold a peer hop's wire ledger into this one, re-basing stamp
        times onto this ledger's anchor (same-host monotonic clocks
        line up exactly; cross-host offsets only skew rendering, never
        the durations the fold consumes).  Malformed payloads are
        dropped with a rate-limited warn; returns False then."""
        decoded = decode_wire(obj, where=where)
        if decoded is None:
            return False
        peer_anchor, stamps, dropped = decoded
        shift = peer_anchor - self.anchor
        for phase, t, dur, attrs in stamps:
            if len(self.stamps) >= MAX_STAMPS:
                self.dropped += 1
                continue
            self.stamps.append((phase, t + shift, dur, attrs))
        self.dropped += dropped
        return True

    def to_payload(self) -> dict:
        """JSON payload form (`/debug/requests`, trace_merge --ledger):
        absolute monotonic times so spans time-align with the tracer's."""
        return {
            "request_id": self.request_id,
            "anchor": self.anchor,
            "stamps": [
                {"phase": p, "t": self.anchor + t, "dur": d,
                 "attrs": a or {}}
                for p, t, d, a in self.stamps],
            "phase_totals": {k: round(v, 6)
                             for k, v in self.phase_totals().items()},
            "dropped": self.dropped,
        }


def decode_wire(obj, where: str = "wire"):
    """Tolerant wire decode → (anchor, stamps, dropped) or None.

    EVERY structural failure — wrong container, non-scalar attrs,
    unparsable numbers, absurd sizes — drops the ledger with ONE
    rate-limited warn per site and never raises: telemetry must never
    fail a request."""
    try:
        if not isinstance(obj, dict):
            raise TypeError(f"ledger payload is {type(obj).__name__}")
        raw = obj.get("stamps")
        if not isinstance(raw, (list, tuple)):
            raise TypeError("stamps is not a list")
        anchor = float(obj.get("anchor", 0.0))
        stamps = []
        for row in raw[:MAX_STAMPS]:
            phase, t, dur = row[0], float(row[1]), float(row[2])
            if not isinstance(phase, str):
                raise TypeError("phase is not a string")
            attrs = row[3] if len(row) > 3 else None
            if attrs is not None:
                if not isinstance(attrs, dict):
                    raise TypeError("attrs is not a dict")
                attrs = {str(k): v for k, v in attrs.items()
                         if isinstance(v, _SCALAR_TYPES)} or None
            stamps.append((phase, t, dur, attrs))
        dropped = int(obj.get("dropped", 0)) \
            + max(0, len(raw) - MAX_STAMPS)
        return anchor, stamps, dropped
    except Exception as e:
        warn_rate_limited(
            logger, f"ledger_decode:{where}", 10.0,
            "dropping malformed request ledger at %s (%s) — request "
            "unaffected", where, e)
        return None


# ---------------------------------------------------------------------------
# Request attachment helpers (the seam every stamp site goes through)


def ledger_of(request) -> Optional[RequestLedger]:
    """The live ledger riding `request` (None when disabled/absent) —
    the getattr every stamp site uses so requests from old peers or
    ledger-off frontends cost one attribute read."""
    return getattr(request, "ledger", None)


def begin(request) -> Optional[RequestLedger]:
    """Frontend entry: attach a live ledger to the preprocessed request
    and mark the wire annotation so remote hops stamp too."""
    if not _enabled:
        return None
    led = RequestLedger(request.request_id)
    request.ledger = led
    try:
        request.annotations[LEDGER_ANNOTATION] = f"v{LEDGER_VERSION}"
    except (AttributeError, TypeError):
        # Annotations missing/frozen on odd request types: local stamps
        # still work, remote hops just don't opt in.
        pass
    return led


def begin_hop(request) -> Optional[RequestLedger]:
    """Worker-side entry (engine_wire_handler): a fresh per-hop ledger,
    created only when this hop has the plane enabled AND the request
    opted in via the annotation marker."""
    if not _enabled:
        return None
    ann = getattr(request, "annotations", None) or {}
    if not ann.get(LEDGER_ANNOTATION):
        return None
    led = RequestLedger(request.request_id)
    request.ledger = led
    return led


def absorb_delta(request, delta, where: str = "wire",
                 sent: Optional[float] = None,
                 first: Optional[float] = None) -> None:
    """Merge a wire delta's returned hop ledger (final or migrate delta)
    into the request's live ledger; consumed ledgers are cleared so
    upper layers never double-merge.  No-ops cheaply when either side
    is absent.  `sent` / `first`: the wire client's monotonic times of
    sending the request and of receiving this stream's first token;
    given both, the hop's `rpc` is stamped (once a request)."""
    wire = getattr(delta, "ledger", None)
    if wire is None:
        return
    led = ledger_of(request)
    if (led is not None and led.merge_wire(wire, where=where)
            and sent is not None and first is not None):
        _stamp_rpc(led, wire["stamps"], sent, first)
    delta.ledger = None


def _stamp_rpc(led: RequestLedger, hop_stamps, sent: float,
               first: float) -> None:
    """`rpc`: the round trip `first - sent` less the hop's own time to
    its first token (its `first_token` stamp's end, relative to the
    hop's anchor).  A request has one: a resumed stream's hop (after a
    migration) delivered no first token of the request."""
    if any(p == "rpc" for p, _t, _d, _a in led.stamps):
        return
    served = next((float(row[1]) for row in hop_stamps[:MAX_STAMPS]
                   if row[0] == "first_token"), None)
    if served is not None:
        led.stamp("rpc", dur=max(0.0, first - sent - float(served)), t=first)


# ---------------------------------------------------------------------------
# Coverage (honesty checks on a ledger against a measured TTFT)

COVERAGE_FLOOR = 0.9     # assembled phases must explain >= 90% of TTFT
COVERAGE_CEIL = 1.10     # claiming more time than wall-clock = fabricated

# Phases on the TTFT critical path (everything stamped before the first
# token); the decode interval summary and terminal bookkeeping phases
# land after TTFT and must not count toward its coverage.
TTFT_PHASES = ("receive", "route", "queue", "prefill", "first_token",
               "kv_transfer", "prefill_remote", "migration", "rpc")


def ttft_coverage(led: "RequestLedger", ttft_s: float) -> float:
    """Fraction of a measured TTFT the ledger's TTFT-path phase
    durations account for (0.0 on a degenerate TTFT)."""
    if ttft_s <= 0:
        return 0.0
    covered = sum(d for p, _t, d, _a in led.stamps if p in TTFT_PHASES)
    return covered / ttft_s


def coverage_ok(led: "RequestLedger", ttft_s: float,
                floor: float = COVERAGE_FLOOR,
                ceil: float = COVERAGE_CEIL) -> bool:
    """True iff the ledger honestly explains the measured TTFT: no dark
    time (>= floor) and no fabricated over-claim (<= ceil — a ledger
    claiming more time than the wall-clock envelope FAILS)."""
    ratio = ttft_coverage(led, ttft_s)
    return floor <= ratio <= ceil


# ---------------------------------------------------------------------------
# Frontend fold


class LedgerSink:
    """Where completed ledgers land on the frontend.

    Folds each finished request into (a) per-phase latency histograms
    `dynamo_request_phase_seconds{phase=}` — fleet-wide merge semantics:
    `sum(_sum)/sum(_count)` per phase across instances; (b)
    the goodput counter pair `dynamo_goodput_good_tokens_total` /
    `dynamo_goodput_tokens_total` (good = the request met its TTFT/TPOT
    SLO thresholds and finished ok); (c) a slowest-N ring served by
    `/debug/requests?n=K`; (d) a recent-window per-phase duration
    aggregate answering `dominant_phase()` for SLO burn attribution.
    Thread-safe (HTTP handlers + SLO tick
    thread)."""

    def __init__(self, registry, slo_ttft: Optional[float] = None,
                 slo_tpot: Optional[float] = None, keep_slowest: int = 64,
                 window_s: float = 300.0) -> None:
        self.phase_seconds = registry.histogram(
            "request_phase_seconds",
            "Per-request ledger phase durations (label phase=; "
            "fleet merge: sum sums and counts across instances)")
        self.goodput_good = registry.counter(
            "goodput_good_tokens_total",
            "Output tokens of requests that met their TTFT/TPOT SLO "
            "thresholds and finished ok (sum across instances)")
        self.goodput_total = registry.counter(
            "goodput_tokens_total",
            "Output tokens of all finished requests "
            "(sum across instances)")
        self.slo_ttft = slo_ttft
        self.slo_tpot = slo_tpot
        self.keep_slowest = keep_slowest
        self.window_s = window_s
        self.folded = 0
        self.decode_failures = 0
        self._slowest: List[dict] = []          # desc by total_s
        self._window = deque()                  # (wall_ts, {phase: dur})
        self._lock = threading.Lock()

    def fold(self, led: Optional[RequestLedger], ttft: Optional[float],
             tpot: Optional[float], output_tokens: int,
             ok: bool = True) -> None:
        if led is None:
            return
        totals = led.phase_totals()
        for phase, dur in totals.items():
            self.phase_seconds.observe(dur, labels={"phase": phase})
        good = ok
        if good and self.slo_ttft is not None and ttft is not None \
                and ttft > self.slo_ttft:
            good = False
        if good and self.slo_tpot is not None and tpot is not None \
                and tpot > self.slo_tpot:
            good = False
        if output_tokens > 0:
            self.goodput_total.inc(output_tokens)
            if good:
                self.goodput_good.inc(output_tokens)
        entry = led.to_payload()
        entry["ttft_s"] = ttft
        entry["tpot_s"] = tpot
        entry["output_tokens"] = output_tokens
        entry["ok"] = bool(ok)
        entry["slo_good"] = bool(good)
        entry["total_s"] = round(sum(totals.values()), 6)
        now = time.monotonic()
        with self._lock:
            self.folded += 1
            self._slowest.append(entry)
            self._slowest.sort(key=lambda e: e["total_s"], reverse=True)
            del self._slowest[self.keep_slowest:]
            self._window.append((now, totals))
            self._prune(now)

    def _prune(self, now: float) -> None:
        # Callers hold self._lock (fold / dominant_phase).
        cutoff = now - self.window_s
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()

    def dominant_phase(
            self, exclude: Tuple[str, ...] = ("decode",)
    ) -> Optional[str]:
        """The phase with the largest summed duration over the recent
        window — the burn-attribution answer.  The steady `decode`
        interval summary is excluded by default: long generations make
        it dominate by construction, while stalls on the decode path
        surface as their own phases (migration, kv_transfer)."""
        sums: Dict[str, float] = {}
        with self._lock:
            self._prune(time.monotonic())
            for _ts, totals in self._window:
                for phase, dur in totals.items():
                    if phase in exclude:
                        continue
                    sums[phase] = sums.get(phase, 0.0) + dur
        if not sums:
            return None
        return max(sums.items(), key=lambda kv: kv[1])[0]

    def goodput_ratio(self) -> Optional[float]:
        total = self.goodput_total.value()
        if total <= 0:
            return None
        return self.goodput_good.value() / total

    def debug_payload(self, n: int = 10) -> dict:
        """`/debug/requests?n=K`: the K slowest completed ledgers with
        full stamp detail, plus the window attribution summary."""
        with self._lock:
            slowest = [dict(e) for e in self._slowest[:max(0, n)]]
        return {
            "slowest": slowest,
            "folded": self.folded,
            "dominant_phase": self.dominant_phase(),
            "goodput": self.goodput_ratio(),
            "window_s": self.window_s,
            "ledger_enabled": enabled(),
        }
