"""Per-process flight recorder + engine-thread stall watchdog (port of
`dynamo_tpu/runtime/flight_recorder.py`).

The postmortem plane: traces and gauges describe the HEALTHY steady
state and evaporate exactly when a process wedges or dies — a scrape of
a hung worker times out, a crashed one takes its span ring with it.
This module is the black box that survives those moments:

- **FlightRecorder** — a fixed-size ring of structured host-side events
  (per-step counter breadcrumbs, dispatch shapes, preemptions, first
  dispatches of a shape, HBM samples, SLO state transitions).  Recording
  is lock-light (one atomic `itertools.count` next + one list-slot store
  under the GIL) and allocation-thin: hot paths pass PRE-COMPUTED
  scalars only, so the formatting cost is paid at dump time, never per
  step.
- **Dump triggers** — the ring serializes to JSONL when something goes
  wrong: SLO PAGE transition (runtime/slo.py), slow-request
  force-sample (runtime/tracing.py), `SIGUSR2` (operator-initiated live
  snapshot), atexit (+ `faulthandler` armed for hard crashes, whose C
  traceback lands in the same dump file), and the stall watchdog below.
  Dumps are rate-limited per reason so a flapping trigger cannot grind
  the disk.
- **StallWatchdog** — the step loop stamps a heartbeat
  (`FlightRecorder.beat`, one `time.monotonic` store) every iteration;
  a daemon thread checks it against pending work.  No progress for
  `stall_s` seconds while `pending_fn()` reports queued prefill or
  in-flight decode ⇒ one stall event, `stalls` increments (surfaced as
  `dynamo_engine_stalls_total`), and an automatic dump.  Re-arms when
  the heartbeat resumes, so one wedge produces one dump, not a storm.

Compiles in this package: the first launch of a CUDA kernel library
runs nvcc (tens of seconds on a cold build directory) and the first
dispatch of a shape pays the allocator's and cuBLAS's first use.  The
engine stamps `note_compile` for both (on every first-seen dispatch
shape), so the watchdog's compile grace covers them.

Surfaces: `/debug/flightrecorder?n=K` on every StatusServer and the
frontend HttpService (`debug_payload`), and the
`dynamo_engine_last_step_age_seconds` / `dynamo_engine_stalls_total`
series on the worker's `/metrics`.

Stdlib-only by design: every subsystem (engine, scheduler, slo,
metrics, tracing, block managers) may import this module without cycles.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

# Event payloads must stay scalar-cheap at hot record sites;
# anything structured belongs in the dump header, computed once.
DEFAULT_RING = 4096
# Per-reason dump throttle: a trigger that keeps firing (slow requests
# under sustained overload, SLO flapping at the PAGE threshold) re-dumps
# at most this often; the ring still holds the latest events when the
# next dump lands.
DEFAULT_DUMP_INTERVAL_S = 30.0


class FlightRecorder:
    """Bounded in-memory ring of structured events + JSONL dumping.

    Writer cost budget (the whole point): `record` is one enabled check,
    one atomic counter next, one tuple build, one list store.  No locks
    on the write path — `itertools.count` is atomic under the GIL and a
    torn read in `events()` can at worst show a slot mid-overwrite,
    which the sequence numbers make detectable and the dump path
    tolerates.  `beat()` is a single float store, cheap enough to run
    unconditionally every engine step even with recording disabled (the
    watchdog needs it regardless)."""

    def __init__(self, service: str = "dynamo", *, enabled: bool = False,
                 ring_size: int = DEFAULT_RING,
                 dump_dir: Optional[str] = None,
                 dump_interval_s: float = DEFAULT_DUMP_INTERVAL_S) -> None:
        self.service = service
        self.enabled = enabled
        self.dump_dir = dump_dir
        self.dump_interval_s = dump_interval_s
        self._buf: List[Optional[tuple]] = [None] * max(2, int(ring_size))
        self._seq = itertools.count()
        self.events_written = 0
        # Engine heartbeat (monotonic) — stamped by the step loop; None
        # until the first step (a never-stepped engine is "starting",
        # not "stalled").
        self.last_beat: Optional[float] = None
        # Last first-seen-shape compile start (monotonic), stamped by
        # the engine's recompile hook.  A compile that began after the
        # last heartbeat means the current step is probably inside a
        # kernel build or a first dispatch, not wedged — the watchdog widens its
        # threshold to compile_grace_s for that episode instead of
        # false-paging every cold start.
        self.last_compile: Optional[float] = None
        # Stall accounting (incremented by the watchdog; exported as
        # dynamo_engine_stalls_total).
        self.stalls = 0
        self._dump_lock = threading.Lock()
        self._last_dump: Dict[str, float] = {}   # reason -> monotonic ts
        self.dumps_written = 0
        self.last_dump_path: Optional[str] = None
        self._signal_installed = False
        self._atexit_installed = False
        self._crash_file = None

    # -- configuration -----------------------------------------------------

    def configure(self, *, service: Optional[str] = None,
                  enabled: Optional[bool] = None,
                  ring_size: Optional[int] = None,
                  dump_dir: Optional[str] = None,
                  dump_interval_s: Optional[float] = None
                  ) -> "FlightRecorder":
        """In-place reconfiguration (the module singleton is shared by
        reference; identity must survive — same contract as
        tracing.Tracer.configure)."""
        if service is not None:
            self.service = service
        if enabled is not None:
            self.enabled = enabled
        if ring_size is not None and ring_size != len(self._buf):
            # Resize drops history: acceptable at configure time (process
            # startup / test setup), never done on the record path.
            self._buf = [None] * max(2, int(ring_size))
            self._seq = itertools.count()
        if dump_dir is not None:
            self.dump_dir = dump_dir
        if dump_interval_s is not None:
            self.dump_interval_s = dump_interval_s
        return self

    def reset(self) -> None:
        """Drop all state (test isolation)."""
        self._buf = [None] * len(self._buf)
        self._seq = itertools.count()
        self.events_written = 0
        self.last_beat = None
        self.last_compile = None
        self.stalls = 0
        self._last_dump.clear()
        self.dumps_written = 0
        self.last_dump_path = None

    # -- hot-path writers --------------------------------------------------

    def beat(self) -> None:
        """Engine-thread heartbeat: one float store per step.  Runs even
        with recording disabled — the stall watchdog reads it."""
        self.last_beat = time.monotonic()

    def note_compile(self) -> None:
        """Stamp a compile start (one float store; called from the
        engine's first-seen-shape hook regardless of `enabled` — the
        watchdog's compile grace needs it even with recording off)."""
        self.last_compile = time.monotonic()

    def record(self, kind: str, **fields) -> None:
        """Append one event.  Callers on `@hot_path` code must pass only
        pre-computed scalars (names/constants/plain attributes);
        this body itself does no formatting and takes no lock."""
        if not self.enabled:
            return
        i = next(self._seq)
        self._buf[i % len(self._buf)] = (i, time.time(), kind, fields)
        self.events_written += 1

    def record_always(self, kind: str, **fields) -> None:
        """Force an event past the enabled gate — for the watchdog's
        stall marker and crash-adjacent triggers, which must leave
        evidence even on a process that never opted into recording."""
        i = next(self._seq)
        self._buf[i % len(self._buf)] = (i, time.time(), kind, fields)
        self.events_written += 1

    # -- reads -------------------------------------------------------------

    def last_step_age_s(self) -> Optional[float]:
        """Seconds since the step loop last stamped a heartbeat; None
        before the first step.  The `dynamo_engine_last_step_age_seconds`
        gauge reads this."""
        if self.last_beat is None:
            return None
        return max(0.0, time.monotonic() - self.last_beat)

    def events(self, n: Optional[int] = None) -> List[dict]:
        """Oldest→newest snapshot of the ring as dicts (`n` newest when
        given).  Slots being overwritten concurrently are skipped via the
        sequence-number sanity check."""
        buf = list(self._buf)      # one GIL-atomic copy of the slot list
        rows = [e for e in buf if e is not None]
        rows.sort(key=lambda e: e[0])
        if n is not None:
            # n <= 0 means "no events, just the envelope" — a plain
            # negative slice would degenerate to the WHOLE ring.
            rows = rows[-n:] if n > 0 else []
        return [dict({"seq": seq, "ts": ts, "kind": kind}, **fields)
                for seq, ts, kind, fields in rows]

    def debug_payload(self, n: int = 256) -> dict:
        """The `/debug/flightrecorder` response body — one shape for
        every process (frontend HttpService, worker/router/planner
        StatusServer)."""
        return {
            "service": self.service,
            "enabled": self.enabled,
            "pid": os.getpid(),
            "ring_size": len(self._buf),
            "events_written": self.events_written,
            "stalls": self.stalls,
            "last_step_age_s": self.last_step_age_s(),
            "dumps_written": self.dumps_written,
            "last_dump_path": self.last_dump_path,
            "events": self.events(n),
        }

    # -- dumping -----------------------------------------------------------

    def default_dump_path(self) -> str:
        import tempfile

        d = self.dump_dir or tempfile.gettempdir()
        return os.path.join(
            d, f"flight_{self.service.replace('/', '_')}_{os.getpid()}"
               ".jsonl")

    def dump(self, reason: str, path: Optional[str] = None,
             min_interval_s: Optional[float] = None) -> Optional[str]:
        """Serialize the ring to JSONL; returns the path written, or
        None when the per-reason throttle suppressed it.  First line is
        a header (reason, pid, service, stall count, wall/mono clocks
        for offline time alignment); one line per event follows.  Dumps
        APPEND — a stall dump followed by the atexit dump of the same
        death lands in one file, in order."""
        interval = (self.dump_interval_s if min_interval_s is None
                    else min_interval_s)
        now = time.monotonic()
        with self._dump_lock:
            last = self._last_dump.get(reason)
            if last is not None and interval > 0 \
                    and now - last < interval:
                return None
            self._last_dump[reason] = now
            target = path or self.default_dump_path()
            try:
                events = self.events()
                header = {
                    "flight_dump": True,
                    "reason": reason,
                    "service": self.service,
                    "pid": os.getpid(),
                    "ts": time.time(),
                    "mono": now,
                    "stalls": self.stalls,
                    "events": len(events),
                    "events_written": self.events_written,
                    "last_step_age_s": self.last_step_age_s(),
                }
                with open(target, "a") as f:
                    f.write(json.dumps(header) + "\n")
                    for ev in events:
                        f.write(json.dumps(ev, default=str) + "\n")
            except OSError as e:
                logger.warning("flight-recorder dump to %s failed: %s",
                               target, e)
                return None
            self.dumps_written += 1
            self.last_dump_path = target
        logger.warning("flight recorder dumped %d event(s) to %s "
                       "(reason=%s)", len(events), target, reason)
        return target

    def dump_async(self, reason: str,
                   min_interval_s: Optional[float] = None
                   ) -> Optional[threading.Thread]:
        """`dump` on a short-lived daemon thread — for triggers that
        fire on latency-sensitive threads: the asyncio event loop (SLO
        PAGE in SloMonitor.tick, slow-request force-sample) must not
        stall behind ring serialization + file I/O, and the SIGUSR2
        handler must not re-enter `_dump_lock` a suspended main-thread
        frame may already hold (a non-reentrant lock there would
        deadlock the process).  Returns the started thread, or None
        when the per-reason throttle will suppress the dump anyway
        (lock-free pre-check: under sustained overload the slow-request
        trigger fires per request, and spawning a thread just to hit
        the throttle would be pure churn; dump() re-checks under the
        lock, so a racy pre-read only ever skips work, never doubles
        it)."""
        interval = (self.dump_interval_s if min_interval_s is None
                    else min_interval_s)
        last = self._last_dump.get(reason)
        if last is not None and interval > 0 \
                and time.monotonic() - last < interval:
            return None
        t = threading.Thread(
            target=self.dump, args=(reason,),
            kwargs={"min_interval_s": min_interval_s},
            name="flight-dump", daemon=True)
        t.start()
        return t

    # -- crash / signal triggers ------------------------------------------

    def install_crash_dump(self, signal_dump: bool = True) -> None:
        """Arm the involuntary triggers: `faulthandler` (hard-crash C
        traceback appended to the dump file), an atexit ring dump, and —
        when `signal_dump` and we are on the main thread — SIGUSR2 as
        the operator's live-snapshot hook (`kill -USR2 <pid>`)."""
        import atexit
        import faulthandler

        if self._crash_file is None:
            try:
                # The crash traceback lands IN the flight dump file, so
                # one artifact carries both the ring and the fatal stack.
                self._crash_file = open(self.default_dump_path(), "a")
                faulthandler.enable(file=self._crash_file)
            except (OSError, ValueError):
                faulthandler.enable()
        if not self._atexit_installed:
            self._atexit_installed = True
            atexit.register(self._atexit_dump)
        if signal_dump and not self._signal_installed:
            import signal as _signal

            try:
                # dump_async, not dump: the handler interrupts an
                # arbitrary main-thread frame — possibly one already
                # inside dump() holding _dump_lock.
                _signal.signal(_signal.SIGUSR2,
                               lambda *_: self.dump_async(
                                   "sigusr2", min_interval_s=0.0))
                self._signal_installed = True
            except (ValueError, OSError, AttributeError):
                # Non-main thread or platform without SIGUSR2: the other
                # triggers still work.
                logger.debug("SIGUSR2 dump handler not installed")

    def _atexit_dump(self) -> None:
        # Only leave an artifact when there is evidence to leave: an
        # idle process exiting cleanly should not litter dump files.
        if self.events_written or self.stalls:
            self.dump("atexit", min_interval_s=0.0)
            return
        # Nothing to dump: the file faulthandler pre-opened (so a hard
        # crash has somewhere to write its C traceback) is still empty
        # — remove it rather than leave one stray zero-byte
        # flight_*.jsonl per process start.
        f = self._crash_file
        if f is None:
            return
        try:
            import faulthandler

            faulthandler.disable()
            f.flush()
            empty = os.path.getsize(f.name) == 0
            f.close()
            self._crash_file = None
            if empty:
                os.unlink(f.name)
        except (OSError, ValueError):
            pass  # best-effort tidy at exit


class StallWatchdog:
    """Detects a wedged engine thread: heartbeat stamped by the step
    loop, checked off-thread against pending work.

    `pending_fn` must be cheap and thread-safe-ish (it runs off the
    engine thread against live engine state); any exception it raises
    reads as "no pending work" — the watchdog must never take a worker
    down, only report on one.  One stall EPISODE produces one counter
    increment, one `stall` ring event and one dump; the episode re-arms
    when the heartbeat advances again.

    Compile grace: a first-seen dispatch shape legitimately holds one
    step() open for tens of seconds (a cold nvcc build of a kernel
    library, the allocator's and cuBLAS's first use of a shape).  The engine stamps `note_compile` right before
    such a dispatch, so a compile that began at/after the last
    heartbeat widens this episode's threshold to `compile_grace_s` —
    a genuine wedge without a preceding compile still pages at
    `stall_s`, and a wedge DURING a compile pages at the grace."""

    def __init__(self, recorder: FlightRecorder,
                 pending_fn: Callable[[], bool],
                 stall_s: float = 10.0,
                 interval_s: Optional[float] = None,
                 compile_grace_s: float = 120.0,
                 on_stall: Optional[Callable[[], None]] = None) -> None:
        self.recorder = recorder
        self.pending_fn = pending_fn
        self.stall_s = stall_s
        self.interval_s = (interval_s if interval_s is not None
                           else max(0.05, stall_s / 4.0))
        self.compile_grace_s = max(compile_grace_s, stall_s)
        self.on_stall = on_stall
        self.stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self, now: Optional[float] = None) -> bool:
        """One watchdog evaluation (importable for deterministic tests);
        returns True when a NEW stall episode was just declared."""
        rec = self.recorder
        beat = rec.last_beat
        if beat is None:
            return False          # engine never stepped: starting, not stuck
        now = time.monotonic() if now is None else now
        age = now - beat
        threshold = self.stall_s
        compile_ts = rec.last_compile
        if compile_ts is not None and compile_ts >= beat:
            # The step that owns the stale heartbeat dispatched a
            # first-seen shape: probably compiling, not wedged.
            threshold = self.compile_grace_s
        if age < threshold:
            if self.stalled:
                logger.warning(
                    "engine thread recovered after stall (heartbeat "
                    "age now %.2fs)", age)
            self.stalled = False
            return False
        try:
            pending = bool(self.pending_fn())
        except Exception:
            pending = False       # racing teardown: do not page on it
        if not pending:
            # Idle engines stop stepping by design — old heartbeat with
            # no pending work is rest, not a wedge.
            self.stalled = False
            return False
        if self.stalled:
            return False          # same episode: already counted + dumped
        self.stalled = True
        rec.stalls += 1
        rec.record_always("stall", age_s=round(age, 3),
                          threshold_s=threshold, stalls=rec.stalls)
        logger.error(
            "engine-thread stall: no step heartbeat for %.2fs with "
            "pending work (threshold %.2fs) — dumping flight recorder",
            age, threshold)
        if self.on_stall is not None:
            try:
                self.on_stall()
            except Exception:
                logger.exception("on_stall callback failed")
        rec.dump("stall", min_interval_s=0.0)
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.check_once()
            except Exception:  # the watchdog must outlive its own bugs
                logger.exception("stall watchdog check failed")
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="engine-stall-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ---------------------------------------------------------------------------
# Process singleton (same pattern as tracing.get_tracer)

_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def configure(**kwargs) -> FlightRecorder:
    return _recorder.configure(**kwargs)


def add_flight_args(parser) -> None:
    """The shared --flight* / --watchdog* CLI surface (frontend,
    worker)."""
    parser.add_argument("--flight-recorder", choices=("on", "off"),
                        default="on",
                        help="per-process flight recorder: bounded ring "
                             "of structured engine/scheduler/KV/SLO "
                             "events, dumped as JSONL on SLO PAGE, slow "
                             "requests, SIGUSR2, exit/crash, and "
                             "engine-thread stalls "
                             "(/debug/flightrecorder)")
    parser.add_argument("--flight-ring", type=int, default=DEFAULT_RING,
                        help="flight-recorder ring size (events kept)")
    parser.add_argument("--flight-dump-dir", default=None,
                        help="directory for flight-recorder JSONL dumps "
                             "(default: the system temp dir; file name "
                             "flight_<service>_<pid>.jsonl)")
    parser.add_argument("--watchdog-stall-s", type=float, default=10.0,
                        help="engine-thread stall watchdog: no step "
                             "heartbeat for this many seconds while "
                             "prefill/decode work is pending counts as "
                             "a stall (event + dynamo_engine_stalls_total "
                             "+ automatic dump); 0 disables")


def configure_from_args(args, service: str) -> FlightRecorder:
    """Apply the add_flight_args flags to the process recorder."""
    return configure(
        service=service,
        enabled=getattr(args, "flight_recorder", "on") != "off",
        ring_size=getattr(args, "flight_ring", DEFAULT_RING),
        dump_dir=getattr(args, "flight_dump_dir", None))
