"""The port's flight recorder, request ledger and SLO monitor against the
JAX modules on the CPU.

- FlightRecorder: one record sequence (wrapping the ring, a disabled
  stretch, `record_always`) leaves equal events and debug payloads; a
  dump writes JAX's header and event lines, and the per-reason throttle
  suppresses alike.
- StallWatchdog.check_once under a fake clock: one scripted sequence of
  heartbeats, compile stamps, pending work and clock readings declares
  the same stall episodes in both.
- RequestLedger: `to_wire` → `merge_wire` across the packages both ways
  keeps every stamp (re-based onto the receiving anchor); malformed wire
  forms drop the ledger in both; TTFT coverage and `coverage_ok` agree;
  LedgerSink folds of the same ledgers give equal exposition text,
  goodput, dominant phase and /debug/requests payloads; the port's own
  `rpc` stamp is the wire client's round trip less the hop's time.
- SloMonitor.tick under an injected clock over seeded latency and error
  sources: equal payloads (burn rates, states, compliance) at every tick,
  and equal `dynamo_slo_*` exposition.
"""

import argparse
import json
import types

import numpy as np
import pytest

from dynamo_tpu.runtime import flight_recorder as jfr
from dynamo_tpu.runtime import ledger as jled
from dynamo_tpu.runtime import metrics as jm
from dynamo_tpu.runtime import slo as jslo
from dynamo_tpu_torch.runtime import flight_recorder as tfr
from dynamo_tpu_torch.runtime import ledger as tled
from dynamo_tpu_torch.runtime import metrics as tm
from dynamo_tpu_torch.runtime import slo as tslo


@pytest.fixture(autouse=True)
def _quiet_singletons(tmp_path):
    """Both packages' process recorders off, dumping (if at all) into
    tmp_path; restored afterwards."""
    for mod in (jfr, tfr):
        rec = mod.get_recorder()
        rec.reset()
        rec.configure(enabled=False, dump_dir=str(tmp_path),
                      ring_size=mod.DEFAULT_RING)
    yield
    for mod in (jfr, tfr):
        rec = mod.get_recorder()
        rec.reset()
        rec.configure(enabled=False, ring_size=mod.DEFAULT_RING)
        rec.dump_dir = None


def _strip(events):
    """Events (or dump lines) without their clock readings."""
    return [{k: v for k, v in e.items()
             if k not in ("ts", "mono", "last_step_age_s")} for e in events]


def _record(mod, tmp_path):
    tmp_path.mkdir()
    rec = mod.FlightRecorder("svc", enabled=True, ring_size=16,
                             dump_dir=str(tmp_path))
    rng = np.random.default_rng(0)
    for i in range(40):
        if i == 20:
            rec.configure(enabled=False)
        if i == 25:
            rec.configure(enabled=True)
        kind = str(rng.choice(["window", "prefill_packed", "preempt"]))
        rec.record(kind, bucket=int(rng.integers(8)), lag=i)
        if i % 13 == 0:
            rec.record_always("stall", age_s=1.5, stalls=i)
    rec.beat()
    payload = rec.debug_payload(8)
    first = rec.dump("test")
    again = rec.dump("test")                # throttled
    forced = rec.dump("test", min_interval_s=0.0)
    lines = [json.loads(ln) for ln in open(first)]
    return rec, payload, (first is not None, again, forced is not None), lines


def test_flight_events_payload_and_dump_match_jax(tmp_path):
    jrec, jp, jd, jlines = _record(jfr, tmp_path / "j")
    trec, tp, td, tlines = _record(tfr, tmp_path / "t")
    assert _strip(trec.events()) == _strip(jrec.events())
    assert trec.events_written == jrec.events_written
    skip = ("pid", "last_step_age_s", "last_dump_path", "events")
    assert ({k: v for k, v in tp.items() if k not in skip}
            == {k: v for k, v in jp.items() if k not in skip})
    assert _strip(tp["events"]) == _strip(jp["events"])
    assert td == jd == (True, None, True)
    assert len(tlines) == len(jlines)
    header_keys = set(jlines[0])
    assert set(tlines[0]) == header_keys and tlines[0]["reason"] == "test"
    assert _strip(tlines[1:]) == _strip(jlines[1:])


def _watch(mod):
    rec = mod.FlightRecorder("svc", enabled=True)
    pending = {"v": True}
    dog = mod.StallWatchdog(rec, lambda: pending["v"], stall_s=2.0,
                            compile_grace_s=10.0)
    rec.dump = lambda *a, **k: None          # no files from the episodes
    out = []
    rng = np.random.default_rng(4)
    now = 100.0
    for i in range(300):
        op = int(rng.integers(6))
        if op == 0:
            rec.last_beat = now
        elif op == 1:
            rec.last_compile = now + float(rng.uniform(-1, 1))
        elif op == 2:
            pending["v"] = bool(rng.integers(2))
        now += float(rng.exponential(1.2))
        out.append((dog.check_once(now), dog.stalled, rec.stalls))
    return out


def test_stall_watchdog_check_once_matches_jax():
    got = _watch(tfr)
    assert got == _watch(jfr)
    assert any(new for new, _, _ in got) and got[-1][2] > 1


def _ledger(mod, seed: int):
    rng = np.random.default_rng(seed)
    led = mod.RequestLedger("rid", anchor=1000.0)
    t = 1000.0
    for phase in ("receive", "route", "queue", "prefill", "first_token",
                  "kv_transfer", "decode"):
        dur = float(rng.uniform(0, 0.2))
        t += dur
        led.stamp(phase, dur=dur, t=t, blocks=int(rng.integers(9)),
                  plane=str(rng.choice(["device", "host"])))
    return led, t - 1000.0


@pytest.mark.parametrize("src,dst", [(jled, tled), (tled, jled)])
def test_ledger_wire_round_trip_across_packages(src, dst):
    hop, _ = _ledger(src, 0)
    front = dst.RequestLedger("rid", anchor=990.0)
    front.stamp("receive", dur=0.01, t=990.5)
    assert front.merge_wire(hop.to_wire())
    assert len(front.stamps) == 1 + len(hop.stamps)
    # The wire keeps times to the microsecond.
    for (p, t, d, a), (hp, ht, hd, ha) in zip(front.stamps[1:], hop.stamps):
        assert (p, d, a) == (hp, round(hd, 6), ha)
        assert t == pytest.approx(ht + 10.0, abs=1e-6)
    for bad in ("x", {"stamps": "no"}, {"stamps": [[1, 2, 3]]},
                {"stamps": [["p", "t", 0]]}, {"stamps": [["p", 0, 0, [1]]]}):
        assert dst.decode_wire(bad, where="test") is None
        assert src.decode_wire(bad, where="test") is None


def test_ledger_coverage_and_sink_match_jax():
    jreg, treg = jm.MetricsRegistry(), tm.MetricsRegistry()
    jsink = jled.LedgerSink(jreg, slo_ttft=0.3, slo_tpot=0.05)
    tsink = tled.LedgerSink(treg, slo_ttft=0.3, slo_tpot=0.05)
    for seed in range(12):
        jl, total = _ledger(jled, seed)
        tl, _ = _ledger(tled, seed)
        for ttft in (total * 0.5, total, total * 1.05, total * 2):
            assert (tled.ttft_coverage(tl, ttft)
                    == jled.ttft_coverage(jl, ttft))
            assert tled.coverage_ok(tl, ttft) == jled.coverage_ok(jl, ttft)
        ok = seed % 5 != 0
        jsink.fold(jl, total * 0.8, 0.04 + seed / 1000, 20 + seed, ok=ok)
        tsink.fold(tl, total * 0.8, 0.04 + seed / 1000, 20 + seed, ok=ok)
    assert treg.expose() == jreg.expose()
    assert tsink.goodput_ratio() == jsink.goodput_ratio()
    assert tsink.dominant_phase() == jsink.dominant_phase()
    jp, tp = jsink.debug_payload(5), tsink.debug_payload(5)
    for e in jp["slowest"] + tp["slowest"]:
        e.pop("anchor")
        for s in e["stamps"]:
            s.pop("t")
    assert tp == jp


def test_rpc_is_the_round_trip_less_the_hops_time():
    """The port's `rpc` phase (JAX stamps none): the wire client's round
    trip from sending the request to its first token, less the hop's
    time from its anchor to emitting it, each on its own clock; once a
    request, and none without a first token or a hop `first_token`."""
    def hop():
        led = tled.RequestLedger("rid", anchor=500.0)   # another clock
        for phase, dur, t in (("receive", 0.001, 500.001),
                              ("queue", 0.004, 500.005),
                              ("prefill", 0.02, 500.025),
                              ("first_token", 0.005, 500.030),
                              ("decode", 0.2, 500.25)):
            led.stamp(phase, dur=dur, t=t)
        return led

    def absorbed(hop_led, sent=1000.001, first=1000.043):
        front = tled.RequestLedger("rid", anchor=1000.0)
        front.stamp("receive", dur=0.0005, t=1000.0005)
        front.stamp("route", dur=0.0005, t=1000.001)
        req = types.SimpleNamespace(ledger=front)
        delta = types.SimpleNamespace(ledger=hop_led.to_wire())
        tled.absorb_delta(req, delta, "test", sent=sent, first=first)
        assert delta.ledger is None
        return req, front

    req, front = absorbed(hop())
    rpc = [(t, d) for p, t, d, _ in front.stamps if p == "rpc"]
    assert rpc == [(pytest.approx(0.043), pytest.approx(0.012))]
    assert tled.ttft_coverage(front, 0.043) == pytest.approx(1.0)
    # A resumed stream's hop adds no second one.
    tled.absorb_delta(req, types.SimpleNamespace(ledger=hop().to_wire()),
                      "test", sent=1000.1, first=1000.2)
    assert [p for p, *_ in front.stamps].count("rpc") == 1
    # No first token on this stream, or none emitted by the hop.
    _, front = absorbed(hop(), first=None)
    assert "rpc" not in front.phase_totals()
    bare = tled.RequestLedger("rid", anchor=500.0)
    bare.stamp("queue", dur=0.004, t=500.005)
    _, front = absorbed(bare)
    assert "rpc" not in front.phase_totals()


def _monitor(mod, mmod):
    reg = mmod.MetricsRegistry()
    rm = mmod.RequestMetrics(reg)
    args = argparse.Namespace(
        slo_ttft_p99=0.5, slo_tpot_p99=0.05, slo_error_rate=0.01,
        slo_target=0.99, slo_fast_window=60.0, slo_slow_window=600.0,
        slo_warn_burn=3.0, slo_page_burn=14.4, slo_tick=5.0)
    clock = {"now": 0.0}
    mon = mod.monitor_from_args(args, rm, registry=reg,
                                attribution_fn=lambda: "queue")
    mon._clock = lambda: clock["now"]
    rng = np.random.default_rng(7)
    payloads = []
    for i in range(120):
        bad = 0.4 if 40 <= i < 70 else 0.01
        for _ in range(int(rng.integers(0, 30))):
            rm.ttft.observe(float(rng.uniform(0.6, 2.0)
                                  if rng.uniform() < bad
                                  else rng.uniform(0.01, 0.4)))
            rm.tpot.observe(float(rng.uniform(0.001, 0.08)))
            rm.observe_outcome(bool(rng.uniform() > bad / 4))
        clock["now"] += float(rng.uniform(1, 15))
        payloads.append(mon.tick())
    return payloads, reg.expose(), mon.last_max_burn


def test_slo_monitor_ticks_match_jax():
    jp, jtext, jburn = _monitor(jslo, jm)
    tp, ttext, tburn = _monitor(tslo, tm)
    assert tp == jp and ttext == jtext and tburn == jburn
    assert {p["state"] for p in tp} >= {"OK", "PAGE"}
    for p in tp:
        assert tslo.max_burn(p) == jslo.max_burn(p)
    assert tslo.disabled_payload() == jslo.disabled_payload()
