"""The port's `runtime/device_profiler.py` against the JAX module on the
CPU, and the planes' zero-overhead rule.

- DriftAuditor: over a seeded sequence of (series, modeled, measured)
  observations the ratios, states, strikes and the PAGE / recovery
  flight events are JAX's.
- ProgramCostRegistry, `program_label` and the `metrics_lines` families
  are JAX's; the HELP text says the costs are modeled.
- `modeled_step_cost` for a llama-3-1b window at batch 8: the weight
  bytes of 8 forwards dominate, and its roofline time is the ~6 ms a
  window's weights take at 3.35 TB/s.
- A capture on the CPU writes a Chrome trace and `capture_meta.json`
  (JAX's sidecar keys), lists `*.trace.json` files, refuses a second
  concurrent capture and answers `ok: false` when the plane is off.
- `summarize_trace` on a synthetic trace: busy share, kernels by time,
  idle gaps with the innermost host event spanning each.
- A CPU engine with every plane on (tracing with bound contexts, flight
  recorder, ledger, device profiler): harvests once per first-seen shape,
  the drift audit reads `kv_decode` and `window_time` in band, and the
  steady window's EngineStepCounters deltas are byte-identical to the
  planes-off run's.
"""

import json
import threading

import numpy as np
import pytest
import torch

from dynamo_tpu.runtime import device_profiler as jdp
from dynamo_tpu.runtime import flight_recorder as jfr
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import RequestState, SchedulerConfig
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime import device_profiler as tdp
from dynamo_tpu_torch.runtime import flight_recorder as tfr
from dynamo_tpu_torch.runtime import ledger, tracing


@pytest.fixture(autouse=True)
def _planes_off(tmp_path):
    """Every process singleton of both packages off (and dumping, if at
    all, into tmp_path) before and after each test."""
    def off():
        for fr in (jfr, tfr):
            fr.get_recorder().reset()
            fr.get_recorder().configure(enabled=False, dump_dir=str(tmp_path))
        for dp in (jdp, tdp):
            dp.get_profiler().reset()
            dp.get_profiler().configure(enabled=False, dump_dir=str(tmp_path))
        tracing.get_tracer().configure(enabled=False, sampling=1.0)
        tracing.get_tracer().reset()
        ledger.set_enabled(True)
    off()
    yield
    off()


def _audit(mod, fr):
    aud = mod.DriftAuditor(band_hi=1.25)
    rng = np.random.default_rng(5)
    out = []
    for _ in range(300):
        series = str(rng.choice(["kv_decode", "window_time"]))
        measured = float(rng.choice([0.0, rng.uniform(0.5, 2.0)]))
        modeled = float(rng.uniform(0.0, 2.0))
        out.append(aud.observe(series, modeled, measured))
    events = [(e["kind"], e["series"], e["ratio"])
              for e in fr.get_recorder().events()]
    return out, aud.states(), aud.paged(), events


def test_drift_auditor_states_match_jax():
    for fr in (jfr, tfr):
        fr.get_recorder().dump_async = lambda *a, **k: None
    try:
        got = _audit(tdp, tfr)
        assert got == _audit(jdp, jfr)
    finally:
        for fr in (jfr, tfr):
            del fr.get_recorder().dump_async
    ratios, states, _, events = got
    assert {"drift_page", "drift_ok"} <= {k for k, _, _ in events}
    assert tdp.PAGE_STRIKES == jdp.PAGE_STRIKES
    assert tdp.DEFAULT_BAND_HI == jdp.DEFAULT_BAND_HI


def test_registry_labels_and_metric_families_match_jax():
    rows = [("window", (True, 8, 4), 1e9, 2e9, 1e-3),
            ("decode1g", (8, 4), 5e8, 1e9, None),
            ("prefill_packed", (512, 8, 4), 3e12, 5e9, 2e-3)]
    regs = {}
    for mod in (jdp, tdp):
        prof = mod.DeviceProfiler("w", enabled=True)
        for tag, sig, fl, by, opt in rows:
            prof.registry.record(mod.program_label(tag, sig), flops=fl,
                                 bytes_accessed=by, optimal_s=opt)
        prof.auditor.observe("kv_decode", 1.0, 4.0)
        regs[mod] = prof
    j, t = regs[jdp], regs[tdp]
    assert t.registry.items() == j.registry.items()
    for key in ("flops", "bytes_accessed", "optimal_s"):
        assert (t.registry.mean_for_tags(key, "window", "decode1g")
                == j.registry.mean_for_tags(key, "window", "decode1g"))

    def samples(lines):
        return [ln for ln in lines if not ln.startswith("# HELP")]

    assert samples(t.metrics_lines()) == samples(j.metrics_lines())
    helps = [ln for ln in t.metrics_lines() if ln.startswith("# HELP")]
    assert any("modeled" in ln for ln in helps)
    assert set(t.debug_payload()) == set(j.debug_payload())
    assert (tdp.profile_key_pid(7), tdp.profile_key_instance(3)) == (
        jdp.profile_key_pid(7), jdp.profile_key_instance(3))


def test_modeled_window_cost_is_its_weight_traffic():
    cfg = get_config("llama-3-1b")
    kv = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    flops, nbytes = tdp.modeled_step_cost(
        cfg, steps=8, tokens=8, kv_tokens=8 * 4 * 64, kv_bytes_per_token=kv)
    weights = 8 * cfg.param_count() * 2
    assert weights < nbytes < 1.05 * weights
    assert flops > 8 * 2 * 8 * (cfg.param_count() - cfg.hidden_size)
    assert tdp.roofline_s(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12) == pytest.approx(5.9e-3, rel=0.05)


def test_cpu_capture_writes_trace_and_sidecar(tmp_path):
    prof = tdp.DeviceProfiler("svc", enabled=True, dump_dir=str(tmp_path))
    stop = threading.Event()

    def work():
        a = torch.randn(64, 64)
        while not stop.is_set():
            (a @ a).relu_()

    t = threading.Thread(target=work)
    t.start()
    try:
        res = {}
        cap = threading.Thread(target=lambda: res.update(prof.capture(50)))
        cap.start()
        cap.join(timeout=60)
        assert prof._capture_lock.acquire(blocking=False)
        try:
            busy = prof.capture(10)
        finally:
            prof._capture_lock.release()
    finally:
        stop.set()
        t.join(timeout=10)
    assert busy == {"ok": False, "error": "capture already in progress"}
    assert res["ok"] and res["files"] == [res["files"][0]]
    assert res["files"][0].endswith(".trace.json")
    with open(res["trace"]) as f:
        trace = json.load(f)
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    with open(tmp_path / f"deviceprofile_svc_{res['pid']}" /
              "capture_meta.json") as f:
        meta = json.load(f)
    assert {"service", "pid", "ms", "wall_start", "wall_end"} <= set(meta)
    assert meta["ms"] == 50 and prof.captures == 1
    off = tdp.DeviceProfiler("svc").capture(10)
    assert off["ok"] is False and "disabled" in off["error"]


def test_summarize_trace_busy_share_kernels_and_gaps():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::index", "ts": 30,
         "dur": 45, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90, "dur": 10},
        {"ph": "M", "name": "process_name"},
    ]
    s = tdp.summarize_trace({"traceEvents": ev}, top=2, gaps=5)
    assert s["window_us"] == 100 and s["busy_us"] == 25 + 5 + 10
    assert s["busy_share"] == pytest.approx(0.4)
    assert s["kernels"] == [{"name": "k1", "count": 2, "total_us": 30},
                            {"name": "k2", "count": 1, "total_us": 10}]
    assert [(g["gap_us"], g["at_us"]) for g in s["gaps"]] == [(35, 35),
                                                              (15, 75)]
    assert s["gaps"][0]["host_event"]["name"] == "aten::index"
    assert s["gaps"][1]["host_event"]["name"] == "aten::mm"
    assert tdp.summarize_trace({"traceEvents": []})["busy_share"] is None


STEADY_STEPS = 4
GEOM = dict(max_seqs=8, block_size=8, max_pages_per_seq=32,
            max_prefill_chunk=64, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(16, 64))


def _steady(on: bool, state):
    tracer = tracing.configure(enabled=on, sampling=1.0)
    tfr.configure(enabled=on)
    prof = tdp.configure(enabled=on)
    ledger.set_enabled(on)
    core = EngineCore(EngineConfig(
        model=get_config("tiny-test"), num_blocks=128, device="cpu",
        scheduler=SchedulerConfig(**GEOM)), params=state)
    roots = []
    for i in range(6):
        rid = f"r{i}"
        roots.append(tracer.start_span("http.chat", trace_id=rid))
        tracer.bind(rid, roots[-1].ctx)
        core.add_request(rid, [(5 * i + j) % 200 + 1 for j in range(11 + i)],
                         SamplingParams(max_tokens=96))
    # Decode windows in flight, every prompt prefilled: the steady window
    # (the pipeline's fill counts too: each step dispatches one window).
    while not (len(core._inflight) >= 2
               and all(r.state is RequestState.DECODE
                       for r in core.scheduler.running)
               and not core._pending_batches):
        core.step()
    programs = prof.registry.size()
    before = core.counters.as_dict()
    for _ in range(STEADY_STEPS):
        core.step()
    delta = {k: v - before[k] for k, v in core.counters.as_dict().items()}
    ratios = prof.audit_engine(core)
    for r in roots:
        r.end()
    return delta, programs, prof.registry.size(), ratios, core


def test_steady_window_counters_byte_identical_planes_on_and_off():
    from dynamo_tpu_torch.models.weights import init_params

    gen = torch.Generator().manual_seed(0)
    state = init_params(get_config("tiny-test"), gen, torch.device("cpu"))
    off, off_programs, _, off_ratios, _ = _steady(False, state)
    on, programs, programs_after, ratios, core = _steady(True, state)
    assert on == off and off["window_dispatches"] == STEADY_STEPS
    assert off_programs == 0 and off_ratios == {}
    # One harvest per first-seen step shape (the sampler's are no step
    # program), none on a warm dispatch.
    assert programs_after - programs == on["xla_cache_misses"]
    assert programs_after == len([k for k in core.counters._seen_shapes
                                  if k[0] != "sample"])
    assert 0 < ratios["kv_decode"] <= tdp.DEFAULT_BAND_HI
    # window_time: the window's roofline seconds against its measured
    # time — on the CPU the JAX rule (the decode EWMA times the tokens a
    # window emits), on a card the CUDA-event span, which wins.
    prof, c = tdp.get_profiler(), core.counters
    opt = prof.registry.mean_for_tags("optimal_s", "window")
    c.decode_token_cost_ewma = 1e-3
    c.decode_tokens_emitted = 40 * c.window_dispatches
    assert prof.audit_engine(core)["window_time"] == pytest.approx(
        opt / 0.04)
    c.note_window_device_time(0.25)
    assert prof.audit_engine(core)["window_time"] == pytest.approx(opt / 0.25)
    assert tfr.get_recorder().events_written > 0
    assert len(core._ledger_timings) == 6
    assert tracing.get_tracer().spans_recorded >= 3 * 6
