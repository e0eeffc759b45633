"""`python -m dynamo_tpu_torch.worker` — a backend worker process (port of
`dynamo_tpu/worker/main.py`: the aggregated, prefill and decode roles).

    python -m dynamo_tpu_torch.worker --control-plane HOST:PORT \\
        --model llama-3-1b --model-name m [--health-port 0]
    python -m dynamo_tpu_torch.worker --control-plane HOST:PORT \\
        --model tiny-test --device cpu
    python -m dynamo_tpu_torch.worker --control-plane HOST:PORT \\
        --model llama-3-1b --role prefill
    python -m dynamo_tpu_torch.worker --control-plane HOST:PORT \\
        --model llama-3-1b --model-name m --role decode \\
        --max-local-prefill 512

Connects to the control plane, serves the port's engine (`EngineCore` /
`InferenceEngine`: packed prefill through the paged-prefill kernel, decode
windows through the paged-decode kernel) on the `generate` endpoint,
registers the model (`register_llm`), and publishes the engine's KV events
and load metrics for the frontends' KV routers.  SIGTERM or SIGINT leaves
routing at once (the lease is revoked, so the instance and model keys
go), lets in-flight streams finish, and shuts down; a killed worker's keys
expire with its lease.

`--spec-decode K` runs speculative decode (prompt-lookup drafts of K
tokens, `--spec-ngram N`-grams) in place of the decode windows, and the
published SliceSpec then carries the `spec` feature.  Every worker serves
the `embed` and `clear_kv` endpoints behind a frontend's /v1/embeddings
and /clear_kv_blocks.

Every worker serves the KV data plane: `kv_blocks` (host-staged block
pulls), `kv_offer` and `kv_pulled` (the device plane: CUDA IPC between
processes on one card, the same-process fabric on the CPU), so every
worker is a prefix donor.  By default a worker consumes the router's
remote-prefix hints, pulling a donor's blocks before admission
(`--no-prefix-share` turns that off).  Roles (`--role`):

- `both` (default): aggregated serving.
- `prefill`: serves the disagg prefill queue only, under the component
  `<component>-prefill`, with no model registration and no KV events, so
  no frontend or KV router routes chats to it.
- `decode`: registers the model; prompts longer than the threshold
  (`--max-local-prefill`, written to the control plane at start and
  hot-reloaded from it) prefill on a prefill worker while their sealed
  blocks stream here (`--no-eager-kv`: pull only at prefill-done).
- `encode`: the multimodal vision tower (`llm/multimodal.py`'s stub
  encoder, sized by `--model`'s hidden size) behind `encoder/encode`: no
  engine, no model registration.  A frontend on the same fabric pulls
  the embeddings from this process's device plane (CUDA IPC on one
  card); any other gets them inline on the RPC.

The status port's `/debug/stats` adds the data plane's counters: `disagg`
(remote prefills, local fallbacks, tokens onboarded, eager blocks pulled
before and after prefill-done, `overlap_ratio`), `plane_counts` by plane
and reason, `transfer_plane` (offers, staged high-water marks, pulled
blocks), `prefix_share` (pulls and blocks; hinted chats' admission hits
and the pulled tokens admission prefilled again) and `onboarded_blocks`;
`POST /debug/stats/reset` zeroes them with the rest.

Runs on the card unless `--device cpu` is given.  `--model` takes a
preset (random weights from seed 0, the byte tokenizer), an HF-layout
checkpoint directory, a `.gguf` file or an `org/repo` of the local hub
cache (models/loader.py); the model card it publishes carries the
checkpoint's tokenizer.json inline (`hf_inline`) with its chat template
and eos, so a remote frontend serves them.  On a card the kernels its
path launches are built (or reused from `_build/`) and loaded before it
registers: a kernel that fails to build or load stops the worker with an
error.

Observability, with JAX's flags (all served on the status port):
`/metrics` (the worker's engine series — `dynamo_worker_*`,
`dynamo_worker_engine_*` from EngineStepCounters, the heartbeat age and
stalls, the KV pool / prefix / transfer-plane series, HBM occupancy from
`--hbm-poll-interval`, the device profiler's `dynamo_program_*` and
`dynamo_modeled_vs_measured_ratio`, RequestMetrics at the RPC boundary,
SLO gauges); `--trace*` (`/debug/traces`), `--slo-*` (`/debug/slo`),
`--flight-recorder` / `--flight-dump-dir` (`/debug/flightrecorder`,
dumps on SIGUSR2 and exit) with `--watchdog-stall-s` (the stall
watchdog), `--request-ledger` (the hop ledger returned on the final
delta) and `--device-profiler on|off` (`/debug/deviceprofile?ms=N`, a
torch.profiler capture written under `--flight-dump-dir`; also taken by
putting `profile/<pid>` or `profile/instance/<id>` on the control plane,
the value its milliseconds).

Elasticity and QoS, as in JAX.  `--drain on` (default): SIGTERM, or a
put under `drain/<pid>` / `drain/instance/<id>` on the control plane,
leaves routing at once, ends each in-flight stream with a `migrate`
delta naming this worker's address and the stream's sealed high-water
mark (`llm/drain.DrainableService`, the outermost serving stage), and
lingers until the peers' KV pulls finish (`--drain-timeout-s`,
`--drain-linger-s`); `--drain off` lets the streams run out instead.
The request's QoS class reaches the scheduler; with an SLO monitor the
scheduler's `qos_pressure_fn` and the pool's eviction bias read its
worst burn rate.  `/metrics` adds `dynamo_requests_migrated_total`,
`dynamo_worker_draining`, `dynamo_qos_preemptions_total`,
`dynamo_qos_demoted_blocks_total` and `dynamo_requests_migrated_in_total`.
The status port is registered under `status_endpoints/` on the control
plane (with the pid), where the metrics aggregator and the planner find
it.

`--mocker [--speedup-ratio R]` serves `llm/mocker.MockEngine` in place of
the engine: deterministic tokens, real KV events and load metrics, no
device and no KV data plane (a CPU test backend for the planner, the
launcher and the drain; the roles refuse it).

Not ported: multihost and lockstep, and `--slice`.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
from typing import Optional

from dynamo_tpu_torch.engine.engine import (
    DECODE_WINDOW,
    EngineConfig,
    EngineCore,
    InferenceEngine,
)
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.fleet.topology import SliceSpec
from dynamo_tpu_torch.frontend.main import stats_hooks
from dynamo_tpu_torch.llm.block_manager import device_transfer as dt
from dynamo_tpu_torch.llm.block_manager.pool import slo_eviction_bias
from dynamo_tpu_torch.llm.block_manager.prefix_share import (
    PrefixFetcher,
    PrefixShareClient,
)
from dynamo_tpu_torch.llm.block_manager.transfer import (
    KV_BLOCKS_ENDPOINT,
    make_kv_blocks_handler,
)
from dynamo_tpu_torch.llm.disagg import (
    DisaggDecodeClient,
    disagg_config_key,
    prefill_worker_loop,
)
from dynamo_tpu_torch.llm.drain import (
    DRAIN_PREFIX,
    DrainableService,
    drain_key_instance,
    drain_key_pid,
)
from dynamo_tpu_torch.llm.discovery import (
    CLEAR_KV_ENDPOINT,
    EMBED_ENDPOINT,
    clear_kv_wire_handler,
    embed_wire_handler,
    engine_wire_handler,
    register_llm,
)
from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.service import LocalEngineClient
from dynamo_tpu_torch.models.loader import resolve_model
from dynamo_tpu_torch.runtime.config import (
    apply_to_parser_defaults,
    load_layered_config,
)
from dynamo_tpu_torch.runtime import (
    device_profiler,
    flight_recorder,
    ledger,
    slo,
    tracing,
)
from dynamo_tpu_torch.runtime.contracts import never_engine_thread
from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneClient
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.metrics import (
    HbmPoller,
    KvCacheMetrics,
    MetricsRegistry,
    RequestMetrics,
)

logger = logging.getLogger("dynamo_tpu_torch.worker")

KV_EVENTS_SUBJECT = "kv_events"        # reference kv_router.rs:56
METRICS_SUBJECT = "load_metrics"       # reference stats endpoint name
STREAM_DRAIN_S = 30.0                  # in-flight streams' grace at exit


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        "dynamo_tpu_torch.worker",
        description="Layered config: defaults < dynamo.toml [worker] "
                    "section < DYN_* env < these flags "
                    "(runtime/config.py).")
    p.add_argument("--control-plane", default=None,
                   help="control plane HOST:PORT")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--model-name", default="dynamo-tpu")
    p.add_argument("--role", choices=("both", "prefill", "decode", "encode"),
                   default="both",
                   help="disaggregated P/D role: 'prefill' serves the "
                        "prefill queue only (no model registration); "
                        "'decode' registers the model and sends long "
                        "prompts to the prefill queue; 'both' = "
                        "aggregated; 'encode' serves the multimodal "
                        "vision tower (encoder/encode endpoint)")
    p.add_argument("--max-local-prefill", type=int, default=None,
                   help="decode role: write the disagg threshold (tokens) "
                        "to the control plane at start; prompts longer "
                        "than this prefill remotely.  The key is watched, "
                        "so it can be retuned live")
    p.add_argument("--no-eager-kv", action="store_true",
                   help="decode role: pull the sealed prefix only after "
                        "the prefill-done announcement, instead of "
                        "streaming blocks while the prefill runs")
    p.add_argument("--no-prefix-share", action="store_true",
                   help="ignore the router's remote-prefix hints instead "
                        "of pulling a peer's sealed prefix blocks before "
                        "prefill (the worker still serves them as a "
                        "donor)")
    p.add_argument("--mocker", action="store_true",
                   help="serve the mock engine (no model, no device): a "
                        "CPU test backend with real KV events and load "
                        "metrics")
    p.add_argument("--speedup-ratio", type=float, default=10.0,
                   help="mocker: simulated step time divided by this")
    p.add_argument("--model", default="llama-3-1b",
                   help="model preset (random weights), e.g. llama-3-1b, "
                        "mixtral-8x7b, tiny-test; an HF-layout checkpoint "
                        "directory, a .gguf file, or org/repo in the "
                        "local hub cache")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--num-blocks", type=int, default=512)
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=None,
                   help="keep the first N decoder layers of the preset "
                        "(default: all), as the port's frontend does")
    p.add_argument("--max-prefill-chunk", type=int, default=512,
                   help="chunked-prefill step ceiling (tokens)")
    p.add_argument("--kv-quant", choices=("none", "int8"), default="none",
                   help="KV cache storage: int8 pages with per-token, "
                        "per-head f32 scales, or the model dtype")
    p.add_argument("--spec-decode", type=int, default=0, metavar="K",
                   help="speculative decode: draft K tokens a decode step "
                        "(prompt-lookup n-gram drafter) and verify them in "
                        "one batched forward; greedy output equals K=0's, "
                        "stochastic requests keep their sampling "
                        "distribution.  0 disables; windows are off "
                        "while it is on")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="n-gram length of the prompt-lookup drafter")
    p.add_argument("--moe-mode", choices=("auto", "dense", "grouped"),
                   default="auto",
                   help="MoE expert compute (dense models ignore it): "
                        "grouped = the CUDA grouped-expert kernel, dense = "
                        "every expert over every token; auto = grouped on "
                        "a card when the expert geometry allows it")
    p.add_argument("--metrics-interval", type=float, default=1.0,
                   help="seconds between load-metrics publications")
    p.add_argument("--health-port", type=int, default=0,
                   help="per-worker status server port (0 = ephemeral; "
                        "-1 disables): /live, /health, /metrics, "
                        "/debug/*")
    p.add_argument("--hbm-poll-interval", type=float, default=10.0,
                   help="seconds between device memory polls "
                        "(torch.cuda.mem_get_info; without a card the "
                        "process RSS).  0 disables the poller.")
    p.add_argument("--rpc-host", default="127.0.0.1",
                   help="bind + ADVERTISED host for this worker's RPC "
                        "server; cross-host deployments must set a "
                        "routable address")
    p.add_argument("--drain", choices=("on", "off"), default="on",
                   help="SIGTERM drain with live KV migration: leave "
                        "routing at once, hand each in-flight stream to a "
                        "peer with its sealed KV (migrate delta + pull), "
                        "linger for the peers' pulls, then exit.  'off' "
                        "waits every stream out instead.  The "
                        "control-plane key drain/<pid> (or "
                        "drain/instance/<id>) triggers the same drain")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="bound on each drain phase (stream handoff; peer "
                        "KV pulls): past it the worker exits anyway, and "
                        "peers fall back to re-prefill")
    p.add_argument("--drain-linger-s", type=float, default=1.0,
                   help="grace after the last stream handoff for peers to "
                        "open their KV pulls before the worker waits for "
                        "zero active streams")
    tracing.add_trace_args(p)
    slo.add_slo_args(p)
    flight_recorder.add_flight_args(p)
    ledger.add_ledger_args(p)
    device_profiler.add_device_profiler_args(p)
    apply_to_parser_defaults(p, load_layered_config(
        {"control_plane": None, "namespace": "dynamo",
         "component": "backend", "endpoint": "generate",
         "model_name": "dynamo-tpu", "num_blocks": 512, "block_size": 64,
         "metrics_interval": 1.0},
        section="worker"))
    args = p.parse_args(argv)
    if not args.control_plane:
        p.error("--control-plane is required (flag, DYN_CONTROL_PLANE, "
                "or dynamo.toml)")
    if args.mocker and args.role != "both":
        # The mocker has no KV bytes to serve or pull: a disagg role
        # would silently serve aggregated.
        p.error(f"--role {args.role} requires a real engine (the mocker "
                "has no KV data plane); drop --role or --mocker")
    return args


def load_kernels(core: EngineCore) -> None:
    """Build (or reuse) and load the CUDA libraries this engine's path
    launches, so a kernel that cannot build or load stops the worker at
    start instead of failing its first request."""
    if core.device.type != "cuda":
        return
    from dynamo_tpu_torch.ops.cuda import build

    names = ["paged_decode", "paged_prefill"]
    if core.moe_mode == "grouped":
        names.append("moe_grouped")
    for name in names:
        build.load(name)


def build_engine(args, kv_event_sink):
    """(core, engine, card fields) for the flags; the engine is not
    started yet."""
    cfg, params, spec, template = resolve_model(
        args.model, device=args.device, num_layers=args.num_layers)
    sched = SchedulerConfig(block_size=args.block_size,
                            max_prefill_chunk=args.max_prefill_chunk)
    core = EngineCore(EngineConfig(
        model=cfg, num_blocks=args.num_blocks, scheduler=sched,
        device=args.device, moe_mode=args.moe_mode,
        kv_quant=args.kv_quant, speculative_tokens=args.spec_decode,
        speculative_ngram=args.spec_ngram), params=params,
        kv_event_sink=kv_event_sink)
    load_kernels(core)
    card_fields = {
        # A checkpoint's tokenizer.json rides the card inline, with its
        # template and eos: a remote frontend serves them.
        "tokenizer_spec": spec,
        "chat_template": template,
        "max_context": min(cfg.max_context,
                           sched.max_pages_per_seq * sched.block_size),
    }
    return core, InferenceEngine(core), card_fields


def derive_slice_spec(core: Optional[EngineCore], role: str = "both",
                      fabric: str = "") -> SliceSpec:
    """The SliceSpec this worker publishes in its instance record: one
    device, its role, KV mode and serving features, the device's memory
    (0 on the CPU: unknown) and its device-transfer fabric.  A mocker
    (no core) publishes a bare slice."""
    if core is None:
        return SliceSpec(role=role)
    hbm = 0
    if core.device.type == "cuda":
        import torch

        hbm = int(torch.cuda.get_device_properties(core.device).total_memory)
    # Speculative decode takes the place of the decode windows.
    decode = ("spec" if core.config.speculative_tokens > 0
              else f"window{DECODE_WINDOW}")
    return SliceSpec(role=role, kv_quant=core.cache_cfg.kv_quant,
                     features=("packed_prefill", decode),
                     hbm_per_chip_bytes=hbm, fabric=fabric)


def data_plane_stats_hooks(core: EngineCore, plane, fetcher, disagg):
    """The worker's `/debug/stats` and reset hooks: the engine's (see
    `frontend.main.stats_hooks`) plus the data plane's counters."""
    stats, reset = stats_hooks(core)
    manager = getattr(core.allocator, "manager", None)

    def worker_stats() -> dict:
        out = stats()
        out.update(
            onboarded_blocks=(manager.onboarded_blocks if manager else 0),
            plane_counts=dt.plane_counts_by_plane(),
            transfer_plane=plane.stats() if plane is not None else None,
            prefix_share=fetcher.stats() if fetcher is not None else None,
            # Streams a draining peer handed here, with the blocks pulled.
            migrated_in=({"streams": fetcher.migrated_in,
                          "blocks": fetcher.migrated_in_blocks}
                         if fetcher is not None else None),
            disagg=disagg.stats() if disagg is not None else None)
        return out

    def worker_reset() -> None:
        reset()
        dt.reset_plane_counts()
        if manager is not None:
            manager.onboarded_blocks = 0
        for part in (plane, fetcher, disagg):
            if part is not None:
                part.reset_stats()

    return worker_stats, worker_reset


@never_engine_thread
def worker_metrics_text(engine, recorder, watchdog,
                        kv_metrics: KvCacheMetrics, fetcher=None,
                        drainable=None) -> str:
    """The worker's engine series for `/metrics` (JAX's
    `worker_metrics_text`), sampled at scrape time from host counts —
    never on the engine thread.  A mocker `engine` has no core: its
    lines stop at the load, drain and heartbeat series, as in JAX."""
    core = getattr(engine, "core", None)
    m = engine.metrics
    ws, ks = m.worker_stats, m.kv_stats
    lines = [
        f"dynamo_worker_request_active_slots {ws.request_active_slots}",
        f"dynamo_worker_requests_waiting {ws.num_requests_waiting}",
        f"dynamo_worker_kv_active_blocks {ks.kv_active_blocks}",
        f"dynamo_worker_kv_usage {ks.gpu_cache_usage_perc}",
        "dynamo_worker_kv_prefix_cache_hit_rate "
        f"{ks.gpu_prefix_cache_hit_rate}",
    ]
    if m.expert_load:
        for e, n in enumerate(m.expert_load):
            lines.append(f'dynamo_moe_expert_load{{expert="{e}"}} {n}')
        lines.append(f"dynamo_moe_dropped_tokens_total {m.moe_dropped_tokens}")
    if core is not None:
        for k, v in core.counters.to_dict().items():
            lines.append(f"dynamo_worker_engine_{k} {v}")
    age = recorder.last_step_age_s()
    if age is not None:
        lines.append(f"dynamo_engine_last_step_age_seconds {age:.3f}")
    lines.append(f"dynamo_engine_stalls_total {recorder.stalls}")
    lines.append("dynamo_engine_stalled "
                 f"{1 if watchdog is not None and watchdog.stalled else 0}")
    # Elasticity and QoS plane: `dynamo top`'s QOS/DRN column and the
    # fleet checks read these.
    if drainable is not None:
        lines.append("dynamo_requests_migrated_total "
                     f"{drainable.migrated_out}")
        lines.append("dynamo_worker_draining "
                     f"{1 if drainable.draining else 0}")
    if core is not None:
        lines.append("dynamo_qos_preemptions_total "
                     f"{core.scheduler.qos_preemptions}")
        lines.append("dynamo_qos_demoted_blocks_total "
                     f"{core.qos_demoted_blocks}")
    if fetcher is not None:
        lines.append("dynamo_requests_migrated_in_total "
                     f"{fetcher.migrated_in}")
    # Memory-plane sample: pool occupancy / evictions / prefix hits land
    # in the shared registry.
    if core is not None:
        kv_metrics.observe_engine(core)
    if fetcher is not None:
        kv_metrics.observe_prefix_share(fetcher)
    kv_metrics.observe_transfer_plane()
    # Device-truth plane: fold the modeled counters against the program
    # registry and the measured window time, then export both.
    prof = device_profiler.get_profiler()
    if prof.enabled:
        if core is not None:
            prof.audit_engine(core)
        lines.extend(prof.metrics_lines())
    return "\n".join(lines) + "\n"


async def watch_profile_commands(cp, instance_id: int) -> None:
    """The control-plane `profile` command: a put under profile/<pid> or
    profile/instance/<id> runs one bounded device capture on this worker
    (value: capture ms, default 500), in a thread while serving goes on.
    Loops: one worker serves many captures."""
    mine = {device_profiler.profile_key_pid(os.getpid()),
            device_profiler.profile_key_instance(instance_id)}
    prof = device_profiler.get_profiler()
    try:
        watch = await cp.watch_prefix(device_profiler.PROFILE_PREFIX)
        async for ev in watch:
            if ev.kind != "put" or ev.key not in mine:
                continue
            try:
                ms = int(ev.value)
            except (TypeError, ValueError):
                ms = 500
            logger.warning("control-plane profile command: %s (%d ms)",
                           ev.key, ms)
            res = await asyncio.to_thread(prof.capture, ms)
            logger.warning("device capture result: %s",
                           {k: res.get(k) for k in ("ok", "dir", "error")})
    except ConnectionError:
        return  # the control plane is gone: /debug/deviceprofile remains


async def run_encode(args, cp, runtime) -> None:
    """The encode role: the vision tower behind `encoder/encode`, its
    embeddings offered on this process's device plane."""
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.llm.multimodal import EncodeWorker, StubVisionEncoder
    from dynamo_tpu_torch.models.loader import resolve_config

    hidden = resolve_config(args.model).hidden_size
    plane = dt.KvTransferPlane(device=resolve_device(args.device))
    plane.start()
    worker = EncodeWorker(StubVisionEncoder(hidden), transfer_plane=plane)
    endpoint = (runtime.namespace(args.namespace)
                .component("encoder").endpoint("encode"))
    instance = await endpoint.serve(worker.make_handler())
    print(f"encode worker instance {instance.instance_id} at "
          f"{instance.address} (hidden {hidden}, transfer "
          f"{plane.transport_kind})", flush=True)
    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_ev.set)
    await stop_ev.wait()
    await endpoint.leave()
    plane.stop()
    await runtime.shutdown()
    await cp.close()


async def run(args) -> None:
    service = f"worker-{args.component}"
    tracing.configure_from_args(args, service=service)
    # The worker's black box, configured before anything serves so that
    # startup builds and first dispatches land in the ring; the crash
    # triggers (faulthandler, atexit, SIGUSR2) armed on the main thread.
    recorder = flight_recorder.configure_from_args(args, service=service)
    recorder.install_crash_dump()
    # The device profiler is live before the engine builds: first-seen
    # shapes record their modeled cost exactly once.
    device_profiler.configure_from_args(args, service=service)
    ledger.configure_from_args(args)
    cp = ControlPlaneClient(*_split(args.control_plane))
    await cp.start()
    runtime = DistributedRuntime(cp, rpc_host=args.rpc_host)
    if args.role == "encode":
        await run_encode(args, cp, runtime)
        return
    # Prefill workers live under a component of their own, so the
    # frontends' model clients (which watch the decode endpoint's
    # instances) never route chats to them.
    component = (f"{args.component}-prefill" if args.role == "prefill"
                 else args.component)
    endpoint = (runtime.namespace(args.namespace)
                .component(component).endpoint(args.endpoint))

    loop = asyncio.get_running_loop()
    pending_events: list = []

    def kv_event_sink(event):
        # The engine thread emits; hop onto the loop for the publish.
        loop.call_soon_threadsafe(pending_events.append, event)

    # The worker's registry: RequestMetrics at the RPC boundary (and the
    # disagg onboard), the memory plane, the SLO gauges.
    registry = MetricsRegistry()
    request_metrics = RequestMetrics(registry)
    kv_metrics = KvCacheMetrics(registry)
    slo_monitor = slo.monitor_from_args(args, request_metrics,
                                        registry=registry)
    if slo_monitor is not None:
        slo_monitor.start(interval=args.slo_tick)

    core = plane = fetcher = disagg = watchdog = None
    if args.mocker:
        from dynamo_tpu_torch.llm.mocker import MockEngine, MockEngineArgs

        engine = MockEngine(
            MockEngineArgs(block_size=args.block_size,
                           speedup_ratio=args.speedup_ratio),
            kv_event_sink=kv_event_sink)
        await engine.start()
        serve_client = engine
        card_fields = {}
    else:
        # A prefill worker's blocks are pulled by request, never routed
        # to: it publishes no KV events.
        core, engine, card_fields = build_engine(
            args, None if args.role == "prefill" else kv_event_sink)
        await engine.start()
        # Stall watchdog: no step heartbeat for --watchdog-stall-s while
        # work is pending is a stall (event, counter, dump).
        if args.watchdog_stall_s > 0:
            watchdog = flight_recorder.StallWatchdog(
                recorder, lambda: core.has_work,
                stall_s=args.watchdog_stall_s)
            watchdog.start()
        # The KV data plane: every worker serves its blocks.
        plane = dt.KvTransferPlane(engine)
        plane.start()
        runtime.rpc.register(KV_BLOCKS_ENDPOINT,
                             make_kv_blocks_handler(engine))
        runtime.rpc.register(dt.KV_OFFER_ENDPOINT,
                             plane.make_offer_handler())
        runtime.rpc.register(dt.KV_PULLED_ENDPOINT,
                             plane.make_pulled_handler())
        # Admin and embeddings endpoints (a frontend's clear reaches the
        # prefill workers too).
        local = LocalEngineClient(engine)
        runtime.rpc.register(EMBED_ENDPOINT, embed_wire_handler(local))
        runtime.rpc.register(CLEAR_KV_ENDPOINT,
                             clear_kv_wire_handler(local))
        logger.info("device transfer plane on %s (%s)", plane.address,
                    plane.transport_kind)

        # Fleet prefix reuse, innermost: on a decode worker the pull runs
        # after a remote-prefill onboard, whose blocks are then resident.
        serve_client = local
        if not args.no_prefix_share:
            fetcher = PrefixFetcher(engine, runtime.client_for,
                                    args.block_size, plane=plane)
            serve_client = PrefixShareClient(serve_client, fetcher)
        if args.role == "decode":
            if args.max_local_prefill is not None:
                await cp.put(disagg_config_key(args.namespace),
                             {"max_local_prefill_length":
                              args.max_local_prefill})
            disagg = DisaggDecodeClient(
                serve_client, engine, cp, args.namespace, args.block_size,
                transfer_plane=plane, request_metrics=request_metrics,
                eager=not args.no_eager_kv)
            await disagg.start()
            serve_client = disagg
        if slo_monitor is not None:
            # SLO-aware eviction and the QoS lever: while the error
            # budget burns, hot prefix blocks resist eviction, and
            # best-effort admissions hold while running best-effort
            # requests are shed (the monitor's cheap last_max_burn).
            manager = getattr(core.allocator, "manager", None)
            if manager is not None:
                manager.set_eviction_bias(slo_eviction_bias(
                    lambda: slo_monitor.last_max_burn))
            core.scheduler.qos_pressure_fn = (
                lambda: slo_monitor.last_max_burn)

    # The drain wrapper is the outermost serving stage, so a drain
    # cancels the whole chain beneath it and ends each wire stream with
    # the KV-carrying migrate delta.
    drainable = DrainableService(serve_client, block_size=args.block_size)
    slice_spec = derive_slice_spec(core, args.role,
                                   plane.fabric if plane is not None else "")
    instance = await endpoint.serve(
        engine_wire_handler(drainable, request_metrics=request_metrics),
        metadata={"slice": slice_spec.to_dict()})
    if plane is not None:
        # Peers pull the handed-off KV from this worker's kv_blocks
        # endpoint: the instance address is the donor descriptor.
        drainable.kv_address = instance.address
    prefill_task = None
    if args.role == "prefill":
        prefill_task = asyncio.create_task(prefill_worker_loop(
            cp, args.namespace, local, instance.address))
    else:
        card = ModelDeploymentCard(name=args.model_name,
                                   kv_block_size=args.block_size,
                                   **card_fields)
        await register_llm(endpoint, instance, card)
    status = None
    hbm_poller = None
    status_reg_task = None
    if args.health_port >= 0:
        from dynamo_tpu_torch.runtime.status import (
            StatusServer,
            register_status_endpoint_task,
        )

        stats = reset_stats = None
        if core is not None:
            stats, reset_stats = data_plane_stats_hooks(core, plane,
                                                        fetcher, disagg)
        status = StatusServer(
            registry=registry,
            extra_text_fn=lambda: worker_metrics_text(
                engine, recorder, watchdog, kv_metrics, fetcher,
                drainable),
            slo_fn=(slo_monitor.payload if slo_monitor is not None
                    else None),
            stats_fn=stats, reset_fn=reset_stats)
        hport = await status.start(host=args.rpc_host,
                                   port=args.health_port)
        # Fleet discovery: the metrics aggregator scrapes it, the planner
        # and `dynamo top` read it (retried: a control plane mid-restart
        # must not crash the worker).
        status_reg_task = register_status_endpoint_task(
            cp, f"worker-{args.role}", hport, host=args.rpc_host,
            extra={"mesh": slice_spec.describe(),
                   "slice": slice_spec.to_dict()})
        if args.hbm_poll_interval > 0 and core is not None:
            cards = None
            if core.device.type != "cuda":
                cards = []   # no card: the host fallback
            elif core.device.index is not None:
                cards = [core.device.index]
            hbm_poller = HbmPoller(kv_metrics,
                                   interval=args.hbm_poll_interval,
                                   devices=cards)
            hbm_poller.start()
        print(f"worker status server on :{hport}", flush=True)
    serving = ("the prefill queue" if args.role == "prefill"
               else repr(args.model_name))
    backend = ("mocker" if core is None else
               f"{args.model}, role {args.role}, on {core.device}, kv_quant "
               f"{core.cache_cfg.kv_quant}, transfer {plane.transport_kind}")
    print(f"worker instance {instance.instance_id} serving {serving} "
          f"({backend}) at {instance.address}", flush=True)

    async def pump_events():
        while True:
            await asyncio.sleep(0.02)
            while pending_events:
                ev = pending_events.pop(0)
                await cp.publish(KV_EVENTS_SUBJECT, RouterEvent(
                    worker_id=instance.instance_id, event=ev).to_dict())

    async def pump_metrics():
        while True:
            await asyncio.sleep(args.metrics_interval)
            await cp.publish(METRICS_SUBJECT, {
                "worker_id": instance.instance_id,
                "metrics": engine.metrics.to_dict()})

    pumps = [asyncio.create_task(pump_events()),
             asyncio.create_task(pump_metrics())]
    if device_profiler.get_profiler().enabled:
        pumps.append(asyncio.create_task(
            watch_profile_commands(cp, instance.instance_id)))
    stop_ev = asyncio.Event()
    drain_started = [False]

    async def start_drain(reason: str) -> None:
        """Planned drain: leave routing, hand every in-flight stream to a
        peer with its KV, linger for the peers' pulls, then let the
        normal shutdown run.  Idempotent: a SIGTERM racing a
        control-plane command drains once."""
        if drain_started[0]:
            return
        drain_started[0] = True
        try:
            logger.warning("drain (%s): leaving routing, handing off %d "
                           "in-flight stream(s)", reason,
                           drainable.active_requests)
            await endpoint.leave()      # instant removal from routing
            await drainable.drain(args.drain_timeout_s)
            if drainable.migrated_out and plane is not None:
                # The handed-off KV moves only if the peers' pulls get to
                # run: give them a beat to open their streams, then wait
                # (bounded) until the RPC plane goes quiet.
                await asyncio.sleep(max(0.0, args.drain_linger_s))
                deadline = loop.time() + max(0.0, args.drain_timeout_s)
                while (runtime.rpc.active_streams > 0
                       and loop.time() < deadline):
                    await asyncio.sleep(0.05)
            logger.info("drain complete: %d stream(s) migrated out",
                        drainable.migrated_out)
        except Exception:
            # A drain that trips over a dead control plane must still end
            # the worker, or every later SIGTERM would be inert.
            logger.exception("drain (%s) failed; shutting down anyway",
                             reason)
        finally:
            stop_ev.set()

    def on_sigterm():
        if args.drain == "off":
            stop_ev.set()
        else:
            asyncio.ensure_future(start_drain("sigterm"))

    loop.add_signal_handler(signal.SIGINT, stop_ev.set)
    loop.add_signal_handler(signal.SIGTERM, on_sigterm)
    if args.drain != "off":
        pumps.append(asyncio.create_task(watch_drain_commands(
            cp, instance.instance_id, start_drain)))
    await stop_ev.wait()

    # Leave routing at once, then let in-flight streams finish (bounded;
    # already done when a drain ran).
    await endpoint.leave()
    if prefill_task is not None:
        prefill_task.cancel()
    deadline = loop.time() + max(5.0, args.drain_timeout_s
                                 if args.drain != "off" else STREAM_DRAIN_S)
    while runtime.rpc.active_streams > 0 and loop.time() < deadline:
        await asyncio.sleep(0.05)
    if status_reg_task is not None:
        pumps.append(status_reg_task)
    for t in pumps + ([prefill_task] if prefill_task else []):
        t.cancel()
    await asyncio.gather(*pumps, *([prefill_task] if prefill_task else []),
                         return_exceptions=True)
    if disagg is not None:
        await disagg.stop()
    if status is not None:
        await status.stop()
    if hbm_poller is not None:
        hbm_poller.stop()
    if watchdog is not None:
        watchdog.stop()
    if slo_monitor is not None:
        await slo_monitor.stop()
    if plane is not None:
        plane.stop()
    await engine.stop()
    await runtime.shutdown()
    await cp.close()


async def watch_drain_commands(cp, instance_id: int, start_drain) -> None:
    """The control-plane `drain` command: a put under drain/<pid> or
    drain/instance/<id> drains this worker exactly as SIGTERM does (the
    operator and planner surface where signals do not reach)."""
    mine = {drain_key_pid(os.getpid()), drain_key_instance(instance_id)}
    try:
        watch = await cp.watch_prefix(DRAIN_PREFIX)
        async for ev in watch:
            if ev.kind == "put" and ev.key in mine:
                logger.warning("control-plane drain command: %s", ev.key)
                await start_drain("control_plane")
                return
    except ConnectionError:
        return  # the control plane is gone: SIGTERM still drains


def _split(addr: str):
    host, port = addr.rsplit(":", 1)
    return host, int(port)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(parse_args(argv)))
