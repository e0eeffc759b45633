"""`python -m dynamo_tpu_torch.frontend` — OpenAI ingress, with the engine
in the same process or on workers found through the control plane (port
of `dynamo_tpu/frontend/main.py`: single-process engine mode and the
distributed mode).

    python -m dynamo_tpu_torch.frontend --model llama-3-1b --model-name m \\
        --http-port 8080 [--device cpu] [--num-blocks N --block-size 64]
    python -m dynamo_tpu_torch.frontend --model mixtral-8x7b --num-layers 16 \\
        [--moe-mode auto|dense|grouped]
    python -m dynamo_tpu_torch.frontend --model llama-3-1b --kv-quant int8
    python -m dynamo_tpu_torch.frontend --model llama-3-1b --sp 4 \
        [--max-prefill-chunk 512]

Runs on the card unless `--device cpu` is given; random weights from
seed 0 (`EngineConfig.seed`); the byte tokenizer; the prefix cache on,
as the JAX worker runs it.  `--sp N` prefills whole prompts of 256
tokens or more over a ring of N ranks, spread over the visible cards
(several ranks share a card when there are fewer cards than ranks); the
rank -> card map is logged at start and shown by `/debug/stats`.

Distributed mode (`--control-plane HOST:PORT`, or `--serve-control-plane`
to host the control plane in this process too) builds no engine: a
ModelWatcher registers each model as `dynamo_tpu_torch.worker` processes
announce it, behind migration (`--migration-limit`) and a router
(`--router-mode random | round_robin | kv`; kv routes by the prefix
overlap the workers' KV events report and their load):

    python -m dynamo_tpu_torch.frontend --serve-control-plane \\
        --router-mode kv --http-port 8080
    python -m dynamo_tpu_torch.worker --control-plane 127.0.0.1:4222 \\
        --model llama-3-1b --model-name m

Its `/debug/stats` reports the frontend-side per-request timings; each
worker's `--health-port` serves its engine's stats.

Observability, with JAX's flags: `--trace [--trace-sample R
--trace-slow-ms MS --trace-ring N --trace-slow-log PATH]` (spans in
`/debug/traces`), `--slo-ttft-p99 S` / `--slo-tpot-p99 S` /
`--slo-error-rate F` (burn rates in `/debug/slo` and `dynamo_slo_*`),
`--flight-recorder on|off --flight-ring N --flight-dump-dir DIR` (the
ring in `/debug/flightrecorder`, JSONL dumps on SLO PAGE, slow requests,
SIGUSR2 and exit) and `--request-ledger on|off` (`/debug/requests`,
`dynamo_request_phase_seconds`, the goodput pair); `/metrics` serves
them all.  The single-process frontend's engine keeps its device
profiler off (workers take `--device-profiler`).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import signal
from typing import Optional

from dynamo_tpu_torch.engine.engine import (
    EngineConfig,
    EngineCore,
    InferenceEngine,
)
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.kv_router.protocols import SpecDecodeStats
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.service import LocalEngineClient, ModelHandle, ModelManager
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops import cuda as kernels
from dynamo_tpu_torch.runtime import flight_recorder, ledger, slo, tracing
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

logger = logging.getLogger("dynamo_tpu_torch.frontend")


def parse_args(argv=None):
    p = argparse.ArgumentParser("dynamo_tpu_torch.frontend")
    p.add_argument("--http-host", default="127.0.0.1")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--control-plane", default=None,
                   help="control plane HOST:PORT: discover models from "
                        "registered workers instead of building an engine")
    p.add_argument("--serve-control-plane", action="store_true",
                   help="host the control plane in this process (and "
                        "discover models through it)")
    p.add_argument("--control-plane-port", type=int, default=4222)
    p.add_argument("--control-plane-store", default=None,
                   help="control-plane persistence for unleased keys: "
                        "memory (default) or file:PATH")
    p.add_argument("--router-mode", default="round_robin",
                   choices=("random", "round_robin", "kv"))
    p.add_argument("--migration-limit", type=int, default=3)
    p.add_argument("--model", default="llama-3-1b",
                   help="model preset (e.g. llama-3-1b, tiny-test)")
    p.add_argument("--model-name", default="dynamo-tpu",
                   help="name the model is served under")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--num-blocks", type=int, default=512)
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=None,
                   help="keep the first N decoder layers of the preset "
                        "(default: all).  For a model that one card cannot "
                        "hold whole, e.g. mixtral-8x7b (94 GB of bf16 "
                        "weights at 32 layers); a checkpoint's "
                        "num_hidden_layers plays this part for the JAX "
                        "worker")
    p.add_argument("--moe-mode", default="auto",
                   choices=("auto", "dense", "grouped"),
                   help="MoE expert compute: grouped = the CUDA grouped-"
                        "expert kernel, dense = every expert over every "
                        "token (the exact oracle); auto = grouped on a "
                        "card when the expert geometry allows it")
    p.add_argument("--kv-quant", default="none", choices=("none", "int8"),
                   help="KV cache storage: int8 pages with per-token, "
                        "per-head f32 scales (about half the bytes a "
                        "decode step reads), or the model dtype")
    p.add_argument("--max-prefill-chunk", type=int, default=512,
                   help="chunked-prefill step ceiling (tokens); a longer "
                        "prompt prefills in several steps")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree: whole-prompt prefills "
                        "past the engine's threshold run ring attention "
                        "over N ranks (the long-context prefill path); "
                        "decode stays on the first card")
    tracing.add_trace_args(p)
    slo.add_slo_args(p)
    flight_recorder.add_flight_args(p)
    ledger.add_ledger_args(p)
    return p.parse_args(argv)


def model_config(args):
    """The preset, cut to `--num-layers` when given."""
    cfg = get_config(args.model)
    n = args.num_layers
    if n is None:
        return cfg
    if not 1 <= n <= cfg.num_layers:
        raise ValueError(f"--num-layers {n} outside 1..{cfg.num_layers} "
                         f"for {cfg.name}")
    return cfg.replace(num_layers=n)


async def build_model_handle(args):
    """Returns (handle, engine core, shutdown coroutine)."""
    cfg = model_config(args)
    sched = SchedulerConfig(block_size=args.block_size,
                            max_prefill_chunk=args.max_prefill_chunk)
    core = EngineCore(EngineConfig(
        model=cfg, num_blocks=args.num_blocks, scheduler=sched,
        device=args.device, moe_mode=args.moe_mode, kv_quant=args.kv_quant,
        sp=args.sp))
    engine = InferenceEngine(core)
    await engine.start()
    tokenizer = ByteTokenizer()
    handle = ModelHandle(
        name=args.model_name, tokenizer=tokenizer,
        preprocessor=OpenAIPreprocessor(tokenizer),
        client=LocalEngineClient(engine),
        max_context=min(cfg.max_context,
                        sched.max_pages_per_seq * sched.block_size))
    return handle, core, engine.stop


def spec_decode_stats(core: EngineCore) -> Optional[dict]:
    """Speculative decode's draft counts and acceptance rate (accepted
    over drafted tokens), or None when it is off."""
    st = core.metrics.spec_decode_stats
    if st is None:
        return None
    out = dataclasses.asdict(st)
    out["k"] = core.config.speculative_tokens
    out["acceptance_rate"] = (st.num_accepted_tokens / st.num_drafts
                              if st.num_drafts else 0.0)
    return out


def stats_hooks(core: EngineCore):
    """The `/debug/stats` reply and the `/debug/stats/reset` action over
    one engine."""

    def stats() -> dict:
        load = core.snapshot_expert_load()
        return {"device": str(core.device),
                "kernels": kernels.launch_counts(),
                "counters": core.counters.as_dict(),
                "kv_quant": core.cache_cfg.kv_quant,
                # Ring prefill: the degree and the rank -> device map.
                "sp": core.config.sp,
                "sp_devices": (core.ring.describe() if core.ring is not None
                               else []),
                "prefix_cache": core.prefix_cache_stats(),
                "spec_decode": spec_decode_stats(core),
                "mixed_prefill": core.mixed_prefill_stats(),
                "moe_mode": core.moe_mode,
                # [E+1]: per-expert assignments, then the dropped ones.
                "expert_load": (None if load is None else
                                [int(x) for x in load]
                                + [core.moe_dropped_tokens])}

    def reset_stats() -> None:
        # Launch counts, engine counters, the expert load and the prefix
        # hit and miss tokens start one window together, so launches per
        # dispatch can be read off one /debug/stats reply.
        kernels.reset_launch_counts()
        core.reset_expert_load()
        core.reset_prefix_stats()
        # The cost calibration and the shapes seen are engine state, not
        # statistics: they carry over.
        core.counters.reset_counts()
        if core.metrics.spec_decode_stats is not None:
            core.metrics.spec_decode_stats = SpecDecodeStats()

    return stats, reset_stats


async def start_discovery(args, models: ModelManager, registry=None):
    """Distributed mode: watch the control plane's `models/` prefix and
    register each model's routed pipeline (the router's and migration's
    series on `registry`); returns the watcher and the shutdown
    coroutines, outermost first."""
    from dynamo_tpu_torch.llm.discovery import ModelWatcher
    from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneClient
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    host, _, port = args.control_plane.rpartition(":")
    cp = ControlPlaneClient(host, int(port))
    await cp.start()
    runtime = DistributedRuntime(cp)
    watcher = ModelWatcher(runtime, models, router_mode=args.router_mode,
                           migration_limit=args.migration_limit,
                           registry=registry)
    await watcher.start()
    return watcher, [watcher.stop, runtime.shutdown, cp.close]


async def run(args) -> None:
    tracing.configure_from_args(args, service="frontend")
    # The frontend's flight recorder holds SLO transitions and slow
    # requests; crash / SIGUSR2 / exit dumps armed here.
    flight_recorder.configure_from_args(
        args, service="frontend").install_crash_dump()
    ledger.configure_from_args(args)
    # One registry for the process: the HTTP series and the router's.
    registry = MetricsRegistry()
    shutdowns = []
    if args.serve_control_plane:
        from dynamo_tpu_torch.runtime.control_plane import ControlPlaneState
        from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneServer
        from dynamo_tpu_torch.runtime.kv_store import make_backend

        cp_server = ControlPlaneServer(ControlPlaneState(
            backend=make_backend(args.control_plane_store)))
        cp_port = await cp_server.start(port=args.control_plane_port)
        args.control_plane = args.control_plane or f"127.0.0.1:{cp_port}"
        print(f"control plane on 127.0.0.1:{cp_port}", flush=True)
        shutdowns.append(cp_server.stop)
    models = ModelManager()
    cp_client = None
    if args.control_plane:
        watcher, stops = await start_discovery(args, models, registry)
        cp_client = watcher.runtime.cp
        shutdowns[:0] = stops
        # Beside the request timings: the blocks the KV router indexes
        # per model and worker.
        svc = HttpService(models, stats=lambda: {
            "kv_index": watcher.kv_index_blocks()}, registry=registry)
        banner = (f"discovering models via {args.control_plane} (router "
                  f"{args.router_mode})")
    else:
        handle, core, shutdown = await build_model_handle(args)
        models.register(handle)
        shutdowns.append(shutdown)
        stats, reset_stats = stats_hooks(core)
        svc = HttpService(models, stats=stats, reset_stats=reset_stats,
                          registry=registry)
        cfg = core.config.model
        banner = (f"serving {handle.name!r} ({args.model}, {cfg.num_layers} "
                  f"layers, moe_mode {core.moe_mode}, kv_quant "
                  f"{core.cache_cfg.kv_quant}, on {core.device}"
                  + (f", sp {core.ring.sp} ranks on {core.ring.describe()}"
                     if core.ring is not None else "") + ")")
    # Goodput: the ledger sink judges requests by the SLO thresholds;
    # the monitor's PAGEs name the dominant ledger phase.
    svc.ledger_sink.slo_ttft = args.slo_ttft_p99
    svc.ledger_sink.slo_tpot = args.slo_tpot_p99
    svc.slo_monitor = slo.monitor_from_args(
        args, svc.request_metrics, registry=registry,
        attribution_fn=svc.ledger_sink.dominant_phase)
    if svc.slo_monitor is not None:
        svc.slo_monitor.start(interval=args.slo_tick)
        shutdowns.insert(0, svc.slo_monitor.stop)
    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_ev.set)
    try:
        port = await svc.start(args.http_host, args.http_port)
        if cp_client is not None:
            # Fleet discovery: the metrics aggregator, the planner and
            # `dynamo top` find this frontend under status_endpoints/ as
            # they find a worker (retried: a control plane mid-restart
            # must not crash the frontend).
            from dynamo_tpu_torch.runtime.status import (
                register_status_endpoint_task)

            adv_host = args.http_host
            if adv_host in ("0.0.0.0", "::", ""):
                logger.warning(
                    "--http-host %s is a wildcard bind; advertising "
                    "127.0.0.1 under status_endpoints/ — pass a routable "
                    "--http-host for cross-host scraping", adv_host)
                adv_host = "127.0.0.1"
            reg_task = register_status_endpoint_task(
                cp_client, "frontend", port, host=adv_host)
            shutdowns.insert(0, _cancel_coro(reg_task))
        print(f"dynamo_tpu_torch frontend {banner} on "
              f"http://{args.http_host}:{port}", flush=True)
        await stop_ev.wait()
    finally:
        await svc.stop()
        for shutdown in shutdowns:
            await shutdown()


def _cancel_coro(task):
    async def cancel():
        task.cancel()
    return cancel


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(parse_args(argv)))
