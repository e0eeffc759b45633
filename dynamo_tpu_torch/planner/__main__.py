"""CLI entry: `python -m dynamo_tpu_torch.planner` (port of
`dynamo_tpu/planner/__main__.py`).

    python -m dynamo_tpu_torch.planner --control-plane HOST:PORT \
        --min-replicas 1 --max-replicas 2 -- --model llama-3-1b
    python -m dynamo_tpu_torch.planner --control-plane HOST:PORT \
        --min-replicas 1 --max-replicas 4 -- --mocker --model-name m
    python -m dynamo_tpu_torch.planner --control-plane HOST:PORT \
        --mode sla --profile p.json --metrics-url http://FE/metrics \
        -- --model llama-3-1b

Everything after `--` is passed to each spawned worker (on the card
unless it says `--device cpu`)."""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from dynamo_tpu_torch.planner import LoadPlanner, LocalConnector, PlannerConfig
from dynamo_tpu_torch.runtime.control_plane_tcp import (
    STARTUP_WAIT_S, ControlPlaneClient)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dynamo_tpu_torch.planner")
    p.add_argument("--control-plane", required=True, help="HOST:PORT")
    p.add_argument("--mode", choices=("load", "sla"), default="load")
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=8)
    p.add_argument("--kv-high", type=float, default=0.8)
    p.add_argument("--kv-low", type=float, default=0.3)
    p.add_argument("--adjustment-interval", type=float, default=5.0)
    # SLA mode (reference planner_sla.py): profile + targets + the
    # frontend exposition to scrape.
    p.add_argument("--profile", default=None,
                   help="sla: profile JSON from dynamo_tpu_torch.planner.profiler")
    p.add_argument("--ttft", type=float, default=0.5,
                   help="sla: target time-to-first-token (s)")
    p.add_argument("--itl", type=float, default=0.05,
                   help="sla: target inter-token latency (s)")
    p.add_argument("--metrics-url", default=None,
                   help="sla: frontend /metrics URL to observe")
    p.add_argument("--slo-url", default=None,
                   help="load mode: a /debug/slo URL (frontend or "
                        "worker) whose burn rate biases scale-up "
                        "(runtime/slo.py)")
    p.add_argument("--slo-burn-scale-up", type=float, default=2.0,
                   help="fast-window burn rate at or above which the "
                        "load planner scales up regardless of KV usage")
    p.add_argument("--prefill-worker-args", default=None,
                   help="sla: comma-joined args for the prefill pool "
                        "(omit for aggregated deployments)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="status server port for /metrics "
                        "(0 = ephemeral; -1 disables)")
    p.add_argument("--metrics-host", default="127.0.0.1",
                   help="bind + ADVERTISED host for the status server; a "
                        "cross-host aggregator needs a routable address "
                        "(the 127.0.0.1 default only works single-host)")
    p.add_argument("worker_args", nargs="*",
                   help="args after -- go to spawned workers")
    from dynamo_tpu_torch.runtime.tracing import (
        add_trace_args, configure_from_args)

    add_trace_args(p)
    args = p.parse_args(argv)
    if args.mode == "sla" and (not args.profile or not args.metrics_url):
        p.error("--mode sla needs --profile and --metrics-url")
    logging.basicConfig(level=logging.INFO)
    configure_from_args(args, service="planner")

    async def run():
        host, port = args.control_plane.rsplit(":", 1)
        cp = ControlPlaneClient(host, int(port))
        await cp.start(wait_s=STARTUP_WAIT_S)
        connector = LocalConnector(args.control_plane,
                                   worker_args=args.worker_args)
        if args.mode == "sla":
            from dynamo_tpu_torch.planner import (
                PrometheusScraper, SlaPlanner, SlaPlannerConfig)
            from dynamo_tpu_torch.planner.interpolation import load_profile

            prefill_connector = None
            if args.prefill_worker_args is not None:
                prefill_connector = LocalConnector(
                    args.control_plane,
                    worker_args=args.prefill_worker_args.split(","))
            planner = SlaPlanner(
                load_profile(args.profile),
                PrometheusScraper(args.metrics_url).observe,
                decode_connector=connector,
                prefill_connector=prefill_connector,
                config=SlaPlannerConfig(
                    ttft_s=args.ttft, itl_s=args.itl,
                    adjustment_interval_s=args.adjustment_interval,
                    min_replicas=args.min_replicas,
                    max_replicas=args.max_replicas))
        else:
            planner = LoadPlanner(cp, connector, PlannerConfig(
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                kv_high=args.kv_high, kv_low=args.kv_low,
                adjustment_interval=args.adjustment_interval,
                slo_burn_scale_up=args.slo_burn_scale_up),
                slo_url=args.slo_url)
        await planner.start()
        status = None
        if args.metrics_port >= 0:
            from dynamo_tpu_torch.planner.core import planner_metrics_text
            from dynamo_tpu_torch.runtime.status import (
                StatusServer, register_status_endpoint)

            status = StatusServer(
                extra_text_fn=lambda: planner_metrics_text(planner,
                                                           connector))
            bound = await status.start(host=args.metrics_host,
                                       port=args.metrics_port)
            await register_status_endpoint(cp, "planner", bound,
                                           host=args.metrics_host)
            print(f"planner metrics on :{bound}/metrics", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        if status is not None:
            await status.stop()
        await planner.stop()
        await connector.shutdown()
        pc = getattr(planner, "prefill_connector", None)
        if pc is not None:
            await pc.shutdown()
        await cp.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
