"""CLI entry: `python -m dynamo_tpu_torch.router_service`.

    python -m dynamo_tpu_torch.router_service --control-plane HOST:PORT \
        --model-name my-model
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from dynamo_tpu_torch.router_service import RouterService
from dynamo_tpu_torch.runtime.control_plane_tcp import (
    STARTUP_WAIT_S, ControlPlaneClient)
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dynamo_tpu_torch.router_service")
    p.add_argument("--control-plane", required=True, help="HOST:PORT")
    p.add_argument("--model-name", required=True)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="router")
    p.add_argument("--serve-as", default=None,
                   help="public name of the routed model "
                        "(default: <model-name>-routed)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="status server port for /metrics + /debug/traces "
                        "(0 = ephemeral; -1 disables)")
    p.add_argument("--metrics-host", default="127.0.0.1",
                   help="bind + ADVERTISED host for the status server; a "
                        "cross-host aggregator needs a routable address "
                        "(the 127.0.0.1 default only works single-host)")
    from dynamo_tpu_torch.runtime.tracing import (
        add_trace_args, configure_from_args)

    add_trace_args(p)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    configure_from_args(args, service="router")

    async def run():
        from dynamo_tpu_torch.runtime.status import (
            StatusServer, register_status_endpoint)

        host, port = args.control_plane.rsplit(":", 1)
        cp = ControlPlaneClient(host, int(port))
        await cp.start(wait_s=STARTUP_WAIT_S)
        runtime = DistributedRuntime(cp)
        svc = RouterService(runtime, args.model_name,
                            namespace=args.namespace,
                            component=args.component,
                            serve_as=args.serve_as)
        await svc.start()
        status = None
        if args.metrics_port >= 0:
            status = StatusServer(registry=svc.registry)
            bound = await status.start(host=args.metrics_host,
                                       port=args.metrics_port)
            await register_status_endpoint(cp, args.component, bound,
                                           host=args.metrics_host)
            print(f"router metrics on :{bound}/metrics", flush=True)
        print(f"router service for {args.model_name!r} at "
              f"{svc.instance.address}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        if status is not None:
            await status.stop()
        await svc.stop()
        await runtime.shutdown()
        await cp.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
