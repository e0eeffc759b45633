"""CLI entry: `python -m dynamo_tpu_torch.metrics_aggregator` (port of
`dynamo_tpu/metrics_aggregator/__main__.py`)."""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from dynamo_tpu_torch.metrics_aggregator import serve
from dynamo_tpu_torch.runtime.control_plane_tcp import (
    STARTUP_WAIT_S, ControlPlaneClient)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dynamo_tpu_torch.metrics_aggregator")
    p.add_argument("--control-plane", required=True, help="HOST:PORT")
    p.add_argument("--http-host", default="127.0.0.1")
    p.add_argument("--http-port", type=int, default=8081)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    async def run():
        host, port = args.control_plane.rsplit(":", 1)
        cp = ControlPlaneClient(host, int(port))
        await cp.start(wait_s=STARTUP_WAIT_S)
        agg, server, bound = await serve(cp, args.http_host, args.http_port)
        print(f"metrics aggregator serving :{bound}/metrics", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await agg.stop()
        await server.stop()
        await cp.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
