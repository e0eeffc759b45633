"""`python -m dynamo_tpu_torch.control_plane_service` — the control plane
as a standalone, supervisable OS process (port of
`dynamo_tpu/control_plane_service/`).

Role of the reference's external etcd+NATS pair : a
deployment's discovery/queue/pub-sub broker that the launcher (or any
supervisor) can restart independently of workers.  With `--store
file:PATH`, unleased config and work-queue items survive kill -9
(runtime/kv_store.FileBackend + ControlPlaneState queue restore);
workers re-register through ControlPlaneClient's session-loss replay
(runtime/distributed.Endpoint).

    python -m dynamo_tpu_torch.control_plane_service --port 7411 \
        --store file:/var/lib/dynamo/cp.json
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

logger = logging.getLogger("dynamo_tpu_torch.control_plane_service")


def parse_args(argv=None):
    p = argparse.ArgumentParser("dynamo_tpu_torch.control_plane_service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 picks an ephemeral port (printed on stdout)")
    p.add_argument("--store", default=None,
                   help="persistence backend, e.g. file:/path/cp.json "
                        "(default: in-memory)")
    return p.parse_args(argv)


async def run(args) -> None:
    from dynamo_tpu_torch.runtime.control_plane import ControlPlaneState
    from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneServer
    from dynamo_tpu_torch.runtime.kv_store import make_backend

    server = ControlPlaneServer(
        ControlPlaneState(backend=make_backend(args.store)))
    port = await server.start(args.host, args.port)
    print(f"control plane serving on {args.host}:{port}", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(parse_args(argv)))
