"""Graph spec parsing + process supervision (see package docstring; port
of `dynamo_tpu/launcher/launcher.py`).  The graph's `log_dir` defaults to
the temp directory."""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import sys
import tempfile
import time
import tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

VALID_RESTART = ("always", "on-failure", "never")


@dataclass
class ServiceSpec:
    name: str
    module: str
    args: List[str] = field(default_factory=list)
    replicas: int = 1
    restart: str = "on-failure"
    # Services whose args already include --control-plane keep theirs.
    inject_control_plane: bool = True

    def validate(self) -> None:
        if self.restart not in VALID_RESTART:
            raise ValueError(
                f"service {self.name}: restart={self.restart!r} "
                f"(valid: {VALID_RESTART})")
        if self.replicas < 0:
            raise ValueError(f"service {self.name}: replicas < 0")


@dataclass
class GraphSpec:
    namespace: str = "dynamo"
    control_plane: str = "127.0.0.1:0"
    serve_control_plane: bool = True
    kv_store: Optional[str] = None  # 'file:PATH' persists unleased config
    log_dir: str = field(default_factory=tempfile.gettempdir)
    services: List[ServiceSpec] = field(default_factory=list)


def load_graph(path: str) -> GraphSpec:
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    g = doc.get("graph", {})
    spec = GraphSpec(
        namespace=g.get("namespace", "dynamo"),
        control_plane=g.get("control_plane", "127.0.0.1:0"),
        serve_control_plane=bool(g.get("serve_control_plane", True)),
        kv_store=g.get("kv_store"),
        log_dir=g.get("log_dir", tempfile.gettempdir()),
    )
    for name, s in doc.get("services", {}).items():
        svc = ServiceSpec(
            name=name,
            module=s["module"],
            args=[str(a) for a in s.get("args", [])],
            replicas=int(s.get("replicas", 1)),
            restart=s.get("restart", "on-failure"),
            inject_control_plane=bool(s.get("inject_control_plane", True)),
        )
        svc.validate()
        spec.services.append(svc)
    if not spec.services:
        raise ValueError(f"{path}: no [services.*] tables")
    return spec


class _Replica:
    def __init__(self, svc: ServiceSpec, index: int, log_path: str) -> None:
        self.svc = svc
        self.index = index
        self.log_path = log_path
        self.proc: Optional[asyncio.subprocess.Process] = None
        self.restarts = 0
        self._backoff = 1.0

    @property
    def name(self) -> str:
        return f"{self.svc.name}[{self.index}]"


class Launcher:
    """Bring up the graph, supervise it, tear it down in reverse order."""

    def __init__(self, spec: GraphSpec,
                 env: Optional[dict] = None) -> None:
        self.spec = spec
        self.env = dict(env if env is not None else os.environ)
        self.cp_addr: Optional[str] = None
        self._cp_server = None
        self._replicas: List[_Replica] = []
        self._supervisors: List[asyncio.Task] = []
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> str:
        """Start control plane (if hosted) + every service; returns the
        control-plane address."""
        if self.spec.serve_control_plane:
            from dynamo_tpu_torch.runtime.control_plane import (
                ControlPlaneState,
            )
            from dynamo_tpu_torch.runtime.control_plane_tcp import (
                ControlPlaneServer,
            )
            from dynamo_tpu_torch.runtime.kv_store import make_backend

            host, _, port = self.spec.control_plane.partition(":")
            self._cp_server = ControlPlaneServer(ControlPlaneState(
                backend=make_backend(self.spec.kv_store)))
            bound = await self._cp_server.start(host or "127.0.0.1",
                                               int(port or 0))
            self.cp_addr = f"{host or '127.0.0.1'}:{bound}"
            logger.info("launcher: control plane on %s", self.cp_addr)
        else:
            self.cp_addr = self.spec.control_plane
        for svc in self.spec.services:
            for i in range(svc.replicas):
                rep = _Replica(svc, i, os.path.join(
                    self.spec.log_dir,
                    f"dynamo_graph_{os.getpid()}_{svc.name}_{i}.log"))
                self._replicas.append(rep)
                await self._spawn(rep)
                self._supervisors.append(
                    asyncio.create_task(self._supervise(rep)))
        return self.cp_addr

    async def stop(self) -> None:
        """Reverse-order graceful teardown (workers drain on SIGTERM)."""
        self._stopping = True
        for t in self._supervisors:
            t.cancel()
        for t in self._supervisors:
            try:
                await t
            except asyncio.CancelledError:
                pass
        for rep in reversed(self._replicas):
            await self._terminate(rep)
        if self._cp_server is not None:
            await self._cp_server.stop()

    # -- supervision -------------------------------------------------------

    async def _spawn(self, rep: _Replica) -> None:
        args = [sys.executable, "-m", rep.svc.module, *rep.svc.args]
        if (rep.svc.inject_control_plane
                and "--control-plane" not in rep.svc.args):
            args += ["--control-plane", self.cp_addr]
        log = open(rep.log_path, "ab")
        rep.proc = await asyncio.create_subprocess_exec(
            *args, stdout=log, stderr=log, env=self.env)
        log.close()
        logger.info("launcher: %s pid=%d (%s)", rep.name, rep.proc.pid,
                    " ".join(args[2:]))

    async def _supervise(self, rep: _Replica) -> None:
        while True:
            rc = await rep.proc.wait()
            if self._stopping:
                return
            policy = rep.svc.restart
            if policy == "never" or (policy == "on-failure" and rc == 0):
                logger.info("launcher: %s exited rc=%d (restart=%s); "
                            "leaving down", rep.name, rc, policy)
                return
            rep.restarts += 1
            logger.warning("launcher: %s exited rc=%d; restart #%d in "
                           "%.1fs", rep.name, rc, rep.restarts,
                           rep._backoff)
            await asyncio.sleep(rep._backoff)
            rep._backoff = min(rep._backoff * 2, 30.0)
            await self._spawn(rep)

    async def _terminate(self, rep: _Replica, timeout: float = 15.0) -> None:
        proc = rep.proc
        if proc is None or proc.returncode is not None:
            return
        logger.info("launcher: stopping %s pid=%d", rep.name, proc.pid)
        proc.terminate()  # workers drain gracefully on SIGTERM
        try:
            await asyncio.wait_for(proc.wait(), timeout)
        except asyncio.TimeoutError:
            logger.warning("launcher: %s ignored SIGTERM; killing",
                           rep.name)
            proc.kill()
            await proc.wait()

    # -- introspection -----------------------------------------------------

    def status(self) -> Dict[str, dict]:
        out = {}
        for rep in self._replicas:
            alive = rep.proc is not None and rep.proc.returncode is None
            out[rep.name] = {"alive": alive, "restarts": rep.restarts,
                             "log": rep.log_path}
        return out


def main(argv: Optional[list] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        "dynamo_tpu_torch.launcher",
        description="Bring up a declarative service graph "
                    "(the local DynamoGraphDeployment).")
    p.add_argument("graph", help="graph TOML path")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    spec = load_graph(args.graph)

    async def run():
        launcher = Launcher(spec)
        addr = await launcher.start()
        print(f"graph up: control plane {addr}; services: "
              f"{[s.name for s in spec.services]}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        t0 = time.monotonic()
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=30.0)
            except asyncio.TimeoutError:
                up = sum(1 for s in launcher.status().values()
                         if s["alive"])
                logger.info("graph: %d/%d replicas up (%.0fs)", up,
                            len(launcher.status()),
                            time.monotonic() - t0)
        await launcher.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
