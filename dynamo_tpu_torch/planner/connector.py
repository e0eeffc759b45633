"""Connectors: converge the actual worker set to the planner's target
(port of `dynamo_tpu/planner/connector.py`).

Reference analogs: `kubernetes_connector.py:172` patches the
DynamoGraphDeployment CRD; `circusd.py:360` manages local processes.
`LocalConnector` is the latter for our runtime: it spawns
`python -m dynamo_tpu_torch.worker` subprocesses (on the card unless the
worker args say `--device cpu`) and drains them with SIGTERM (the
worker's drain hands its in-flight streams to peers with their KV —
worker/main.py).  A worker on a card takes 15-25 s to start (model build
and kernel load); the planner's adjustment interval should allow it.

Not ported: `role_worker_args` and the role filters, which serve the
heterogeneous cells of `--slice` (tp/dp/ep/pp)."""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
from typing import List, Optional

logger = logging.getLogger(__name__)


class LocalConnector:
    def __init__(self, control_plane_addr: str, *,
                 worker_args: Optional[List[str]] = None,
                 env: Optional[dict] = None,
                 log_dir: Optional[str] = None,
                 drain_timeout_s: float = 45.0,
                 ) -> None:
        """`worker_args`: extra argv after `--control-plane ADDR`
        (e.g. ["--mocker", "--model-name", "m"]).  `log_dir`: where each
        worker's log goes (default: the temp directory).

        `drain_timeout_s`: scale-down budget — SIGTERM starts the
        worker's KV-migrating drain (worker/main.py `--drain on`); a
        worker that hasn't exited inside the budget is force-killed,
        counted and logged distinctly from a clean drain."""
        self.control_plane_addr = control_plane_addr
        self.worker_args = list(worker_args or [])
        self.env = dict(env if env is not None else os.environ)
        self.log_dir = log_dir or tempfile.gettempdir()
        self.drain_timeout_s = drain_timeout_s
        # Scale-down outcome accounting (planner_metrics_text exports
        # these as dynamo_planner_drains_total{outcome}).
        self.clean_drains = 0
        self.force_kills = 0
        self._procs: List[subprocess.Popen] = []
        # add_worker's spawn thread appends while _reap (event loop,
        # via a concurrent /metrics scrape) rebuilds the list — both
        # sides serialize here or a freshly spawned proc can vanish
        # from the roster and never be SIGTERMed at shutdown.
        self._procs_lock = threading.Lock()
        self._seq = 0

    def replicas(self) -> int:
        self._reap()
        return len(self._procs)


    @staticmethod
    def _close_log(proc) -> None:
        log = getattr(proc, "_logfile", None)
        if log is not None and not log.closed:
            log.close()

    def _reap(self) -> None:
        with self._procs_lock:
            live = []
            for p in self._procs:
                if p.poll() is None:
                    live.append(p)
                else:
                    self._close_log(p)
            self._procs = live

    async def add_worker(self) -> None:
        self._seq += 1
        log_path = os.path.join(
            self.log_dir,
            f"dynamo_planner_worker_{os.getpid()}_{self._seq}.log")

        def spawn():
            # Log-file open AND fork+exec both block (slow/network
            # storage, page-cache-cold python): the planner shares its
            # event loop with the metrics server, and neither may stall
            # scrapes.  The proc registers into
            # _procs HERE, on the spawn thread — if the awaiting
            # coroutine is cancelled mid-await (planner stop), the
            # thread still completes and shutdown() can reap the child
            # instead of orphaning it.
            log = open(log_path, "w")
            proc = subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.worker",
                 "--control-plane", self.control_plane_addr,
                 *self.worker_args],
                env=self.env, stdout=log, stderr=subprocess.STDOUT)
            proc._logfile = log  # type: ignore[attr-defined]
            with self._procs_lock:
                self._procs.append(proc)
            return proc

        proc = await asyncio.to_thread(spawn)
        logger.info("connector: spawned worker pid %d (log %s)", proc.pid,
                    log_path)

    async def remove_worker(self) -> None:
        """Scale-down = drain, not drop: SIGTERM starts the worker's
        KV-migrating drain (it leaves routing instantly, hands each
        in-flight stream to a peer with its sealed KV, lingers for the
        peers' pulls, then exits).  This call WAITS for drain-complete —
        worker exit — up to `drain_timeout_s`; only then does the reaper
        escalate to SIGKILL, logging and counting the force-kill
        distinctly from a clean drain.  No worker: a no-op."""
        self._reap()
        with self._procs_lock:
            if not self._procs:
                return
            proc = self._procs.pop()
        logger.info("connector: draining worker pid %d (budget %.1fs)",
                    proc.pid, self.drain_timeout_s)
        proc.send_signal(signal.SIGTERM)
        deadline = (asyncio.get_running_loop().time()
                    + max(0.0, self.drain_timeout_s))
        while proc.poll() is None \
                and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.1)
        if proc.poll() is None:
            self.force_kills += 1
            logger.error(
                "connector: worker pid %d did NOT drain within %.1fs — "
                "force-killing (SIGKILL); its in-flight KV is lost and "
                "peers fall back to re-prefill", proc.pid,
                self.drain_timeout_s)
            proc.kill()
            await asyncio.to_thread(proc.wait, 10)
        else:
            self.clean_drains += 1
            logger.info("connector: worker pid %d drained cleanly "
                        "(rc=%s)", proc.pid, proc.returncode)
        self._close_log(proc)

    async def shutdown(self) -> None:
        self._reap()
        with self._procs_lock:
            procs, self._procs = self._procs, []
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            # Off-loop: a slow-draining worker may take the full 15 s,
            # and N of them would freeze the shared planner/metrics
            # loop for 15*N s.
            try:
                await asyncio.to_thread(p.wait, 15)
            except subprocess.TimeoutExpired:
                p.kill()
            self._close_log(p)
