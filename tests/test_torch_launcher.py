"""The port's launcher and standalone control plane.

- `load_graph` against JAX's: the same TOMLs give the same specs
  (dataclass fields), and the same malformed TOMLs the same errors.
- As processes (marker `e2e`): `python -m dynamo_tpu_torch.launcher` on a
  graph whose control plane is its own service
  (`dynamo_tpu_torch.control_plane_service --store file:`), with a mocker
  worker and a frontend.  A chat is served; the control plane is killed
  with SIGKILL and the launcher restarts it on the same port and store;
  unleased config survives and the worker (never restarted) re-registers
  under the same instance id; SIGTERM tears the graph down in reverse
  order within its timeout.
"""

import asyncio
import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from dynamo_tpu.launcher import load_graph as jax_load_graph
from dynamo_tpu_torch.launcher import load_graph
from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneClient

ROOT = Path(__file__).resolve().parents[1]

GRAPHS = {
    "full": """
[graph]
namespace = "ns"
serve_control_plane = false
control_plane = "127.0.0.1:7411"
kv_store = "file:/var/cp.json"
log_dir = "logs"

[services.cp]
module = "dynamo_tpu_torch.control_plane_service"
args = ["--port", 7411, "--store", "file:cp.json"]
inject_control_plane = false
restart = "always"

[services.frontend]
module = "dynamo_tpu_torch.frontend"
args = ["--http-port", "0", "--router-mode", "kv"]

[services.decode]
module = "dynamo_tpu_torch.worker"
args = ["--mocker"]
replicas = 2
restart = "never"
""",
    "minimal": """
[graph]
log_dir = "x"

[services.only]
module = "m"
""",
}
BAD = {
    "restart": '[services.x]\nmodule = "m"\nrestart = "sometimes"\n',
    "replicas": '[services.x]\nmodule = "m"\nreplicas = -1\n',
    "empty": '[graph]\nnamespace = "n"\n',
    "module": '[services.x]\nargs = []\n',
    "toml": '[services.x\nmodule = "m"\n',
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_load_graph_equal_jax(tmp_path, name):
    path = tmp_path / "g.toml"
    path.write_text(GRAPHS[name])
    assert (dataclasses.asdict(load_graph(str(path)))
            == dataclasses.asdict(jax_load_graph(str(path))))


@pytest.mark.parametrize("name", sorted(BAD))
def test_load_graph_errors_equal_jax(tmp_path, name):
    path = tmp_path / "g.toml"
    path.write_text(BAD[name])
    errs = []
    for fn in (load_graph, jax_load_graph):
        with pytest.raises(Exception) as e:
            fn(str(path))
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(pred, deadline, what):
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.2)
    raise TimeoutError(what)


@pytest.mark.e2e
def test_launcher_graph_survives_control_plane_kill(tmp_path):
    port = _free_port()
    store = tmp_path / "cp.json"
    graph = tmp_path / "graph.toml"
    graph.write_text(f"""
[graph]
serve_control_plane = false
control_plane = "127.0.0.1:{port}"
log_dir = "{tmp_path}"

[services.control_plane]
module = "dynamo_tpu_torch.control_plane_service"
args = ["--port", "{port}", "--store", "file:{store}"]
inject_control_plane = false
restart = "always"

[services.frontend]
module = "dynamo_tpu_torch.frontend"
args = ["--http-port", "0", "--router-mode", "kv"]
restart = "on-failure"

[services.worker]
module = "dynamo_tpu_torch.worker"
args = ["--mocker", "--model-name", "m", "--block-size", "8",
        "--health-port", "-1"]
restart = "on-failure"
""")
    log = open(tmp_path / "launcher.log", "w+")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.launcher", str(graph)],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 150
    try:
        def logs(svc):
            paths = list(tmp_path.glob(f"dynamo_graph_*_{svc}_0.log"))
            return paths[0].read_text() if paths else ""

        base = _wait(lambda: (re.search(r"on (http://\S+)", logs("frontend"))
                              or [None, None])[1], deadline, "frontend up")

        def models():
            with urllib.request.urlopen(base + "/v1/models", timeout=10) as r:
                return [d["id"] for d in json.loads(r.read())["data"]]

        _wait(lambda: models() == ["m"], deadline, "model listed")
        body = {"model": "m", "max_tokens": 6,
                "messages": [{"role": "user", "content": "hi"}]}
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["usage"]["completion_tokens"] == 6

        async def main():
            cli = ControlPlaneClient("127.0.0.1", port)
            await cli.start()
            await cli.put("config/knob", {"v": 42})
            before = await cli.get_prefix("instances/")
            assert len(before) == 1
            cp_pid = int(re.findall(r"control_plane\[0\] pid=(\d+)",
                                    Path(log.name).read_text())[-1])
            os.kill(cp_pid, signal.SIGKILL)
            back, knob = {}, None
            end = time.monotonic() + 60
            while time.monotonic() < end:
                try:
                    knob = await cli.get("config/knob")
                    back = await cli.get_prefix("instances/")
                    if set(back) == set(before):
                        break
                except (ConnectionError, RuntimeError):
                    pass
                await asyncio.sleep(0.5)
            await cli.close()
            return before, back, knob

        before, back, knob = asyncio.run(asyncio.wait_for(main(), 90))
        assert knob == {"v": 42}
        assert set(back) == set(before)       # same instance id
        assert "control_plane[0] exited" in Path(log.name).read_text()
        # The frontend still serves through the restarted control plane.
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["usage"]["completion_tokens"] == 6

        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert time.monotonic() - t0 < 60
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()


def test_fleet_modules_import_no_jax():
    code = ("import sys\n"
            "import dynamo_tpu_torch.launcher, "
            "dynamo_tpu_torch.control_plane_service, "
            "dynamo_tpu_torch.planner.__main__, "
            "dynamo_tpu_torch.planner.profiler, "
            "dynamo_tpu_torch.metrics_aggregator.__main__, "
            "dynamo_tpu_torch.llm.mocker, dynamo_tpu_torch.llm.drain\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'dynamo_tpu', 'aiohttp')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
