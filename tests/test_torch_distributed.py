"""Distributed serving with the port's engines, on the CPU.

- In process: two port engines (tiny-test, the same weights) behind an
  `InProcessControlPlane`, each served on its own RPC endpoint with its
  KV events published as the worker publishes them, and a
  `KvRoutedEngineClient` in front.  Requests that share a prefix stick
  to the worker that holds it (its prefix-hit tokens grow, the other's do
  not), and every request's greedy tokens equal those of one port engine
  serving them alone.  Exact.
- As processes (marker `e2e`): `python -m dynamo_tpu_torch.frontend
  --serve-control-plane --router-mode kv` and two `python -m
  dynamo_tpu_torch.worker --device cpu --model tiny-test` answer unary and
  streaming chats; a SIGKILL of the worker serving a stream, mid-stream,
  migrates it to the survivor, and its text equals the same request's
  uninterrupted answer.  Ports are ephemeral, logs go to files, every wait
  has a deadline.
- In a fresh interpreter: importing the worker and the frontend loads no
  `jax` and nothing of `dynamo_tpu`; the worker runs on the card unless
  `--device cpu` is given, and exits non-zero where there is none.
"""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore, InferenceEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.discovery import engine_wire_handler
from dynamo_tpu_torch.llm.kv_router.client import KV_EVENTS_SUBJECT, KvRoutedEngineClient
from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.llm.service import LocalEngineClient
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.weights import init_params
from dynamo_tpu_torch.runtime.control_plane import InProcessControlPlane
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

ROOT = Path(__file__).resolve().parents[1]
BS = 8
GEOM = dict(max_seqs=8, block_size=BS, max_pages_per_seq=16,
            max_prefill_chunk=32, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16, 32))


def _core(state, sink=None):
    return EngineCore(EngineConfig(
        model=get_config("tiny-test"), num_blocks=64, device="cpu",
        scheduler=SchedulerConfig(**GEOM)), params=state, kv_event_sink=sink)


def _req(rid, tokens, n=6):
    return PreprocessedRequest(rid, "m", list(tokens),
                               SamplingParams(max_tokens=n))


PREFIX_A = list(range(100, 148))          # 6 blocks
PREFIX_B = list(range(200, 248))
REQUESTS = ([("a0", PREFIX_A + [1, 2]), ("b0", PREFIX_B + [3])]
            + [(f"{p}{i}", (PREFIX_A if p == "a" else PREFIX_B) + [i, 7])
               for i in range(1, 4) for p in "ab"])


def test_kv_routing_sticks_prefixes_with_port_engines():
    gen = torch.Generator().manual_seed(0)
    state = init_params(get_config("tiny-test"), gen, torch.device("cpu"))

    async def main():
        cp = InProcessControlPlane()
        await cp.start()
        runtimes, cores, pumps = [], {}, []
        for _ in range(2):
            rt = DistributedRuntime(cp)
            pending = []
            loop = asyncio.get_running_loop()
            core = _core(state, lambda ev, p=pending: loop.call_soon_threadsafe(
                p.append, ev))
            engine = InferenceEngine(core)
            await engine.start()
            ep = rt.namespace("dyn").component("backend").endpoint("generate")
            inst = await ep.serve(engine_wire_handler(LocalEngineClient(engine)))
            cores[inst.instance_id] = (core, engine)
            runtimes.append(rt)

            async def pump(pending=pending, iid=inst.instance_id):
                while True:
                    await asyncio.sleep(0.005)
                    while pending:
                        await cp.publish(KV_EVENTS_SUBJECT, RouterEvent(
                            worker_id=iid, event=pending.pop(0)).to_dict())

            pumps.append(asyncio.create_task(pump()))
        front = DistributedRuntime(cp)
        client = await (front.namespace("dyn").component("backend")
                        .endpoint("generate").client())
        await client.wait_for_instances()
        while len(client.instance_ids()) < 2:
            await asyncio.sleep(0.01)
        kv = KvRoutedEngineClient(client, front, block_size=BS)
        await kv.start()

        out, placed = {}, {}
        for rid, toks in REQUESTS:
            before = {i: c.scheduler.prefix_hit_tokens
                      for i, (c, _) in cores.items()}
            out[rid] = [t async for d in kv.generate(_req(rid, toks))
                        for t in d.token_ids]
            placed[rid] = {i: c.scheduler.prefix_hit_tokens - before[i]
                           for i, (c, _) in cores.items()}
            await asyncio.sleep(0.05)         # let the events index
        for t in pumps:
            t.cancel()
        await kv.stop()
        await client.stop()
        for _, engine in cores.values():
            await engine.stop()
        for rt in runtimes + [front]:
            await rt.shutdown()
        await cp.close()
        return out, placed

    out, placed = asyncio.run(asyncio.wait_for(main(), 120))
    # Every repeat hits all 6 shared blocks on exactly one worker, and
    # each prefix stays on its first worker.
    home = {}
    for rid, hits in placed.items():
        if rid.endswith("0"):
            assert sum(hits.values()) == 0, (rid, hits)
            continue
        (w, n), = [(w, n) for w, n in hits.items() if n]
        assert n == 48, (rid, hits)
        assert home.setdefault(rid[0], w) == w
    # One port engine serving the same requests alone gives the same tokens.
    ref = _core(state)
    want = {}
    for rid, toks in REQUESTS:
        ref.add_request(rid, toks, SamplingParams(max_tokens=6))
        while ref._requests:
            for d in ref.step():
                want.setdefault(d.request_id, []).extend(d.token_ids)
    assert out == want and all(len(v) == 6 for v in out.values())


# -- as processes -------------------------------------------------------------


def _spawn(args, log_path):
    log = open(log_path, "w+")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                            stdout=log, stderr=subprocess.STDOUT, text=True)
    proc.log, proc.log_path = log, log_path
    return proc


def _wait_log(proc, pattern, deadline):
    while time.monotonic() < deadline:
        m = re.search(pattern, Path(proc.log_path).read_text())
        if m:
            return m
        assert proc.poll() is None, Path(proc.log_path).read_text()[-3000:]
        time.sleep(0.1)
    raise TimeoutError(f"no {pattern!r} in {proc.log_path}")


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _chat(n, stream=False, text="tell me about paged attention"):
    body = {"model": "m", "messages": [{"role": "user", "content": text}],
            "max_tokens": n, "temperature": 0, "stream": stream}
    if stream:
        body["stream_options"] = {"include_usage": True}
    return body


@pytest.mark.e2e
def test_distributed_serving_and_migration(tmp_path):
    procs = []
    deadline = time.monotonic() + 240
    try:
        fe = _spawn(["dynamo_tpu_torch.frontend", "--serve-control-plane",
                     "--control-plane-port", "0", "--router-mode", "kv",
                     "--http-port", "0"], tmp_path / "frontend.log")
        procs.append(fe)
        m = _wait_log(fe, r"discovering models via (\S+) .* on (http://\S+)",
                      deadline)
        cp, base = m.group(1), m.group(2)
        workers = [_spawn(["dynamo_tpu_torch.worker", "--control-plane", cp,
                           "--device", "cpu", "--model", "tiny-test",
                           "--model-name", "m", "--num-blocks", "64",
                           "--health-port", "0"], tmp_path / f"worker{i}.log")
                   for i in range(2)]
        procs += workers
        for w in workers:
            _wait_log(w, r"worker instance \d+ serving", deadline)
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/v1/models", timeout=10) as r:
                if [d["id"] for d in json.loads(r.read())["data"]] == ["m"]:
                    break
            time.sleep(0.1)

        # Unary, then the same chat streamed: the same text.
        with _post(base + "/v1/chat/completions", _chat(350)) as r:
            unary = json.loads(r.read())
        assert unary["usage"]["completion_tokens"] == 350
        want = unary["choices"][0]["message"]["content"]

        # Stream it again; kill the worker serving it after a few chunks.
        text, finish, usage, killed = [], None, None, None
        with _post(base + "/v1/chat/completions", _chat(350, True)) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                chunk = json.loads(line[6:])
                usage = chunk.get("usage") or usage
                for ch in chunk["choices"]:
                    text.append(ch["delta"].get("content") or "")
                    finish = ch.get("finish_reason") or finish
                if killed is None and len(text) >= 5:
                    rid = chunk["id"]
                    (killed,) = [w for w in workers if rid in
                                 Path(w.log_path).read_text()]
                    killed.send_signal(signal.SIGKILL)
        assert killed is not None and killed.wait(timeout=30) == -9
        (survivor,) = [w for w in workers if w is not killed]
        assert f"{rid}#m1" in Path(survivor.log_path).read_text()
        assert finish == "length" and usage["completion_tokens"] == 350
        assert "".join(text) == want

        # The survivor serves on; SIGTERM deregisters it and it exits 0.
        with _post(base + "/v1/chat/completions", _chat(5, text="hi")) as r:
            assert json.loads(r.read())["usage"]["completion_tokens"] == 5
        survivor.send_signal(signal.SIGTERM)
        assert survivor.wait(timeout=60) == 0
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/v1/models", timeout=10) as r:
                if not json.loads(r.read())["data"]:
                    break
            time.sleep(0.1)
        else:
            raise TimeoutError("the model stayed listed after SIGTERM")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.log.close()


def test_worker_and_frontend_import_no_jax():
    code = ("import sys\n"
            "import dynamo_tpu_torch.worker.main, dynamo_tpu_torch.frontend.main\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'dynamo_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_worker_runs_on_the_card_unless_asked():
    from dynamo_tpu_torch.worker.main import parse_args

    assert parse_args(["--control-plane", "127.0.0.1:1"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c",
         "import asyncio\n"
         "from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneServer\n"
         "from dynamo_tpu_torch.worker.main import parse_args, run\n"
         "async def main():\n"
         "    srv = ControlPlaneServer()\n"
         "    port = await srv.start()\n"
         "    await run(parse_args(['--control-plane', f'127.0.0.1:{port}',"
         " '--model', 'tiny-test']))\n"
         "asyncio.run(main())\n"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
