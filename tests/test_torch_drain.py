"""Worker drain with KV-carrying migration, on the CPU.

- `DrainableService` alone: a draining service refuses admissions with
  the `DRAIN_REFUSAL` marker, ends an in-flight stream with a `migrate`
  delta (reason, the sealed high-water mark, the donor address), and an
  idle drain returns at once.
- `MigrationClient` against JAX's over the same scripted deltas and
  errors: the same tokens reach the caller, the re-issues carry the same
  prompts, budgets, seed offsets and `migrate_kv` hints, and the
  migration reasons (`drain`, `drain_refused`, `death`) count the same.
- The kv router keeps a worker that handed a stream off, or refused one
  as draining, out of its candidates while the frontend still lists it.
- As processes (marker `e2e`): a frontend (kv router) and two tiny-test
  workers on `--device cpu`.  SIGTERM the worker holding a greedy stream
  mid-decode: the stream completes through the peer with the same token
  ids as an undrained run, the peer pulled the sealed blocks before
  admission (no re-prefill of them), the frontend counts
  `dynamo_migrations_total{reason="drain"}`, and the drained worker
  exits 0.  Then the control-plane drain command
  (`drain/instance/<id>`) drains the survivor the same way.
- The planner's connector counts a clean drain apart from a force kill
  (mocker workers).

Every process wait has a deadline; logs go to files.
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
from types import SimpleNamespace

import pytest

from dynamo_tpu.engine.engine import TokenDelta as JaxDelta
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import FinishReason as JaxFinish
from dynamo_tpu.llm.migration import MigrationClient as JaxMigrationClient
from dynamo_tpu.llm.preprocessor import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu.runtime.rpc import RpcError as JaxRpcError
from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.llm.drain import (
    DRAIN_REFUSAL,
    DrainableService,
    WorkerDrainingError,
    drain_key_instance,
    drain_key_pid,
)
from dynamo_tpu_torch.llm.kv_router.client import KvRoutedEngineClient
from dynamo_tpu_torch.llm.migration import MigrationClient
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.planner.connector import LocalConnector
from dynamo_tpu_torch.runtime.control_plane import InProcessControlPlane
from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneClient
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.rpc import RpcError

ROOT = Path(__file__).resolve().parents[1]


# -- DrainableService ---------------------------------------------------------


class SlowEngine:
    """Streams one token every 10 ms until cancelled or done."""

    def __init__(self, n=1000):
        self.n = n
        self.cancelled = []

    async def generate(self, request):
        try:
            for i in range(self.n):
                await asyncio.sleep(0.01)
                yield TokenDelta(request.request_id, [i + 1],
                                 finished=i == self.n - 1,
                                 finish_reason=(FinishReason.LENGTH
                                                if i == self.n - 1 else None))
        except (asyncio.CancelledError, GeneratorExit):
            self.cancelled.append(request.request_id)
            raise


def _req(rid, prompt_len=21, n=1000):
    return PreprocessedRequest(rid, "m", list(range(1, prompt_len + 1)),
                               SamplingParams(max_tokens=n))


def test_drain_hands_off_with_migrate_delta_and_refuses_new():
    async def main():
        inner = SlowEngine()
        svc = DrainableService(inner, kv_address="10.0.0.1:7", block_size=8)
        got = []

        async def consume():
            async for d in svc.generate(_req("a")):
                got.append(d)

        task = asyncio.create_task(consume())
        while sum(len(d.token_ids) for d in got) < 6:
            await asyncio.sleep(0.005)
        assert svc.active_requests == 1
        assert await svc.drain(5.0) is True
        await asyncio.wait_for(task, 5)
        with pytest.raises(WorkerDrainingError) as e:
            async for _ in svc.generate(_req("b")):
                pass
        return got, svc, inner, str(e.value)

    got, svc, inner, err = asyncio.run(asyncio.wait_for(main(), 30))
    last = got[-1]
    emitted = sum(len(d.token_ids) for d in got)
    assert last.token_ids == [] and not last.finished
    covered = (21 + emitted) // 8 * 8
    assert last.migrate == {"reason": "drain", "covered_tokens": covered,
                            "address": "10.0.0.1:7"}
    assert svc.migrated_out == 1 and svc.draining and inner.cancelled == ["a"]
    assert err == DRAIN_REFUSAL == "worker-draining"


def test_idle_drain_is_instant_and_kvless_handoff_has_no_address():
    async def main():
        svc = DrainableService(SlowEngine(), block_size=8)
        t0 = time.monotonic()
        assert await svc.drain(30.0) is True
        idle = time.monotonic() - t0
        svc2 = DrainableService(SlowEngine(), block_size=8)  # no kv_address
        got = []

        async def consume():
            async for d in svc2.generate(_req("x", prompt_len=3)):
                got.append(d)

        task = asyncio.create_task(consume())
        while not got:
            await asyncio.sleep(0.005)
        await svc2.drain(5.0)
        await task
        return idle, got[-1].migrate

    idle, migrate = asyncio.run(asyncio.wait_for(main(), 30))
    assert idle < 0.1
    assert migrate["reason"] == "drain" and "address" not in migrate


def test_drain_keys():
    assert drain_key_pid(42) == "drain/42"
    assert drain_key_instance(7) == "drain/instance/7"


# -- MigrationClient against JAX's ---------------------------------------------


class Scripted:
    """Inner client replaying one script per attempt: a list of deltas
    (dicts) ending in an optional exception name."""

    def __init__(self, scripts, delta_cls, finish_cls, errors):
        self.scripts = list(scripts)
        self.delta_cls, self.finish_cls, self.errors = (delta_cls,
                                                        finish_cls, errors)
        self.seen = []

    async def generate(self, req):
        self.seen.append((req.request_id, list(req.token_ids),
                          req.sampling.max_tokens, req.sampling.seed_offset,
                          dict(req.annotations)))
        for step in self.scripts.pop(0):
            if isinstance(step, str):
                raise self.errors[step]
            fin = step.get("finished", False)
            yield self.delta_cls(
                req.request_id, list(step.get("tokens", [])), finished=fin,
                finish_reason=self.finish_cls.LENGTH if fin else None,
                migrate=step.get("migrate"))


SCRIPTS = [
    [{"tokens": [5, 6]}, {"migrate": {"reason": "drain",
                                      "covered_tokens": 16,
                                      "address": "w1:1"}}],
    ["refused"],
    [{"tokens": [7]}, "dead"],
    [{"tokens": [8, 9]}, {"tokens": [10], "finished": True}],
]


def run_migration(client_cls, req_cls, sp_cls, delta_cls, finish_cls,
                  registry, errors):
    inner = Scripted(SCRIPTS, delta_cls, finish_cls, errors)
    client = client_cls(inner, migration_limit=5, retry_delay=0.0,
                        registry=registry)
    req = req_cls("r", "m", list(range(1, 15)), sp_cls(max_tokens=8))

    async def main():
        return [(d.token_ids, d.finished) async for d in client.generate(req)]

    out = asyncio.run(asyncio.wait_for(main(), 30))
    return out, inner.seen, client.migrations, registry.expose()


def test_migration_reasons_and_reissues_equal_jax():
    got = run_migration(
        MigrationClient, PreprocessedRequest, SamplingParams, TokenDelta,
        FinishReason, MetricsRegistry(),
        {"refused": RpcError(f"handler error: {DRAIN_REFUSAL}"),
         "dead": ConnectionError("peer gone")})
    want = run_migration(
        JaxMigrationClient, JaxRequest, JaxSamplingParams, JaxDelta,
        JaxFinish, JaxRegistry(),
        {"refused": JaxRpcError(f"handler error: {DRAIN_REFUSAL}"),
         "dead": ConnectionError("peer gone")})
    assert got == want
    out, seen, hops, text = got
    assert [t for toks, _ in out for t in toks] == [5, 6, 7, 8, 9, 10]
    assert hops == 3
    # The drain hop carried the KV hint; later hops dropped the stale one.
    assert json.loads(seen[1][4]["migrate_kv"]) == {"address": "w1:1",
                                                    "covered_tokens": 16}
    assert "migrate_kv" not in seen[3][4]
    for reason in ("drain", "drain_refused", "death"):
        assert f'dynamo_migrations_total{{reason="{reason}"}} 1' in text


def test_non_drain_rpc_error_is_not_migrated():
    inner = Scripted([["boom"]], TokenDelta, FinishReason,
                     {"boom": RpcError("handler error: bad request")})
    client = MigrationClient(inner, retry_delay=0.0)

    async def main():
        async for _ in client.generate(_req("r", n=4)):
            pass

    with pytest.raises(RpcError):
        asyncio.run(main())
    assert client.migrations == 0


class _Instances:
    """A runtime client over a settable instance list: worker 1 hands
    the stream off, worker 2 refuses it as draining."""

    def __init__(self):
        self.live, self.sent = [], []

    def instance_ids(self):
        return list(self.live)

    def instances(self):
        return [SimpleNamespace(instance_id=i, metadata={})
                for i in self.live]

    async def direct(self, payload, worker_id):
        self.sent.append(worker_id)
        if worker_id == 2:
            raise RpcError(f"handler error: {DRAIN_REFUSAL}")
        yield {"token_ids": [7],
               "migrate": {"reason": "drain", "address": "w:1",
                           "covered_tokens": 8}}


def test_kv_router_skips_a_worker_that_handed_off_or_refused():
    """The frontend may see a drained worker's handoff before its leave
    from the instance set; the re-issue must not be routed back to it
    (the highest-overlap worker), or it is refused and loses its KV."""
    inst = _Instances()
    kv = KvRoutedEngineClient(inst, SimpleNamespace(
        cp=InProcessControlPlane()), block_size=8)

    async def route(rid):
        return [d async for d in kv.generate(_req(rid, n=4))]

    inst.live = [1]
    (d,) = asyncio.run(route("a"))
    assert d.migrate["address"] == "w:1"
    inst.live = [1, 2]
    assert kv._sync_workers() == [2]
    inst.live = [2]
    with pytest.raises(RpcError):
        asyncio.run(route("b"))
    inst.live = [1, 2, 3]
    assert kv._sync_workers() == [3]
    assert inst.sent == [1, 2]


# -- as processes ---------------------------------------------------------------


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


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read().decode()
    return json.loads(body) if body[:1] in "{[" else body


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _chat(n, stream=False):
    body = {"model": "m", "max_tokens": n, "temperature": 0,
            "stream": stream, "logprobs": True,
            "return_tokens_as_token_ids": True,
            "messages": [{"role": "user",
                          "content": "drain me gently " * 6}]}
    return body


def _ids(entries):
    return [int(e["token"].split(":")[1]) for e in entries]


def _stream(base, n, on_chunk):
    """Stream one chat; `on_chunk(rid, n_tokens)` after every chunk.
    Returns (token ids, finish reason, completion tokens)."""
    ids, finish, usage = [], None, None
    body = _chat(n, True)
    body["stream_options"] = {"include_usage": True}
    with _post(base + "/v1/chat/completions", body) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            usage = chunk.get("usage") or usage
            for ch in chunk["choices"]:
                ids += _ids((ch.get("logprobs") or {}).get("content") or [])
                finish = ch.get("finish_reason") or finish
            on_chunk(chunk["id"], len(ids))
    return ids, finish, usage and usage["completion_tokens"]


def _worker(cp, i, tmp_path):
    return _spawn(["dynamo_tpu_torch.worker", "--control-plane", cp,
                   "--device", "cpu", "--model", "tiny-test",
                   "--model-name", "m", "--num-blocks", "96",
                   "--block-size", "8", "--health-port", "0",
                   "--drain-linger-s", "0.5"], tmp_path / f"worker{i}.log")


@pytest.mark.e2e
def test_sigterm_drain_migrates_stream_with_its_kv(tmp_path):
    procs = []
    deadline = time.monotonic() + 300
    try:
        fe = _spawn(["dynamo_tpu_torch.frontend", "--serve-control-plane",
                     "--control-plane-port", "0", "--router-mode", "kv",
                     "--http-port", "0"], tmp_path / "frontend.log")
        procs.append(fe)
        m = _wait_log(fe, r"discovering models via (\S+) .* on (http://\S+)",
                      deadline)
        cp, base = m.group(1), m.group(2)
        workers = [_worker(cp, i, tmp_path) for i in range(2)]
        procs += workers
        info = {}
        for w in workers:
            m = _wait_log(w, r"worker instance (\d+) serving", deadline)
            port = _wait_log(w, r"worker status server on :(\d+)", deadline)
            info[w.pid] = (int(m.group(1)),
                           f"http://127.0.0.1:{port.group(1)}")
        while time.monotonic() < deadline:
            if [d["id"] for d in _get(base + "/v1/models")["data"]] == ["m"]:
                break
            time.sleep(0.1)

        # The chat undrained first, as JAX's chaos test takes its
        # reference before the drain: tokens that owe nothing to the
        # blocks the drain moves.  Then every worker's cache is flushed,
        # so the peer holds none of the chat's blocks but those it pulls.
        with _post(base + "/v1/chat/completions", _chat(300)) as r:
            unary = json.loads(r.read())
        want = _ids(unary["choices"][0]["logprobs"]["content"])
        assert len(want) == 300
        with _post(base + "/clear_kv_blocks", {}) as r:
            assert json.loads(r.read())["m"]["status"] == "ok"

        # The chat streamed; SIGTERM its worker mid-decode.
        drained = []

        def on_chunk(rid, n):
            if not drained and n >= 40:
                (w,) = [w for w in workers
                        if rid in Path(w.log_path).read_text()]
                w.send_signal(signal.SIGTERM)
                drained.append(w)

        ids, finish, n_out = _stream(base, 300, on_chunk)
        assert drained and finish == "length" and n_out == 300
        assert ids == want
        (gone,) = drained
        assert gone.wait(timeout=60) == 0
        glog = Path(gone.log_path).read_text()
        assert "drain complete: 1 stream(s) migrated out" in glog
        (peer,) = [w for w in workers if w is not gone]
        stats = _get(info[peer.pid][1] + "/debug/stats")
        ps, mig = stats["prefix_share"], stats["migrated_in"]
        assert mig["streams"] == 1 and mig["blocks"] >= 5, (mig, ps)
        assert ps["hinted_admissions"] >= 1 and ps["reprefilled_tokens"] == 0
        metrics = _get(base + "/metrics")
        assert 'dynamo_migrations_total{reason="drain"} 1' in metrics
        wmetrics = _get(info[peer.pid][1] + "/metrics")
        assert "dynamo_requests_migrated_in_total 1" in wmetrics
        assert "dynamo_qos_preemptions_total 0" in wmetrics
        assert "dynamo_worker_draining 0" in wmetrics

        # The control-plane command drains the survivor as SIGTERM does.
        async def put_drain():
            host, _, port = cp.rpartition(":")
            client = ControlPlaneClient(host, int(port))
            await client.start()
            await client.put(drain_key_instance(info[peer.pid][0]), "test")
            await client.close()

        asyncio.run(asyncio.wait_for(put_drain(), 30))
        assert peer.wait(timeout=60) == 0
        assert "control-plane drain command" in Path(
            peer.log_path).read_text()
        while time.monotonic() < deadline:
            if not _get(base + "/v1/models")["data"]:
                break
            time.sleep(0.1)
        else:
            raise TimeoutError("the model stayed listed after the drains")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.log.close()


@pytest.mark.e2e
def test_connector_counts_clean_drain_apart_from_force_kill(tmp_path):
    procs = []
    try:
        fe = _spawn(["dynamo_tpu_torch.frontend", "--serve-control-plane",
                     "--control-plane-port", "0", "--http-port", "0"],
                    tmp_path / "frontend.log")
        procs.append(fe)
        m = _wait_log(fe, r"discovering models via (\S+) ",
                      time.monotonic() + 120)
        cp = m.group(1)

        async def main():
            conn = LocalConnector(cp, worker_args=["--mocker",
                                                   "--model-name", "m"],
                                  log_dir=str(tmp_path),
                                  drain_timeout_s=60.0)
            await conn.add_worker()
            await conn.add_worker()
            assert conn.replicas() == 2
            await asyncio.sleep(3.0)        # both serving
            await conn.remove_worker()      # SIGTERM -> idle drain, exit
            assert (conn.clean_drains, conn.force_kills) == (1, 0)
            # A budget no worker can meet is a force kill, counted apart.
            conn.drain_timeout_s = 0.0
            await conn.remove_worker()
            assert (conn.clean_drains, conn.force_kills) == (1, 1)
            assert conn.replicas() == 0
            await conn.shutdown()

        asyncio.run(asyncio.wait_for(main(), 120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.log.close()
