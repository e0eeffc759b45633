"""Disaggregated prefill/decode in the port, on the CPU: ports of
tests/test_disagg.py and tests/test_disagg_stream.py, each held against
the JAX aggregated engine's greedy tokens (the same tiny-test weights),
over three caches: f32 (tiny-test's dtype), bf16 (tiny-test at bf16,
llama-3-1b's dtype) and int8 (the bf16 model's quantized cache).

- A long prompt goes to the prefill queue; the prefill worker's real
  `prefill_worker_loop` prefills it, the decode side onboards its 3
  sealed blocks (`tokens_onboarded`, `onboarded_blocks`), prefills only
  the tail, and the queue item is acked.  A short prompt stays local.
- No prefill worker: the decode side falls back to local prefill.
- The threshold hot-reloads from the control plane.
- The device-direct plane (the same-process `local` transport) carries
  every block, none host-staged.
- Eager pulls begin before prefill-done: blocks announced mid-prefill
  land before the done message is sent.
- A prefill worker that dies mid-stream: the decode side falls back to
  local prefill, reusing the contiguous prefix that landed.
- The prefill loop publishes incremental progress from the engine's seal
  stream.
- The seal stream adds nothing to a steady decode window: the engine
  counters are equal with and without a sink, which did fire.
- As processes (marker `e2e`): a frontend, a `--role prefill` worker and
  a `--role decode` worker on `--device cpu`; a long chat goes remote, and
  the cross-process pull rides the host-staged plane, counted with its
  reason (the local fabric refuses other processes).

Tolerance: tokens are equal and counts exact.
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

import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore, InferenceEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.block_manager import device_transfer as dt
from dynamo_tpu_torch.llm.block_manager.transfer import (
    KV_BLOCKS_ENDPOINT,
    make_kv_blocks_handler,
)
from dynamo_tpu_torch.llm.disagg import (
    PREFILL_DONE_SUBJECT,
    PREFILL_PROGRESS_SUBJECT,
    DisaggDecodeClient,
    disagg_config_key,
    prefill_queue_name,
    prefill_worker_loop,
)
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.llm.service import LocalEngineClient
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.runtime.control_plane import InProcessControlPlane
from dynamo_tpu_torch.runtime.rpc import RpcServer
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

ROOT = Path(__file__).resolve().parents[1]
BS = 8
NS = "test-disagg"
GEOM = dict(max_seqs=4, block_size=BS, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4),
            prefill_buckets=(8, 16))
LONG_PROMPT = list(range(1, 28))   # 3 sealed blocks + tail
SHORT_PROMPT = list(range(100, 108))
# cache mode -> (model dtype, kv_quant)
MODES = {"f32": ("float32", "none"), "bf16": ("bfloat16", "none"),
         "int8": ("bfloat16", "int8")}
QUANTS = list(MODES)


def _cfgs(mode):
    dtype = MODES[mode][0]
    jc = jcfg.get_config("tiny-test")
    tc = tcfg.get_config("tiny-test")
    if dtype == "bfloat16":
        jc, tc = jc.replace(dtype=jnp.bfloat16), tc.replace(dtype=torch.bfloat16)
    return jc, tc


@pytest.fixture(scope="module")
def all_weights():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, _ = _cfgs("f32" if dtype == "float32" else "bf16")
        params = jax_init_params(jc, jax.random.key(0))
        out[dtype] = params, from_jax_params(jax.device_get(params), "cpu")
    return out


class _Mode:
    """One cache mode's weights on both sides."""

    def __init__(self, all_weights, mode):
        self.mode = mode
        self.jcfg, self.tcfg = _cfgs(mode)
        self.kv_quant = MODES[mode][1]
        self.params, self.state = all_weights[MODES[mode][0]]


@pytest.fixture(params=QUANTS)
def mode(request, all_weights):
    return _Mode(all_weights, request.param)


@pytest.fixture
def weights(all_weights):
    return _Mode(all_weights, "f32")


_WANT = {}


def jax_tokens(m: _Mode, prompt, n=4):
    """The JAX aggregated engine's greedy tokens (cached per case)."""
    key = (tuple(prompt), m.mode, n)
    if key not in _WANT:
        core = JaxEngineCore(JaxEngineConfig(
            model=m.jcfg, num_blocks=64,
            packed_prefill=True, kv_quant=m.kv_quant,
            scheduler=JaxSchedulerConfig(**GEOM)), params=m.params)
        core.add_request("ref", list(prompt), JaxSamplingParams(max_tokens=n))
        out = []
        while core._requests:
            for d in core.step():
                out.extend(d.token_ids)
        _WANT[key] = out
    return _WANT[key]


class _Worker:
    """One in-process worker: engine, RPC server with kv_blocks, and with
    `plane` the device plane's kv_offer / kv_pulled too."""

    def __init__(self, m: "_Mode", plane=False):
        self.m, self.with_plane = m, plane
        self.plane = None

    async def start(self):
        self.engine = InferenceEngine(EngineCore(EngineConfig(
            model=self.m.tcfg, num_blocks=64, device="cpu",
            kv_quant=self.m.kv_quant, scheduler=SchedulerConfig(**GEOM)),
            params=self.m.state))
        await self.engine.start()
        self.client = LocalEngineClient(self.engine)
        self.rpc = RpcServer()
        self.rpc.register(KV_BLOCKS_ENDPOINT,
                          make_kv_blocks_handler(self.engine))
        if self.with_plane:
            self.plane = dt.KvTransferPlane(self.engine)
            self.plane.start()
            self.rpc.register(dt.KV_OFFER_ENDPOINT,
                              self.plane.make_offer_handler())
            self.rpc.register(dt.KV_PULLED_ENDPOINT,
                              self.plane.make_pulled_handler())
        self.address = await self.rpc.start()
        return self

    @property
    def manager(self):
        return self.engine.core.allocator.manager

    async def stop(self, rpc=True):
        if rpc:
            await self.rpc.stop()
        if self.plane is not None:
            self.plane.stop()
        await self.engine.stop()


async def _collect(client, rid, prompt, n=4):
    req = PreprocessedRequest(request_id=rid, model="m",
                              token_ids=list(prompt),
                              sampling=SamplingParams(max_tokens=n))
    out = []
    async for d in client.generate(req):
        out.extend(d.token_ids)
        if d.finished:
            break
    return out


async def _wait_for(pred, timeout=30.0, what="condition"):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, f"timed out on {what}"
        await asyncio.sleep(0.01)


async def _control_plane(threshold=12):
    cp = InProcessControlPlane()
    await cp.start()
    if threshold is not None:
        await cp.put(disagg_config_key(NS),
                     {"max_local_prefill_length": threshold})
    return cp


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 120))


def test_long_prompt_skips_decode_prefill(mode):
    want = jax_tokens(mode, LONG_PROMPT)
    want_short = jax_tokens(mode, SHORT_PROMPT)

    async def main():
        cp = await _control_plane()
        prefill = await _Worker(mode).start()
        decode = await _Worker(mode).start()
        ploop = asyncio.create_task(prefill_worker_loop(
            cp, NS, prefill.client, prefill.address))
        dec = DisaggDecodeClient(decode.client, decode.engine, cp, NS, BS)
        await dec.start()
        try:
            assert await _collect(dec, "r1", LONG_PROMPT) == want
            assert dec.remote_prefills == 1 and dec.local_fallbacks == 0
            assert dec.tokens_onboarded == 24
            assert decode.manager.onboarded_blocks == 3
            sched = decode.engine.core.scheduler
            assert sched.prefix_hit_tokens == 24          # only the tail
            assert sched.prefix_miss_tokens == len(LONG_PROMPT) - 24
            # The prefill worker prefilled it all and never decoded.
            pc = prefill.engine.core.counters
            assert pc.window_dispatches == pc.single_step_dispatches == 0
            assert await cp.queue_len(prefill_queue_name(NS)) == 0
            await _wait_for(lambda: not cp.state._inflight_msgs,
                            what="the queue ack")
            # A short prompt stays local.
            assert await _collect(dec, "r2", SHORT_PROMPT) == want_short
            assert dec.remote_prefills == 1
            st = dec.stats()
            assert st["tokens_onboarded"] == 24
            assert (st["eager_blocks_before_done"]
                    + st["eager_blocks_after_done"]) == 3
        finally:
            ploop.cancel()
            await asyncio.gather(ploop, return_exceptions=True)
            await dec.stop()
            await prefill.stop()
            await decode.stop()
            await cp.close()

    _run(main())


def test_falls_back_when_no_prefill_worker(mode):
    want = jax_tokens(mode, LONG_PROMPT)

    async def main():
        cp = await _control_plane()
        decode = await _Worker(mode).start()
        dec = DisaggDecodeClient(decode.client, decode.engine, cp, NS, BS,
                                 prefill_timeout=0.3)
        await dec.start()
        try:
            assert await _collect(dec, "r1", LONG_PROMPT) == want
            assert dec.local_fallbacks == 1 and dec.remote_prefills == 0
            assert dec.tokens_onboarded == 0
        finally:
            await dec.stop()
            await decode.stop()
            await cp.close()

    _run(main())


def test_threshold_hot_reload(weights):
    async def main():
        cp = await _control_plane(threshold=None)
        decode = await _Worker(weights).start()
        dec = DisaggDecodeClient(decode.client, decode.engine, cp, NS, BS)
        await dec.start()
        try:
            assert not dec.router.prefill_remotely(1000)   # disagg off
            await cp.put(disagg_config_key(NS),
                         {"max_local_prefill_length": 16})
            await _wait_for(lambda: dec.router.prefill_remotely(17),
                            what="the threshold")
            assert not dec.router.prefill_remotely(16)
            await cp.delete(disagg_config_key(NS))
            await _wait_for(lambda: not dec.router.prefill_remotely(1000),
                            what="disagg off")
        finally:
            await dec.stop()
            await decode.stop()
            await cp.close()

    _run(main())


@pytest.mark.parametrize("eager", [True, False])
def test_device_direct_data_plane(mode, eager):
    """Every block crosses on the device plane (the local fabric: both
    workers live in this process), none host-staged."""
    want = jax_tokens(mode, LONG_PROMPT)

    async def main():
        cp = await _control_plane()
        prefill = await _Worker(mode, plane=True).start()
        decode = await _Worker(mode, plane=True).start()
        ploop = asyncio.create_task(prefill_worker_loop(
            cp, NS, prefill.client, prefill.address))
        dec = DisaggDecodeClient(decode.client, decode.engine, cp, NS, BS,
                                 transfer_plane=decode.plane, eager=eager)
        await dec.start()
        dt.reset_plane_counts()
        try:
            assert await _collect(dec, "r1", LONG_PROMPT) == want
            assert dec.remote_prefills == 1 and dec.local_fallbacks == 0
            assert dec.device_pulls == 1
            assert dec.tokens_onboarded == 24
            assert decode.plane.pulled_blocks == 3
            assert prefill.plane.offers >= 1
            counts = dt.plane_counts()
            assert sum(n for (p, _), n in counts.items() if p == "device") >= 1
            assert not [k for k in counts if k[0] == "host"], counts
            assert decode.manager.onboarded_blocks == 3
            # Every offer was acked: the holder keeps no staging.
            await _wait_for(lambda: not prefill.plane._outstanding,
                            what="the acks")
            assert not dt._staged
        finally:
            ploop.cancel()
            await asyncio.gather(ploop, return_exceptions=True)
            await dec.stop()
            await prefill.stop()
            await decode.stop()
            await cp.close()

    _run(main())


async def _prefill_job(cp, worker):
    """Pop the job and run the real prefill on `worker` (its blocks become
    resident and registered); returns (msg_id, rid)."""
    msg_id, job = await cp.queue_pop(prefill_queue_name(NS), 60)
    rid = job["request_id"]
    await _collect(worker.client, f"prefill-{rid}", job["token_ids"], n=1)
    return msg_id, rid


def test_eager_pulls_begin_before_prefill_done(mode):
    want = jax_tokens(mode, LONG_PROMPT)

    async def main():
        cp = await _control_plane()
        prefill = await _Worker(mode).start()
        decode = await _Worker(mode).start()
        dec = DisaggDecodeClient(decode.client, decode.engine, cp, NS, BS)
        await dec.start()

        async def scripted_prefill():
            msg_id, rid = await _prefill_job(cp, prefill)
            await cp.publish(PREFILL_PROGRESS_SUBJECT, {
                "request_id": rid, "address": prefill.address,
                "sealed_blocks": 2})
            # Done is withheld until both announced blocks landed, so
            # "before done" is asserted, not raced.
            await _wait_for(lambda: decode.manager.onboarded_blocks >= 2,
                            what="streamed blocks landing")
            await cp.publish(PREFILL_DONE_SUBJECT, {
                "request_id": rid, "address": prefill.address,
                "prefill_s": 0.0})
            await cp.queue_ack(prefill_queue_name(NS), msg_id)

        task = asyncio.create_task(scripted_prefill())
        try:
            assert await _collect(dec, "r1", LONG_PROMPT) == want
            await task
            assert dec.remote_prefills == 1 and dec.local_fallbacks == 0
            assert dec.tokens_onboarded == 24
            assert dec.tokens_streamed >= 2 * BS
            assert dec.last_overlap_ratio >= 2 / 3
            assert dec.eager_blocks_before_done >= 2
            assert decode.manager.onboarded_blocks == 3
            assert decode.engine.core.scheduler.prefix_hit_tokens == 24
        finally:
            if not task.done():
                task.cancel()
            await dec.stop()
            await prefill.stop()
            await decode.stop()
            await cp.close()

    _run(main())


def test_midstream_death_falls_back_with_landed_prefix(mode):
    want = jax_tokens(mode, LONG_PROMPT)

    async def main():
        cp = await _control_plane()
        prefill = await _Worker(mode).start()
        decode = await _Worker(mode).start()
        dec = DisaggDecodeClient(decode.client, decode.engine, cp, NS, BS)
        await dec.start()

        async def dying_prefill():
            _, rid = await _prefill_job(cp, prefill)
            await cp.publish(PREFILL_PROGRESS_SUBJECT, {
                "request_id": rid, "address": prefill.address,
                "sealed_blocks": 2})
            await _wait_for(lambda: decode.manager.onboarded_blocks >= 2,
                            what="streamed blocks landing")
            # Death mid-stream: the RPC plane goes, then the done message
            # points at the dead address.  No ack either.
            await prefill.rpc.stop()
            await cp.publish(PREFILL_DONE_SUBJECT, {
                "request_id": rid, "address": prefill.address,
                "prefill_s": 0.0})

        task = asyncio.create_task(dying_prefill())
        try:
            assert await _collect(dec, "r1", LONG_PROMPT) == want
            await task
            assert dec.local_fallbacks == 1 and dec.remote_prefills == 0
            assert dec.tokens_onboarded == 2 * BS        # the landed prefix
            assert decode.manager.onboarded_blocks == 2
            # ... which the local prefill reused.
            assert decode.engine.core.scheduler.prefix_hit_tokens == 2 * BS
        finally:
            if not task.done():
                task.cancel()
            await dec.stop()
            await prefill.stop(rpc=False)
            await decode.stop()
            await cp.close()

    _run(main())


def test_prefill_worker_loop_publishes_progress(mode):
    """The real loop: the 27-token prompt prefills in two 16-token chunks,
    so the first announcement is a partial high-water mark."""
    want = jax_tokens(mode, LONG_PROMPT)

    async def main():
        cp = await _control_plane()
        prefill = await _Worker(mode).start()
        decode = await _Worker(mode).start()
        listener = await cp.subscribe(PREFILL_PROGRESS_SUBJECT)
        ploop = asyncio.create_task(prefill_worker_loop(
            cp, NS, prefill.client, prefill.address))
        dec = DisaggDecodeClient(decode.client, decode.engine, cp, NS, BS)
        await dec.start()
        try:
            assert await _collect(dec, "r1", LONG_PROMPT) == want
            assert dec.remote_prefills == 1 and dec.tokens_onboarded == 24
            marks = []
            while not listener._q.empty():
                m = listener._q.get_nowait()
                assert m["request_id"] == "r1"
                assert m["address"] == prefill.address
                marks.append(m["sealed_blocks"])
            # Chunk 1 (16 tokens) seals 2 blocks, chunk 2 the third.
            assert marks == [2, 3]
        finally:
            listener.cancel()
            ploop.cancel()
            await asyncio.gather(ploop, return_exceptions=True)
            await dec.stop()
            await prefill.stop()
            await decode.stop()
            await cp.close()

    _run(main())


def test_seal_stream_adds_nothing_to_steady_window(mode):
    """The sink fires in the steady decode window (a block seals every
    8 tokens) and changes no engine counter: no sync, no upload."""
    def steady(with_sink):
        core = EngineCore(EngineConfig(
            model=mode.tcfg, num_blocks=128,
            device="cpu", kv_quant=mode.kv_quant,
            scheduler=SchedulerConfig(
                max_seqs=8, block_size=8, max_pages_per_seq=32,
                max_prefill_chunk=128, decode_buckets=(1, 2, 4, 8),
                prefill_buckets=(16, 128))), params=mode.state)
        calls = []
        if with_sink:
            core.seal_sink = lambda rid, n: calls.append((rid, n))
        core.add_request("a", list(range(1, 71)),
                         SamplingParams(max_tokens=120))
        out = []
        for _ in range(12):     # prefill and the window pipeline's fill
            out += [t for d in core.step() for t in d.token_ids]
        base = core.counters.as_dict()
        at_steady = len(calls)
        for _ in range(6):
            out += [t for d in core.step() for t in d.token_ids]
        delta = {k: v - base[k] for k, v in core.counters.as_dict().items()}
        return delta, len(calls) - at_steady, out

    d_off, _, out_off = steady(False)
    d_on, steady_calls, out_on = steady(True)
    assert steady_calls > 0
    assert d_on == d_off and d_on["window_dispatches"] > 0
    assert out_on == out_off


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


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.e2e
def test_prefill_and_decode_workers_serve_a_long_chat(tmp_path):
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
        common = ["--control-plane", cp, "--device", "cpu", "--model",
                  "tiny-test", "--model-name", "m", "--num-blocks", "128",
                  "--block-size", "8", "--health-port", "0"]
        pre = _spawn(["dynamo_tpu_torch.worker", *common, "--role",
                      "prefill"], tmp_path / "prefill.log")
        dec = _spawn(["dynamo_tpu_torch.worker", *common, "--role",
                      "decode", "--max-local-prefill", "160"],
                     tmp_path / "decode.log")
        procs += [pre, dec]
        _wait_log(pre, r"worker instance \d+ serving the prefill queue",
                  deadline)
        _wait_log(dec, r"worker instance \d+ serving 'm'", deadline)
        dport = int(_wait_log(dec, r"worker status server on :(\d+)",
                              deadline).group(1))
        pport = int(_wait_log(pre, r"worker status server on :(\d+)",
                              deadline).group(1))
        while time.monotonic() < deadline:
            if [d["id"] for d in _get(base + "/v1/models")["data"]] == ["m"]:
                break
            time.sleep(0.1)
        long_text = "Tell me about disaggregated serving. " * 8
        body = {"model": "m", "max_tokens": 8, "temperature": 0,
                "messages": [{"role": "user", "content": long_text}]}
        out = _post(base + "/v1/chat/completions", body)
        assert out["usage"]["completion_tokens"] == 8
        st = _get(f"http://127.0.0.1:{dport}/debug/stats")
        d = st["disagg"]
        assert d["remote_prefills"] == 1 and d["local_fallbacks"] == 0
        assert d["tokens_onboarded"] > 0 and d["tokens_onboarded"] % 8 == 0
        assert st["onboarded_blocks"] == d["tokens_onboarded"] // 8
        # The local fabric refuses another process: host-staged, with
        # the reason.
        assert "device" not in st["plane_counts"]
        assert st["plane_counts"]["host"].get("transport", 0) >= 1
        pst = _get(f"http://127.0.0.1:{pport}/debug/stats")
        assert pst["transfer_plane"]["refused_offers"] >= 1
        assert pst["kernels"]["paged_decode_attention"] == 0
        # A short chat stays on the decode worker.
        body["messages"][0]["content"] = "hi"
        assert _post(base + "/v1/chat/completions",
                     body)["usage"]["completion_tokens"] == 8
        assert _get(f"http://127.0.0.1:{dport}/debug/stats")[
            "disagg"]["remote_prefills"] == 1
        # The reset zeroes the data plane's counters with the rest.
        _post(f"http://127.0.0.1:{dport}/debug/stats/reset", {})
        st = _get(f"http://127.0.0.1:{dport}/debug/stats")
        assert st["disagg"]["remote_prefills"] == 0
        assert st["plane_counts"] == {} and st["onboarded_blocks"] == 0
        for p in (dec, pre):
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.log.close()
