"""Embeddings and the KV clear, the port's against the JAX package's, on
the CPU.

- `EngineCore.embed_tokens` equals the JAX engine's on tiny-test and
  tiny-gemma (the same weights through the bridge): f32 hidden states
  that differ only in summation order, held at atol 1e-4 (the values are
  of order 1); its limits raise as JAX's do, and every borrowed page
  comes back.
- `clear_prefix_cache` after the same traffic clears JAX's count, each
  block reported REMOVED as JAX reports it, and an indexer fed by the
  port's events then scores no prompt.
- `/v1/embeddings` and `/clear_kv_blocks` through the port's
  single-process HTTP service: string, string list, token list and token
  lists, float and base64 (the same floats), the errors (empty input, too
  long, too many inputs, unknown model, bad format), and a clear count.
- The same through a CPU worker process behind an in-process frontend on
  the port's control plane (kv router): the worker's rows equal an
  in-process engine's of the same seed, and after a clear the frontend's
  indexer holds no block of the worker and its pool no inactive block.
"""

import asyncio
import base64
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.frontend.main import (
    build_model_handle,
    parse_args,
    start_discovery,
)
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent
from dynamo_tpu_torch.llm.service import ModelManager
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.tokens import compute_block_hashes
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
BS = 8
GEOM = dict(max_seqs=8, block_size=BS, max_pages_per_seq=8,
            max_prefill_chunk=32, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16, 32))
INPUTS = [[1, 2, 3], list(range(40, 72)), [7] * 9, [200, 3, 17, 99, 5]]


def _pair(name, **kw):
    params = jax_init_params(jcfg.get_config(name), jax.random.key(0))
    jev, tev = [], []
    j = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config(name), num_blocks=32, packed_prefill=True,
        scheduler=JaxSchedulerConfig(**GEOM), **kw), params=params,
        kv_event_sink=jev.append)
    t = EngineCore(EngineConfig(
        model=tcfg.get_config(name), num_blocks=32, device="cpu",
        scheduler=SchedulerConfig(**GEOM), **kw),
        params=from_jax_params(jax.device_get(params), "cpu"),
        kv_event_sink=tev.append)
    return j, t, jev, tev


@pytest.mark.parametrize("name", ["tiny-test", "tiny-gemma"])
def test_embed_tokens_match_jax(name):
    j, t, _, _ = _pair(name)
    free = t.allocator.free_blocks
    want = j.embed_tokens(INPUTS)
    got = t.embed_tokens(INPUTS)
    assert got.shape == (len(INPUTS), tcfg.get_config(name).hidden_size)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert t.allocator.free_blocks == free        # the pages came back
    for bad, msg in (([], "empty"), (list(range(33)), "exceeds")):
        for core in (j, t):
            with pytest.raises(ValueError, match=msg):
                core.embed_tokens([[1, 2], bad])
    assert t.allocator.free_blocks == free


def _removed(events):
    out = Counter()
    for e in events:
        if e.data.kind.value == "removed":
            out.update(e.data.remove.block_hashes)
    return out


def _index(events):
    idx = KvIndexer(BS)
    for e in events:
        idx.apply_event(RouterEvent.from_dict(RouterEvent(
            worker_id=1, event=e).to_dict()))
    return idx


def test_clear_matches_jax_counts_and_removed_events():
    j, t, jev, tev = _pair("tiny-test")
    prompts = {"a": list(range(1, 30)), "b": list(range(1, 17)) + [90, 91],
               "c": [5, 6, 7, 8] * 6}
    for core, sp in ((j, JaxSamplingParams), (t, SamplingParams)):
        for rid, p in prompts.items():
            core.add_request(rid, p, sp(max_tokens=10))
        while core._requests:
            core.step()
    before = len(tev)
    assert _index(tev).find_matches(
        compute_block_hashes(prompts["a"], BS)).scores
    n = t.clear_prefix_cache()
    assert n == j.clear_prefix_cache() > 0
    cleared = _removed(tev[before:])
    assert sum(cleared.values()) == n
    assert _removed(tev) == _removed(jev)
    idx = _index(tev)
    assert idx.tree.num_blocks() == 0
    for p in prompts.values():
        assert not idx.find_matches(compute_block_hashes(p, BS)).scores
    assert t.prefix_cache_stats()["pool"]["g1_inactive"] == 0
    assert t.clear_prefix_cache() == 0


# -- HTTP ------------------------------------------------------------------


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _vectors(resp):
    out = []
    for d in sorted(resp["data"], key=lambda d: d["index"]):
        e = d["embedding"]
        out.append(np.frombuffer(base64.b64decode(e), "<f4") if isinstance(
            e, str) else np.asarray(e, np.float32))
    return np.stack(out)


TEXTS = ["tell me about paged attention", "hi"]


def _check_embeddings(base, ref_core):
    """The embeddings answers at `base`, held to `ref_core`'s rows."""
    tok = ByteTokenizer()
    want = ref_core.embed_tokens([tok.encode(s) for s in TEXTS])
    url = base + "/v1/embeddings"
    st, f = _post(url, {"model": "m", "input": TEXTS})
    assert st == 200 and f["object"] == "list" and len(f["data"]) == 2
    assert f["usage"]["prompt_tokens"] == sum(len(tok.encode(s))
                                              for s in TEXTS)
    st, b = _post(url, {"model": "m", "input": TEXTS,
                        "encoding_format": "base64"})
    assert st == 200 and isinstance(b["data"][0]["embedding"], str)
    fv, bv = _vectors(f), _vectors(b)
    assert fv.shape == (2, ref_core.config.model.hidden_size)
    assert np.isfinite(fv).all() and np.array_equal(fv, bv)
    np.testing.assert_allclose(fv, want, rtol=0, atol=1e-5)
    st, one = _post(url, {"model": "m", "input": TEXTS[0]})
    assert st == 200 and np.array_equal(_vectors(one)[0], fv[0])
    toks = tok.encode(TEXTS[1])
    st, tl = _post(url, {"model": "m", "input": toks})
    assert st == 200 and np.array_equal(_vectors(tl)[0], fv[1])
    st, tll = _post(url, {"model": "m", "input": [toks, toks]})
    assert st == 200 and np.array_equal(_vectors(tll), fv[[1, 1]])
    errors = {
        "empty": {"model": "m", "input": []},
        "too_many": {"model": "m", "input": ["x"] * 129},
        "too_long": {"model": "m", "input": [1] * 100_000},
        "format": {"model": "m", "input": "x", "encoding_format": "bf16"},
        "mixed": {"model": "m", "input": ["x", 3]},
    }
    for name, body in errors.items():
        st, e = _post(url, body)
        assert st == 400 and "error" in e, (name, st, e)
    assert _post(url, {"model": "nope", "input": "x"})[0] == 404


def _chat(base, text, n=4):
    st, r = _post(base + "/v1/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": text}],
        "max_tokens": n, "temperature": 0})
    assert st == 200, r
    return r


def test_single_process_embeddings_and_clear():
    args = parse_args(["--model", "tiny-test", "--model-name", "m",
                       "--device", "cpu", "--block-size", "8"])
    ref = EngineCore(EngineConfig(model=tcfg.get_config("tiny-test"),
                                  device="cpu",
                                  scheduler=SchedulerConfig(block_size=8)))

    async def main():
        handle, core, shutdown = await build_model_handle(args)
        models = ModelManager()
        models.register(handle)
        svc = HttpService(models)
        port = await svc.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        try:
            await asyncio.to_thread(_check_embeddings, base, ref)
            await asyncio.to_thread(_chat, base, "x" * 60)
            st, cleared = await asyncio.to_thread(
                _post, base + "/clear_kv_blocks", {})
            return st, cleared, core.prefix_cache_stats()["pool"]
        finally:
            await svc.stop()
            await shutdown()

    st, cleared, pool = asyncio.run(asyncio.wait_for(main(), 180))
    assert st == 200 and cleared["m"]["status"] == "ok"
    assert cleared["m"]["cleared"] > 0 and pool["g1_inactive"] == 0


def _wait_log(proc, path, pattern, deadline):
    while time.monotonic() < deadline:
        m = re.search(pattern, Path(path).read_text())
        if m:
            return m
        assert proc.poll() is None, Path(path).read_text()[-3000:]
        time.sleep(0.1)
    raise TimeoutError(f"no {pattern!r} in {path}")


@pytest.mark.e2e
def test_worker_behind_frontend_embeddings_and_clear(tmp_path):
    from dynamo_tpu_torch.runtime.control_plane import ControlPlaneState
    from dynamo_tpu_torch.runtime.control_plane_tcp import ControlPlaneServer

    ref = EngineCore(EngineConfig(model=tcfg.get_config("tiny-test"),
                                  device="cpu",
                                  scheduler=SchedulerConfig(block_size=8)))
    log = tmp_path / "worker.log"

    async def main():
        server = ControlPlaneServer(ControlPlaneState())
        cp_port = await server.start(port=0)
        cp = f"127.0.0.1:{cp_port}"
        models = ModelManager()
        args = parse_args(["--control-plane", cp, "--router-mode", "kv"])
        watcher, shutdowns = await start_discovery(args, models)
        svc = HttpService(models)
        base = f"http://127.0.0.1:{await svc.start('127.0.0.1', 0)}"
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        with open(log, "w") as out:
            worker = subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.worker",
                 "--control-plane", cp, "--device", "cpu", "--model",
                 "tiny-test", "--model-name", "m", "--block-size", "8",
                 "--num-blocks", "64", "--health-port", "0"],
                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 150
        try:
            hport = (await asyncio.to_thread(
                _wait_log, worker, log, r"worker status server on :(\d+)",
                deadline)).group(1)
            iid = int((await asyncio.to_thread(
                _wait_log, worker, log, r"worker instance (\d+) serving",
                deadline)).group(1))
            while models.get("m") is None:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.05)
            await asyncio.to_thread(_check_embeddings, base, ref)
            index = watcher._kv_clients["m"].router.indexer
            await asyncio.to_thread(_chat, base, "y" * 60)
            while not index.tree.blocks_for_worker(iid):
                assert time.monotonic() < deadline
                await asyncio.sleep(0.05)
            st, cleared = await asyncio.to_thread(
                _post, base + "/clear_kv_blocks", {})
            while index.tree.blocks_for_worker(iid):
                assert time.monotonic() < deadline, "the index kept blocks"
                await asyncio.sleep(0.05)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{hport}/debug/stats") as r:
                pool = json.loads(r.read())["prefix_cache"]["pool"]
            return (st, cleared, pool, index.tree.num_blocks(),
                    watcher.kv_index_blocks())
        finally:
            worker.terminate()
            await asyncio.to_thread(worker.wait, 30)
            await svc.stop()
            for stop in shutdowns:
                await stop()
            await server.stop()

    st, cleared, pool, left, kv_index = asyncio.run(
        asyncio.wait_for(main(), 200))
    assert st == 200 and cleared["m"]["status"] == "ok"
    assert cleared["m"]["cleared"] > 0
    assert pool["g1_inactive"] == 0 and left == 0
    assert kv_index == {"m": {}}        # what the frontend's /debug/stats shows
