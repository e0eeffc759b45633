"""The port's KV data plane against the JAX package's, on the CPU.

- Whole-block extract (`engine/kv_cache.extract_blocks`) gives JAX's
  `make_block_ops` wire blocks byte for byte, for several pages of f32,
  bf16 and packed int8 caches; injecting JAX's wire blocks leaves the
  cache pages and scales byte-equal to JAX's inject.
- `encode_block` dicts equal JAX's field for field (bf16 as raw bytes),
  and `decode_block` round-trips them.
- A block a JAX engine exported and a port engine imported (the same
  weights) gives the JAX engine's greedy continuation: the cross-package
  onboard.
- Ports of tests/test_kv_transfer.py: engine-to-engine export/import,
  transfer over the RPC plane, the int8 round trip, and mixed-kv-quant
  peers refused loudly (nothing registered, no page leaked).
- The control plane's work queues: push, pop, ack, redelivery after the
  visibility timeout and queue_len, in process, persisted across a
  restart, and over TCP both ways (the port's client against JAX's
  server, JAX's client against the port's).
- Importing the data-plane modules loads no jax, dynamo_tpu, ml_dtypes
  or msgpack.

Tolerance: transfers are byte-exact and tokens equal.
"""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_cache as jkv
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.llm.block_manager import transfer as jtransfer
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime import control_plane_tcp as jcp_tcp
from dynamo_tpu_torch.engine import kv_cache as tkv
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore, InferenceEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.block_manager.transfer import (
    KV_BLOCKS_ENDPOINT,
    decode_block,
    encode_block,
    fetch_blocks,
    make_kv_blocks_handler,
    pull_prefix,
)
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.runtime import control_plane_tcp as tcp_tcp
from dynamo_tpu_torch.runtime.control_plane import (
    ControlPlaneState,
    InProcessControlPlane,
)
from dynamo_tpu_torch.runtime.rpc import RpcClient, RpcServer
from dynamo_tpu_torch.tokens import compute_block_hashes
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

ROOT = Path(__file__).resolve().parents[1]
BS = 8
GEOM = dict(max_seqs=4, block_size=BS, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4),
            prefill_buckets=(8, 16))
PROMPT = list(range(1, 28))          # 3 sealed blocks + tail


@pytest.fixture(scope="module")
def weights():
    params = jax_init_params(jcfg.get_config("tiny-test"), jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def jax_core(params, kv_quant="none"):
    return JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=64,
        packed_prefill=True, kv_quant=kv_quant,
        scheduler=JaxSchedulerConfig(**GEOM)), params=params)


def port_core(state, kv_quant="none"):
    return EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=64, device="cpu",
        kv_quant=kv_quant, scheduler=SchedulerConfig(**GEOM)), params=state)


def run_core(core, rid, prompt, n=4, sampling=SamplingParams):
    core.add_request(rid, prompt, sampling(max_tokens=n))
    out = []
    for _ in range(200):
        for d in core.step():
            out.extend(d.token_ids)
        if not core._requests:
            break
    return out


def to_np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the numpy array JAX holds (bf16 via ml_dtypes)."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.dtype(ml_dtypes.bfloat16):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def raw(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


# ---------------------------------------------------------------------------
# Block ops against make_block_ops


def _caches(dtype: str, seed: int = 0):
    """The same random cache contents on both sides (tiny-test geometry,
    8 pages of 8): (port cache dict, JAX cache dict)."""
    cfg = tcfg.get_config("tiny-test")
    quant = dtype == "int8"
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cc = tkv.KvCacheConfig(num_blocks=8, block_size=BS,
                           num_layers=cfg.num_layers,
                           num_kv_heads=cfg.num_kv_heads,
                           head_dim=cfg.head_dim, dtype=tdt,
                           kv_quant="int8" if quant else "none")
    rng = np.random.default_rng(seed)
    shape = (cc.num_slots, cc.feature_dim)
    sshape = (cc.num_slots, cc.num_kv_heads)
    jc = {"k": [], "v": []}
    if quant:
        jc.update(k_scale=[], v_scale=[])
    for kind in ("k", "v"):
        for _ in range(cc.num_layers):
            if quant:
                jc[kind].append(rng.integers(-127, 128, shape).astype(np.int8))
                jc[f"{kind}_scale"].append(
                    (rng.random(sshape) * 0.1).astype(np.float32))
            else:
                a = rng.standard_normal(shape).astype(np.float32)
                if tdt == torch.bfloat16:
                    a = a.astype(ml_dtypes.bfloat16)
                jc[kind].append(a)
    port = {k: [to_torch(a) for a in v] for k, v in jc.items()}
    return port, {k: [jnp.asarray(a) for a in v] for k, v in jc.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_extract_is_byte_equal_to_jax(dtype):
    port, jc = _caches(dtype)
    extract, _ = jkv.make_block_ops(BS)
    pages = [3, 1, 6, 2]
    got = tkv.extract_blocks(port, torch.tensor(pages), BS)
    assert got.shape[0] == len(pages)
    for i, page in enumerate(pages):
        want = np.asarray(extract(jc, np.int32(page)))
        mine = to_np(got[i])
        assert mine.dtype == want.dtype and mine.shape == want.shape
        assert raw(mine) == raw(want), (dtype, page)
    # The staging tensor shares no storage with the cache.
    for buf in port["k"] + port["v"]:
        assert buf.untyped_storage().data_ptr() != \
            got.untyped_storage().data_ptr()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_inject_is_byte_equal_to_jax(dtype):
    port, jc = _caches(dtype, seed=1)
    _, src = _caches(dtype, seed=2)
    extract, inject = jkv.make_block_ops(BS)
    wire = {page: np.asarray(extract(src, np.int32(page))) for page in (5, 1)}
    for page, block in wire.items():
        jc = inject(jc, np.int32(page), jnp.asarray(block))
    dest = [2, 7]
    tkv.inject_blocks(port, torch.tensor(dest),
                      torch.stack([to_torch(b) for b in wire.values()]), BS)
    # JAX injected into pages 5 and 1, the port into pages 2 and 7 (a
    # batch of two): page by page they must hold the same bytes.
    for (jpage, _), tpage in zip(wire.items(), dest):
        for key in jc:
            for layer in range(len(jc[key])):
                want = np.asarray(jc[key][layer])[jpage * BS:(jpage + 1) * BS]
                mine = to_np(port[key][layer][tpage * BS:(tpage + 1) * BS])
                assert raw(mine) == raw(want), (dtype, key, layer)
    # Every other page is untouched.
    fresh, _ = _caches(dtype, seed=1)
    for key in port:
        for layer in range(len(port[key])):
            for page in range(8):
                if page in dest:
                    continue
                sl = slice(page * BS, (page + 1) * BS)
                assert torch.equal(port[key][layer][sl], fresh[key][layer][sl])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_encode_block_equals_jax_and_roundtrips(dtype):
    port, _ = _caches(dtype)
    block = tkv.extract_blocks(port, torch.tensor([4]), BS)[0]
    mine = encode_block(123, block)
    want = jtransfer.encode_block(123, to_np(block))
    assert mine == want
    h, back = decode_block(mine)
    assert h == 123 and back.dtype == block.dtype
    assert torch.equal(back.view(torch.uint8), block.view(torch.uint8))
    # JAX decodes the port's message to the same array, and the reverse.
    jh, jarr = jtransfer.decode_block(mine)
    assert jh == 123 and raw(jarr) == raw(to_np(block))
    _, from_jax = decode_block(want)
    assert torch.equal(from_jax.view(torch.uint8), block.view(torch.uint8))


# ---------------------------------------------------------------------------
# Engines


@pytest.mark.parametrize("dtype,kv_quant", [
    ("float32", "none"), ("bfloat16", "none"), ("float32", "int8"),
    ("bfloat16", "int8")])
def test_jax_exported_blocks_onboard_into_port(weights, dtype, kv_quant):
    """Cross-package onboard: the JAX engine prefills, exports its sealed
    blocks; the port engine imports them and continues exactly as JAX
    (tiny-test at f32 and at bf16, llama-3-1b's dtype)."""
    jm, tm = jcfg.get_config("tiny-test"), tcfg.get_config("tiny-test")
    if dtype == "bfloat16":
        jm, tm = jm.replace(dtype=jnp.bfloat16), tm.replace(dtype=torch.bfloat16)
        params = jax_init_params(jm, jax.random.key(0))
        state = from_jax_params(jax.device_get(params), "cpu")
    else:
        params, state = weights
    jc = JaxEngineCore(JaxEngineConfig(
        model=jm, num_blocks=64, packed_prefill=True, kv_quant=kv_quant,
        scheduler=JaxSchedulerConfig(**GEOM)), params=params)
    want = run_core(jc, "a", PROMPT, sampling=JaxSamplingParams)
    hashes = compute_block_hashes(PROMPT, BS)
    exported = jc.export_blocks(hashes)
    assert len(exported) == 3
    tc = EngineCore(EngineConfig(
        model=tm, num_blocks=64, device="cpu", kv_quant=kv_quant,
        scheduler=SchedulerConfig(**GEOM)), params=state)
    blocks = {h: to_torch(np.asarray(a)) for h, a in exported.items()}
    assert tc.import_blocks(blocks) == 3
    assert tc.allocator.manager.onboarded_blocks == 3
    # What the port holds now is byte-equal to what JAX exported.
    back = tc.export_blocks(hashes)
    for h in hashes:
        assert raw(to_np(back[h])) == raw(np.asarray(exported[h]))
    got = run_core(tc, "b", PROMPT)
    assert got == want
    assert tc.scheduler.prefix_hit_tokens == 3 * BS


def test_export_import_between_port_engines(weights):
    params, state = weights
    want = run_core(jax_core(params), "j", PROMPT, sampling=JaxSamplingParams)
    a = port_core(state)
    assert run_core(a, "a", PROMPT) == want
    hashes = compute_block_hashes(PROMPT, BS)
    blocks = a.export_blocks(hashes)
    assert len(blocks) == 3
    shape = next(iter(blocks.values())).shape
    assert tuple(shape) == a.cache_cfg.block_wire_shape
    assert all(b.device.type == "cpu" for b in blocks.values())
    b = port_core(state)
    assert b.import_blocks(blocks) == 3
    assert b.import_blocks(blocks) == 0          # already resident
    hits = b.allocator.manager.device.hits
    assert run_core(b, "b", PROMPT) == want
    assert b.allocator.manager.device.hits >= hits + 3
    assert b.resident_prefix_blocks(hashes) == 3


def test_transfer_over_rpc_plane(weights):
    """A behind an RpcServer; B pulls with pull_prefix over the wire."""
    params, state = weights
    prompt = list(range(40, 70))     # 3 sealed blocks + tail
    want = run_core(jax_core(params), "j", prompt, sampling=JaxSamplingParams)

    async def main():
        eng_a = InferenceEngine(port_core(state))
        await eng_a.start()
        server = RpcServer()
        server.register(KV_BLOCKS_ENDPOINT, make_kv_blocks_handler(eng_a))
        addr = await server.start()
        eng_b = InferenceEngine(port_core(state))
        await eng_b.start()
        client = RpcClient(addr)
        try:
            out_a = []
            async for d in eng_a.generate("a", prompt,
                                          SamplingParams(max_tokens=4)):
                out_a.extend(d.token_ids)
            covered = await pull_prefix(eng_b, client, prompt, BS)
            assert covered == 24
            out_b = []
            async for d in eng_b.generate("b", prompt,
                                          SamplingParams(max_tokens=4)):
                out_b.extend(d.token_ids)
            assert out_a == out_b == want
            assert eng_b.core.allocator.manager.onboarded_blocks == 3
            assert eng_b.core.scheduler.prefix_hit_tokens == 24
            # Missing hashes are absent, not errors; the stream stops at
            # the first gap.
            assert await fetch_blocks(client, [999999]) == {}
            hashes = compute_block_hashes(prompt[:24], BS)
            got = await fetch_blocks(client, [hashes[0], 999, hashes[1]])
            assert list(got) == [hashes[0]]
        finally:
            await client.close()
            await server.stop()
            await eng_a.stop()
            await eng_b.stop()

    asyncio.run(asyncio.wait_for(main(), 120))


def test_quantized_block_roundtrip_over_wire(weights):
    params, state = weights
    want = run_core(jax_core(params, "int8"), "j", PROMPT,
                    sampling=JaxSamplingParams)
    a = port_core(state, "int8")
    assert run_core(a, "a", PROMPT) == want
    hashes = compute_block_hashes(PROMPT, BS)
    blocks = a.export_blocks(hashes)
    for data in blocks.values():
        assert data.dtype == torch.int8
        assert tuple(data.shape) == a.cache_cfg.block_wire_shape
    wired = dict(decode_block(encode_block(h, d)) for h, d in blocks.items())
    for h in hashes:
        assert torch.equal(wired[h], blocks[h])
    b = port_core(state, "int8")
    assert b.import_blocks(wired) == 3
    again = b.export_blocks(hashes)
    for h in hashes:
        assert torch.equal(again[h], blocks[h])   # pages and scales
    assert run_core(b, "b", PROMPT) == want
    assert b.scheduler.prefix_hit_tokens == 3 * BS


def test_mixed_kv_quant_peers_fail_loudly(weights):
    _, state = weights
    src8 = port_core(state, "int8")
    run_core(src8, "a", PROMPT)
    hashes = compute_block_hashes(PROMPT, BS)
    blocks8 = src8.export_blocks(hashes)
    dst = port_core(state)
    with pytest.raises(ValueError, match="kv_quant|KV block format"):
        dst.import_blocks(blocks8)
    mgr = dst.allocator.manager
    assert mgr.device.registry.by_hash == {}
    assert mgr.device.active_slots == 0 and mgr.onboarded_blocks == 0
    dst8 = port_core(state, "int8")
    fake = {hashes[0]: torch.zeros(dst.cache_cfg.block_wire_shape)}
    with pytest.raises(ValueError, match="kv_quant|KV block format"):
        dst8.import_blocks(fake)
    assert dst8.allocator.manager.device.active_slots == 0


# ---------------------------------------------------------------------------
# Work queues


def test_queue_push_pop_ack_redeliver_in_process():
    async def main():
        cp = InProcessControlPlane()
        await cp.start()
        try:
            await cp.queue_push("ns/q", {"n": 1})
            await cp.queue_push("ns/q", {"n": 2})
            assert await cp.queue_len("ns/q") == 2
            mid1, p1 = await cp.queue_pop("ns/q", visibility_timeout=60)
            assert p1 == {"n": 1} and await cp.queue_len("ns/q") == 1
            assert await cp.queue_ack("ns/q", mid1)
            assert not await cp.queue_ack("ns/q", mid1)   # once only
            # Popped and never acked: redelivered after the timeout.
            mid2, p2 = await cp.queue_pop("ns/q", visibility_timeout=0.05)
            assert p2 == {"n": 2} and await cp.queue_len("ns/q") == 0
            await asyncio.sleep(0.1)
            assert cp.state.redeliver_expired() == 1
            mid2b, p2b = await asyncio.wait_for(cp.queue_pop("ns/q", 60), 5)
            assert (mid2b, p2b) == (mid2, p2)
            assert await cp.queue_ack("ns/q", mid2)
            assert not cp.state._inflight_msgs
            # The reaper redelivers on its own.
            await cp.queue_push("ns/q", {"n": 3})
            mid3, _ = await cp.queue_pop("ns/q", visibility_timeout=0.05)
            again, _ = await asyncio.wait_for(cp.queue_pop("ns/q", 60), 5)
            assert again == mid3
        finally:
            await cp.close()

    asyncio.run(asyncio.wait_for(main(), 30))


def test_queue_items_survive_a_restart(tmp_path):
    from dynamo_tpu_torch.runtime.kv_store import FileBackend

    path = str(tmp_path / "cp.json")

    async def main():
        st = ControlPlaneState(backend=FileBackend(path))
        for n in range(12):          # ids past 9: numeric, not string, order
            st.queue_push("a/prefill_queue", {"n": n})
        mid, _ = await st.queue_pop("a/prefill_queue")
        assert st.queue_ack("a/prefill_queue", mid)
        await st.queue_pop("a/prefill_queue")          # popped, unacked
        st2 = ControlPlaneState(backend=FileBackend(path))
        assert st2.queue_len("a/prefill_queue") == 11
        got = [(await st2.queue_pop("a/prefill_queue"))[1]["n"]
               for _ in range(11)]
        assert got == list(range(1, 12))
        assert st2.get_prefix("") == {}               # queues stay hidden
        st2.queue_push("a/prefill_queue", {"n": 99})
        mid99, _ = await st2.queue_pop("a/prefill_queue")
        assert mid99 == 13                             # ids keep counting

    asyncio.run(asyncio.wait_for(main(), 30))


@pytest.mark.parametrize("server_side,client_side", [
    ("jax", "port"), ("port", "jax")])
def test_queue_ops_over_tcp_interoperate(server_side, client_side):
    """The queue ops' JSON lines are JAX's: each side's client against
    the other side's server."""
    server_cls = (jcp_tcp if server_side == "jax" else tcp_tcp).ControlPlaneServer
    client_cls = (jcp_tcp if client_side == "jax" else tcp_tcp).ControlPlaneClient

    async def main():
        srv = server_cls()
        port = await srv.start()
        cli = client_cls("127.0.0.1", port)
        await cli.start()
        try:
            popper = asyncio.create_task(cli.queue_pop("ns/q", 60))
            await asyncio.sleep(0.05)
            assert not popper.done()                  # waits for an item
            await cli.queue_push("ns/q", {"token_ids": [1, 2, 3]})
            mid, payload = await asyncio.wait_for(popper, 5)
            assert payload == {"token_ids": [1, 2, 3]}
            await cli.queue_push("ns/q", {"n": 2})
            assert await cli.queue_len("ns/q") == 1
            assert await cli.queue_ack("ns/q", mid)
            assert not await cli.queue_ack("ns/q", mid)
            mid2, _ = await cli.queue_pop("ns/q", visibility_timeout=0.05)
            await asyncio.sleep(0.1)
            srv.state.redeliver_expired()
            mid2b, p2 = await asyncio.wait_for(cli.queue_pop("ns/q", 60), 5)
            assert mid2b == mid2 and p2 == {"n": 2}
            assert await cli.queue_len("ns/q") == 0
        finally:
            await cli.close()
            await srv.stop()

    asyncio.run(asyncio.wait_for(main(), 30))


# ---------------------------------------------------------------------------
# Imports


def test_data_plane_modules_import_nothing_of_jax():
    mods = ["dynamo_tpu_torch.llm.block_manager.transfer",
            "dynamo_tpu_torch.llm.block_manager.device_transfer",
            "dynamo_tpu_torch.llm.block_manager.eager",
            "dynamo_tpu_torch.llm.block_manager.prefix_share",
            "dynamo_tpu_torch.llm.disagg",
            "dynamo_tpu_torch.fleet.topology",
            "dynamo_tpu_torch.llm.kv_router.client",
            "dynamo_tpu_torch.worker.main",
            "dynamo_tpu_torch.runtime.control_plane_tcp"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'dynamo_tpu', 'ml_dtypes', 'msgpack'))\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
