"""The port's prefix cache against the JAX package's, on the CPU.

- Block hashes: `dynamo_tpu_torch.tokens` (its own pure-Python xxh3_64)
  gives the values of `dynamo_tpu.tokens` (the xxhash package) for every
  xxh3 length class, salts of 0-300 bytes and block sizes 1-256.
- `BlockPool` / `KvBlockManager` / `ManagedBlockSource` follow the JAX
  classes through one operation sequence: match, pin, release, LRU
  eviction, re-register, flush.
- Scheduler admission gives JAX's hit and miss tokens, pages and
  prefill starts.
- Engines on both sides with `enable_prefix_cache=True`, unquantized and
  int8 caches: a two-wave fleet over a shared 3-block prefix emits the
  same greedy tokens and the same `prefix_hit_tokens`, and so does a
  run whose preempted request hits again on re-admission.

Everything here is exact: hashes, pool states, token ids and counts.
"""

import os

import jax
import numpy as np
import pytest
import xxhash

from dynamo_tpu import tokens as jtok
from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.llm.block_manager import engine_source as jsrc
from dynamo_tpu.llm.block_manager import manager as jman
from dynamo_tpu.llm.block_manager import pool as jpool
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch import tokens as ttok
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.llm.block_manager import (
    BlockPool,
    KvBlockManager,
    ManagedBlockSource,
    TieredConfig,
)
from dynamo_tpu_torch.llm.block_manager import engine_source as tsrc_mod
from dynamo_tpu_torch.llm.block_manager import manager as tman
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

GEOM = dict(max_seqs=8, block_size=8, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16))


# ---------------------------------------------------------------------------
# Hashes


@pytest.mark.parametrize("lo,hi", [(9, 17), (17, 129), (129, 241),
                                   (241, 1100), (2040, 2100)])
def test_xxh3_64_matches_xxhash_per_length_class(lo, hi):
    """Each length class of XXH3_64bits; 241-1100 spans the striped path
    up to a first scramble (1024), 2040-2100 a second one (2048)."""
    rng = np.random.default_rng(lo)
    for n in range(lo, hi):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttok.xxh3_64(data) == xxhash.xxh3_64_intdigest(data), n
    with pytest.raises(ValueError):
        ttok.xxh3_64(b"12345678")


@pytest.mark.parametrize("block_size", list(range(1, 257)))
def test_block_hashes_match_jax(block_size):
    rng = np.random.default_rng(block_size)
    toks = rng.integers(0, 2 ** 32, 2 * block_size + 3,
                        dtype=np.uint64).tolist()
    got = ttok.compute_block_hashes(toks, block_size)
    assert got == jtok.compute_block_hashes(toks, block_size)
    assert len(got) == len(toks) // block_size
    parent = int(rng.integers(0, 2 ** 63))
    assert (ttok.hash_block(parent, toks[:block_size])
            == jtok.hash_block(parent, toks[:block_size]))


def test_salted_hasher_and_block_sequence_match_jax():
    for n in range(0, 301):
        salt = os.urandom(n)
        t, j = ttok.SaltedBlockHasher(salt), jtok.SaltedBlockHasher(salt)
        assert t.root == j.root, n
    salt = b"adapter:x"
    toks = list(range(100, 140))
    assert (ttok.SaltedBlockHasher(salt).block_hashes(toks, 8)
            == jtok.SaltedBlockHasher(salt).block_hashes(toks, 8))
    ts, js = ttok.TokenBlockSequence(block_size=8), jtok.TokenBlockSequence(
        block_size=8)

    def fields(blocks):
        if not isinstance(blocks, list):
            blocks = [] if blocks is None else [blocks]
        return [(b.tokens, b.block_hash, b.parent_hash, b.position)
                for b in blocks]

    assert fields(ts.extend(toks[:13])) == fields(js.extend(toks[:13]))
    for x in toks[13:30]:
        assert fields(ts.append(x)) == fields(js.append(x))
    assert fields(ts.extend(toks[30:])) == fields(js.extend(toks[30:]))
    assert (ts.block_hashes, ts.last_hash(), len(ts)) == (
        js.block_hashes, js.last_hash(), len(js))
    with pytest.raises(ValueError):
        ttok.compute_block_hashes([1, -2, 3], 1)
    with pytest.raises(ValueError):
        ttok.TokenBlockSequence(block_size=4).append(2 ** 32)


# ---------------------------------------------------------------------------
# Pool, manager, block source


def _pool_state(p):
    return (p.free_slots, p.reusable_slots, p.active_slots, p.hits,
            p.misses, p.evictions, list(p.registry.inactive),
            sorted(p.registry.by_hash))


def test_block_pool_follows_jax():
    """One operation sequence on both pools (capacity 6, null slot
    reserved): allocate, register, match and pin, release into the LRU,
    duplicate registration, eviction under pressure, re-register, flush."""
    t = BlockPool(6, reserve_null=True)
    j = jpool.BlockPool(6, reserve_null=True)
    ops = [("allocate", 3), ("register", 1, 11), ("register", 2, 12),
           ("register", 3, 13), ("release", [1, 2, 3]),
           ("match", [11, 12, 99]), ("allocate", 2), ("register", 4, 12),
           ("release", [1, 2]), ("allocate", 3), ("register", 5, 21),
           ("match", [11]), ("register", 1, 31), ("release", [1, 3, 4, 5]),
           ("match", [31, 13]), ("allocate", 2), ("release", [1]),
           ("clear",)]
    for op in ops:
        outs = []
        for p in (t, j):
            if op[0] == "allocate":
                outs.append(p.allocate(op[1]))
            elif op[0] == "register":
                outs.append(p.register(op[1], op[2]))
            elif op[0] == "release":
                outs.append(p.release(op[1]))
            elif op[0] == "match":
                outs.append(p.acquire_matched(
                    p.match_sequence_hashes(op[1])))
            else:
                outs.append(sorted(p.clear_inactive()))
        assert outs[0] == outs[1], op
        assert _pool_state(t) == _pool_state(j), op
    assert t.evictions == j.evictions > 0
    with pytest.raises(RuntimeError):
        t.allocate(99)


def test_manager_and_block_source_follow_jax():
    tsrc = ManagedBlockSource(TieredConfig(device_blocks=8, block_size=4))
    jsrc_ = jsrc.ManagedBlockSource(jman.TieredConfig(device_blocks=8,
                                                      block_size=4))
    prompt = list(range(1, 15))           # 3 sealed blocks + 2 tokens
    for src in (tsrc, jsrc_):
        pages = src.allocate(4)
        for i, h in enumerate(src.prompt_hashes(prompt)):
            src.register_block(pages[i], h)
        src.release(pages)
    assert tsrc.prompt_hashes(prompt) == jsrc_.prompt_hashes(prompt)
    for probe in (prompt, prompt[:9] + [99] * 5, prompt[:3]):
        got = tsrc.match(probe)
        assert got == jsrc_.match(probe)
        tsrc.release(got[1])
        jsrc_.release(got[1])
    assert (tsrc.free_blocks, tsrc.usage, tsrc.num_blocks) == (
        jsrc_.free_blocks, jsrc_.usage, jsrc_.num_blocks)
    for key, val in tsrc.stats.items():
        if key in jsrc_.stats:
            assert val == jsrc_.stats[key], key
    assert tsrc.clear_cache() == jsrc_.clear_cache() == 3
    with pytest.raises(ValueError, match="queue A item 6"):
        KvBlockManager(TieredConfig(device_blocks=8, host_blocks=4))
    with pytest.raises(ValueError, match="queue A item 6"):
        TieredConfig(device_blocks=8, disk_blocks=4)


def test_scheduler_admission_hits_match_jax():
    """Admissions against a warmed cache: a full hit (the last prompt
    token recomputed), a partial hit, a miss, and a refusal that must
    give its pinned pages back."""
    bs = 4

    def build(mod, src_mod, cfg_mod):
        src = src_mod.ManagedBlockSource(cfg_mod.TieredConfig(
            device_blocks=10, block_size=bs))
        sched = mod.Scheduler(mod.SchedulerConfig(
            max_seqs=4, block_size=bs, max_pages_per_seq=8,
            max_prefill_chunk=16, prefill_buckets=(8, 16),
            decode_buckets=(1, 2, 4)), src)
        return src, sched

    sides = [build(tsched, tsrc_mod, tman), build(jsched, jsrc, jman)]
    warm = list(range(1, 13))                           # 3 sealed blocks
    for src, _ in sides:
        pages = src.allocate(3)
        for p, h in zip(pages, src.prompt_hashes(warm)):
            src.register_block(p, h)
        src.release(pages)
    prompts = {"full": warm, "part": warm[:8] + [50, 51, 52],
               "miss": [70, 71, 72, 73, 74], "big": list(range(200, 228))}
    reqs = []
    for (src, sched), mod, sp in ((sides[0], tsched, SamplingParams),
                                  (sides[1], jsched, JaxSamplingParams)):
        rs = [mod.Request(request_id=r, prompt_tokens=list(p),
                          sampling=sp(max_tokens=4))
              for r, p in prompts.items()]
        for r in rs:
            sched.add_request(r)
        sched.plan()
        reqs.append(rs)
    (tsrc, ts), (jsrc_, js) = sides
    assert (ts.prefix_hit_tokens, ts.prefix_miss_tokens) == (
        js.prefix_hit_tokens, js.prefix_miss_tokens) == (11 + 8, 1 + 3 + 5)
    for a, b in zip(*reqs):
        assert (a.state.value, a.prefilled, a.pages,
                a.cached_prompt_tokens, a.block_hashes) == (
            b.state.value, b.prefilled, b.pages, b.cached_prompt_tokens,
            b.block_hashes)
    # "big" (8 pages) did not fit: its matched pages went back.
    assert reqs[0][3].state.value == "waiting"
    assert tsrc.free_blocks == jsrc_.free_blocks
    # Preemption forgets the hashes (the prompt grows by the outputs).
    ts.preempt(reqs[0][0])
    js.preempt(reqs[1][0])
    assert reqs[0][0].block_hashes is None is reqs[1][0].block_hashes
    assert tsrc.free_blocks == jsrc_.free_blocks


# ---------------------------------------------------------------------------
# Engines


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jcfg.get_config("tiny-test"),
                                jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def _engines(weights, kv_quant, num_blocks):
    params, state = weights
    j = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=num_blocks,
        packed_prefill=True, enable_prefix_cache=True, kv_quant=kv_quant,
        scheduler=jsched.SchedulerConfig(**GEOM)), params=params)
    t = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=num_blocks,
        device="cpu", kv_quant=kv_quant, enable_prefix_cache=True,
        scheduler=tsched.SchedulerConfig(**GEOM)), params=state)
    assert isinstance(t.allocator, ManagedBlockSource)
    return j, t


def _wave(core, prompts, sp, n_out, max_steps=2000):
    for rid, p in prompts.items():
        core.add_request(rid, p, sp(max_tokens=n_out))
    out = {}
    for _ in range(max_steps):
        for d in core.step():
            out.setdefault(d.request_id, []).extend(d.token_ids)
        if not core._requests:
            break
    return out


SHARED = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 11, 12, 13, 14, 15, 16,
          21, 22, 23, 24, 25, 26, 27, 28]          # 3 blocks of 8


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_two_wave_fleet_with_shared_prefix_matches_jax(weights, kv_quant):
    """Wave 1 computes the shared prefix (nothing cached yet); wave 2 hits
    its 3 blocks (one prompt ends exactly on them: its last token is
    recomputed).  Tokens and hit/miss counts equal JAX's, wave by wave."""
    jcore, tcore = _engines(weights, kv_quant, 64)
    waves = [{"a": SHARED + [40, 41, 42], "b": SHARED + [50, 51]},
             {"c": SHARED + [60, 61, 62, 63, 64], "d": SHARED[:],
              "e": SHARED[:16] + [70]}]
    for i, prompts in enumerate(waves):
        want = _wave(jcore, prompts, JaxSamplingParams, 10)
        got = _wave(tcore, prompts, SamplingParams, 10)
        assert got == want and all(len(t) == 10 for t in got.values())
        hits = (tcore.scheduler.prefix_hit_tokens,
                tcore.scheduler.prefix_miss_tokens)
        assert hits == (jcore.scheduler.prefix_hit_tokens,
                        jcore.scheduler.prefix_miss_tokens)
    # Wave 2: c and e hit whole blocks, d hits all but its last token.
    assert tcore.scheduler.prefix_hit_tokens == 24 + 23 + 16
    assert tcore.counters.window_dispatches > 0
    assert tcore.prefix_cache_stats()["hit_rate"] > 0
    # Every page is back: free or cached for reuse.
    assert tcore.allocator.free_blocks == 63


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_preempted_request_hits_again_on_readmission(weights, kv_quant):
    """12 blocks of 8 tokens, two requests growing to ~48 tokens: one is
    preempted, and its re-admission matches the blocks it had sealed.
    Tokens and hit counts equal JAX's."""
    jcore, tcore = _engines(weights, kv_quant, 12)
    preempted = []
    orig = tcore.scheduler.preempt
    tcore.scheduler.preempt = lambda req: (preempted.append(
        (req.request_id, len(req.prompt_tokens) + len(req.output_tokens))),
        orig(req))
    prompts = {"a": SHARED[:12], "b": SHARED[:12] + [90, 91]}
    want = _wave(jcore, prompts, JaxSamplingParams, 34)
    got = _wave(tcore, prompts, SamplingParams, 34)
    assert preempted, "the scenario must preempt"
    assert got == want and all(len(t) == 34 for t in got.values())
    assert (tcore.scheduler.prefix_hit_tokens,
            tcore.scheduler.prefix_miss_tokens) == (
        jcore.scheduler.prefix_hit_tokens, jcore.scheduler.prefix_miss_tokens)
    # b's admission hits a's first block; the re-admission hits more.
    assert tcore.scheduler.prefix_hit_tokens > 8
