"""The port's KV tiers (G2 host, G3 disk, the G4 remote hook) against the
JAX package's, on the CPU.

- Manager step for step: one seeded sequence of seal (allocate, register,
  release), match-and-onboard, demote, import and flush operations goes
  through JAX's `ManagedBlockSource` (numpy extract and inject over a
  block array) and the port's (torch over the same values), for G1 only,
  G1+G2, G1+G2+G3 and all four tiers.  Every result, the shared `stats`,
  each tier's residency and LRU order, the REMOVED events in order and
  the bytes every known block exports are equal after every operation.
- Batched offload: one `allocate` that evicts several blocks extracts
  once in the port (JAX once a block) with the same REMOVED order.
- Engines (tiny-test and tiny-moe, the same weights on both sides): the
  scenarios of JAX's tests/test_engine.py (G2 offload and onboard, REMOVED
  events), test_kv_quant.py (int8 with G2), test_kv_metrics.py (the host
  tier's series), test_kv_transfer.py (the G4 hook, export from G2),
  test_prefix_share.py (the eviction bias on G1 and G2), with a G3 leg
  added: greedy tokens, KV events and counters equal; a block read back
  from G2 or G3 is bit-equal to the bytes it had in G1.  (QoS demotion
  into G2: test_torch_kv_tiers_qos.py.)
- A donor whose prefix sits in G2 serves it over the host-staged plane to
  a puller whose device plane it cannot serve; the puller's tokens equal
  JAX's.

Tolerance: none; everything is exact.
"""

import asyncio
import tempfile

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.llm.block_manager import engine_source as jsrc
from dynamo_tpu.llm.block_manager import manager as jman
from dynamo_tpu.llm.block_manager.pool import slo_eviction_bias as jbias
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.runtime import metrics as jmetrics
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore, InferenceEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.llm.block_manager import ManagedBlockSource, TieredConfig
from dynamo_tpu_torch.llm.block_manager import device_transfer as dt
from dynamo_tpu_torch.llm.block_manager.pool import slo_eviction_bias as tbias
from dynamo_tpu_torch.llm.block_manager.prefix_share import PrefixFetcher
from dynamo_tpu_torch.llm.block_manager.transfer import (
    KV_BLOCKS_ENDPOINT,
    make_kv_blocks_handler,
)
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.runtime import metrics as tmetrics
from dynamo_tpu_torch.runtime.rpc import RpcClient, RpcServer
from dynamo_tpu_torch.tokens import compute_block_hashes
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

BS = 8
WIRE = (2, 3)


@pytest.fixture(autouse=True)
def private_tmp(tmp_path, monkeypatch):
    """JAX names its disk tier's file after the pid alone: give each test
    a temp dir of its own."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


# ---------------------------------------------------------------------------
# The manager, step for step


class _Side:
    """One package's block source over a block array of its own."""

    def __init__(self, jax_side: bool, cfg: dict, remote: dict):
        self.jax = jax_side
        self.events = []
        self.extracts = 0
        n = cfg["device_blocks"]
        if jax_side:
            self.cache = np.zeros((n, *WIRE), np.float32)
            self.src = jsrc.ManagedBlockSource(
                jman.TieredConfig(block_size=BS, **cfg),
                extract_fn=self._j_extract, inject_fn=self._j_inject,
                on_removed=self.events.append,
                remote_fetch_fn=(lambda h: remote.get(h)) if remote else None)
        else:
            self.cache = torch.zeros((n, *WIRE))
            self.src = ManagedBlockSource(
                TieredConfig(block_size=BS, **cfg),
                on_removed=self.events.append,
                extract_fn=self._t_extract, inject_fn=self._t_inject,
                remote_fetch_fn=((lambda h: None if h not in remote
                                  else torch.from_numpy(remote[h]))
                                 if remote else None),
                wire_shape=WIRE, wire_dtype=torch.float32, device="cpu")
        self.mgr = self.src.manager

    def _j_extract(self, slot):
        self.extracts += 1
        return self.cache[slot].copy()

    def _j_inject(self, slot, data):
        self.cache[slot] = np.asarray(data)

    def _t_extract(self, pages):
        self.extracts += 1
        return self.cache[torch.tensor(pages)].clone()

    def _t_inject(self, pages, data):
        self.cache[torch.tensor(pages)] = data

    def fill(self, page, value):
        vals = value + np.arange(6, dtype=np.float32).reshape(WIRE) / 8
        self.cache[page] = vals if self.jax else torch.from_numpy(vals)

    def export(self, h):
        data = self.mgr.export_block(h)
        return None if data is None else np.asarray(data)


def _tier_state(pool):
    if pool is None:
        return None
    return (pool.free_slots, pool.active_slots, list(pool.registry.inactive),
            sorted(pool.registry.by_hash), pool.hits, pool.misses)


def _state(side):
    m = side.mgr
    return [_tier_state(p) for p in (m.device, m.host, m.disk)]


def _ops(seed, cfg, remote):
    """A seeded operation script that stays valid on both sides."""
    rng = np.random.default_rng(seed)
    seqs, ops, nxt = [], [], [1000]
    for _ in range(40):
        kind = rng.choice(["seal", "seal", "match", "match", "demote",
                           "import"])
        if kind == "seal" or not seqs:
            k = int(rng.integers(1, 4))
            seq = [nxt[0] + i for i in range(k)]
            nxt[0] += k
            seqs.append(seq)
            ops.append(("seal", seq))
        elif kind == "match":
            seq = seqs[int(rng.integers(len(seqs)))]
            probe = list(seq)
            if remote and rng.random() < 0.3:
                probe = sorted(remote)[:int(rng.integers(1, 3))]
            ops.append(("match", probe))
        elif kind == "demote":
            seq = seqs[int(rng.integers(len(seqs)))]
            ops.append(("demote", seq))
        else:
            ops.append(("import", nxt[0]))
            nxt[0] += 1
    ops.append(("clear",))
    return ops


def _apply(side, op):
    src, mgr = side.src, side.mgr
    if op[0] == "seal":
        seq = op[1]
        if src.free_blocks < len(seq):
            return "full"
        pages = src.allocate(len(seq))
        for p, h in zip(pages, seq):
            side.fill(p, float(h % 97))
            src.register_block(p, h)
        src.release(pages)
        return pages
    if op[0] == "match":
        n, ids = mgr.match_and_onboard(op[1])
        src.release(ids)
        return n, ids
    if op[0] == "demote":
        return mgr.demote_blocks(op[1])
    if op[0] == "import":
        data = np.full(WIRE, op[1] % 89, np.float32)
        return mgr.import_block(op[1], data if side.jax
                                else torch.from_numpy(data))
    return sorted(mgr.clear_cache())


TIER_CFGS = {
    "g1": dict(device_blocks=8),
    "g2": dict(device_blocks=8, host_blocks=6),
    "g3": dict(device_blocks=8, host_blocks=4, disk_blocks=6),
    "g4": dict(device_blocks=6, host_blocks=3, disk_blocks=3),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("tiers", list(TIER_CFGS))
def test_manager_step_for_step_equal_jax(tiers, seed):
    cfg = TIER_CFGS[tiers]
    remote = ({h: np.full(WIRE, h % 83, np.float32)
               for h in (900001, 900002)} if tiers == "g4" else {})
    j, t = _Side(True, cfg, remote), _Side(False, cfg, remote)
    known = set()
    try:
        for op in _ops(seed, cfg, remote):
            got, want = _apply(t, op), _apply(j, op)
            assert got == want, op
            if op[0] in ("seal", "match"):
                known.update(op[1])
            elif op[0] == "import":
                known.add(op[1])
            assert _state(t) == _state(j), op
            assert t.events == j.events, op
            jstats = j.mgr.stats
            assert {k: t.mgr.stats[k] for k in jstats} == jstats, op
            for h in sorted(known):
                a, b = t.export(h), j.export(h)
                assert (a is None) == (b is None), (op, h)
                if a is not None:
                    assert a.tobytes() == b.tobytes(), (op, h)
        if tiers != "g1":
            assert t.mgr.offloaded_blocks > 0
        if tiers == "g4":
            assert t.mgr.remote_fetched_blocks > 0
    finally:
        j.mgr.close()
        t.mgr.close()


def test_batched_offload_keeps_jax_removed_order():
    """One allocate evicting five blocks: the port extracts them in one
    call (JAX in five), with the same REMOVED order and G2 contents."""
    cfg = dict(device_blocks=8, host_blocks=8)
    j, t = _Side(True, cfg, {}), _Side(False, cfg, {})
    for side in (j, t):
        for seq in ([1, 2, 3], [4, 5], [6, 7]):
            pages = side.src.allocate(len(seq))
            for p, h in zip(pages, seq):
                side.fill(p, float(h))
                side.src.register_block(p, h)
            side.src.release(pages)
        side.extracts = 0
        side.src.allocate(5)
    assert t.events == j.events and len(t.events) == 5
    assert (t.extracts, j.extracts) == (1, 5)
    assert _state(t) == _state(j)
    for h in range(1, 8):
        a, b = t.export(h), j.export(h)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.tobytes() == b.tobytes()
    j.mgr.close()
    t.mgr.close()


def test_tiered_config_and_disk_file_lifecycle(tmp_path):
    """Both tiers construct; the disk tier's file lives in the temp dir
    until `close`; a tier without the wire format is refused."""
    side = _Side(False, dict(device_blocks=4, host_blocks=2, disk_blocks=2),
                 {})
    path = side.mgr._disk_file
    assert path.startswith(str(tmp_path))
    assert side.mgr.stats["g2_resident"] == side.mgr.stats["g3_resident"] == 0
    side.mgr.close()
    assert not (tmp_path / path.rsplit("/", 1)[-1]).exists()
    with pytest.raises(ValueError, match="wire shape"):
        ManagedBlockSource(TieredConfig(device_blocks=4, host_blocks=2))
    bias = tbias(lambda: 2.0)
    mgr = ManagedBlockSource(TieredConfig(device_blocks=8, host_blocks=4),
                             wire_shape=WIRE, wire_dtype=torch.float32,
                             device="cpu").manager
    mgr.set_eviction_bias(bias)
    assert mgr.device.eviction_bias is bias and mgr.host.eviction_bias is bias
    jm = jman.KvBlockManager(jman.TieredConfig(device_blocks=8,
                                               host_blocks=4, block_size=BS))
    jm.set_eviction_bias(jbias(lambda: 2.0))
    assert (jm.device.eviction_bias is not None
            and jm.host.eviction_bias is not None)
    jm.close()


# ---------------------------------------------------------------------------
# Engines


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name in ("tiny-test", "tiny-moe"):
        params = jax_init_params(jcfg.get_config(name), jax.random.key(0))
        out[name] = (params, from_jax_params(jax.device_get(params), "cpu"))
    return out


GEOM = dict(max_seqs=4, block_size=BS, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4),
            prefill_buckets=(8, 16))


def _pair(weights, model="tiny-test", **kw):
    params, state = weights[model]
    jev, tev = [], []
    extra = {"moe_mode": "dense"} if model == "tiny-moe" else {}
    j = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config(model), packed_prefill=True,
        scheduler=jsched.SchedulerConfig(**GEOM), **extra, **kw),
        params=params, kv_event_sink=jev.append)
    t = EngineCore(EngineConfig(
        model=tcfg.get_config(model), device="cpu",
        scheduler=tsched.SchedulerConfig(**GEOM), **kw),
        params=state, kv_event_sink=tev.append)
    return (j, jev), (t, tev)


def _run(core, rid, prompt, n=4, priority=None):
    sp = (SamplingParams if isinstance(core, EngineCore)
          else JaxSamplingParams)
    kw = {} if priority is None else {"priority": priority}
    core.add_request(rid, list(prompt), sp(max_tokens=n), **kw)
    out = []
    for _ in range(500):
        for d in core.step():
            out.extend(d.token_ids)
        if not core._requests:
            break
    return out


def _events(events):
    return [(e.data.kind.value,
             list(e.data.store.block_hashes) if e.data.store else
             list(e.data.remove.block_hashes)) for e in events]


def _g1_bytes(core, hashes):
    return {h: b.clone() for h, b in core.export_blocks(hashes).items()}


def _close(*cores):
    for c in cores:
        c.allocator.manager.close()


CHURN = [[100 + 16 * i + j for j in range(16)] for i in range(4)]


@pytest.mark.parametrize("model,kv_quant,tiers", [
    ("tiny-test", "none", dict(host_blocks=16)),
    ("tiny-test", "int8", dict(host_blocks=16)),
    ("tiny-test", "none", dict(host_blocks=2, disk_blocks=16)),
    ("tiny-test", "int8", dict(host_blocks=2, disk_blocks=16)),
    ("tiny-moe", "none", dict(host_blocks=16)),
])
def test_offload_and_onboard_equal_jax(weights, model, kv_quant, tiers):
    """JAX's test_managed_eviction_emits_removed_and_offloads (and, int8,
    test_quantized_tier_offload_onboard_roundtrip): churn evicts a's
    blocks into G2 (or through it into G3); a's prompt again onboards
    them and answers as before.  Tokens, events and counts equal JAX's;
    the onboarded bytes equal the bytes a's blocks had in G1."""
    (j, jev), (t, tev) = _pair(weights, model, num_blocks=9,
                               kv_quant=kv_quant, **tiers)
    prompt_a = list(range(1, 17))
    hashes = compute_block_hashes(prompt_a, BS)
    try:
        want = [_run(j, "a", prompt_a, 2)]
        got = [_run(t, "a", prompt_a, 2)]
        before = _g1_bytes(t, hashes)
        assert len(before) == 2
        for i, p in enumerate(CHURN):
            want.append(_run(j, f"c{i}", p, 2))
            got.append(_run(t, f"c{i}", p, 2))
        tm, jm = t.allocator.manager, j.allocator.manager
        assert tm.offloaded_blocks == jm.offloaded_blocks > 0
        assert t.resident_prefix_blocks(hashes) == 2
        assert not tm.resident_pages(hashes)       # only below G1
        assert t.export_blocks_device(hashes) == {}
        lower = t.export_blocks(hashes)
        for h in hashes:
            assert torch.equal(lower[h].view(torch.uint8),
                               before[h].view(torch.uint8))
        want.append(_run(j, "a2", prompt_a, 2))
        got.append(_run(t, "a2", prompt_a, 2))
        assert got == want and got[-1] == got[0]
        assert tm.onboarded_blocks == jm.onboarded_blocks > 0
        assert _events(tev) == _events(jev)
        assert any(k == "removed" for k, _ in _events(tev))
        jstats = j.allocator.stats
        assert {k: t.allocator.stats[k] for k in jstats} == jstats
        if "disk_blocks" in tiers:
            assert t.allocator.stats["g3_resident"] > 0
        after = _g1_bytes(t, hashes)
        for h in hashes:
            assert torch.equal(after[h].view(torch.uint8),
                               before[h].view(torch.uint8))
        assert (t.scheduler.prefix_hit_tokens
                == j.scheduler.prefix_hit_tokens > 0)
    finally:
        _close(j, t)


def test_host_tier_pool_series_equal_jax(weights):
    """JAX's test_host_tier_pool_series_after_offload: the host tier's
    pool series, and after churn every dynamo_kv_ line, equal JAX's."""
    (j, _), (t, _) = _pair(weights, num_blocks=9, host_blocks=8,
                           disk_blocks=4)
    try:
        for i, p in enumerate([list(range(1, 17))] + CHURN):
            assert _run(t, f"r{i}", p, 2) == _run(j, f"r{i}", p, 2)
        texts = []
        for mod, core in ((tmetrics, t), (jmetrics, j)):
            reg = mod.MetricsRegistry()
            mod.KvCacheMetrics(reg).observe_engine(core)
            texts.append(sorted(line for line in reg.expose().splitlines()
                                if "pool" in line or "evictions" in line))
        assert texts[0] == texts[1]
        assert ('dynamo_kv_pool_capacity_blocks{pool="G2-host",tier="host"} '
                '8.0') in texts[0]
        assert any('tier="disk"' in line for line in texts[0])
    finally:
        _close(j, t)


def test_g4_remote_tier_equal_jax(weights):
    """JAX's test_g4_remote_tier_onboards_peer_blocks: a local-tier miss
    pulls the peer's blocks through `remote_fetch_fn`; tokens and fetch
    counts equal JAX's, and a repeat hits G1 with no further fetch.  The
    peer serves them from G2 (its export searches every tier)."""
    prompt = list(range(1, 25))
    (ja, _), (ta, _) = _pair(weights, num_blocks=9, host_blocks=16)
    try:
        out_a = _run(ta, "a", prompt)
        assert out_a == _run(ja, "a", prompt)
        for i, p in enumerate(CHURN):
            _run(ta, f"c{i}", p, 2)
            _run(ja, f"c{i}", p, 2)
        hashes = compute_block_hashes(prompt, BS)
        assert not ta.allocator.manager.resident_pages(hashes)
        fetches = {"t": [], "j": []}

        def fetch(core, key):
            def f(h):
                fetches[key].append(h)
                return core.export_blocks([h]).get(h)
            return f

        params, state = weights["tiny-test"]
        jb = JaxEngineCore(JaxEngineConfig(
            model=jcfg.get_config("tiny-test"), num_blocks=64,
            packed_prefill=True, remote_fetch_fn=fetch(ja, "j"),
            scheduler=jsched.SchedulerConfig(**GEOM)), params=params)
        tb = EngineCore(EngineConfig(
            model=tcfg.get_config("tiny-test"), num_blocks=64, device="cpu",
            remote_fetch_fn=fetch(ta, "t"),
            scheduler=tsched.SchedulerConfig(**GEOM)), params=state)
        assert _run(tb, "b", prompt) == _run(jb, "b", prompt) == out_a
        assert fetches["t"] == fetches["j"] == hashes
        assert (tb.allocator.manager.remote_fetched_blocks
                == jb.allocator.manager.remote_fetched_blocks == 3)
        assert _run(tb, "b2", prompt) == out_a
        assert len(fetches["t"]) == 3
        _close(jb, tb)
    finally:
        _close(ja, ta)


def test_g4_block_of_the_other_kv_mode_is_refused(weights):
    """A remote tier that answers with int8 packed blocks for a bf16 cache
    raises, as the JAX engine's inject does, and leaves no page
    registered over them."""
    _, state = weights["tiny-test"]
    src8 = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=64, device="cpu",
        kv_quant="int8", scheduler=tsched.SchedulerConfig(**GEOM)),
        params=state)
    prompt = list(range(1, 25))
    _run(src8, "a", prompt)
    dst = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=64, device="cpu",
        remote_fetch_fn=lambda h: src8.export_blocks([h]).get(h),
        scheduler=tsched.SchedulerConfig(**GEOM)), params=state)
    with pytest.raises(ValueError, match="KV block format"):
        dst.allocator.match(prompt)
    assert dst.allocator.manager.device.registry.by_hash == {}


# ---------------------------------------------------------------------------
# A donor's G2 prefix over the host-staged plane


def test_donor_serves_g2_prefix_over_the_host_plane(weights):
    """The donor's prefix sits in G2, where its device plane cannot offer
    it: the pull switches to the host-staged wire, which exports it from
    G2; the puller prefills only the tail and answers as JAX does."""
    params, state = weights["tiny-test"]
    prompt = list(range(1, 36))           # 4 sealed blocks + 3 tokens
    jcore = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=64,
        packed_prefill=True, scheduler=jsched.SchedulerConfig(**GEOM)),
        params=params)
    want = _run(jcore, "ref", prompt)

    def engine(**kw):
        return InferenceEngine(EngineCore(EngineConfig(
            model=tcfg.get_config("tiny-test"), device="cpu",
            scheduler=tsched.SchedulerConfig(**GEOM), **kw), params=state))

    async def main():
        donor = engine(num_blocks=9, host_blocks=16)
        puller = engine(num_blocks=64)
        core = donor.core
        assert _run(core, "seed", prompt) == want
        for i, p in enumerate(CHURN):
            _run(core, f"c{i}", p, 2)
        hashes = compute_block_hashes(prompt, BS)
        assert not core.allocator.manager.resident_pages(hashes)
        assert core.resident_prefix_blocks(hashes) == 4
        await donor.start()
        await puller.start()
        plane_d, plane_p = dt.KvTransferPlane(donor), dt.KvTransferPlane(
            puller)
        plane_d.start()
        plane_p.start()
        rpc = RpcServer()
        rpc.register(KV_BLOCKS_ENDPOINT, make_kv_blocks_handler(donor))
        rpc.register(dt.KV_OFFER_ENDPOINT, plane_d.make_offer_handler())
        rpc.register(dt.KV_PULLED_ENDPOINT, plane_d.make_pulled_handler())
        address = await rpc.start()
        client = RpcClient(address)
        try:
            dt.reset_plane_counts()
            fetcher = PrefixFetcher(puller, lambda a: client, BS,
                                    plane=plane_p, batch_blocks=2)
            assert await fetcher.pull(prompt, address, 4 * BS) == 4 * BS
            assert fetcher.device_pulled_blocks == 0
            assert fetcher.pulled_blocks == 4 and fetcher.fallbacks == 0
            assert [k for k in dt.plane_counts() if k[0] == "host"]
            pcore = puller.core
            got = []
            async for d in puller.generate("b", prompt,
                                           SamplingParams(max_tokens=4)):
                got.extend(d.token_ids)
            assert got == want
            assert pcore.scheduler.prefix_hit_tokens == 4 * BS
        finally:
            await client.close()
            await rpc.stop()
            plane_d.stop()
            plane_p.stop()
            await donor.stop()
            await puller.stop()

    asyncio.run(asyncio.wait_for(main(), timeout=120))
