"""Fleet-wide prefix reuse in the port, on the CPU, against the JAX package.

- `pick_donor` makes JAX's decisions on the same scores, slices and
  metrics (hypothesis over random fleets: ids, coverage, fabrics, device
  memory and cache occupancy); `donor_preference_key`, `stable_id_key`,
  `free_hbm_bytes` and `SliceSpec.reachable` give JAX's values; the
  KvRouter's `last_donor` follows JAX's on the same KV events.
- The hint codec round-trips and writes JAX's annotation string.
- `PrefixFetcher` (ports of tests/test_prefix_share.py): a request routed
  off the prompt's holder pulls the donor's blocks and emits the JAX
  engine's greedy tokens; donor death and a mixed-kv-quant donor fall
  back to local prefill; a donor dying mid-pull keeps the landed prefix;
  a failed batch is refetched gap-only; a burst of same-prefix pulls
  transfers once; a pool that refuses injects reports no phantom hits.
- Device first: with a `KvTransferPlane` the pull rides the device plane
  and only the blocks the holder did not grant cross the host wire; a
  holder at its offer cap sends the whole pull over the host, counted
  with the reason.
- The worker's prefix-hit tokens after a donor pull equal those of a
  local hit on the donor.

Tolerance: decisions, counts and tokens are exact.
"""

import asyncio
import json
import logging
import random
import time

import jax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.fleet import topology as jtopo
from dynamo_tpu.llm.block_manager import prefix_share as jps
from dynamo_tpu.llm.kv_router import protocols as jp
from dynamo_tpu.llm.kv_router import router as jrouter
from dynamo_tpu.llm.kv_router import scheduler as jsched
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore, InferenceEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.fleet import topology as ttopo
from dynamo_tpu_torch.llm.block_manager import device_transfer as dt
from dynamo_tpu_torch.llm.block_manager.prefix_share import (
    HINT_ANNOTATION,
    PrefixFetcher,
    PrefixShareClient,
    attach_hint,
    decode_hint,
    encode_hint,
)
from dynamo_tpu_torch.llm.block_manager.transfer import (
    KV_BLOCKS_ENDPOINT,
    encode_block,
    make_kv_blocks_handler,
    sealed_hashes,
)
from dynamo_tpu_torch.llm.kv_router import protocols as tp
from dynamo_tpu_torch.llm.kv_router import router as trouter
from dynamo_tpu_torch.llm.kv_router import scheduler as tsched
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.llm.service import LocalEngineClient
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.runtime.rpc import RpcClient, RpcServer
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

BS = 8
GEOM = dict(max_seqs=4, block_size=BS, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4),
            prefill_buckets=(8, 16))
LONG_PROMPT = list(range(1, 36))   # 4 sealed blocks + 3-token tail


# ---------------------------------------------------------------------------
# Donor policy against JAX

FABRICS = ["", "local:1", "local:2", "cuda_ipc:boot:GPU-a",
           "cuda_ipc:boot:GPU-b"]

worker_ids = st.one_of(st.integers(0, 40), st.sampled_from(
    ["w1", "w10", "w2", "a", "b"]))
fleet = st.dictionaries(
    worker_ids,
    st.tuples(st.integers(0, 12),                 # overlap blocks
              st.sampled_from(FABRICS),           # published fabric
              st.sampled_from([0, 80 * 2 ** 30, 160 * 2 ** 30]),
              st.one_of(st.none(), st.floats(0.0, 1.0))),   # cache use
    min_size=1, max_size=6)


def _side(topo, proto, rows):
    slices = {w: topo.SliceSpec(fabric=f, hbm_per_chip_bytes=h)
              for w, (_, f, h, _) in rows.items()}
    metrics = {w: proto.ForwardPassMetrics(
        worker_stats=proto.WorkerStats(),
        kv_stats=proto.KvStats(gpu_cache_usage_perc=u))
        for w, (_, _, _, u) in rows.items() if u is not None}
    return slices, metrics


@settings(max_examples=200, deadline=None)
@given(fleet, st.integers(1, 12), st.integers(0, 4))
def test_pick_donor_matches_jax(rows, request_blocks, chosen_i):
    ids = list(rows)
    chosen = ids[chosen_i % len(ids)]
    scores = {w: r[0] for w, r in rows.items()}
    ts, tm = _side(ttopo, tp, rows)
    js, jm = _side(jtopo, jp, rows)
    got = tsched.pick_donor(scores, chosen, scores[chosen], request_blocks,
                            slices=ts, metrics=tm)
    want = jsched.pick_donor(scores, chosen, scores[chosen], request_blocks,
                             slices=js, metrics=jm)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.worker_id, got.overlap_blocks) == \
            (want.worker_id, want.overlap_blocks)
    # The topology reads under it agree one by one.
    for w, (ov, fab, _, _) in rows.items():
        assert ttopo.free_hbm_bytes(ts[w], tm.get(w)) == \
            jtopo.free_hbm_bytes(js[w], jm.get(w))
        assert ttopo.stable_id_key(w) == jtopo.stable_id_key(w)
        assert ts[chosen].reachable(ts[w]) == js[chosen].reachable(js[w])


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(worker_ids, st.integers(0, 12), st.booleans(),
                          st.integers(0, 10 ** 12)), min_size=2, max_size=8))
def test_donor_preference_order_matches_jax(cands):
    def order(topo):
        return sorted(range(len(cands)), key=lambda i: topo.donor_preference_key(
            cands[i][0], cands[i][1], reachable=cands[i][2],
            free_hbm=cands[i][3]))

    assert order(ttopo) == order(jtopo)


def test_pick_donor_policy_and_tiebreak():
    d = tsched.pick_donor({"A": 6, "B": 0}, chosen="B", chosen_overlap=0,
                          request_blocks=8)
    assert d is not None and d.worker_id == "A" and d.overlap_blocks == 6
    assert tsched.pick_donor({"A": 3, "B": 0}, "B", 0, 8) is None
    assert tsched.pick_donor({"A": 6, "B": 5}, "B", 5, 8) is None
    assert tsched.pick_donor({"B": 8}, "B", 8, 8) is None
    assert tsched.pick_donor({"C": 6, "A": 6, "B": 6}, "Z", 0, 8).worker_id == "A"
    assert tsched.pick_donor({10: 6, 2: 6}, 99, 0, 8).worker_id == 2
    # A donor the chosen worker reaches over the card's fabric beats a
    # deeper host-wire-only one.
    fab = "cuda_ipc:boot:GPU-a"
    slices = {1: ttopo.SliceSpec(fabric=fab), 2: ttopo.SliceSpec(fabric=fab),
              3: ttopo.SliceSpec(fabric="cuda_ipc:boot:GPU-b")}
    d = tsched.pick_donor({1: 0, 2: 5, 3: 7}, 1, 0, 8, slices=slices)
    assert d.worker_id == 2


@pytest.mark.parametrize("seed", range(3))
def test_router_last_donor_matches_jax(seed):
    """The same stored events on both routers: every decision's donor
    (or none) is JAX's, through a spilled holder and a dead one."""
    rng = random.Random(seed)
    tr = trouter.KvRouter(trouter.KvRouterConfig(block_size=BS))
    jr = jrouter.KvRouter(jrouter.KvRouterConfig(block_size=BS))
    tr.selector.rng, jr.selector.rng = random.Random(seed), random.Random(seed)
    stems = [[rng.randrange(64) for _ in range(6 * BS)] for _ in range(3)]
    for i, stem in enumerate(stems):
        hs = sealed_hashes(stem, BS)
        for mod, r in ((tp, tr), (jp, jr)):
            r.apply_event(mod.RouterEvent(worker_id=11 + i, event=mod.KvCacheEvent(
                event_id=1, data=mod.KvCacheEventData.stored(hs))))
    for r in (tr, jr):
        r.active.add_request("busy", 11, 512, 0, expected_output_tokens=512)
    for i in range(30):
        stem = stems[rng.randrange(3)]
        toks = stem[: rng.randrange(BS, len(stem) + 1)] + [rng.randrange(64)
                                                          for _ in range(5)]
        workers = [11, 12, 13] if i < 20 else [12, 13]
        got = tr.find_best_match(f"r{i}", toks, workers, update_states=False)
        want = jr.find_best_match(f"r{i}", toks, workers, update_states=False)
        assert got == want
        a, b = tr.last_donor, jr.last_donor
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.worker_id, a.overlap_blocks) == \
                (b.worker_id, b.overlap_blocks)


def test_hint_codec_matches_jax_and_tolerates_garbage():
    assert encode_hint("1.2.3.4:5", 64, "w7") == jps.encode_hint(
        "1.2.3.4:5", 64, "w7")
    assert encode_hint("h:1", 8) == jps.encode_hint("h:1", 8)
    req = PreprocessedRequest(request_id="r", model="m", token_ids=[1],
                              sampling=SamplingParams(max_tokens=1))
    attach_hint(req, "1.2.3.4:5", 64, "w7")
    h = decode_hint(req.annotations[HINT_ANNOTATION])
    assert h == {"address": "1.2.3.4:5", "covered_tokens": 64,
                 "worker": "w7"}
    assert h == jps.decode_hint(req.annotations[HINT_ANNOTATION])
    for bad in (None, "", "not json", '{"covered_tokens": 8}',
                '{"address": "x", "covered_tokens": 0}', "[1, 2]"):
        assert decode_hint(bad) is None


# ---------------------------------------------------------------------------
# Fetcher with stub wires


_PROMPT4 = list(range(1, 4 * BS + 1))            # 4 sealed blocks
_HASHES4 = sealed_hashes(_PROMPT4, BS)
_BLOCK = torch.zeros((2, 1, BS, 4))


class _ScriptWire:
    """kv_blocks stub: call N fails when N is in `fail_calls`, and every
    call past `die_after`; counts the blocks served."""

    def __init__(self, fail_calls=(), die_after=None):
        self.fail_calls = set(fail_calls)
        self.die_after = die_after
        self.calls = 0
        self.served = 0

    def call(self, endpoint, payload):
        self.calls += 1
        n = self.calls

        async def gen():
            if n in self.fail_calls or (self.die_after is not None
                                        and n > self.die_after):
                raise ConnectionError("donor died")
            for h in payload["hashes"]:
                self.served += 1
                yield encode_block(h, _BLOCK)

        return gen()


class _Sink:
    def __init__(self, accept=True):
        self.accept = accept
        self.imported = []

    async def import_blocks(self, blocks):
        if not self.accept:
            return 0
        self.imported.extend(blocks)
        return len(blocks)

    async def resident_prefix_blocks(self, hashes):
        n = 0
        for h in hashes:
            if n < len(self.imported) and self.imported[n] == h:
                n += 1
            else:
                break
        return n


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 120))


def test_partial_pull_keeps_landed_prefix():
    async def main():
        wire, sink = _ScriptWire(die_after=1), _Sink()
        fetcher = PrefixFetcher(sink, lambda a: wire, BS, max_inflight=1,
                                batch_blocks=2)
        assert await fetcher.pull(_PROMPT4, "dead", 4 * BS) == 2 * BS
        assert sink.imported == _HASHES4[:2]
        assert (fetcher.remote_hits, fetcher.pulled_blocks,
                fetcher.fallbacks) == (1, 2, 1)

    _run(main())


def test_gap_refetch_reuses_post_gap_blocks():
    async def main():
        wire, sink = _ScriptWire(fail_calls={1}), _Sink()
        fetcher = PrefixFetcher(sink, lambda a: wire, BS, max_inflight=2,
                                batch_blocks=2)
        assert await fetcher.pull(_PROMPT4, "flaky", 4 * BS) == 4 * BS
        assert sink.imported == _HASHES4
        assert wire.served == 4          # only the gap was fetched again
        assert (fetcher.remote_hits, fetcher.pulled_blocks,
                fetcher.fallbacks) == (1, 4, 0)

    _run(main())


def test_concurrent_same_prefix_pulls_dedup():
    async def main():
        wire, sink = _ScriptWire(), _Sink()
        fetcher = PrefixFetcher(sink, lambda a: wire, BS, max_inflight=2,
                                batch_blocks=2)
        covered = await asyncio.gather(*(
            fetcher.pull(_PROMPT4, "donor", 4 * BS) for _ in range(3)))
        assert covered == [4 * BS] * 3
        assert wire.served == 4 and sink.imported == _HASHES4
        assert fetcher.remote_hits == 1 and fetcher.pulled_blocks == 4

    _run(main())


def test_capacity_stall_reports_no_phantom_hits():
    async def main():
        wire, sink = _ScriptWire(), _Sink(accept=False)
        fetcher = PrefixFetcher(sink, lambda a: wire, BS, max_inflight=1,
                                batch_blocks=2)
        assert await fetcher.pull(_PROMPT4, "full", 4 * BS) == 0
        assert fetcher.remote_hits == 0 and fetcher.pulled_blocks == 0
        assert wire.served <= 2

    _run(main())


# ---------------------------------------------------------------------------
# Engines


@pytest.fixture(scope="module")
def weights():
    params = jax_init_params(jcfg.get_config("tiny-test"), jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def jax_tokens(params, prompt, kv_quant="none", n=4):
    core = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=64,
        packed_prefill=True, kv_quant=kv_quant,
        scheduler=JaxSchedulerConfig(**GEOM)), params=params)
    core.add_request("ref", list(prompt), JaxSamplingParams(max_tokens=n))
    out = []
    while core._requests:
        for d in core.step():
            out.extend(d.token_ids)
    return out


class _Worker:
    """An in-process worker: engine, kv_blocks, and the device plane's
    endpoints; its KV events are captured as a real worker pumps them."""

    def __init__(self, state, kv_quant="none"):
        self.state, self.kv_quant = state, kv_quant
        self.events = []

    async def start(self):
        self.engine = InferenceEngine(EngineCore(EngineConfig(
            model=tcfg.get_config("tiny-test"), num_blocks=64, device="cpu",
            kv_quant=self.kv_quant, scheduler=SchedulerConfig(**GEOM)),
            params=self.state, kv_event_sink=self.events.append))
        await self.engine.start()
        self.client = LocalEngineClient(self.engine)
        self.plane = dt.KvTransferPlane(self.engine)
        self.plane.start()
        self.rpc = RpcServer()
        self.rpc.register(KV_BLOCKS_ENDPOINT,
                          make_kv_blocks_handler(self.engine))
        self.rpc.register(dt.KV_OFFER_ENDPOINT, self.plane.make_offer_handler())
        self.rpc.register(dt.KV_PULLED_ENDPOINT,
                          self.plane.make_pulled_handler())
        self.address = await self.rpc.start()
        return self

    @property
    def sched(self):
        return self.engine.core.scheduler

    async def stop(self, rpc=True):
        if rpc:
            await self.rpc.stop()
        self.plane.stop()
        await self.engine.stop()


async def _collect(client, rid, prompt, n=4, annotations=None):
    req = PreprocessedRequest(request_id=rid, model="m",
                              token_ids=list(prompt),
                              sampling=SamplingParams(max_tokens=n),
                              annotations=dict(annotations or {}))
    out = []
    async for d in client.generate(req):
        out.extend(d.token_ids)
        if d.finished:
            assert d.finish_reason.value != "error"
            break
    return out


def _hint(address, tokens):
    return {HINT_ANNOTATION: json.dumps({"address": address,
                                         "covered_tokens": tokens})}


def test_remote_prefix_pull_e2e(weights):
    """The router spills the repeat off the busy holder with a donor
    hint; the other worker pulls the 4 sealed blocks, prefills only the
    3-token tail, and emits the JAX engine's tokens.  Its prefix-hit
    tokens equal those of a local hit on the donor."""
    params, state = weights
    want = jax_tokens(params, LONG_PROMPT)

    async def main():
        wa = await _Worker(state).start()
        wb = await _Worker(state).start()
        rpc = RpcClient(wa.address)
        try:
            assert await _collect(wa.client, "seed", LONG_PROMPT) == want
            router = trouter.KvRouter(trouter.KvRouterConfig(block_size=BS))
            for ev in wa.events:
                router.apply_event(tp.RouterEvent(worker_id="A", event=ev))
            router.active.add_request("busy", "A", 512, 0,
                                      expected_output_tokens=512)
            chosen, overlap = router.find_best_match(
                "r1", LONG_PROMPT, ["A", "B"])
            assert chosen == "B" and overlap == 0
            donor = router.last_donor
            assert donor.worker_id == "A" and donor.overlap_blocks == 4

            fetcher = PrefixFetcher(wb.engine, lambda a: rpc, BS)
            psc = PrefixShareClient(wb.client, fetcher)
            req = PreprocessedRequest(
                request_id="r1", model="m", token_ids=list(LONG_PROMPT),
                sampling=SamplingParams(max_tokens=4))
            attach_hint(req, wa.address, donor.overlap_blocks * BS,
                        donor.worker_id)
            got = []
            async for d in psc.generate(req):
                got.extend(d.token_ids)
            assert got == want
            assert wb.sched.prefix_hit_tokens == 4 * BS
            assert wb.sched.prefix_miss_tokens == len(LONG_PROMPT) - 4 * BS
            assert fetcher.stats() == {
                "remote_hits": 1, "pulled_blocks": 4, "pulled_tokens": 32,
                "device_pulled_blocks": 0, "fallbacks": 0,
                "hinted_admissions": 1, "hinted_covered_tokens": 32,
                "hinted_hit_tokens": 32, "reprefilled_tokens": 0}
            assert wb.engine.core.allocator.manager.onboarded_blocks == 4
            # A local hit on the donor skips exactly as many tokens.
            hits0 = wa.sched.prefix_hit_tokens
            assert await _collect(wa.client, "again", LONG_PROMPT) == want
            assert wa.sched.prefix_hit_tokens - hits0 == \
                wb.sched.prefix_hit_tokens
        finally:
            await rpc.close()
            await wa.stop()
            await wb.stop()

    _run(main())


def test_admission_that_misses_pulled_blocks_is_counted(weights):
    """A hinted request whose pulled blocks admission did not match (the
    pool dropped them between pull and admission) counts those tokens
    as prefilled again, read from its first delta's `cached_tokens`."""
    params, state = weights

    async def main():
        wa = await _Worker(state).start()
        wb = await _Worker(state).start()
        rpc = RpcClient(wa.address)
        try:
            await _collect(wa.client, "seed", LONG_PROMPT)
            fetcher = PrefixFetcher(wb.engine, lambda a: rpc, BS)
            pull = fetcher.pull
            manager = wb.engine.core.allocator.manager

            async def pull_then_drop(*a, **kw):
                covered = await pull(*a, **kw)
                dropped = await wb.engine.run_in_engine(manager.clear_cache)
                assert len(dropped) == 4
                return covered

            fetcher.pull = pull_then_drop
            psc = PrefixShareClient(wb.client, fetcher)
            req = PreprocessedRequest(
                request_id="r1", model="m", token_ids=list(LONG_PROMPT),
                sampling=SamplingParams(max_tokens=4))
            attach_hint(req, wa.address, 4 * BS, "A")
            async for _ in psc.generate(req):
                pass
            st = fetcher.stats()
            assert st["pulled_tokens"] == 4 * BS
            assert (st["hinted_admissions"], st["hinted_covered_tokens"],
                    st["hinted_hit_tokens"], st["reprefilled_tokens"]) == \
                (1, 4 * BS, 0, 4 * BS)
        finally:
            await rpc.close()
            await wa.stop()
            await wb.stop()

    _run(main())


def test_donor_death_falls_back_to_local(weights):
    params, state = weights
    want = jax_tokens(params, LONG_PROMPT)

    async def main():
        wa = await _Worker(state).start()
        wb = await _Worker(state).start()
        try:
            await _collect(wa.client, "seed", LONG_PROMPT)
            dead = wa.address
            await wa.rpc.stop()
            fetcher = PrefixFetcher(wb.engine, RpcClient, BS,
                                    pull_timeout=10.0)
            psc = PrefixShareClient(wb.client, fetcher)
            got = await _collect(psc, "r1", LONG_PROMPT,
                                 annotations=_hint(dead, 4 * BS))
            assert got == want
            assert fetcher.fallbacks == 1 and fetcher.remote_hits == 0
            assert wb.sched.prefix_hit_tokens == 0
        finally:
            await wa.stop(rpc=False)
            await wb.stop()

    _run(main())


def test_mixed_kv_quant_peer_refused_loudly(weights, caplog):
    _, state = weights

    async def main():
        wa = await _Worker(state, "int8").start()
        wb = await _Worker(state).start()
        rpc = RpcClient(wa.address)
        try:
            await _collect(wa.client, "seed", LONG_PROMPT)
            fetcher = PrefixFetcher(wb.engine, lambda a: rpc, BS)
            psc = PrefixShareClient(wb.client, fetcher)
            with caplog.at_level(
                    logging.ERROR,
                    logger="dynamo_tpu_torch.llm.block_manager.prefix_share"):
                got = await _collect(psc, "r1", LONG_PROMPT,
                                     annotations=_hint(wa.address, 4 * BS))
            assert fetcher.fallbacks == 1 and fetcher.remote_hits == 0
            assert any("REFUSED" in r.message for r in caplog.records)
            assert wb.engine.core.allocator.manager.onboarded_blocks == 0
            assert got == await _collect(wb.client, "r2", LONG_PROMPT)
        finally:
            await rpc.close()
            await wa.stop()
            await wb.stop()

    _run(main())


class _PartialOffers:
    """An RpcClient whose kv_offer probes ask for every other block only,
    as a holder that keeps some blocks off the device would grant them;
    kv_blocks and kv_pulled go through untouched."""

    def __init__(self, inner):
        self.inner = inner
        self.host_blocks = 0

    def call(self, endpoint, payload):
        if endpoint == dt.KV_OFFER_ENDPOINT:
            payload = dict(payload, hashes=payload["hashes"][::2])
        if endpoint == KV_BLOCKS_ENDPOINT:
            self.host_blocks += len(payload["hashes"])
        return self.inner.call(endpoint, payload)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_fetcher_pulls_device_first_and_refetches_gaps_over_host(
        weights, kv_quant):
    params, state = weights
    want = jax_tokens(params, LONG_PROMPT, kv_quant)

    async def main():
        holder = await _Worker(state, kv_quant).start()
        await _collect(holder.client, "seed", LONG_PROMPT)
        inner = RpcClient(holder.address)
        try:
            # All offered: every block rides the device plane.
            wb = await _Worker(state, kv_quant).start()
            dt.reset_plane_counts()
            fetcher = PrefixFetcher(wb.engine, lambda a: inner, BS,
                                    plane=wb.plane, batch_blocks=2)
            assert await fetcher.pull(LONG_PROMPT, holder.address,
                                      4 * BS) == 4 * BS
            assert fetcher.device_pulled_blocks == 4
            assert fetcher.remote_hits == 1 and fetcher.fallbacks == 0
            counts = dt.plane_counts()
            assert counts.get(("device", "prefix"), 0) == 2
            assert not [k for k in counts if k[0] == "host"]
            assert await _collect(wb.client, "b", LONG_PROMPT) == want
            await wb.stop()

            # Half granted: the device plane carries those, and only the
            # gaps cross the host wire.
            wc = await _Worker(state, kv_quant).start()
            wire = _PartialOffers(inner)
            fetcher = PrefixFetcher(wc.engine, lambda a: wire, BS,
                                    plane=wc.plane, batch_blocks=2)
            assert await fetcher.pull(LONG_PROMPT, holder.address,
                                      4 * BS) == 4 * BS
            assert fetcher.device_pulled_blocks == 2
            assert wire.host_blocks == 2
            assert fetcher.pulled_blocks == 4
            assert await _collect(wc.client, "c", LONG_PROMPT) == want
            await wc.stop()

            # The holder at its offer cap: the whole pull goes host-staged,
            # counted with the reason.
            wd = await _Worker(state, kv_quant).start()
            held = dict(holder.plane._outstanding)
            holder.plane._outstanding.update({
                10 ** 9 + i: (1, time.monotonic() + 999, 0)
                for i in range(dt.MAX_OUTSTANDING_OFFERS)})
            dt.reset_plane_counts()
            fetcher = PrefixFetcher(wd.engine, lambda a: inner, BS,
                                    plane=wd.plane, batch_blocks=2)
            assert await fetcher.pull(LONG_PROMPT, holder.address,
                                      4 * BS) == 4 * BS
            assert fetcher.device_pulled_blocks == 0 and fetcher.fallbacks == 0
            assert dt.plane_counts().get(("host", "offer_cap"), 0) >= 1
            holder.plane._outstanding = held
            assert await _collect(wd.client, "d", LONG_PROMPT) == want
            await wd.stop()
        finally:
            await inner.close()
            await holder.stop()

    _run(main())


def test_offer_ttl_cap_and_transport_refusals():
    """The holder's offer accounting: the cap refuses the 33rd live
    offer, an ack frees a slot, TTL 0 expires stale offers instead, and a
    peer on another fabric is refused before anything is staged."""
    blocks = {h: torch.zeros((2, 1, BS, 4))
              for h in range(1, dt.MAX_OUTSTANDING_OFFERS + 2)}
    plane = dt.KvTransferPlane()
    plane.start()
    first = plane.stage(blocks, [1])
    for h in range(2, dt.MAX_OUTSTANDING_OFFERS + 1):
        assert plane.stage(blocks, [h]) is not None
    assert plane.stage(blocks, [dt.MAX_OUTSTANDING_OFFERS + 1]) is None
    assert plane.last_refusal == "offer_cap"
    assert plane.refused_offers == 1 and plane.expired_offers == 0
    assert plane.outstanding_high_water == dt.MAX_OUTSTANDING_OFFERS
    plane.mark_pulled(first["uuid"])
    assert first["uuid"] not in dt._staged
    assert plane.stage(blocks, [dt.MAX_OUTSTANDING_OFFERS + 1]) is not None
    plane.stop()
    assert not dt._staged

    plane = dt.KvTransferPlane(offer_ttl_s=0.0)
    plane.start()
    for h in range(1, dt.MAX_OUTSTANDING_OFFERS + 2):
        assert plane.stage(blocks, [h]) is not None
    assert plane.expired_offers == dt.MAX_OUTSTANDING_OFFERS
    assert plane.refused_offers == 0 and len(plane._outstanding) == 1
    plane.stop()

    plane = dt.KvTransferPlane()
    plane.start()
    assert plane.stage(blocks, [1], peer_fabric="local:0") is None
    assert plane.last_refusal == "transport"
    assert plane.stage(blocks, [999]) is None
    assert plane.last_refusal == "not_resident"
    plane.stop()
