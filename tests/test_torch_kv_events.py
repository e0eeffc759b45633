"""The port's KV events and load metrics against the JAX engine's, on the
CPU (tiny-test, the same weights through `from_jax_params`).

The same prompts, which share prefixes, go through JAX's `EngineCore`
and the port's, each with a `kv_event_sink`, in waves; a small
`num_blocks` forces evictions from the prefix cache (managed source) or
preemptions (plain allocator).  Held exactly:

- the greedy tokens;
- the STORED events as (block hash, parent hash) pairs, counted with
  multiplicity, and the REMOVED hashes likewise (events of one step may
  be grouped differently, so the streams are compared by content, not by
  `event_id`); event ids run 1, 2, 3, ... on each side;
- a `KvIndexer` fed by each stream answers the same overlap scores for a
  set of probe prompts;
- `ForwardPassMetrics` at idle, before any request, and after the trace.
"""

from collections import Counter

import jax
import pytest

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.protocols import KvEventKind, RouterEvent
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from dynamo_tpu_torch.tokens import compute_block_hashes
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

BS = 8
GEOM = dict(max_seqs=8, block_size=BS, max_pages_per_seq=8,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16))
SHARED = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 11, 12, 13, 14, 15, 16,
          21, 22, 23, 24, 25, 26, 27, 28]          # 3 blocks of 8
WAVES = [{"a": SHARED + [40, 41, 42], "b": SHARED[:12] + [50, 51]},
         {"c": SHARED + [60, 61, 62, 63, 64], "d": SHARED[:],
          "e": SHARED[:16] + [70], "f": [90, 91, 92, 93, 94, 95, 96, 97, 98]}]


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jcfg.get_config("tiny-test"),
                                jax.random.key(0))
    return params, from_jax_params(jax.device_get(params), "cpu")


def _run(core, sp, n_out):
    tokens = {}
    for wave in WAVES:
        for rid, p in wave.items():
            core.add_request(rid, p, sp(max_tokens=n_out))
        for _ in range(2000):
            for d in core.step():
                tokens.setdefault(d.request_id, []).extend(d.token_ids)
            if not core._requests:
                break
    return tokens


def _pairs(events):
    """Counter of STORED (hash, parent) pairs and of REMOVED hashes."""
    stored, removed = Counter(), Counter()
    for e in events:
        d = e.data
        if d.kind.value == "stored":
            parent = d.store.parent_hash
            for h in d.store.block_hashes:
                stored[(h, parent)] += 1
                parent = h
        elif d.kind.value == "removed":
            removed.update(d.remove.block_hashes)
    return stored, removed


def _scores(events, probes):
    idx = KvIndexer(BS)
    for e in events:
        idx.apply_event(RouterEvent.from_dict({"worker_id": 1, "event": {
            "event_id": e.event_id, "data": {
                "kind": e.data.kind.value,
                "store": (None if e.data.store is None else {
                    "block_hashes": list(e.data.store.block_hashes),
                    "parent_hash": e.data.store.parent_hash}),
                "remove": (None if e.data.remove is None else {
                    "block_hashes": list(e.data.remove.block_hashes)})}}}))
    return [idx.find_matches(compute_block_hashes(p, BS)).scores
            for p in probes]


@pytest.mark.parametrize("prefix_cache,num_blocks,kv_quant", [
    (True, 64, "none"),      # sealed blocks stay cached: STORED only
    (True, 12, "none"),      # LRU evictions: REMOVED from the pool hook
    (True, 12, "int8"),
    (False, 64, "none"),     # plain allocator: REMOVED at finish
    (False, 9, "none"),      # and at preemption
])
def test_kv_events_and_metrics_match_jax(weights, prefix_cache, num_blocks,
                                         kv_quant):
    params, state = weights
    jev, tev = [], []
    j = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config("tiny-test"), num_blocks=num_blocks,
        packed_prefill=True, enable_prefix_cache=prefix_cache,
        kv_quant=kv_quant, scheduler=jsched.SchedulerConfig(**GEOM)),
        params=params, kv_event_sink=jev.append)
    t = EngineCore(EngineConfig(
        model=tcfg.get_config("tiny-test"), num_blocks=num_blocks,
        device="cpu", kv_quant=kv_quant, enable_prefix_cache=prefix_cache,
        scheduler=tsched.SchedulerConfig(**GEOM)), params=state,
        kv_event_sink=tev.append)
    assert t.metrics.to_dict() == j.metrics.to_dict()   # idle

    want = _run(j, JaxSamplingParams, 20)
    got = _run(t, SamplingParams, 20)
    assert got == want and all(len(v) == 20 for v in got.values())

    assert [e.event_id for e in tev] == list(range(1, len(tev) + 1))
    stored, removed = _pairs(tev)
    assert (stored, removed) == _pairs(jev)
    assert stored
    kinds = {e.data.kind for e in tev}
    if num_blocks < 64 or not prefix_cache:
        assert KvEventKind.REMOVED in kinds and removed
    else:
        assert kinds == {KvEventKind.STORED}

    probes = [p for wave in WAVES for p in wave.values()] + [SHARED[:8]]
    assert _scores(tev, probes) == _scores(jev, probes)

    assert t.metrics.to_dict() == j.metrics.to_dict()   # after the trace
    assert t.metrics.kv_stats.kv_total_blocks == num_blocks - 1
    if prefix_cache:
        assert t.metrics.kv_stats.gpu_prefix_cache_hit_rate > 0


def test_no_sink_or_events_off_emits_nothing(weights):
    """Events are opt-in: no sink, or `enable_kv_events=False`, leaves the
    engine silent (and with the prefix cache off it skips the hashing)."""
    _, state = weights
    seen = []
    for kw in (dict(enable_kv_events=False), dict()):
        core = EngineCore(EngineConfig(
            model=tcfg.get_config("tiny-test"), num_blocks=64, device="cpu",
            enable_prefix_cache=False, scheduler=tsched.SchedulerConfig(**GEOM),
            **kw), params=state,
            kv_event_sink=seen.append if kw else None)
        _run(core, SamplingParams, 4)
        assert not core._hash_seqs
    assert seen == []
