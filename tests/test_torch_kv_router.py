"""The port's KV router (`dynamo_tpu_torch.llm.kv_router`) against the JAX
package's, on the CPU.

Both sides take the same seeded inputs and must agree exactly (hashes,
scores, chosen workers, costs and load accounting are all integers or
the same float arithmetic):

- `KvIndexer` / `RadixTree`: a random `RouterEvent` stream over three
  workers (chained STORED batches, REMOVED, CLEARED, stale and repeated
  event ids, a worker leaving) gives equal `OverlapScores` for a set of
  probe sequences after every event, early exit included.
- `DefaultWorkerSelector`: random candidates (overlap, decode and
  prefill load, published `ForwardPassMetrics`, slices with device
  memory, QoS priority) at temperature 0 and above, with one seed, choose
  the same worker and report the same `KVHitRateEvent`.
- `KvRouter.find_best_match`: the same events, requests, metrics and
  seed choose the same (worker, overlap) request after request, and the
  optimistic accounting (`ActiveSequencesMultiWorker`) stays equal
  through prefill completion, token growth and frees; the approximate
  indexer (no KV events) likewise.
"""

import random

import numpy as np
import pytest

from dynamo_tpu.fleet import topology as jtopo
from dynamo_tpu.llm.kv_router import indexer as jidx
from dynamo_tpu.llm.kv_router import protocols as jp
from dynamo_tpu.llm.kv_router import router as jrouter
from dynamo_tpu.llm.kv_router import scheduler as jsched
from dynamo_tpu_torch.fleet import topology as ttopo
from dynamo_tpu_torch.llm.kv_router import indexer as tidx
from dynamo_tpu_torch.llm.kv_router import protocols as tp
from dynamo_tpu_torch.llm.kv_router import router as trouter
from dynamo_tpu_torch.llm.kv_router import scheduler as tsched
from dynamo_tpu_torch.tokens import compute_block_hashes

BS = 8
WORKERS = (11, 12, 13)


def _events(rng, n=120):
    """(worker, event_id, kind, hashes, parent) tuples: each worker seals
    chains of a few shared stems, evicts, clears; ids mostly advance,
    some repeat (stale)."""
    stems = [rng.integers(0, 64, 6 * BS).tolist() for _ in range(4)]
    chains = {w: [] for w in WORKERS}        # worker -> sealed hash lists
    ids = {w: 0 for w in WORKERS}
    out = []
    for _ in range(n):
        w = WORKERS[int(rng.integers(0, len(WORKERS)))]
        r = rng.random()
        if r < 0.1 and ids[w] > 0:
            eid = ids[w] - int(rng.integers(0, 2))     # stale / repeated
        else:
            ids[w] += 1
            eid = ids[w]
        if r < 0.6:
            stem = stems[int(rng.integers(0, len(stems)))]
            toks = stem + rng.integers(0, 64, int(rng.integers(0, 3)) * BS
                                       ).tolist()
            hs = compute_block_hashes(toks, BS)
            lo = int(rng.integers(0, len(hs)))
            hi = int(rng.integers(lo + 1, len(hs) + 1))
            out.append((w, eid, "stored", hs[lo:hi], hs[lo - 1] if lo else None))
            chains[w].append(hs[lo:hi])
        elif r < 0.9 and chains[w]:
            hs = chains[w][int(rng.integers(0, len(chains[w])))]
            k = int(rng.integers(1, len(hs) + 1))
            out.append((w, eid, "removed", hs[-k:], None))
        else:
            out.append((w, eid, "cleared", [], None))
            chains[w] = []
    return out, stems


def _router_event(mod, w, eid, kind, hs, parent):
    data = {"stored": lambda: mod.KvCacheEventData.stored(hs, parent),
            "removed": lambda: mod.KvCacheEventData.removed(hs),
            "cleared": mod.KvCacheEventData.cleared}[kind]()
    return mod.RouterEvent(worker_id=w, event=mod.KvCacheEvent(
        event_id=eid, data=data))


def _probes(rng, stems):
    out = []
    for stem in stems:
        for extra in (0, 1, 2):
            toks = stem[: len(stem) - int(rng.integers(0, 3)) * BS] + \
                rng.integers(0, 64, extra * BS).tolist()
            out.append(compute_block_hashes(toks, BS))
    out.append(compute_block_hashes(list(range(100, 100 + 3 * BS)), BS))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_indexer_scores_match_jax(seed):
    rng = np.random.default_rng(seed)
    events, stems = _events(rng)
    probes = _probes(rng, stems)
    j, t = jidx.KvIndexer(BS), tidx.KvIndexer(BS)
    for i, e in enumerate(events):
        j.apply_event(_router_event(jp, *e))
        t.apply_event(_router_event(tp, *e))
        if i == len(events) // 2:
            j.remove_worker(WORKERS[0])
            t.remove_worker(WORKERS[0])
        for h in probes:
            assert t.find_matches(h).scores == j.find_matches(h).scores
        for h in probes[::3]:
            assert (t.tree.find_matches(h, early_exit=True).scores
                    == j.tree.find_matches(h, early_exit=True).scores)
    assert t.stale_events_dropped == j.stale_events_dropped > 0
    assert sorted(t.tree.workers()) == sorted(j.tree.workers())
    assert t.tree.num_blocks() == j.tree.num_blocks()
    for w in WORKERS:
        assert t.tree.blocks_for_worker(w) == j.tree.blocks_for_worker(w)


def _metrics(mod, rng):
    return mod.ForwardPassMetrics(
        worker_stats=mod.WorkerStats(
            request_active_slots=int(rng.integers(0, 64)),
            request_total_slots=64,
            num_requests_waiting=int(rng.integers(0, 8))),
        kv_stats=mod.KvStats(kv_active_blocks=int(rng.integers(0, 200)),
                             kv_total_blocks=511,
                             gpu_cache_usage_perc=float(rng.random())))


@pytest.mark.parametrize("seed", range(4))
def test_selector_choices_match_jax(seed):
    rng = np.random.default_rng(seed)
    for trial in range(60):
        n = int(rng.integers(1, 5))
        temp = 0.0 if trial % 2 == 0 else float(rng.uniform(0.1, 5.0))
        priority = [None, 0, 1, 2][trial % 4]
        rows = []
        for w in range(n):
            hbm = int(rng.integers(1, 4)) * 80 * 2 ** 30 if rng.random() < 0.7 else 0
            rows.append(dict(
                worker_id=100 + w,
                overlap_blocks=int(rng.integers(0, 12)),
                decode_blocks=int(rng.integers(0, 100)),
                prefill_blocks=int(rng.integers(0, 10)),
                seed=int(rng.integers(0, 2 ** 31)),
                metrics=rng.random() < 0.6, hbm=hbm,
                slice=rng.random() < 0.7))

        def candidates(mod, proto, topo):
            out = []
            for r in rows:
                m = (_metrics(proto, np.random.default_rng(r["seed"]))
                     if r["metrics"] else None)
                sl = (topo.SliceSpec(hbm_per_chip_bytes=r["hbm"])
                      if r["slice"] else None)
                out.append(mod.WorkerLoadSnapshot(
                    worker_id=r["worker_id"], overlap_blocks=r["overlap_blocks"],
                    decode_blocks=r["decode_blocks"],
                    prefill_blocks=r["prefill_blocks"], metrics=m, slice=sl))
            return out

        req_blocks = int(rng.integers(1, 16))
        got, want = [], []
        ts = tsched.DefaultWorkerSelector(
            temperature=temp, rng=random.Random(trial),
            on_hit_rate_event=got.append)
        js = jsched.DefaultWorkerSelector(
            temperature=temp, rng=random.Random(trial),
            on_hit_rate_event=want.append)
        for _ in range(3):
            a = ts.select(candidates(tsched, tp, ttopo), req_blocks, priority)
            b = js.select(candidates(jsched, jp, jtopo), req_blocks, priority)
            assert a.worker_id == b.worker_id
        assert [e.__dict__ for e in got] == [e.__dict__ for e in want]


def _fpm_map(mod, rng):
    return {w: _metrics(mod, np.random.default_rng(int(s)))
            for w, s in zip(WORKERS, rng.integers(0, 2 ** 31, 3))}


@pytest.mark.parametrize("use_kv_events", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_router_find_best_match_matches_jax(seed, use_kv_events):
    rng = np.random.default_rng(seed)
    events, stems = _events(rng, n=60)
    cfg = dict(block_size=BS, use_kv_events=use_kv_events)
    tr = trouter.KvRouter(trouter.KvRouterConfig(**cfg))
    jr = jrouter.KvRouter(jrouter.KvRouterConfig(**cfg))
    tr.selector.rng = random.Random(seed)
    jr.selector.rng = random.Random(seed)
    for e in events:
        tr.apply_event(_router_event(tp, *e))
        jr.apply_event(_router_event(jp, *e))
    live = []
    for i in range(40):
        stem = stems[int(rng.integers(0, len(stems)))]
        toks = stem[: int(rng.integers(1, len(stem) + 1))] + rng.integers(
            0, 64, int(rng.integers(0, 20))).tolist()
        workers = list(WORKERS[: 2 + i % 2])
        mseed = int(rng.integers(0, 2 ** 31))
        kw = dict(expected_output_tokens=int(rng.integers(0, 64)))
        if i % 3:
            kw_t = dict(kw, metrics=_fpm_map(tp, np.random.default_rng(mseed)))
            kw_j = dict(kw, metrics=_fpm_map(jp, np.random.default_rng(mseed)))
        else:
            kw_t = kw_j = kw
        got = tr.find_best_match(f"r{i}", toks, workers, **kw_t)
        want = jr.find_best_match(f"r{i}", toks, workers, **kw_j)
        assert got == want
        live.append(f"r{i}")
        # Lifecycle: prefill done, a few tokens, some frees.
        rid = live[int(rng.integers(0, len(live)))]
        n = int(rng.integers(1, 20))
        for r in (tr, jr):
            r.mark_prefill_complete(rid)
            r.push_token(rid, n)
        if rng.random() < 0.4:
            rid = live.pop(int(rng.integers(0, len(live))))
            tr.free(rid)
            jr.free(rid)
        if i == 25:
            tr.remove_worker(WORKERS[1])
            jr.remove_worker(WORKERS[1])
        assert tr.active.prefill_tokens() == jr.active.prefill_tokens()
        assert tr.active.decode_blocks() == jr.active.decode_blocks()
        assert tr.active.active_counts() == jr.active.active_counts()
    assert tr.workers() == jr.workers()
    with pytest.raises(ValueError):
        tr.find_best_match("x", [1, 2, 3], [])
