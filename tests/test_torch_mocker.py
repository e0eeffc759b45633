"""The port's mock engine against the JAX package's.

The same requests (prompts drawn with numpy from a seed, some sharing a
prefix so the mock KV manager hits and evicts) go through both packages'
`MockEngine`.  Stepped synchronously, every step's token deltas, KV
events and `ForwardPassMetrics` must be exactly equal; served through
`generate` (the asyncio loop), every stream's tokens and finish reasons
must be equal too.  A worker `--mocker` answers chats behind a frontend
(see tests/test_torch_planner.py for the connector's mocker fleet).
"""

import asyncio
import dataclasses

import numpy as np
import pytest

from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.llm.mocker import engine as jmock
from dynamo_tpu.llm.preprocessor import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.llm.mocker import engine as tmock
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest


def requests(seed, n=10):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 500, size=40).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(1, 500, size=int(rng.integers(5, 60))).tolist()
        prompt = (shared + tail) if i % 2 else tail
        out.append((f"req-{seed}-{i}", prompt, int(rng.integers(3, 40)),
                    [int(rng.integers(32, 127))] if i % 3 == 0 else []))
    return out


def make(mod, req_cls, sp_cls, args, reqs, events):
    eng = mod.MockEngine(mod.MockEngineArgs(**args),
                         kv_event_sink=events.append)
    seqs = []
    for rid, prompt, max_tokens, stop in reqs:
        r = req_cls(rid, "m", list(prompt),
                    sp_cls(max_tokens=max_tokens, stop_token_ids=stop))
        seq = mod._MockSeq(request=r, queue=asyncio.Queue(),
                           hash_seq=mod.TokenBlockSequence(
                               block_size=args["block_size"]))
        eng._waiting.append(seq)
        seqs.append(seq)
    return eng, seqs


def norm(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def step_all(mod, req_cls, sp_cls, args, reqs, max_steps=500):
    events = []
    eng, seqs = make(mod, req_cls, sp_cls, args, reqs, events)
    log = []
    for _ in range(max_steps):
        ms = eng._step()
        eng._refresh_metrics()
        deltas = []
        for s in seqs:
            while not s.queue.empty():
                d = s.queue.get_nowait()
                deltas.append((d.request_id, d.token_ids, d.finished,
                               d.finish_reason and d.finish_reason.value))
        log.append((ms, deltas, [norm(e) for e in events],
                    norm(eng.metrics)))
        events.clear()
        if not eng._waiting and not eng._running:
            break
    return log


@pytest.mark.parametrize("seed,num_blocks,block_size",
                         [(0, 64, 8), (1, 40, 16), (2, 2048, 64)])
def test_stepped_mock_engine_equal_jax(seed, num_blocks, block_size):
    args = dict(num_blocks=num_blocks, block_size=block_size,
                max_num_seqs=4, max_batched_tokens=64)
    reqs = requests(seed)
    want = step_all(jmock, JaxRequest, JaxSamplingParams, args, reqs)
    got = step_all(tmock, PreprocessedRequest, SamplingParams, args, reqs)
    assert got == want
    assert any(e for _, _, e, _ in got)          # KV events flowed
    assert sum(1 for _, ds, _, _ in got for d in ds if d[2]) == len(reqs)


def serve(mod, req_cls, sp_cls, reqs):
    async def main():
        eng = mod.MockEngine(mod.MockEngineArgs(
            num_blocks=256, block_size=16, speedup_ratio=1000.0))
        out = {}

        async def one(rid, prompt, n, stop):
            r = req_cls(rid, "m", list(prompt),
                        sp_cls(max_tokens=n, stop_token_ids=stop))
            toks, fin = [], None
            async for d in eng.generate(r):
                toks.extend(d.token_ids)
                fin = d.finish_reason
            out[rid] = (toks, fin.value)

        await asyncio.gather(*(one(*r) for r in reqs))
        await eng.stop()
        return out

    return asyncio.run(asyncio.wait_for(main(), 60))


def test_served_streams_equal_jax():
    reqs = requests(3)
    got = serve(tmock, PreprocessedRequest, SamplingParams, reqs)
    assert got == serve(jmock, JaxRequest, JaxSamplingParams, reqs)
    assert len(got) == len(reqs)
