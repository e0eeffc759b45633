"""Speculative decode, the port's against the JAX package's, on the CPU.

- `NgramDrafter` / `DraftModelDrafter` propose JAX's drafts on seeded
  histories.
- Greedy `speculative_verify` gives JAX's (emitted, n_emit) exactly.
- Stochastic verify keeps `sample`'s law: over 4,000 rows with their own
  seeds, the first emitted token's counts and (after an accepted draft)
  the second's fit the filtered distribution, as `sample`'s counts do;
  Pearson chi-square against the exact probabilities, each below the
  0.999 quantile of its chi-square law (a seeded test: it fails on a
  wrong law, by chance about once in a thousand seeds).  Top-k is held:
  nothing outside a position's top k is emitted, nor a draft accepted.
- `EngineCore(speculative_tokens=3)` on tiny-test and tiny-moe: greedy
  ids, `spec_dispatches` and `SpecDecodeStats` equal the JAX engine's,
  and the ids equal the port's own K=0 run.
- Rows asking for logprobs and seeded stochastic rows take the plain
  step; a drafter that proposes garbage (out-of-vocabulary ids too)
  leaves greedy output as it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from dynamo_tpu.engine.drafter import DraftModelDrafter as JaxDraftModelDrafter
from dynamo_tpu.engine.drafter import NgramDrafter as JaxNgramDrafter
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.sampling import speculative_verify as jax_verify
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu_torch.engine.drafter import DraftModelDrafter, NgramDrafter
from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.sampling import (
    SamplingParams,
    _filtered_logits,
    sample,
    speculative_verify,
)
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.models import config as tcfg
from dynamo_tpu_torch.models.weights import from_jax_params
from test_torch_mixed_prefill import pinned_engine_clocks  # noqa: F401

# The engines step under one pinned clock (test_torch_mixed_prefill.py).
pytestmark = pytest.mark.usefixtures("pinned_engine_clocks")

CHI2_Q = 0.999


def test_ngram_and_draft_model_drafters_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(0, 40))
        hist = [int(t) for t in rng.integers(0, int(rng.integers(2, 9)), n)]
        ngram, k = int(rng.integers(1, 5)), int(rng.integers(0, 7))
        assert (NgramDrafter(ngram).propose(hist, k)
                == JaxNgramDrafter(ngram).propose(hist, k))
    with pytest.raises(ValueError):
        NgramDrafter(0)

    def fn(h, k):
        return [len(h) + i for i in range(k + 2)] if len(h) % 3 else []

    for h in ([], [1], [1, 2], [4, 5, 6, 7]):
        assert (DraftModelDrafter(fn).propose(h, 3)
                == JaxDraftModelDrafter(fn).propose(h, 3))


def _logits_and_drafts(seed, B=6, K=3, V=16):
    """Seeded logits and drafts that agree with the argmax chain for a
    row-dependent prefix (0 .. K tokens), then differ."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    argmax = logits.argmax(-1)
    drafts = rng.integers(0, V, (B, K)).astype(np.int32)
    for b in range(B):
        agree = b % (K + 1)
        drafts[b, :agree] = argmax[b, :agree]
        if agree < K and drafts[b, agree] == argmax[b, agree]:
            drafts[b, agree] = (argmax[b, agree] + 1) % V
    return logits, drafts


@pytest.mark.parametrize("seed", range(4))
def test_greedy_verify_equals_jax(seed):
    logits, drafts = _logits_and_drafts(seed)
    B = logits.shape[0]
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    keys = jax.random.split(jax.random.key(0), B)
    for greedy_only in (True, False):
        je, jn = jax_verify(jnp.asarray(logits), jnp.asarray(drafts),
                            jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
                            jnp.asarray(ones), keys, greedy_only=greedy_only)
        te, tn = speculative_verify(
            torch.from_numpy(logits), torch.from_numpy(drafts),
            torch.from_numpy(zeros), torch.zeros(B, dtype=torch.int32),
            torch.from_numpy(ones), [None] * B, [0] * B,
            greedy_only=greedy_only)
        assert te.dtype == tn.dtype == torch.int32
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # Every prefix length 0..K was taken once at least.
    assert sorted(set(tn.tolist())) == [1, 2, 3, 4]


def _chi2_ok(counts, probs) -> float:
    """Pearson's statistic over the cells with p > 0 against the exact
    probabilities; asserts it is under the 0.999 quantile."""
    n = counts.sum()
    live = probs > 0
    assert counts[~live].sum() == 0, "a token of probability 0 was drawn"
    stat = float(((counts[live] - n * probs[live]) ** 2
                  / (n * probs[live])).sum())
    assert stat < chi2.ppf(CHI2_Q, int(live.sum()) - 1), stat
    return stat


@pytest.mark.parametrize("top_k", [0, 5])
def test_stochastic_verify_keeps_the_sampling_law(top_k):
    N, K, V = 4000, 2, 10
    rng = np.random.default_rng(7)
    row = rng.standard_normal((K + 1, V)).astype(np.float32) * 1.5
    logits = torch.from_numpy(np.broadcast_to(row, (N, K + 1, V)).copy())
    temp = torch.full((N,), 0.9)
    tk = torch.full((N,), top_k, dtype=torch.int32)
    tp = torch.ones(N)
    flat = _filtered_logits(logits[0], temp[: K + 1], tk[: K + 1], tp[: K + 1])
    probs = torch.softmax(flat, -1).numpy().astype(np.float64)   # [K+1, V]
    # Draft the most likely token first (often accepted), then a token
    # outside the top 5 (never accepted under top_k 5).
    d0 = int(probs[0].argmax())
    d1 = int(np.argsort(probs[1])[0]) if top_k else int(probs[1].argmax())
    drafts = torch.tensor([[d0, d1]] * N, dtype=torch.int32)
    seeds = [int(s) for s in rng.integers(0, 2 ** 63, N)]
    emitted, n_emit = speculative_verify(logits, drafts, temp, tk, tp, seeds,
                                         [3] * N)
    emitted, n_emit = emitted.numpy(), n_emit.numpy()
    assert ((1 <= n_emit) & (n_emit <= K + 1)).all()
    first = np.bincount(emitted[:, 0], minlength=V)
    _chi2_ok(first, probs[0])
    # `sample` on the same rows has the same law.
    ref = sample(logits[:, 0], temp, tk, tp, seeds, [3] * N).numpy()
    _chi2_ok(np.bincount(ref, minlength=V), probs[0])
    # After an accepted d0, position 1 is a draw from p_1.
    acc = n_emit >= 2
    assert (emitted[acc, 0] == d0).all() and acc.sum() > 500
    _chi2_ok(np.bincount(emitted[acc, 1], minlength=V), probs[1])
    if top_k:
        top = [set(np.argsort(-probs[j])[:top_k]) for j in range(K + 1)]
        for b in range(N):
            for j in range(n_emit[b]):
                assert emitted[b, j] in top[j]
        assert not (n_emit == K + 1).any(), "a draft outside top-k accepted"


# -- engines -------------------------------------------------------------

GEOM = dict(max_seqs=8, block_size=8, max_pages_per_seq=16,
            max_prefill_chunk=16, decode_buckets=(1, 2, 4, 8),
            prefill_buckets=(8, 16))
# Repetitive prompts (the drafter finds their n-grams) and one that is not.
PROMPTS = {"a": [5, 6, 7, 8] * 5, "b": [3, 1, 4, 1, 5, 9, 2, 6] * 2 + [3, 1],
           "c": [11, 12, 13, 11, 12, 13, 11, 12], "d": list(range(40, 52))}


@pytest.fixture(scope="module", params=["tiny-test", "tiny-moe"])
def model(request):
    jc = jcfg.get_config(request.param)
    params = jax_init_params(jc, jax.random.key(0))
    return (request.param, params,
            from_jax_params(jax.device_get(params), "cpu"))


def _run(core, requests, max_steps=3000):
    for rid, (prompt, sp) in requests.items():
        core.add_request(rid, prompt, sp)
    toks = {}
    for _ in range(max_steps):
        for d in core.step():
            toks.setdefault(d.request_id, []).extend(d.token_ids)
        if not core._requests:
            break
    assert not core._requests
    return toks


def _port(model, k=3, **kw):
    name, _, state = model
    return EngineCore(EngineConfig(
        model=tcfg.get_config(name), num_blocks=64, device="cpu",
        enable_prefix_cache=False, speculative_tokens=k,
        scheduler=SchedulerConfig(**GEOM), **kw), params=state)


def test_spec_engine_matches_jax_and_k0(model):
    name, params, _ = model
    j = JaxEngineCore(JaxEngineConfig(
        model=jcfg.get_config(name), num_blocks=64, packed_prefill=True,
        enable_prefix_cache=False, speculative_tokens=3,
        moe_mode="dense", scheduler=JaxSchedulerConfig(**GEOM)),
        params=params)
    want = _run(j, {r: (p, JaxSamplingParams(max_tokens=40))
                    for r, p in PROMPTS.items()})
    t = _port(model)
    got = _run(t, {r: (p, SamplingParams(max_tokens=40))
                   for r, p in PROMPTS.items()})
    assert got == want
    assert t.counters.spec_dispatches == j.counters.spec_dispatches > 0
    assert t.counters.window_dispatches == 0
    js, ts = j.metrics.spec_decode_stats, t.metrics.spec_decode_stats
    assert (ts.num_spec_tokens, ts.num_drafts, ts.num_accepted_tokens,
            ts.num_accepted_tokens_per_pos) == (
        js.num_spec_tokens, js.num_drafts, js.num_accepted_tokens,
        js.num_accepted_tokens_per_pos)
    assert 0 < ts.num_accepted_tokens <= ts.num_drafts
    # The port's own plain run (windows) emits the same ids.
    plain = _port(model, k=0)
    assert _run(plain, {r: (p, SamplingParams(max_tokens=40))
                        for r, p in PROMPTS.items()}) == got
    assert plain.counters.spec_dispatches == 0
    assert plain.metrics.spec_decode_stats is None


def test_logprob_and_seeded_rows_take_the_plain_step(model):
    reqs = {"lp": (PROMPTS["a"], SamplingParams(max_tokens=12, logprobs=True)),
            "seeded": (PROMPTS["c"], SamplingParams(
                max_tokens=12, temperature=0.8, seed=1234))}
    spec = _port(model)
    got = _run(spec, reqs)
    assert spec.counters.spec_dispatches == 0
    assert spec.counters.single_step_dispatches > 0
    assert _run(_port(model, k=0), reqs) == got


def test_unseeded_stochastic_rows_take_the_spec_step(model):
    """(A drafter that always proposes: a sampled tail rarely repeats.)"""
    spec = _port(model, drafter=DraftModelDrafter(lambda h, k: [5, 6, 7][:k]))
    got = _run(spec, {"s": (PROMPTS["a"], SamplingParams(
        max_tokens=24, temperature=0.7, top_k=8))})
    assert len(got["s"]) == 24
    assert spec.counters.spec_dispatches > 0


def test_a_wrong_drafter_stays_lossless(model):
    """Drafts of random ids, out-of-vocabulary ids cut the draft there."""
    rng = np.random.default_rng(0)
    vocab = tcfg.get_config(model[0]).vocab_size

    def garbage(hist, k):
        d = [int(t) for t in rng.integers(0, vocab, k)]
        if len(hist) % 2:
            d[1:2] = [vocab + 5]
        return d

    spec = _port(model, drafter=DraftModelDrafter(garbage))
    reqs = {r: (p, SamplingParams(max_tokens=20)) for r, p in PROMPTS.items()}
    got = _run(spec, reqs)
    assert got == _run(_port(model, k=0), reqs)
    assert spec.counters.spec_dispatches > 0
    st = spec.metrics.spec_decode_stats
    # Cut drafts count only the tokens before the bad id.
    assert st.num_drafts < 3 * spec.counters.spec_dispatches * len(PROMPTS)
