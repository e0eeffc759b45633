"""The port's sampling against `dynamo_tpu/engine/sampling.py`.

`_filtered_logits` must equal JAX's (same f32 division, same masks) and
greedy must pick the same tokens.  JAX's threefry bits cannot be
reproduced, so stochastic draws are held by distribution: a seeded
chi-square test of the port's draws against the exact probabilities of
JAX's filtered distribution, at a critical value of p = 0.001.
"""

import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine import sampling as jsamp
from dynamo_tpu_torch.engine import sampling as tsamp

# chi-square critical values at p = 0.001 by degrees of freedom.
CHI2_001 = {2: 13.816, 3: 16.266, 5: 20.515, 7: 24.322}


def _rows():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 50)).astype(np.float32) * 3
    temp = np.asarray([0.0, 1.0, 0.7, 1.3, 1.0, 0.5], np.float32)
    top_k = np.asarray([0, 0, 5, 0, 10, 3], np.int32)
    top_p = np.asarray([1.0, 1.0, 1.0, 0.8, 0.55, 0.9], np.float32)
    return logits, temp, top_k, top_p


def test_filtered_logits_equal_jax():
    logits, temp, top_k, top_p = _rows()
    want = np.asarray(jsamp._filtered_logits(*map(jnp.asarray, (
        logits, temp, top_k, top_p))))
    got = tsamp._filtered_logits(*map(torch.from_numpy, (
        logits, temp, top_k, top_p))).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got, want)


def test_greedy_and_logprobs_match_jax():
    logits, temp, top_k, top_p = _rows()
    want = np.array(jsamp.greedy(jnp.asarray(logits)))
    assert tsamp.greedy(torch.from_numpy(logits)).numpy().tolist() == want.tolist()
    # Temperature-0 rows (and seedless rows) of `sample` are argmax.
    got = tsamp.sample(*map(torch.from_numpy, (logits, temp, top_k, top_p)),
                       [None, 1, 2, 3, 4, 5], [0] * 6)
    assert int(got[0]) == int(want[0])
    lp_j = np.asarray(jsamp.chosen_logprobs(jnp.asarray(logits),
                                            jnp.asarray(want)))
    lp_t = tsamp.chosen_logprobs(torch.from_numpy(logits),
                                 torch.from_numpy(want)).numpy()
    np.testing.assert_allclose(lp_t, lp_j, rtol=0, atol=1e-5)


def _chi2(draws: np.ndarray, probs: np.ndarray) -> tuple:
    support = probs > 0
    counts = np.bincount(draws, minlength=probs.size)
    assert not counts[~support].any(), "drew a filtered-out token"
    expected = probs[support] * draws.size
    return float(((counts[support] - expected) ** 2 / expected).sum()), \
        int(support.sum()) - 1


def test_stochastic_draws_follow_jax_distribution():
    """4000 seeded draws per configuration against softmax of JAX's
    filtered logits (temperature, top-k, top-p)."""
    logits = np.asarray([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0]],
                        np.float32)
    n = 4000
    for temp, k, p in ((1.0, 0, 1.0), (0.7, 4, 1.0), (1.0, 0, 0.8)):
        filt = np.asarray(jsamp._filtered_logits(
            jnp.asarray(logits), jnp.asarray([temp]), jnp.asarray([k]),
            jnp.asarray([p])))[0].astype(np.float64)
        probs = np.exp(filt - filt.max())
        probs /= probs.sum()
        rows = torch.from_numpy(np.repeat(logits, n, axis=0))
        draws = tsamp.sample(rows, torch.full((n,), temp),
                             torch.full((n,), k, dtype=torch.int32),
                             torch.full((n,), p), [1234] * n,
                             list(range(n))).numpy()
        stat, df = _chi2(draws, probs)
        assert stat < CHI2_001[df], (temp, k, p, stat)


def test_draws_depend_only_on_seed_and_token_index():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    temp = torch.ones(4)
    k = torch.zeros(4, dtype=torch.int32)
    p = torch.ones(4)
    a = tsamp.sample(logits, temp, k, p, [7, 8, 9, 7], [0, 5, 5, 3])
    # Row 3 of a batch equals the same (logits, seed, index) drawn alone.
    b = tsamp.sample(logits[3:], temp[3:], k[3:], p[3:], [7], [3])
    assert int(a[3]) == int(b[0])
    # Reordering the batch changes nothing per row.
    perm = [2, 0, 3, 1]
    c = tsamp.sample(logits[perm], temp, k, p, [9, 7, 7, 8], [5, 0, 3, 5])
    assert c.tolist() == [int(a[i]) for i in perm]
    assert tsamp.draw_seed(7, 0) != tsamp.draw_seed(7, 1) != tsamp.draw_seed(8, 0)
