"""The port's kernel modules against the JAX Pallas kernels.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py); here, on the CPU, each wrapper takes its plain PyTorch
version, which is held against the JAX kernel run in interpret mode on
the same numpy inputs — ragged rows, pad rows, `seq_len == 0` rows,
shuffled pages, a cached prefix and alignment gaps included.

Tolerances: f32 inputs agree to 1e-5 (products are exact in both, only the
f32 summation order differs); bf16 inputs to one bf16 unit in the last
place of the output (|x| < 4 here, so 2**-6), since both sides round the
scaled query and the probabilities to bf16 at the same points.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas import paged_decode_attention as jax_decode
from dynamo_tpu.ops.pallas import paged_prefill_attention as jax_prefill
from dynamo_tpu_torch.ops.cuda import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)

TOLS = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    if dtype == "bfloat16":
        a = arr.astype(ml_dtypes.bfloat16)
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return jnp.asarray(a), t
    a = arr.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jax.device_get(x)).astype(np.float32)


# Decode geometry: GQA group 4, non-contiguous pages, ragged/full/empty rows.
BS, HQ, HKV, D = 8, 8, 2, 32
DECODE_TABLES = [[3, 9, 17, 2], [11, 4, 0, 0], [21, 0, 0, 0], [0, 0, 0, 0],
                 [5, 6, 7, 8]]
DECODE_LENS = [29, 9, 1, 0, 32]


def _decode_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    S = 32 * BS
    q = _pair(rng.standard_normal((len(DECODE_LENS), HQ, D)), dtype)
    kc = _pair(rng.standard_normal((S, HKV * D)), dtype)
    vc = _pair(rng.standard_normal((S, HKV * D)), dtype)
    bt = np.asarray(DECODE_TABLES, np.int32)
    sl = np.asarray(DECODE_LENS, np.int32)
    return q, kc, vc, bt, sl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("soft_cap", [None, 5.0])
def test_decode_plain_matches_jax_kernel(dtype, soft_cap):
    q, kc, vc, bt, sl = _decode_inputs(dtype)
    want = jax_decode(q[0], kc[0], vc[0], jnp.asarray(bt), jnp.asarray(sl),
                      block_size=BS, soft_cap=soft_cap, interpret=True)
    got = paged_decode_attention_plain(
        q[1], kc[1], vc[1], torch.from_numpy(bt), torch.from_numpy(sl),
        block_size=BS, soft_cap=soft_cap)
    assert got.dtype == q[1].dtype and got.shape == q[1].shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=TOLS[dtype])
    # seq_len == 0 rows come back as exact zeros on both sides.
    assert not _np(got)[3].any() and not _np(want)[3].any()


# Prefill geometry: three segments (one with a 7-token cached prefix), a
# pad segment, and unowned alignment rows between/after them.
PREFILL_T = 48
PREFILL_SEGS = [  # (q_start, q_len, seq_len, table)
    (0, 13, 13, [4, 9, 0, 0, 0, 0]),
    (16, 20, 27, [12, 3, 30, 7, 0, 0]),
    (40, 5, 5, [17, 0, 0, 0, 0, 0]),
    (0, 0, 0, [0, 0, 0, 0, 0, 0]),
]


def _prefill_inputs(dtype, seed=1):
    rng = np.random.default_rng(seed)
    S = 32 * BS
    q = _pair(rng.standard_normal((PREFILL_T, HQ, D)), dtype)
    kc = _pair(rng.standard_normal((S, HKV * D)), dtype)
    vc = _pair(rng.standard_normal((S, HKV * D)), dtype)
    cols = [np.asarray([s[i] for s in PREFILL_SEGS], np.int32)
            for i in range(3)]
    bt = np.asarray([s[3] for s in PREFILL_SEGS], np.int32)
    return q, kc, vc, bt, cols[0], cols[1], cols[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("soft_cap", [None, 5.0])
def test_prefill_plain_matches_jax_kernel(dtype, soft_cap):
    q, kc, vc, bt, qs, ql, sl = _prefill_inputs(dtype)
    want = jax_prefill(q[0], kc[0], vc[0], jnp.asarray(bt), jnp.asarray(sl),
                       jnp.asarray(qs), jnp.asarray(ql), block_size=BS,
                       soft_cap=soft_cap, interpret=True)
    got = paged_prefill_attention_plain(
        q[1], kc[1], vc[1], torch.from_numpy(bt), torch.from_numpy(sl),
        torch.from_numpy(qs), torch.from_numpy(ql), block_size=BS,
        soft_cap=soft_cap)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=TOLS[dtype])
    owned = np.zeros(PREFILL_T, bool)
    for q0, n, _, _ in PREFILL_SEGS:
        owned[q0:q0 + n] = True
    assert not _np(got)[~owned].any()


def test_cpu_tensors_take_the_plain_versions():
    q, kc, vc, bt, sl = _decode_inputs("bfloat16")
    before = (paged_decode_attention.launches, paged_prefill_attention.launches)
    got = paged_decode_attention(q[1], kc[1], vc[1], torch.from_numpy(bt),
                                 torch.from_numpy(sl), block_size=BS)
    want = paged_decode_attention_plain(q[1], kc[1], vc[1],
                                        torch.from_numpy(bt),
                                        torch.from_numpy(sl), block_size=BS)
    assert torch.equal(got, want)
    q, kc, vc, bt, qs, ql, sl = _prefill_inputs("bfloat16")
    args = [torch.from_numpy(x) for x in (bt, sl, qs, ql)]
    got = paged_prefill_attention(q[1], kc[1], vc[1], *args, block_size=BS)
    want = paged_prefill_attention_plain(q[1], kc[1], vc[1], *args,
                                         block_size=BS)
    assert torch.equal(got, want)
    # Plain versions are not kernel launches.
    assert (paged_decode_attention.launches,
            paged_prefill_attention.launches) == before


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.zeros((1, HQ, D), device="meta")
    kc = torch.zeros((BS, HKV * D), device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    sl = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no paged decode kernel"):
        paged_decode_attention(q, kc, kc, bt, sl, block_size=BS)
    with pytest.raises(ValueError, match="no paged prefill kernel"):
        paged_prefill_attention(torch.zeros((8, HQ, D), device="meta"), kc,
                                kc, bt, sl, sl, sl, block_size=BS)
