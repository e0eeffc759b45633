"""The port's GGUF loader against the JAX package's.

Random blocks of every supported ggml type go through JAX's numpy
`_dequant` and through the port's two dequantizers (its numpy copy, the
plain oracle, and `dequant_torch`, torch ops on the CPU here): equal
exactly.  A tiny-test GGUF written with `chip_smoke.write_gguf` (F32,
F16, Q8_0 and K-quant tensors, llama.cpp's rope permutation on q/k)
loads through `config_from_gguf` / `load_gguf` on both sides: equal
configs, equal bf16 state element for element, the tokenizer metadata
equal; unsupported types raise JAX's message.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from dynamo_tpu.models import config as jcfg
from dynamo_tpu.models import gguf as jgguf
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.models import gguf as tgguf
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models.weights import from_jax_params

TYPES = {"Q8_0": 8, "Q4_K": 12, "Q5_K": 13, "Q6_K": 14}


@pytest.mark.parametrize("name", sorted(TYPES))
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.filterwarnings("ignore:invalid value:RuntimeWarning")
def test_dequant_equals_jax(name, scaled):
    """Random blocks (bounded f16 scales, or fully random bytes whose
    scales may be inf / NaN): the port's numpy and torch dequantizers
    equal JAX's bit for bit, NaN where JAX has NaN."""
    gtype = TYPES[name]
    rng = np.random.default_rng(gtype)
    n = 8 * chip_smoke.GGUF_BLOCK[gtype][1]
    raw = (chip_smoke.gguf_random_blocks(np, rng, gtype, n) if scaled else
           rng.integers(0, 256, size=(n // chip_smoke.GGUF_BLOCK[gtype][1])
                        * chip_smoke.GGUF_BLOCK[gtype][0],
                        dtype=np.uint8).tobytes())
    want = jgguf._dequant(raw, gtype, n)
    np.testing.assert_array_equal(tgguf._dequant(raw, gtype, n), want)
    got = tgguf.dequant_torch(torch.frombuffer(bytearray(raw),
                                               dtype=torch.uint8), gtype, n)
    np.testing.assert_array_equal(got.numpy(), want)
    if scaled:
        assert np.isfinite(want).all() and 0.005 < want.std() < 0.06


@pytest.mark.parametrize("gtype", [0, 1])
def test_float_types(gtype):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(96).astype(np.float32)
    raw = chip_smoke.gguf_blob(np, rng, gtype, a)
    want = jgguf._dequant(raw, gtype, 96)
    got = tgguf.dequant_torch(torch.frombuffer(bytearray(raw),
                                               dtype=torch.uint8), gtype, 96)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unsupported_type_raises_jax_message():
    with pytest.raises(ValueError) as want:
        jgguf._dequant(b"\0" * 18, 2, 32)
    for fn in (lambda: tgguf._dequant(b"\0" * 18, 2, 32),
               lambda: tgguf.dequant_torch(torch.zeros(18, dtype=torch.uint8),
                                           2, 32)):
        with pytest.raises(ValueError) as got:
            fn()
        assert str(got.value) == str(want.value)


def _permute(w: np.ndarray, n_head: int) -> np.ndarray:
    """llama.cpp's convert-time rope permutation on [out, in] weights."""
    out, in_ = w.shape
    return (w.reshape(n_head, 2, out // n_head // 2, in_)
             .swapaxes(1, 2).reshape(out, in_))


LAYER_TYPES = {"attn_q": "F16", "attn_k": "Q8_0", "attn_v": "F32",
               "attn_output": "Q4_K", "ffn_gate": "Q6_K", "ffn_up": "Q5_K",
               "ffn_down": "Q8_0"}


def write_tiny_gguf(path, cfg, params, rng, tie: bool) -> None:
    """tiny-test as a llama-arch GGUF: F32 norms, the layer types above
    (K-quant tensors random blocks, the others from `params`)."""
    tensors = [("token_embd.weight", [cfg.hidden_size, cfg.vocab_size], 1,
                chip_smoke.gguf_blob(np, rng, 1, params["embed"])),
               ("output_norm.weight", [cfg.hidden_size], 0,
                chip_smoke.gguf_blob(np, rng, 0, params["final_norm"]))]
    if not tie:
        tensors.append(("output.weight", [cfg.hidden_size, cfg.vocab_size],
                        8, chip_smoke.gguf_blob(np, rng, 8,
                                                params["lm_head"].T)))
    names = {"attn_q": "wq", "attn_k": "wk", "attn_v": "wv",
             "attn_output": "wo"}
    for i, layer in enumerate(params["layers"]):
        p = f"blk.{i}."
        for norm, key in (("attn_norm", "attn_norm"),
                          ("ffn_norm", "mlp_norm")):
            tensors.append((p + norm + ".weight", [cfg.hidden_size], 0,
                            chip_smoke.gguf_blob(np, rng, 0, layer[key])))
        for t, kind in LAYER_TYPES.items():
            gtype = chip_smoke.GGUF_TYPE[kind]
            if t in names:
                w = np.asarray(layer["attn"][names[t]], np.float32).T
            else:
                w = np.asarray(layer["mlp"]["w_" + t[4:]], np.float32).T
            if t == "attn_q":
                w = _permute(w, cfg.num_heads)
            elif t == "attn_k":
                w = _permute(w, cfg.num_kv_heads)
            dims = [w.shape[1], w.shape[0]]
            if gtype in (12, 13, 14):
                blob = chip_smoke.gguf_blob(np, rng, gtype, n=w.size)
            else:
                blob = chip_smoke.gguf_blob(np, rng, gtype, w)
            tensors.append((p + t + ".weight", dims, gtype, blob))
    tokens = [f"<t{i}>" for i in range(cfg.vocab_size)]
    chip_smoke.write_gguf(path, chip_smoke.gguf_llama_metadata(cfg, tokens),
                          tensors)


@pytest.mark.parametrize("tie", [True, False])
def test_load_gguf_equals_jax(tmp_path, tie):
    cfg = jcfg.get_config("tiny-test").replace(tie_embeddings=tie,
                                               intermediate_size=256)
    params = jax.device_get(jllama.init_params(cfg, jax.random.key(5)))
    path = str(tmp_path / "tiny.gguf")
    write_tiny_gguf(path, cfg, params, np.random.default_rng(3), tie)
    jc = jgguf.config_from_gguf(jgguf.GgufFile(path))
    tc = tgguf.config_from_gguf(tgguf.GgufFile(path))
    for f in dataclasses.fields(jc):
        if f.name != "dtype":
            assert getattr(jc, f.name) == getattr(tc, f.name), f.name
    assert tc.tie_embeddings == tie
    jc, jp, jtok = jgguf.load_gguf(path)
    tc, tp, ttok = tgguf.load_gguf(path, device="cpu")
    assert ttok == jtok
    want = from_jax_params(jax.device_get(jp), "cpu")
    leaves = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        t, is_leaf=torch.is_tensor)
    assert (jax.tree_util.tree_structure(want, is_leaf=torch.is_tensor)
            == jax.tree_util.tree_structure(tp, is_leaf=torch.is_tensor))
    for a, b in zip(leaves(want), leaves(tp)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
    # The unpermuted q weight is the original one (F16 carries it up to
    # f16 rounding).
    np.testing.assert_allclose(
        tp["layers"][0]["attn"]["wq"].float().numpy(),
        params["layers"][0]["attn"]["wq"], atol=2e-2)
    # resolve_model: the byte tokenizer serves, the GGUF vocabulary's
    # model and special ids ride the spec.
    from dynamo_tpu.models.loader import resolve_model as jresolve

    t = tloader.resolve_model(path, device="cpu")
    j = jresolve(path)
    assert t[2] == j[2] and t[3] is j[3] is None
    assert t[2]["gguf_tokenizer"] == {"model": "llama", "bos_token_id": 1,
                                      "eos_token_id": 2}
    assert tloader.resolve_config(path).hidden_size == cfg.hidden_size
