"""The port's checkpoint loader against the JAX package's.

Checkpoints are written here with `safetensors` in HF layout from JAX
random weights (`tiny-test`, `tiny-gemma`, `tiny-moe`): F32 and F16
files, one file or shards (with and without `model.safetensors.index.json`),
untied and tied embeddings, Gemma-2's names and config keys.  JAX's
`load_params` and the port's must give equal configs and state, element
for element through `from_jax_params`, and logits within 1e-4 (f32 end
to end).  BF16 files are checked on the port's reader alone: equal to
the same tensors rounded to bf16.  Also `resolve_model` (tokenizer spec,
chat template, eos), the local hub cache and `--num-layers`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

safetensors_np = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")

from dynamo_tpu.engine import kv_cache as jkvc  # noqa: E402
from dynamo_tpu.models import config as jcfg  # noqa: E402
from dynamo_tpu.models import llama as jllama  # noqa: E402
from dynamo_tpu.models import loader as jloader  # noqa: E402
from dynamo_tpu_torch.engine import kv_cache as tkvc  # noqa: E402
from dynamo_tpu_torch.models import llama as tllama  # noqa: E402
from dynamo_tpu_torch.models import loader as tloader  # noqa: E402
from dynamo_tpu_torch.models.weights import from_jax_params  # noqa: E402

LOGIT_TOL = 1e-4
BS = 8


def hf_config(cfg, tie: bool) -> dict:
    """The HF config.json of a ModelConfig (config_from_hf's inverse)."""
    gemma = cfg.post_norms
    out = {
        "architectures": ["Gemma2ForCausalLM" if gemma else
                          ("MixtralForCausalLM" if cfg.is_moe
                           else "LlamaForCausalLM")],
        "model_type": "gemma2" if gemma else (
            "mixtral" if cfg.is_moe else "llama"),
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_context,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": tie,
    }
    if cfg.is_moe:
        out["num_local_experts"] = cfg.num_experts
        out["num_experts_per_tok"] = cfg.num_experts_per_token
    if gemma:
        out.update(attn_logit_softcapping=cfg.attn_soft_cap,
                   final_logit_softcapping=cfg.final_soft_cap,
                   query_pre_attn_scalar=cfg.query_scale ** -2,
                   sliding_window=cfg.max_context // 2)
    return out


def hf_tensors(cfg, params) -> dict:
    """JAX params (numpy) under HF names, `[out, in]` linears."""
    t = {"model.embed_tokens.weight": params["embed"],
         "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        t["lm_head.weight"] = params["lm_head"].T
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        for hf, ours in (("q", "wq"), ("k", "wk"), ("v", "wv"), ("o", "wo")):
            t[p + f"self_attn.{hf}_proj.weight"] = layer["attn"][ours].T
        t[p + "input_layernorm.weight"] = layer["attn_norm"]
        if cfg.post_norms:
            t[p + "post_attention_layernorm.weight"] = layer["post_attn_norm"]
            t[p + "pre_feedforward_layernorm.weight"] = layer["mlp_norm"]
            t[p + "post_feedforward_layernorm.weight"] = layer["post_mlp_norm"]
        else:
            t[p + "post_attention_layernorm.weight"] = layer["mlp_norm"]
        if cfg.is_moe:
            moe = layer["moe"]
            t[p + "block_sparse_moe.gate.weight"] = moe["router"].T
            for e in range(cfg.num_experts):
                ep = p + f"block_sparse_moe.experts.{e}."
                t[ep + "w1.weight"] = moe["w_gate"][e].T
                t[ep + "w3.weight"] = moe["w_up"][e].T
                t[ep + "w2.weight"] = moe["w_down"][e].T
        else:
            for hf in ("gate", "up", "down"):
                t[p + f"mlp.{hf}_proj.weight"] = layer["mlp"]["w_" + hf].T
    return {k: np.ascontiguousarray(v) for k, v in t.items()}


def write_checkpoint(d, cfg, params, dtype=np.float32, shards=1,
                     index=True, tie=False, torch_bf16=False) -> dict:
    os.makedirs(d, exist_ok=True)
    tensors = hf_tensors(cfg, params)
    if tie:
        tensors.pop("lm_head.weight", None)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_config(cfg, tie), f)
    names = sorted(tensors)
    groups = [names[i::shards] for i in range(shards)]
    weight_map = {}
    for i, group in enumerate(groups):
        fname = (f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
                 if shards > 1 else "model.safetensors")
        path = os.path.join(d, fname)
        if torch_bf16:
            safetensors_torch.save_file(
                {k: torch.from_numpy(np.array(tensors[k])).to(torch.bfloat16)
                 for k in group}, path)
        else:
            safetensors_np.save_file(
                {k: tensors[k].astype(dtype) for k in group}, path)
        weight_map.update({k: fname for k in group})
    if shards > 1 and index:
        with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return tensors


def jax_params(name: str, tie: bool = False):
    cfg = jcfg.get_config(name).replace(tie_embeddings=tie)
    return cfg, jax.device_get(jllama.init_params(cfg, jax.random.key(11)))


CASES = [
    # (preset, file dtype, shards, index, tied)
    ("tiny-test", np.float32, 1, True, False),
    ("tiny-test", np.float16, 3, True, True),
    ("tiny-test", np.float32, 2, False, False),
    ("tiny-gemma", np.float32, 2, True, True),
    ("tiny-moe", np.float16, 2, False, False),
]


def _leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("name,dtype,shards,index,tie", CASES)
def test_load_params_equals_jax(tmp_path, name, dtype, shards, index, tie):
    """Config and every tensor equal JAX's load (both cast to bf16, the
    config's dtype); keys of the state equal the JAX pytree's."""
    cfg, params = jax_params(name, tie)
    d = str(tmp_path / "ckpt")
    write_checkpoint(d, cfg, params, dtype, shards, index, tie)
    jc, jp = jloader.load_params(d)
    tc, tp = tloader.load_params(d, device="cpu")
    for f in dataclasses.fields(jc):
        if f.name != "dtype":
            assert getattr(jc, f.name) == getattr(tc, f.name), f.name
    want = from_jax_params(jax.device_get(jp), "cpu")
    assert (jax.tree_util.tree_structure(want, is_leaf=torch.is_tensor)
            == jax.tree_util.tree_structure(tp, is_leaf=torch.is_tensor))
    for a, b in zip(_leaves(want), _leaves(tp)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,tie", [("tiny-test", False),
                                      ("tiny-gemma", True),
                                      ("tiny-moe", False)])
def test_loaded_logits_match_jax(tmp_path, name, tie):
    """An f32 load through both loaders, one prefill step: logits within
    1e-4.  Gemma-2's query_pre_attn_scalar and sliding-window clamp ride
    the config."""
    cfg, params = jax_params(name, tie)
    d = str(tmp_path / "ckpt")
    write_checkpoint(d, cfg, params, np.float32, 2, True, tie)
    jc, jp = jloader.load_params(d, dtype=jnp.float32)
    tc, tp = tloader.load_params(d, device="cpu", dtype=torch.float32)
    jc, tc = jc.replace(dtype=jnp.float32), tc.replace(dtype=torch.float32)
    if name == "tiny-gemma":
        assert tc.max_context == cfg.max_context // 2
        assert tc.query_scale == pytest.approx(cfg.query_scale)
    toks = np.asarray([[5, 17, 99, 3, 250, 8, 64]], np.int32)
    pos = np.arange(7, dtype=np.int32)[None]
    sl = np.asarray([7], np.int32)
    bt = np.asarray([[1, 2]], np.int32)
    jcache = jkvc.init_cache(jkvc.KvCacheConfig.for_model(
        jc, num_blocks=8, block_size=BS))
    tcache = tkvc.init_cache(tkvc.KvCacheConfig.for_model(
        tc, num_blocks=8, block_size=BS), "cpu")
    jl, _ = jllama.make_forward_step(jc, BS)(
        jp, jcache, *map(jnp.asarray, (toks, pos, sl, bt)))
    tl, _ = tllama.make_forward_step(tc, BS)(
        tp, tcache, *(torch.from_numpy(x) for x in (toks, pos, sl, bt)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)


def test_bf16_reader(tmp_path):
    """A bf16 sharded checkpoint (written by safetensors.torch) reads back
    equal to the same tensors rounded to bf16, with no float32 detour."""
    cfg, params = jax_params("tiny-test")
    d = str(tmp_path / "bf16")
    tensors = write_checkpoint(d, cfg, params, shards=2, torch_bf16=True)
    seen = {}
    for path in tloader.checkpoint_shards(d):
        f = tloader.SafetensorsFile(path)
        for k in f.keys():
            t = f.get(k)
            assert t.dtype == torch.bfloat16
            seen[k] = t.clone()
        f.close()
    assert sorted(seen) == sorted(tensors)
    for k, v in tensors.items():
        assert torch.equal(seen[k], torch.from_numpy(np.array(v)).to(torch.bfloat16))
    _, state = tloader.load_params(d, device="cpu")
    assert torch.equal(state["layers"][1]["attn"]["wq"],
                       torch.from_numpy(np.array(params["layers"][1]["attn"]["wq"]))
                       .to(torch.bfloat16))


def test_missing_tensor_and_num_layers(tmp_path):
    """A missing tensor raises with its name; a config cut to fewer
    layers loads only those."""
    cfg, params = jax_params("tiny-test")
    d = str(tmp_path / "ckpt")
    write_checkpoint(d, cfg, params)
    tc, tp = tloader.resolve_model(d, device="cpu", num_layers=1)[:2]
    assert tc.num_layers == 1 and len(tp["layers"]) == 1
    tensors = hf_tensors(cfg, params)
    tensors.pop("model.layers.1.mlp.up_proj.weight")
    safetensors_np.save_file(tensors, os.path.join(d, "model.safetensors"))
    with pytest.raises(KeyError, match="model.layers.1.mlp.up_proj.weight"):
        tloader.load_params(d, device="cpu")


TEMPLATE = "{% for m in messages %}<{{ m.role }}>{{ m.content }}{% endfor %}"


def test_resolve_model_matches_jax(tmp_path, monkeypatch):
    """Directory, `org/repo` in the hub cache (refs/main) and preset:
    the tokenizer spec, chat template and eos equal JAX's; the hub never
    downloads (a miss raises)."""
    cfg, params = jax_params("tiny-test")
    cache = tmp_path / "hub"
    snap = cache / "models--acme--tiny" / "snapshots" / "abc123"
    write_checkpoint(str(snap), cfg, params)
    (snap / "tokenizer.json").write_text('{"model": {"type": "BPE"}}')
    (snap / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": TEMPLATE,
         "eos_token": {"content": "</s>"}}))
    os.makedirs(cache / "models--acme--tiny" / "refs")
    (cache / "models--acme--tiny" / "refs" / "main").write_text("abc123")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    for ref in (str(snap), "acme/tiny"):
        j = jloader.resolve_model(ref)
        t = tloader.resolve_model(ref, device="cpu")
        assert t[2] == j[2] and t[3] == j[3] == TEMPLATE
        assert t[2]["eos_token"] == "</s>"
        assert t[0].name == j[0].name
    assert tloader.resolve_config("acme/tiny").hidden_size == cfg.hidden_size
    with pytest.raises(FileNotFoundError, match="local hub cache"):
        tloader.resolve_model("acme/missing", device="cpu")
    jc, jp, js, jt = jloader.resolve_model("tiny-test")
    tc, tp, ts, tt = tloader.resolve_model("tiny-test", device="cpu")
    assert tp is None and jp is None and ts == js and tt == jt is None


def test_smoke_safetensors_writer_reads_back(tmp_path):
    """chip_smoke's writer (the card machine has no `safetensors`): the
    `safetensors` package and the port's reader read its file back
    equal, bf16 and f32."""
    import chip_smoke

    tensors = {"a": torch.randn(3, 5).to(torch.bfloat16),
               "b": torch.arange(7, dtype=torch.float32),
               "c.weight": torch.randn(2, 2, 2).to(torch.float16)}
    path = tmp_path / "x.safetensors"
    chip_smoke.write_safetensors(torch, path, tensors)
    ref = safetensors_torch.load_file(str(path))
    f = tloader.SafetensorsFile(str(path))
    for k, v in tensors.items():
        assert torch.equal(ref[k], v) and torch.equal(f.get(k), v)
    f.close()
