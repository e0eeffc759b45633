"""Checkpoint loading: HF-layout safetensors -> the port's state (port of
`dynamo_tpu/models/loader.py`).

The safetensors reader is the port's own (the serving machine has no
`safetensors` package): an 8-byte little-endian header length, a JSON
header of `{name: {"dtype", "shape", "data_offsets"}}`, then raw bytes.
Each file is memory-mapped and each tensor read with `torch.frombuffer`
in its stored dtype (F32, F16, BF16 — numpy has no bf16, so nothing goes
through numpy), copied to the device and only there cast to the model
dtype and transposed.  The host holds the mapped file pages, never a
float32 copy of the model, and tensors land shard by shard.

Name mapping (HF Llama / Mistral / Qwen, Mixtral, Gemma-2 -> the state):

    model.embed_tokens.weight            embed                [V, H]
    model.norm.weight                    final_norm           [H]
    lm_head.weight                       lm_head (transposed) [H, V]
    model.layers.N.input_layernorm       layers[N].attn_norm
    model.layers.N.post_attention_ln     layers[N].mlp_norm (Gemma-2: the
                                         post-attention norm, with
                                         pre_/post_feedforward_layernorm)
    ...self_attn.{q,k,v,o}_proj.weight   attn.w{q,k,v,o}      (transposed)
    ...mlp.{gate,up,down}_proj.weight    mlp.w_{gate,up,down} (transposed)
    ...block_sparse_moe.gate.weight      moe.router           (transposed)
    ...block_sparse_moe.experts.E.w{1,3,2}  moe.w_{gate,up,down}[E]

HF stores `nn.Linear` weights `[out, in]`; the state multiplies `x @ W`,
so every projection transposes.  GQA's head order is HF's (query head h
reads kv head h // G), and the rotary layout is HF's half split.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, List, Optional, Tuple, Union

import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig

State = Dict

SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16}


def config_from_hf(hf: dict, name: str = "") -> ModelConfig:
    """An HF config.json dict as a ModelConfig (Llama / Mistral / Qwen,
    Mixtral, Gemma-2)."""
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    gemma2 = "Gemma2" in arch or hf.get("model_type") == "gemma2"
    num_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // num_heads
    max_context = hf.get("max_position_embeddings", 8192)
    if gemma2 and hf.get("sliding_window"):
        # Every layer runs global attention, exact while the context
        # stays within Gemma-2's sliding window: clamp to it.
        max_context = min(max_context, int(hf["sliding_window"]))
    query_scale = None
    if gemma2 and hf.get("query_pre_attn_scalar"):
        query_scale = float(hf["query_pre_attn_scalar"]) ** -0.5
    return ModelConfig(
        name=name or hf.get("model_type", "hf-model"),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=head_dim,
        intermediate_size=hf["intermediate_size"],
        max_context=max_context,
        rope_theta=float(hf.get("rope_theta", 10_000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        num_experts=hf.get("num_local_experts", 0),
        num_experts_per_token=hf.get("num_experts_per_tok", 2),
        # HF leaves defaulted keys out of config.json; Gemma-2's default
        # is tied embeddings, Llama's untied.
        tie_embeddings=bool(hf.get("tie_word_embeddings", gemma2)),
        activation="gelu_tanh" if gemma2 else "silu",
        attn_soft_cap=hf.get("attn_logit_softcapping") if gemma2 else None,
        final_soft_cap=(hf.get("final_logit_softcapping")
                        if gemma2 else None),
        post_norms=gemma2,
        rms_offset=gemma2,
        embed_scale=gemma2,
        query_scale=query_scale,
    )


def read_header(path: str) -> dict:
    """A .safetensors file's JSON header (tensor name -> entry)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


class SafetensorsFile:
    """One .safetensors file, memory-mapped; `get` returns a CPU tensor
    viewing the mapped bytes in the stored dtype."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            # Copy-on-write pages: writable for torch.frombuffer, and the
            # file itself is never written.
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self._base = 8 + n
        self._entries = header

    def keys(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype = SAFETENSORS_DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{e['dtype']!r}; supported: "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        start, end = e["data_offsets"]
        shape = tuple(e["shape"])
        count = end - start
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        t = torch.frombuffer(self._map, dtype=torch.uint8, count=count,
                             offset=self._base + start)
        return t.view(dtype).reshape(shape)

    def close(self) -> None:
        self._map.close()


def checkpoint_shards(model_dir: str) -> List[str]:
    """The checkpoint's .safetensors files: those the index names when
    there is one, else every .safetensors file, in name order."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(model_dir)
                       if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    return [os.path.join(model_dir, f) for f in files]


def _name_map(cfg: ModelConfig) -> Dict[str, Tuple[tuple, str]]:
    """HF tensor name -> (path into the state, kind): "lin" transposes,
    "vec" copies, ("expert", e) transposes into row e of a stack."""
    out: Dict[str, Tuple[tuple, object]] = {
        "model.embed_tokens.weight": (("embed",), "vec"),
        "model.norm.weight": (("final_norm",), "vec"),
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        L = ("layers", i)
        for hf, ours in (("q", "wq"), ("k", "wk"), ("v", "wv"), ("o", "wo")):
            out[p + f"self_attn.{hf}_proj.weight"] = (L + ("attn", ours),
                                                      "lin")
        out[p + "input_layernorm.weight"] = (L + ("attn_norm",), "vec")
        if cfg.post_norms:
            # Gemma-2: post_attention_layernorm is a true post-norm; the
            # pre-MLP norm is pre_feedforward_layernorm.
            out[p + "post_attention_layernorm.weight"] = (
                L + ("post_attn_norm",), "vec")
            out[p + "pre_feedforward_layernorm.weight"] = (
                L + ("mlp_norm",), "vec")
            out[p + "post_feedforward_layernorm.weight"] = (
                L + ("post_mlp_norm",), "vec")
        else:
            out[p + "post_attention_layernorm.weight"] = (
                L + ("mlp_norm",), "vec")
        if cfg.is_moe:
            out[p + "block_sparse_moe.gate.weight"] = (
                L + ("moe", "router"), "lin")
            for e in range(cfg.num_experts):
                ep = p + f"block_sparse_moe.experts.{e}."
                for hf, ours in (("w1", "w_gate"), ("w3", "w_up"),
                                 ("w2", "w_down")):
                    out[ep + hf + ".weight"] = (L + ("moe", ours),
                                                ("expert", e))
        else:
            for hf in ("gate", "up", "down"):
                out[p + f"mlp.{hf}_proj.weight"] = (L + ("mlp", "w_" + hf),
                                                    "lin")
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = (("lm_head",), "lin")
    return out


def _empty_state(cfg: ModelConfig) -> State:
    layers = []
    for _ in range(cfg.num_layers):
        layer = {"attn": {}}
        layer["moe" if cfg.is_moe else "mlp"] = {}
        layers.append(layer)
    return {"layers": layers}


def _place(state: State, path: tuple, value) -> None:
    node = state
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _lookup(state: State, path: tuple):
    node = state
    for k in path:
        node = node[k] if isinstance(k, int) else node.get(k)
        if node is None:
            return None
    return node


def load_params(model_dir: str, cfg: Optional[ModelConfig] = None,
                device: Union[str, torch.device, None] = None,
                dtype: Optional[torch.dtype] = None
                ) -> Tuple[ModelConfig, State]:
    """An HF-layout checkpoint directory as (config, state) on `device`
    (the card unless the caller asks for the CPU).  `cfg` overrides the
    directory's config.json; its `num_layers` may keep fewer layers than
    the checkpoint holds.  `dtype=None` takes the config's (bf16)."""
    device = resolve_device(device)
    if cfg is None:
        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = config_from_hf(json.load(f),
                                 name=os.path.basename(model_dir.rstrip("/")))
    cfg.validate()
    dtype = dtype or cfg.dtype
    files = checkpoint_shards(model_dir)
    has_head = any("lm_head.weight" in read_header(f) for f in files)
    if not cfg.tie_embeddings and not has_head:
        cfg = cfg.replace(tie_embeddings=True)
    names = _name_map(cfg)
    state = _empty_state(cfg)
    seen = set()
    for path in files:
        shard = SafetensorsFile(path)
        try:
            for name in shard.keys():
                where = names.get(name)
                if where is None:
                    continue
                dest, kind = where
                # An owned copy: on the CPU `.to` would alias the map.
                t = shard.get(name).to(device, copy=True)
                if kind == "vec":
                    _place(state, dest, t.to(dtype))
                elif kind == "lin":
                    _place(state, dest, t.to(dtype).t().contiguous())
                else:
                    e = kind[1]
                    stack = _lookup(state, dest)
                    if stack is None:
                        out_f, in_f = t.shape
                        stack = torch.empty((cfg.num_experts, in_f, out_f),
                                            dtype=dtype, device=device)
                        _place(state, dest, stack)
                    stack[e].copy_(t.to(dtype).t())
                seen.add(name)
                del t
        finally:
            shard.close()
    missing = sorted(set(names) - seen)
    if missing:
        raise KeyError(f"tensor {missing[0]!r} not in checkpoint "
                       f"{model_dir} ({len(missing)} missing)")
    return cfg, state


def read_tokenizer_config(model_dir: str) -> Tuple[Optional[str],
                                                   Optional[str]]:
    """(chat template, eos token) from tokenizer_config.json, if any."""
    path = os.path.join(model_dir, "tokenizer_config.json")
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        tok_cfg = json.load(f)
    eos = tok_cfg.get("eos_token")
    if isinstance(eos, dict):
        eos = eos.get("content")
    return tok_cfg.get("chat_template"), eos


def _local_ref(ref: str) -> str:
    """An `org/repo` of the local hub cache as its snapshot directory;
    anything else unchanged.  Preset names hold no '/', so this never
    shadows one."""
    if (not os.path.exists(ref) and ref.count("/") == 1
            and not ref.startswith(".")):
        from dynamo_tpu_torch.models.hub import resolve_cached_repo

        return resolve_cached_repo(ref)
    return ref


def _is_gguf(ref: str) -> bool:
    return ref.endswith(".gguf") and os.path.isfile(ref)


def resolve_config(path_or_preset: str,
                   num_layers: Optional[int] = None) -> ModelConfig:
    """The config a `--model` argument names, read without loading any
    weight, cut to its first `num_layers` decoder layers when given."""
    from dynamo_tpu_torch.models import config as mcfg

    ref = path_or_preset if _is_gguf(path_or_preset) else _local_ref(
        path_or_preset)
    if _is_gguf(ref):
        from dynamo_tpu_torch.models.gguf import GgufFile, config_from_gguf

        cfg = config_from_gguf(GgufFile(ref))
    elif os.path.isdir(ref):
        with open(os.path.join(ref, "config.json")) as f:
            cfg = config_from_hf(json.load(f),
                                 name=os.path.basename(ref.rstrip("/")))
    else:
        cfg = mcfg.get_config(ref)
    if num_layers is None:
        return cfg
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(f"--num-layers {num_layers} outside "
                         f"1..{cfg.num_layers} for {cfg.name}")
    return cfg.replace(num_layers=num_layers)


def resolve_model(path_or_preset: str,
                  device: Union[str, torch.device, None] = None,
                  num_layers: Optional[int] = None):
    """A `--model` argument: an HF-layout directory, a `.gguf` file, an
    `org/repo` of the local hub cache, or a preset name (random weights).

    Returns (cfg, state or None, tokenizer spec, chat template or None).
    `num_layers` keeps the first N decoder layers."""
    if _is_gguf(path_or_preset):
        from dynamo_tpu_torch.models.gguf import load_gguf

        cfg, state, tok = load_gguf(path_or_preset, device=device,
                                    num_layers=num_layers)
        # The byte tokenizer serves; the GGUF vocabulary rides the card
        # for clients that want it.
        spec = {"kind": "byte"}
        if tok:
            spec["gguf_tokenizer"] = {k: tok[k] for k in
                                      ("model", "bos_token_id",
                                       "eos_token_id") if k in tok}
        return cfg, state, spec, None
    ref = _local_ref(path_or_preset)
    cfg = resolve_config(ref, num_layers)
    if not os.path.isdir(ref):
        return cfg, None, {"kind": "byte"}, None
    cfg, state = load_params(ref, cfg=cfg, device=device)
    spec = {"kind": "byte"}
    tok_path = os.path.join(ref, "tokenizer.json")
    if os.path.exists(tok_path):
        with open(tok_path, encoding="utf-8") as f:
            spec = {"kind": "hf_inline", "json": f.read()}
    template, eos = read_tokenizer_config(ref)
    if eos and spec.get("kind") == "hf_inline":
        spec["eos_token"] = eos
    return cfg, state, spec, template
