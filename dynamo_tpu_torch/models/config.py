"""Model architecture configs (port of `dynamo_tpu/models/config.py`).

Same presets and knobs as the JAX package; `dtype` is a `torch.dtype`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of a Llama-family (optionally MoE) decoder-only LM."""

    name: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    max_context: int = 8192
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # MoE (Mixtral-style).  num_experts == 0 means dense MLP; this slice
    # of the port serves dense models only.
    num_experts: int = 0
    num_experts_per_token: int = 2
    moe_capacity: Optional[int] = None
    tie_embeddings: bool = False
    # Gemma-family knobs (all default to the Llama conventions):
    activation: str = "silu"              # "silu" | "gelu_tanh"
    attn_soft_cap: Optional[float] = None  # attention-logit soft cap
    final_soft_cap: Optional[float] = None  # lm-head-logit soft cap
    post_norms: bool = False              # post-attn/post-mlp RMSNorms
    rms_offset: bool = False              # norm scales by (1 + w)
    embed_scale: bool = False             # embeddings x sqrt(hidden)
    query_scale: Optional[float] = None   # replaces head_dim**-0.5

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads (GQA)")
        if self.is_moe and self.num_experts_per_token > self.num_experts:
            raise ValueError("num_experts_per_token > num_experts")
        if self.moe_capacity is not None and self.moe_capacity <= 0:
            raise ValueError("moe_capacity must be positive (None = exact)")
        if self.activation not in ("silu", "gelu_tanh"):
            raise ValueError(f"unknown activation {self.activation!r}")

    def param_count(self) -> int:
        h, v = self.hidden_size, self.vocab_size
        attn = h * self.q_size + 2 * h * self.kv_size + self.q_size * h
        if self.is_moe:
            mlp = (self.num_experts * 3 * h * self.intermediate_size
                   + h * self.num_experts)
        else:
            mlp = 3 * h * self.intermediate_size
        per_layer = attn + mlp + 2 * h
        emb = v * h * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + emb + h


TINY = ModelConfig(
    name="tiny-test",
    vocab_size=256,
    hidden_size=64,
    num_layers=2,
    num_heads=8,
    num_kv_heads=4,
    head_dim=16,
    intermediate_size=128,
    max_context=512,
    rope_theta=10_000.0,
    dtype=torch.float32,
    tie_embeddings=True,
)

TINY_MOE = TINY.replace(name="tiny-moe", num_experts=8, num_experts_per_token=2)

LLAMA3_1B = ModelConfig(
    name="llama-3-1b",
    vocab_size=128_256,
    hidden_size=2048,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    intermediate_size=8192,
    max_context=8192,
    tie_embeddings=True,
)

LLAMA3_8B = ModelConfig(
    name="llama-3-8b",
    vocab_size=128_256,
    hidden_size=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=14_336,
    max_context=8192,
)

LLAMA3_70B = ModelConfig(
    name="llama-3-70b",
    vocab_size=128_256,
    hidden_size=8192,
    num_layers=80,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=28_672,
    max_context=8192,
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32_000,
    hidden_size=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=14_336,
    max_context=32_768,
    rope_theta=1_000_000.0,
    num_experts=8,
    num_experts_per_token=2,
)

TINY_GEMMA = TINY.replace(
    name="tiny-gemma",
    activation="gelu_tanh",
    attn_soft_cap=50.0,
    final_soft_cap=30.0,
    post_norms=True,
    rms_offset=True,
    embed_scale=True,
    query_scale=16.0 ** -0.5,
)

GEMMA2_9B = ModelConfig(
    name="gemma-2-9b",
    vocab_size=256_000,
    hidden_size=3584,
    num_layers=42,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    intermediate_size=14_336,
    # Every layer runs global attention, exact while context stays within
    # Gemma-2's 4096 sliding window — max_context is clamped to it.
    max_context=4096,
    rope_theta=10_000.0,
    rms_norm_eps=1e-6,
    tie_embeddings=True,
    activation="gelu_tanh",
    attn_soft_cap=50.0,
    final_soft_cap=30.0,
    post_norms=True,
    rms_offset=True,
    embed_scale=True,
    query_scale=224.0 ** -0.5,
)

PRESETS = {
    c.name: c
    for c in (TINY, TINY_MOE, TINY_GEMMA, LLAMA3_1B, LLAMA3_8B,
              LLAMA3_70B, MIXTRAL_8X7B, GEMMA2_9B)
}


def get_config(name: str) -> ModelConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(PRESETS)}") from None
