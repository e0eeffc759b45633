"""Model state: random init on the device, and the bridge from the JAX
package's parameter pytree.

The state is a plain nested dict with the same names and shapes as
`dynamo_tpu.models.llama.init_params` builds — `embed [V, H]`,
`final_norm [H]`, `layers[i]["attn"]["wq" | "wk" | "wv" | "wo"]`,
`layers[i]["mlp"]["w_gate" | "w_up" | "w_down"]`, the norm vectors, and
`lm_head [H, V]` when embeddings are untied — so a weight crosses over by
name with no transposes.  Matrices are `[in, out]` (`x @ w`).
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig

State = Dict


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device]) -> State:
    """Random-init state with the JAX package's shapes and std
    (fan_in ** -0.5, norms at 1), drawn from `generator` directly on
    `device` (the generator must live on that device).  The draws are
    torch's, not JAX's: parity tests carry JAX weights across with
    `from_jax_params` instead."""
    cfg.validate()
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet")
    dtype = cfg.dtype
    device = torch.device(device)
    h = cfg.hidden_size

    def dense(fan_in, *shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dtype)

    def ones(n):
        return torch.ones((n,), device=device, dtype=dtype)

    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "attn": {
                "wq": dense(h, h, cfg.q_size),
                "wk": dense(h, h, cfg.kv_size),
                "wv": dense(h, h, cfg.kv_size),
                "wo": dense(cfg.q_size, cfg.q_size, h),
            },
            "attn_norm": ones(h),
            "mlp_norm": ones(h),
            "mlp": {
                "w_gate": dense(h, h, cfg.intermediate_size),
                "w_up": dense(h, h, cfg.intermediate_size),
                "w_down": dense(cfg.intermediate_size,
                                cfg.intermediate_size, h),
            },
        }
        if cfg.post_norms:
            layer["post_attn_norm"] = ones(h)
            layer["post_mlp_norm"] = ones(h)
        layers.append(layer)
    state: State = {
        "embed": dense(h, cfg.vocab_size, h),
        "final_norm": ones(h),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        state["lm_head"] = dense(h, h, cfg.vocab_size)
    return state


def _to_tensor(arr, device) -> torch.Tensor:
    a = np.array(arr, copy=True)  # writable, contiguous, owned
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (ml_dtypes supplies it); carry the
        # raw 16-bit patterns across and reinterpret them.
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(params, device: Union[str, torch.device]) -> State:
    """The JAX parameter pytree, as numpy arrays (`jax.device_get`),
    turned into the port's state by name.  Nested dicts and lists keep
    their structure; every leaf becomes a tensor of the same dtype on
    `device`."""
    if isinstance(params, dict):
        return {k: from_jax_params(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [from_jax_params(v, device) for v in params]
    return _to_tensor(params, device)
