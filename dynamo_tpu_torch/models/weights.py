"""Model state: random init on the device, and the bridge from the JAX
package's parameter pytree.

The state is a plain nested dict with the same names and shapes as
`dynamo_tpu.models.llama.init_params` builds — `embed [V, H]`,
`final_norm [H]`, `layers[i]["attn"]["wq" | "wk" | "wv" | "wo"]`,
`layers[i]["mlp"]["w_gate" | "w_up" | "w_down"]` (or, for MoE models,
`layers[i]["moe"]["router" [H, E] | "w_gate" [E, H, F] | "w_up" [E, H, F] |
"w_down" [E, F, H]]`, plus f32 `*_scale` siblings when the experts are
int8), the norm vectors, and `lm_head [H, V]` when embeddings are untied —
so a weight crosses over by name with no transposes.  Matrices are
`[in, out]` (`x @ w`).

A tensor-parallel engine holds one such state per rank, each tensor cut
along the axis `parallel.sharding.param_pspecs` names (`shard_state`).
No card should hold the whole model beside its slices, so the whole
state reaches `shard_state` from the host (`from_jax_params(params,
"cpu")`, a checkpoint's memory map), or `init_params` is given the
group and cuts each layer and table as soon as it is drawn.  A
pipeline's stages (parallel/mesh.PpStages) hold one such state each,
over the stage's layers (parallel/pipeline.shard_stages); given the
stages, `init_params` puts each layer and table on the stage that holds
it as soon as it is drawn.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig

State = Dict


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device],
                group=None, moe_mode: Optional[str] = None
                ) -> Union[State, List[State]]:
    """Random-init state with the JAX package's shapes and std
    (fan_in ** -0.5, norms at 1), drawn from `generator` directly on
    `device` (the generator must live on that device).  The draws are
    torch's, not JAX's: parity tests carry JAX weights across with
    `from_jax_params` instead.

    With a rank `group` (parallel.mesh.DpGrid; tp alone is its one dp
    row) the result is the ranks' states, `shard_state` of the same
    draws: each layer and each table is cut into the ranks' slices as
    soon as it is drawn and then dropped, so `device` holds at most one
    whole layer or table beside the slices, and the ranks that share a
    card and a piece share one copy.  An MoE model's pieces follow
    `moe_mode` on the grid (default JAX's auto: "dispatch" over an ep
    axis, else "dense"): its experts over ep, each expert's intermediate
    width over tp.

    With pipeline stages for `group` (parallel/mesh.PpStages) the result
    is the stages' states (`shard_stages` of the same draws): each layer
    and table moves to the stage that holds it as it is drawn, so
    `device` holds at most one piece beside the stages' pieces."""
    cfg.validate()
    dtype = cfg.dtype
    device = torch.device(device)
    h = cfg.hidden_size
    specs = None
    stages = group if hasattr(group, "microbatches") else None
    if stages is not None:
        from dynamo_tpu_torch.parallel.mesh import _to_device
        from dynamo_tpu_torch.parallel.pipeline import shard_stages

        S = stages.pp
        if cfg.num_layers % S:
            raise ValueError(f"pp={S} must divide num_layers="
                             f"{cfg.num_layers}")
        per_stage = cfg.num_layers // S
        stage_of = {"embed": 0, "final_norm": S - 1, "lm_head": S - 1}
    elif group is not None:
        from dynamo_tpu_torch.parallel.sharding import (
            param_pspecs, shard_state)

        if moe_mode is None:
            moe_mode = "dispatch" if group.ep > 1 else "dense"
        specs = param_pspecs(cfg, moe_mode, dp_attention=group.dp_attention)

    def keep(piece, *path):
        """The whole piece (on its stage's device for a pipeline), or its
        ranks' slices (a list)."""
        if stages is not None:
            s = (path[1] // per_stage if path[0] == "layers"
                 else stage_of[path[0]])
            return _to_device(piece, stages.devices[s])
        if specs is None:
            return piece
        spec = specs
        for k in path:
            spec = spec[k]
        return shard_state(piece, spec, group)

    def dense(fan_in, *shape):
        # One tensor at a time in f32, scaled in place: the f32 peak is one
        # tensor (1.9 GB for a Mixtral-8x7B expert stack).
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(fan_in ** -0.5).to(dtype)

    def ones(n):
        return torch.ones((n,), device=device, dtype=dtype)

    layers = []
    for i in range(cfg.num_layers):
        layer = {
            "attn": {
                "wq": dense(h, h, cfg.q_size),
                "wk": dense(h, h, cfg.kv_size),
                "wv": dense(h, h, cfg.kv_size),
                "wo": dense(cfg.q_size, cfg.q_size, h),
            },
            "attn_norm": ones(h),
            "mlp_norm": ones(h),
        }
        f = cfg.intermediate_size
        if cfg.is_moe:
            e = cfg.num_experts
            layer["moe"] = {
                "router": dense(h, h, e),
                "w_gate": dense(h, e, h, f),
                "w_up": dense(h, e, h, f),
                "w_down": dense(f, e, f, h),
            }
        else:
            layer["mlp"] = {
                "w_gate": dense(h, h, f),
                "w_up": dense(h, h, f),
                "w_down": dense(f, f, h),
            }
        if cfg.post_norms:
            layer["post_attn_norm"] = ones(h)
            layer["post_mlp_norm"] = ones(h)
        layers.append(keep(layer, "layers", i))
        del layer   # a whole layer is gone before the next is drawn
    embed = keep(dense(h, cfg.vocab_size, h), "embed")
    norm = keep(ones(h), "final_norm")
    head = (None if cfg.tie_embeddings
            else keep(dense(h, h, cfg.vocab_size), "lm_head"))

    def state(pick) -> State:
        out = {"embed": pick(embed), "final_norm": pick(norm),
               "layers": [pick(layer) for layer in layers]}
        if head is not None:
            out["lm_head"] = pick(head)
        return out

    if stages is not None:
        return shard_stages(state(lambda piece: piece), stages)
    if group is None:
        return state(lambda piece: piece)
    return [state(lambda piece, r=r: piece[r])
            for r in range(len(group.devices))]


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
    `device`.  For a rank grid, `device` "cpu": `shard_state` (or
    `EngineCore(params=...)`) then copies each rank's slice from the
    host straight to its card, once a place for the ranks that share it
    (an sp grid's ranks of one (dp row, tp slice), say).  JAX's stacked pytree (pipeline.
    stack_layer_params: `layers` one dict of [L, ...] leaves) comes
    across as the port's list of L layer dicts."""
    if isinstance(params, dict) and isinstance(params.get("layers"), dict):
        params = dict(params, layers=_unstack(params["layers"]))
    if isinstance(params, dict):
        return {k: from_jax_params(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [from_jax_params(v, device) for v in params]
    return _to_tensor(params, device)


def _unstack(tree) -> List:
    """A tree of [L, ...] leaves as a list of L trees of their rows."""
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            yield t

    def row(t, i):
        if isinstance(t, dict):
            return {k: row(v, i) for k, v in t.items()}
        return t[i]

    n = next(leaves(tree)).shape[0]
    return [row(tree, i) for i in range(n)]
