"""Pipeline parallelism on the card (port of
`dynamo_tpu/parallel/pipeline.py`): the GPipe stage schedule over the
stages of one process (parallel/mesh.PpStages).

The JAX package runs the schedule inside one `shard_map` over the pp
axis; the port's stages are ranks of one process, each stage a stream
of its own on its card (several stages may share one card), with no
`torch.distributed`:

- stage s owns layers `[s * L/S, (s + 1) * L/S)` (`stage_layers`) and
  their paged KV: the cache is a list of per-stage caches (`init_pp_cache`,
  kv_cache.init_stage_caches), a stage's cache holding its own layers
  only.  The embedding lives on stage 0 and the final norm and the head
  on the last stage (`shard_stages`); a tied-embedding head reads the
  embedding table, one copy a place.
- `_pp_schedule` is JAX's GPipe rotation: M microbatches of B/M rows,
  stage s running microbatch i at tick s + i, S + M - 1 ticks.  The port
  enqueues only the real (stage, microbatch) pairs, in tick order, each
  after the hand-over of (s - 1, i) (`PpStages.send`): no bubble ticks
  and no bubble writes to the null block, which an SPMD program cannot
  skip.  Each stage runs its layers through the meshless step's body
  (llama._decoder_layers) on its own cache list: through K1, the
  paged-decode kernel, for T == 1 with `use_decode_kernel`, and the
  gather path otherwise.  The step's positions, lengths, tables, slots
  and rope tables reach each stage's card once a step; a microbatch's
  are row views of them.  The last stage's logits come back to the
  caller's stream (`PpStages.home`).
- `make_pp_step`, `make_pp_greedy_step` and `make_pp_decode_window` are
  JAX's three programs with JAX's call contracts; the window samples on
  stage 0's card and feeds the tokens back on the device, with no host
  sync (llama's window loop).
- `make_pp_packed_prefill_step` is the port's packed ragged prefill, K2
  per stage on the stage's layers, the pack riding the stages as one
  microbatch.  (The JAX package prefills pp through its padded unified
  step on the gather path.)
- `make_pp_block_ops` moves the whole cache's wire block `[2, L, bs,
  F]` (or the packed int8 one) in and out of the stage-owned layout.

`_validate_pp` holds JAX's rules: dense models only, no post-norms, S
dividing the layers; `MeshConfig` refuses pp beside any other axis.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.cuda import (
    paged_decode_attention,
    paged_prefill_attention,
)
from dynamo_tpu_torch.parallel.mesh import MeshConfig, _to_device


def stage_layers(num_layers: int, S: int) -> List[range]:
    """The layers each of S stages owns: stage s `[s * L/S, (s + 1) *
    L/S)`."""
    n = num_layers // S
    return [range(s * n, (s + 1) * n) for s in range(S)]


def pp_param_pspecs(cfg: ModelConfig) -> Dict:
    """JAX's stacked-params specs: every layer leaf over pp on its layer
    axis, the embedding, the norms and the head replicated.  The port
    keeps a replicated piece only on the stages that read it
    (`shard_stages`)."""
    leaf = ("pp",)
    layers = {
        "attn": {"wq": leaf, "wk": leaf, "wv": leaf, "wo": leaf},
        "attn_norm": leaf,
        "mlp_norm": leaf,
        "mlp": {"w_gate": leaf, "w_up": leaf, "w_down": leaf},
    }
    specs = {"embed": (None, None), "final_norm": (None,), "layers": layers}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, None)
    return specs


def pp_cache_pspecs(kv_quant: bool = False) -> Dict:
    """JAX's stacked-cache specs: each stage owns its layers' pages and,
    int8, their scales (the port's list of per-stage caches)."""
    spec = ("pp", None, None)
    out = {"k": spec, "v": spec}
    if kv_quant:
        out["k_scale"] = spec
        out["v_scale"] = spec
    return out


def init_pp_cache(cfg: kvc.KvCacheConfig, stages) -> List[Dict]:
    """The stage-owned cache: per stage, `{'k': [L/S x [S_slots, F]],
    'v': ...}` of its own layers on its device, plus `k_scale` /
    `v_scale` lists for an int8 cache."""
    return kvc.init_stage_caches(cfg, stages)


def shard_stages(state: Dict, stages) -> List[Dict]:
    """Per-stage states of a whole state (a list of layer dicts, as
    weights.init_params draws it): stage s keeps its layers on its
    device, stage 0 the embedding, the last stage the final norm and the
    head (the embedding table itself when tied).  Stages of one place
    share one copy of a piece two of them hold; a piece already on its
    stage's device is not copied."""
    S = stages.pp
    L = len(state["layers"])
    if L % S:
        raise ValueError(f"pp={S} must divide num_layers={L}")
    held: Dict[tuple, torch.Tensor] = {}

    def put(name: str, s: int):
        key = (name, stages.places[s])
        if key not in held:
            held[key] = _to_device(state[name], stages.devices[s])
        return held[key]

    out = []
    for s, rng in enumerate(stage_layers(L, S)):
        st = {"layers": [_to_device(state["layers"][i], stages.devices[s])
                         for i in rng]}
        if s == 0:
            st["embed"] = put("embed", s)
        if s == S - 1:
            st["final_norm"] = put("final_norm", s)
            head = "lm_head" if "lm_head" in state else "embed"
            st[head] = put(head, s)
        out.append(st)
    return out


def _validate_pp(cfg: ModelConfig, mesh: MeshConfig) -> int:
    """JAX's pp-plane validation; returns the stage count S.  (pp beside
    another axis never builds: MeshConfig holds that rule.)"""
    cfg.validate()
    if cfg.is_moe:
        raise ValueError("pp v1 supports dense models only")
    if cfg.post_norms:
        raise ValueError("pp v1 does not wire Gemma-style post-norms")
    S = mesh.pp
    if cfg.num_layers % S != 0:
        raise ValueError(f"pp={S} must divide num_layers={cfg.num_layers}")
    return S


def _stage_lists(stages, state, cache) -> None:
    S = stages.pp
    if not isinstance(state, list) or len(state) != S or \
            not isinstance(cache, list) or len(cache) != S:
        raise ValueError(f"a pp{S} step takes a list of {S} stage states "
                         "and caches (shard_stages, init_pp_cache)")


def _attention_launches() -> int:
    """K1 and K2 launches so far, both cache bodies."""
    return sum(fn.launches + fn.launches_int8
               for fn in (paged_decode_attention, paged_prefill_attention))


def _head(cfg: ModelConfig, stage: Dict, x: torch.Tensor,
          pick) -> torch.Tensor:
    """The last stage's final norm over its activation, then the head
    over the rows `pick` takes: the meshless step's order."""
    x = llama.rms_norm(x, stage["final_norm"], cfg.rms_norm_eps,
                       cfg.rms_offset)
    return llama._lm_head(cfg, stage, pick(x))


def _pp_schedule(cfg: ModelConfig, block_size: int, stages, M: int,
                 use_kernel: bool):
    """The tick schedule shared by the plain step, the fused greedy step
    and the decode window: `step(state, cache, tokens, positions,
    seq_lens, block_tables, sample_positions) -> (logits [B, V],
    cache)` over per-stage states and caches (module docstring)."""
    S = stages.pp

    def step(state, cache, tokens, positions, seq_lens, block_tables,
             sample_positions=None):
        B, T = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        if sample_positions is None:
            raise ValueError("the pp step banks one sampled row per "
                             "microbatch: pass sample_positions")
        _stage_lists(stages, state, cache)
        mb = B // M
        P = block_tables.shape[1]
        bt = block_tables.to(torch.int32)
        write_slots = kvc.slots_for_positions(bt, positions, block_size)
        ctx_pos = ctx_slots = None
        if not (use_kernel and T == 1):
            ctx_pos = torch.arange(P * block_size, device=tokens.device
                                   ).expand(B, P * block_size)
            ctx_slots = kvc.slots_for_positions(bt, ctx_pos, block_size)
        cos, sin = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        # Stage 0 runs on the caller's stream: its embeddings need no
        # hand-over.
        x = llama._embed(cfg, state[0], tokens)
        stages.fork()
        meta = [None if t is None else stages.replicate(t) for t in (
            positions, seq_lens.to(torch.int32), bt, write_slots, ctx_slots,
            ctx_pos, cos, sin, sample_positions)]

        def run(s: int, i: int, x: torch.Tensor) -> torch.Tensor:
            rows = slice(i * mb, (i + 1) * mb)
            pos, sl, bts, ws, cs, cp, c, sn, smp = (
                None if m is None else m[s][rows] for m in meta)
            before = _attention_launches()
            x = llama._decoder_layers(
                cfg, state[s]["layers"], cache[s], x, pos, (c, sn), sl,
                ws.reshape(mb * T), cs, cp, bts, block_size, "dense", [])
            stages.launches[s] += _attention_launches() - before
            if s < S - 1:
                return x
            return _head(cfg, state[s], x, lambda h: h[
                torch.arange(mb, device=h.device), smp.long()])

        acts = [[None] * M for _ in range(S)]
        acts[0] = [x.narrow(0, i * mb, mb) for i in range(M)]
        outs: List[Optional[torch.Tensor]] = [None] * M
        for t in range(S + M - 1):
            for s in range(max(0, t - M + 1), min(S, t + 1)):
                i = t - s
                with stages.on(s):
                    y = run(s, i, acts[s][i])
                acts[s][i] = None
                if s < S - 1:
                    acts[s + 1][i] = stages.send(y, s)
                else:
                    outs[i] = stages.home(y, s)
        logits = outs[0] if M == 1 else torch.cat(outs, dim=0)
        stages.join()
        return logits, cache

    return step


def _quant_checked(fn, kv_quant: Optional[bool]):
    """`fn(state, cache, ...)` refusing the other cache mode than
    `kv_quant` (None: either)."""
    if kv_quant is None:
        return fn

    def checked(state, cache, *args, **kw):
        if kvc.cache_is_quantized(cache) != kv_quant:
            raise ValueError("the step was built for kv_quant="
                             f"{kv_quant} and got the other cache")
        return fn(state, cache, *args, **kw)

    return checked


def make_pp_step(cfg: ModelConfig, block_size: int, stages,
                 n_microbatches: int, kv_quant: Optional[bool] = None,
                 use_decode_kernel: bool = False):
    """The pipeline-parallel unified step:

        logits [B, V], cache = step(states, cache, tokens [B, T],
                                    positions [B, T], seq_lens [B],
                                    block_tables [B, P],
                                    sample_positions [B])

    the regular step contract, B divisible by `n_microbatches`, over
    per-stage states (`shard_stages`, `init_params(group=stages)`) and
    caches (`init_pp_cache`), inputs and logits on stage 0's card.
    `use_decode_kernel`: a T == 1 call attends through K1 on every
    stage."""
    _validate_pp(cfg, MeshConfig(pp=stages.pp))
    return _quant_checked(_pp_schedule(cfg, block_size, stages,
                                       n_microbatches, use_decode_kernel),
                          kv_quant)


def make_pp_greedy_step(cfg: ModelConfig, block_size: int, stages,
                        n_microbatches: int, kv_quant: Optional[bool] = None,
                        use_decode_kernel: bool = False):
    """The fused greedy pp single step, the meshless greedy step's
    contract: `fused(states, cache, tokens [B, 1], positions [B, 1],
    seq_lens [B], block_tables [B, P], sample_positions [B]) ->
    (tokens [B] int32, cache)`, the argmax taken on stage 0's card."""
    body = make_pp_step(cfg, block_size, stages, n_microbatches, kv_quant,
                        use_decode_kernel)

    def fused(state, cache, tokens, positions, seq_lens, block_tables,
              sample_positions):
        logits, cache = body(state, cache, tokens, positions, seq_lens,
                             block_tables, sample_positions)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return fused


def make_pp_decode_window(cfg: ModelConfig, block_size: int, stages,
                          n_microbatches: int, window: int,
                          greedy_only: bool = False,
                          kv_quant: Optional[bool] = None,
                          use_decode_kernel: bool = False):
    """K decode steps over the pipeline schedule per call, the sampled
    tokens fed back on the device: llama.make_decode_window's run()
    contract, sampled on stage 0's card (the last stage's logits come
    home each step), so the engine's pipelined window path serves pp
    unchanged."""
    body = make_pp_step(cfg, block_size, stages, n_microbatches, kv_quant,
                        use_decode_kernel)
    return llama._window_loop(body, window, greedy_only, False)


def make_pp_packed_prefill_step(cfg: ModelConfig, block_size: int, stages):
    """The packed ragged prefill over the stages (llama's
    `make_packed_prefill_step` contract): the pack rides as one
    microbatch, stage s writing its layers' pages and attending them
    through K2, the paged-prefill kernel, then handing its activation to
    stage s + 1; the segment rows' logits come back to stage 0's card."""
    from dynamo_tpu_torch.parallel.sharding import PlaneSpec, check_plane

    S = _validate_pp(cfg, MeshConfig(pp=stages.pp))

    def step(state, cache, tokens, positions, seg_ids, block_tables,
             q_starts, q_lens, seq_lens, sample_positions,
             input_embeds=None, embed_mask=None):
        if input_embeds is not None:
            check_plane(PlaneSpec(role="mm"), MeshConfig(pp=S))
        _stage_lists(stages, state, cache)
        T = tokens.shape[0]
        bt = block_tables.to(torch.int32)
        write_slots = kvc.slots_for_positions(
            bt[seg_ids.long()], positions[:, None], block_size).reshape(T)
        cos, sin = llama.rope_tables(positions[None], cfg.head_dim,
                                     cfg.rope_theta)
        x = llama._embed(cfg, state[0], tokens)[None]             # [1, T, H]
        stages.fork()
        meta = [stages.replicate(t) for t in (
            write_slots, cos, sin, bt, seq_lens.to(torch.int32),
            q_starts.to(torch.int32), q_lens.to(torch.int32),
            sample_positions)]
        for s in range(S):
            ws, c, sn, bts, sl, qs, ql, smp = (m[s] for m in meta)
            with stages.on(s):
                before = _attention_launches()
                x = llama._packed_layers(
                    cfg, state[s]["layers"], cache[s], x, (c, sn), ws,
                    (bts, sl, qs, ql), block_size, "dense", [])
                stages.launches[s] += _attention_launches() - before
                if s == S - 1:
                    x = _head(cfg, state[s], x, lambda h: h[0][smp.long()])
            x = stages.send(x, s) if s < S - 1 else stages.home(x, s)
        stages.join()
        return x, cache

    return step


def make_pp_block_ops(block_size: int, stages, kv_quant: bool = False):
    """Whole-block (extract, inject) for the stage-owned layout, JAX's
    canonical wire block (`[2, L, bs, F]`, or the packed int8 `[2, L, bs,
    F + 4 * Hkv]`), so a pp worker moves blocks byte for byte with
    meshless, tp and dp peers: `extract(cache, pages [n]) -> [n, 2, L,
    bs, F']` gathers each stage's layers onto stage 0's card, and
    `inject(cache, pages, data) -> cache` scatters them back, in place."""

    def check(cache):
        if not isinstance(cache, list) or len(cache) != stages.pp:
            raise ValueError(f"pp{stages.pp} block ops take a list of "
                             f"{stages.pp} stage caches (init_pp_cache)")
        if kvc.cache_is_quantized(cache) != kv_quant:
            raise ValueError("the block ops were built for kv_quant="
                             f"{kv_quant} and got the other cache")

    def extract(cache, pages: torch.Tensor) -> torch.Tensor:
        check(cache)
        return kvc.extract_stage_blocks(cache, pages, block_size)

    def inject(cache, pages: torch.Tensor, data: torch.Tensor):
        check(cache)
        kvc.inject_stage_blocks(cache, pages, data, block_size)
        return cache

    return extract, inject
