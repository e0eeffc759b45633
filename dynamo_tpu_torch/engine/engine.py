"""The inference engine: device state, step loop and async streaming (port
of `dynamo_tpu/engine/engine.py`).

- `EngineCore` — synchronous: owns the model state, the paged cache and
  the scheduler; `step()` runs one iteration and returns token deltas.
- `InferenceEngine` — the async facade: `generate()` streams deltas while
  the core loop runs on its own thread, so device work never blocks the
  event loop.

The device paths are the JAX engine's main path: packed ragged prefill
through the paged-prefill kernel, fused K-step decode windows through the
paged-decode kernel with their token copies lagging `WINDOW_PIPELINE_DEPTH`
windows behind (device→host on a side stream into pinned memory), the
fused greedy single step, the single step with logprobs, and
recompute-preemption.  MoE models run every step's expert FFN in the
resolved `moe_mode` (the grouped-expert kernel on a card) and accumulate
the steps' [E+1] expert load on the device; `snapshot_expert_load()`
reads it on demand, so the load costs no host sync per step.

`kv_quant="int8"` stores the paged cache as int8 with per-token, per-head
f32 scales; every step then attends through the kernels' int8 bodies.
The prefix cache is on by default, as in the JAX engine: pages come from
a ManagedBlockSource (the tiered block manager), admission reuses the
pages of a prompt's longest cached run of sealed blocks, and
`_publish_completed_blocks` registers each block a request seals, always
before the token that follows it is appended.  With `host_blocks` /
`disk_blocks` an evicted block rides down to pinned host memory (G2) and
disk (G3) and onboards back into fresh pages on a later match;
`remote_fetch_fn` is the G4 tier (llm/block_manager/manager.py).

Block transfer, as in JAX: `export_blocks` hands out the wire bytes of
blocks resident in any tier, `export_blocks_device` those of G1 blocks
on the device (engine/kv_cache.py), `import_blocks`
injects a peer's blocks as registered prefix-cache entries after
`_validate_block` refuses a block of the other KV mode, and
`resident_prefix_blocks` measures the locally held prefix.  The cache is
updated in place, so these run on the engine thread between steps
(`InferenceEngine.run_in_engine`).  `seal_sink(request_id, sealed)`
fires whenever a request's sealed-block count grows (after every prefill
chunk), which `InferenceEngine.watch_seals` turns into the seal-progress
stream a disagg prefill worker publishes.

KV events, as in JAX: with a `kv_event_sink` the engine emits a STORED
event for each batch of blocks a request seals (with the hash of the
block before them as its parent) and a REMOVED event for each block that
leaves the device: evicted from the prefix cache's pool, or, with the
prefix cache off, released by a request that finishes or is preempted.
One counter numbers them.  `metrics` (ForwardPassMetrics) is refreshed
from host counts after every step, for the worker's load publication.

Padding discipline as in JAX: block tables are sliced to the batch's page
bucket, unallocated entries are the null block 0, and pad writes target
position `max_pages * block_size`, which indexes past every table width
and resolves to the null block.

`sp > 1` adds the sequence-parallel prefill: a prefill batch whose every
item is a whole prompt of at least `sp_prefill_threshold` tokens skips
the packed plane and runs as one padded [R, T] step over the ring's ranks
(parallel/mesh.SpRing), attention through the flash-fold ring kernel on a
card.  A prompt that a prefix-cache hit or the mixed-window budget splits
is not a whole prompt and goes the packed plane.  With sp alone the cache
and decode stay on the engine's device, rank 0's; with tp or dp the sp
axis joins the rank grid (JAX's `sp_prefill` plane): each (dp row, tp
slice) has a ring of sp ranks carrying its heads, the batch's rows pad
to a multiple of dp, and decode, the packed prefill and the cache stay
on the ranks of sp index 0.  sp composes with neither ep nor
dp_attention, in JAX's words.

Speculative decode, as in JAX: with `speculative_tokens` K > 0 a
decode-only step drafts K tokens a row (`engine/drafter.py`), feeds
[last, drafts] as one T = K+1 chunk through the gathered-context step and
emits what `sampling.speculative_verify` accepts, with one host sync;
windows are off then, and rows spec declines take the plain step.
`embed_tokens` (the /v1/embeddings surface) prefills on borrowed pages
through the step's `return_hidden` variant; `clear_prefix_cache` flushes
the reusable cached blocks, each reported REMOVED.

Observability, as in JAX: `counters` is the `EngineStepCounters` of
runtime/metrics.py (every dispatch site calls `note_dispatch` with JAX's
tag and shape signature; decode, single-step and spec dispatches tally
`note_kv_read`); `step()` stamps the flight recorder's heartbeat, and
with the recorder on each dispatch leaves a breadcrumb; a first-seen
shape stamps the recorder's compile time and, with the device profiler
on, records the shape's modeled cost, while each window's span on the
stream is timed by CUDA events read at its sync.  A request's first
token records the `engine.queue_wait` / `engine.prefill` / `engine.ttft`
spans under the context the serving layer bound, and parks the ledger's
engine timings (`pop_ledger_timings`).  None of it adds a host sync, and
the steady window's counter deltas are the same with every plane on or
off.  Thread contracts (runtime/contracts.py) pin the core to its step
loop.

QoS, as in JAX: `generate` and `add_request` take the request's class
(`priority`), and the scheduler's QoS victims go through `_qos_preempt`,
which resets the seal bookkeeping, recompute-preempts, and demotes the
victim's sealed blocks through the block manager into the host tier (a
no-op without one, as in JAX; `qos_demoted_blocks` counts the blocks
that moved).  A
drain ends a stream with a `TokenDelta.migrate` hint (llm/drain.py).

`tp > 1`, `dp > 1`, `ep > 1` or `dp_attention` runs every step over a
DpGrid of dp * ep * tp ranks (parallel/mesh.py; tp alone is its one dp
row), the JAX engine's (dp, ep, tp) mesh: the weights are cut by
`parallel.sharding.param_pspecs` (`shard_state`), the ranks of a card
share one copy of each weight piece, and the packed prefill, the fused
greedy step, the decode window, spec decode's T = K+1 verify and
`embed_tokens` all run the same sharded forward (models/llama.py),
whose full-vocab logits land on the engine's device, rank 0's, for the
sampler.  Block tables, the scheduler and the block manager stay whole;
the wire block stays the whole cache's.  Under tp, and plain dp, each
rank holds its kv heads' columns of the paged cache (replicated over
dp).  Over dp the batch rows pad to a multiple of dp (dp * tp under
dp_attention: the grid's decode buckets are padded so) and a packed
prefill is grid-shaped (one equal token range and segment rows a dp
row, a rank under dp_attention).  dp_attention shards the cache's slots
over tp and attends on the gather path; with page locality
(`dp_attention_local`, JAX's auto rule: on with the plain allocator)
the slots shard over the flat grid, the sharded allocator draws a
request's pages from its slot's shard, the decode rows are the slots
themselves (the fixed `_dp_rows` grid, JAX's cost: that many rows every
step; `_slot_perm`), and K1 / K2 run per shard on shard-local tables.
Every modeled byte the counters and the device profiler keep is per
chip: `kv_shard_count` (residency) is tp (dp * tp under dp-local) and
`kv_traffic_shards` (reads) dp * tp, as JAX's; sp divides neither.

An MoE model on a grid resolves its mode by JAX's ladder
(parallel/sharding.resolve_moe_mode: "dispatch" over an ep axis, else
"dense"; "grouped" refused): under "dispatch" each dp row's tokens split
over its ep ranks (the rows pad to a multiple of dp * ep, a packed
prefill's row totals to a multiple of ep) and `ModelConfig.moe_capacity`
bounds each expert's buffer a source shard; the expert load sums over dp
and ep, and `moe_dropped_tokens` counts what a bound dropped.

`pp > 1` runs every step over the pipeline's stages (parallel/mesh.
PpStages, parallel/pipeline.py), JAX's pp engine: each stage holds its
layers' weights and their paged KV (the embedding on stage 0, the final
norm and the head on the last), decode rows pad to a multiple of
`pp_microbatches` (M), and the fused greedy step and the decode window
run the GPipe schedule of M microbatches, K1 on every stage; a packed
prefill rides the stages as one microbatch through K2 on each.  Block
extract and inject go through the pp block ops, the whole cache's wire
block; the capability table refuses MoE, speculative decode,
embeddings and multimodal prompts under pp, in JAX's words.  A stored
KV byte and a decode's KV reads split over the stages: `kv_shard_count`
and `kv_traffic_shards` are pp, as JAX's.

Not ported yet: prewarm of the packed prefill shapes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.engine.drafter import Drafter, NgramDrafter
from dynamo_tpu_torch.engine.sampling import (
    SamplingParams,
    chosen_logprobs,
    greedy as greedy_sample,
    sample,
    speculative_verify,
)
from dynamo_tpu_torch.engine.scheduler import (
    BlockAllocator,
    DecodeWork,
    FinishReason,
    PACKED_PREFILL_SEGMENTS,
    MixedPrefillController,
    PrefillBatch,
    Request,
    RequestState,
    Scheduler,
    SchedulerConfig,
    pack_prefill_chunks,
)
from dynamo_tpu_torch.llm.block_manager import ManagedBlockSource, TieredConfig
from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    KvCacheEventData,
    KvStats,
    SpecDecodeStats,
    WorkerStats,
)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import (
    make_decode_window,
    make_forward_step,
    make_packed_prefill_step,
)
from dynamo_tpu_torch.models.weights import init_params
from dynamo_tpu_torch.ops.cuda import PACK_ALIGN, ring_kernel_supported
from dynamo_tpu_torch.parallel import multihost
from dynamo_tpu_torch.parallel.mesh import DpGrid, MeshConfig, PpStages, SpRing
from dynamo_tpu_torch.parallel.pipeline import (
    init_pp_cache,
    make_pp_block_ops,
    make_pp_greedy_step,
    shard_stages,
)
from dynamo_tpu_torch.parallel.sharding import (
    PlaneSpec,
    check_plane,
    make_sp_prefill_step,
    param_pspecs,
    resolve_moe_mode,
    shard_state,
    validate,
)
from dynamo_tpu_torch.runtime import (
    contracts,
    device_profiler,
    flight_recorder,
    ledger as request_ledger,
    tracing,
)
from dynamo_tpu_torch.runtime.contracts import (
    engine_thread_only,
    hot_path,
    never_engine_thread,
)
from dynamo_tpu_torch.runtime.metrics import EngineStepCounters
from dynamo_tpu_torch.tokens import TokenBlockSequence

logger = logging.getLogger(__name__)

# Fused decode window: K tokens per dispatch with on-device token
# feedback; the host reads each window's tokens WINDOW_PIPELINE_DEPTH
# windows later.
DECODE_WINDOW = 8
WINDOW_PIPELINE_DEPTH = 8
# With no request decoding, a bounded prefill chunk rides behind every
# MIXED_PREFILL_DUTY-th window; while requests decode, the adaptive
# controller picks (duty, chunk) from the modeled interference ratio.
MIXED_PREFILL_DUTY = 2


@dataclass
class TokenDelta:
    """One engine-step output for one request."""

    request_id: str
    token_ids: List[int]
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
    # log p(token) per entry of token_ids (sampling.logprobs only).
    logprobs: Optional[List[float]] = None
    # Prompt tokens the prefix cache served at admission; on the first
    # token delta after each admission only.
    cached_tokens: Optional[int] = None
    # Drain handoff (llm/drain.py): a worker leaving the fleet ends the
    # stream with this set instead of a finish — {"reason",
    # "covered_tokens", "address"?} tells the frontend's MigrationClient
    # to resume the stream on a peer, pulling the resident KV from
    # `address` first.  Never reaches end clients.
    migrate: Optional[dict] = None
    # A worker hop's request ledger in wire form, on the stream's last
    # delta out of a worker (runtime/ledger.py); None elsewhere.
    ledger: Optional[dict] = None


@dataclass(frozen=True)
class EngineConfig:
    model: ModelConfig
    num_blocks: int = 512
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    seed: int = 0
    device: str = "cuda"
    # MoE compute (ops/moe.resolve_moe_mode): "auto" takes the grouped
    # kernel on a card when the expert geometry passes, else "dense".
    moe_mode: str = "auto"
    # "none" = K/V pages at the model dtype; "int8" = int8 pages with
    # per-token, per-head f32 scales (engine/kv_cache.py).
    kv_quant: str = "none"
    # Prefix cache (the tiered block manager: G1 device always; G2 pinned
    # host / G3 disk when sized > 0); off = the plain free-list
    # allocator, no reuse.
    enable_prefix_cache: bool = True
    host_blocks: int = 0
    disk_blocks: int = 0
    # G4 remote tier: `remote_fetch_fn(block_hash) -> Optional[tensor]`,
    # consulted on local-tier misses during admission matching.  Must be
    # synchronous and bounded (it runs on the engine thread).
    remote_fetch_fn: Optional[Callable] = None
    # STORED / REMOVED events to the `kv_event_sink` (the KV router's
    # feed); without a sink nothing is emitted either way.
    enable_kv_events: bool = True
    # Sequence-parallel ring prefill: sp ranks (1 = off), each on the
    # device `sp_devices` names for it (meshless only; a grid places its
    # ranks itself; default: round-robin over the
    # visible cards, rank 0 on `device`; ranks may share a card).  Whole
    # prompts at least `sp_prefill_threshold` tokens long take the ring.
    sp: int = 1
    sp_devices: Optional[Tuple[str, ...]] = None
    sp_prefill_threshold: int = 256
    # Tensor parallelism: tp ranks (1 = off), rank 0 on `device`, a card
    # a rank where there are tp cards, else round-robin sharing.
    tp: int = 1
    # Data parallelism: dp rows of tp ranks each (parallel/mesh.DpGrid).
    dp: int = 1
    # Expert parallelism: ep ranks a (dp row, tp slice), E/ep experts
    # each (an MoE model only).
    ep: int = 1
    # Pipeline parallelism: pp stages of L/pp layers each, stage 0 on
    # `device` (composes with no other axis), and the GPipe microbatch
    # count of the stage schedule (decode rows pad to a multiple of it).
    pp: int = 1
    pp_microbatches: int = 2
    # Batch-sharded attention with slot-sharded KV (JAX's
    # `--dp-attention`): attention weights replicate, the MLP stays
    # tp-sharded.
    dp_attention: bool = False
    # dp-attention page locality: slots shard over the flat (dp, tp)
    # grid, decode rows pin to their slot and the sharded allocator keeps
    # a row's pages on its shard, so K1 and K2 run per shard.  None =
    # auto, JAX's rule: on under dp_attention with a mesh and the plain
    # allocator (the prefix cache has no shard concept).
    dp_attention_local: Optional[bool] = None
    # Speculative decode (`--spec-decode K`): when > 0, a decode step
    # drafts `speculative_tokens` tokens per row (prompt lookup over
    # `speculative_ngram`-grams, or `drafter`), verifies them in one
    # batched forward and emits the longest agreeing prefix plus one:
    # greedy rows emit the plain argmax chain, stochastic rows keep
    # `sample`'s law (sampling.speculative_verify).  Windows are off
    # while it is configured.
    speculative_tokens: int = 0
    speculative_ngram: int = 3
    drafter: Optional[Drafter] = None
    # Multi-process lockstep (parallel/multihost.Fabric): the rank grid
    # spans the fabric's processes, each computing its own ranks.
    fabric: Optional[object] = None


class _HostCopy:
    """A small device tensor copied to pinned host memory on a side stream,
    so the engine thread enqueues the copy and reads it later.  CPU
    tensors are ready at once."""

    def __init__(self, t: torch.Tensor, stream: Optional[torch.cuda.Stream],
                 fabric=None):
        """`fabric` (a process-spanning engine's): the read is checked
        against every process's (parallel/multihost.agree)."""
        self._event = None
        self._fabric = fabric
        if t.device.type != "cuda":
            self._host = t
            return
        ready = torch.cuda.Event()
        ready.record()
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)
        t.record_stream(stream)  # the allocator must not reuse t early

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        if self._fabric is not None:
            return multihost.agree(self._host.numpy(), self._fabric)
        return self._host.numpy()


class EngineCore:
    """Synchronous engine: one `step()` = one scheduler plan executed."""

    def __init__(self, config: EngineConfig, params: Optional[dict] = None,
                 kv_event_sink: Optional[Callable[[KvCacheEvent], None]] = None
                 ) -> None:
        """`kv_event_sink` is called on the engine thread with each
        KvCacheEvent (the worker hops it onto its event loop)."""
        self.config = config
        cfg = config.model
        sched_cfg = config.scheduler
        self.device = resolve_device(config.device)
        self.block_size = sched_cfg.block_size
        self.cache_cfg = kvc.KvCacheConfig.for_model(
            cfg, num_blocks=config.num_blocks, block_size=self.block_size,
            kv_quant=config.kv_quant)
        self.mesh = MeshConfig(dp=config.dp, pp=config.pp, sp=config.sp,
                               ep=config.ep, tp=config.tp)
        # Multi-process lockstep (parallel/multihost.py): the grid spans
        # the fabric's processes; the leader broadcasts every
        # engine-thread mutation on `_lockstep` before it runs it.
        fabric = config.fabric
        self._mh = fabric is not None and fabric.spans
        self._fabric = fabric if self._mh else None
        self._lockstep = None
        if self._mh:
            if config.pp > 1:
                check_plane(PlaneSpec(), self.mesh, multihost=True)
            if self.mesh.size <= 1:
                raise ValueError(
                    "--num-processes > 1 needs parallelism degrees that "
                    "span the cluster (tp*dp*ep*sp*pp > 1); a meshless "
                    "engine is process-local by construction")
            check_plane(PlaneSpec(spec=config.speculative_tokens > 0),
                        self.mesh, multihost=True)
        self._dp_local = self._resolve_dp(config)
        self._n_local_shards = 1
        if self._dp_local:
            self._n_local_shards = config.dp * config.tp
            if config.num_blocks % self._n_local_shards:
                raise ValueError(
                    f"dp_attention_local: num_blocks={config.num_blocks} "
                    f"must divide by dp*tp={self._n_local_shards}")
            if sched_cfg.max_seqs % self._n_local_shards:
                raise ValueError(
                    f"dp_attention_local: max_seqs={sched_cfg.max_seqs} "
                    f"must divide by dp*tp={self._n_local_shards}")
            # The fixed decode row grid: row == slot, so a request's rows
            # ride one shard for its whole life (JAX runs this many rows
            # every decode step, whatever the load).
            self._dp_rows = sched_cfg.bucket_for_decode(sched_cfg.max_seqs)
            if self._dp_rows % self._n_local_shards:
                raise ValueError(
                    f"dp_attention_local: decode bucket {self._dp_rows} "
                    f"must divide by dp*tp={self._n_local_shards}")
        # Every sharded engine runs on a DpGrid (tp alone: its one dp
        # row); `group` is its older name.
        self.grid: Optional[DpGrid] = None
        self._moe = cfg.is_moe
        self.moe_mode = resolve_moe_mode(
            cfg, self.mesh if self._meshed else None, config.moe_mode,
            self.device)
        if self._meshed:
            validate(cfg, self.mesh, config.dp_attention)
            check_plane(PlaneSpec(dp_attention=config.dp_attention,
                                  dp_local=self._dp_local, moe=cfg.is_moe),
                        self.mesh)
            if config.sp > 1:
                # The ring prefill's own row of the table (MoE,
                # dp-attention), before any rank is built.
                check_plane(PlaneSpec(role="sp_prefill", moe=cfg.is_moe,
                                      dp_attention=config.dp_attention),
                            self.mesh)
                if config.sp_devices is not None:
                    raise ValueError(
                        "sp_devices places the meshless ring's ranks; "
                        "with tp or dp the grid places every rank")
            self.grid = DpGrid.for_mesh(
                self.mesh, self.device, config.dp_attention, self._dp_local,
                fabric=self._fabric)
            if (config.dp == config.ep == config.sp == 1
                    and not config.dp_attention):
                logger.info("tp group: %d ranks on %s", config.tp,
                            self.grid.describe())
            else:
                logger.info("dp grid: %s (%s) ranks on %s",
                            self.mesh.describe(), self.grid.mode,
                            self.grid.describe())
        self.stages: Optional[PpStages] = None
        if config.pp > 1:
            # The capability table's refusals first, in JAX's order.
            check_plane(PlaneSpec(moe=cfg.is_moe,
                                  spec=config.speculative_tokens > 0),
                        self.mesh)
            validate(cfg, self.mesh)
            self.stages = PpStages.for_mesh(self.mesh, self.device,
                                            config.pp_microbatches)
            logger.info("pp stages: %d stages, %d microbatches, on %s",
                        config.pp, config.pp_microbatches,
                        self.stages.describe())
        # The steps' rank set: the grid, the pipeline's stages, or None.
        self.group = self.grid if self.grid is not None else self.stages
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            # A sharded engine's draws are cut into its ranks' slices (a
            # pipeline's go to their stages) as they come: the same
            # weights as the meshless engine's.
            params = init_params(cfg, gen, self.device, group=self.group,
                                 moe_mode=self.moe_mode)
        elif self.stages is not None:
            params = shard_stages(params, self.stages)
        elif self.grid is not None:
            # Each rank keeps a copy of its slice only, copied from where
            # the whole state lies (best the host: a card then never holds
            # the whole model beside its slices); dropping the whole state
            # is the caller's.
            params = shard_state(params, param_pspecs(
                cfg, self.moe_mode, dp_attention=config.dp_attention),
                self.grid)
        if self.grid is not None:
            self.cache = kvc.init_grid_caches(self.cache_cfg, self.grid)
        elif self.stages is not None:
            self.cache = init_pp_cache(self.cache_cfg, self.stages)
        else:
            self.cache = kvc.init_cache(self.cache_cfg, self.device)
        self.params = params
        # Per-chip divisors of the modeled bytes (JAX's engine): a stored
        # KV byte splits over kv_shard_count chips (tp's heads or slots;
        # dp-local's flat grid; plain dp replicates), and each chip's
        # attention reads its rows' context, so traffic divides by dp*tp.
        # A pp stage holds and reads its layers' slice for every row:
        # both divide by pp.  sp divides neither: its ranks hold the
        # same pieces and decode stays on sp index 0.
        self.kv_traffic_shards = config.dp * config.tp * config.pp
        self.kv_shard_count = (self.kv_traffic_shards if self._dp_local
                               else config.tp * config.pp)
        # Non-local dp-attention reads pages from any shard: the gather
        # path, as JAX's capability table sends it.
        self._use_kernel = not (config.dp_attention and not self._dp_local)
        self._step = make_forward_step(
            cfg, self.block_size, use_decode_kernel=self._use_kernel,
            moe_mode=self.moe_mode, with_expert_load=self._moe,
            tp=self.group)
        self._packed_step = make_packed_prefill_step(
            cfg, self.block_size, moe_mode=self.moe_mode, tp=self.group)
        # pp's fused greedy single step (the schedule, then the argmax on
        # stage 0's card) and its block ops; other meshes fuse the argmax
        # after their step.
        self._greedy_step = None
        if self.stages is not None:
            self._greedy_step = make_pp_greedy_step(
                cfg, self.block_size, self.stages, config.pp_microbatches,
                use_decode_kernel=self._use_kernel)
            self._pp_extract, self._pp_inject = make_pp_block_ops(
                self.block_size, self.stages, self.cache_cfg.quantized)
        self.ring: Optional[SpRing] = None
        self._sp_step = None
        if config.sp > 1:
            self._build_sp_step()
        # MoE expert load: the steps' [E+1] stats summed on the device,
        # folded into the host totals by snapshot_expert_load (the HTTP
        # thread may call it while the engine thread steps).
        self._load_dev: Optional[torch.Tensor] = None
        self._load_lock = threading.Lock()
        self.expert_load = (np.zeros((cfg.num_experts,), np.int64)
                            if self._moe else None)
        self.moe_dropped_tokens = 0
        self._window_fns: Dict[bool, object] = {}
        self._window_state: Optional[Dict] = None
        self._inflight: List[Dict] = []
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # Prefill first tokens sampled behind a window: their host copies
        # settle on a later step; until then the request sits out of
        # decode work.
        self._pending_first: set = set()
        self._pending_batches: List[tuple] = []
        self._kv_event_sink = kv_event_sink
        self._event_id = 0
        # Seal-progress callback (request id, sealed blocks), called on
        # the engine thread; InferenceEngine installs it.
        self.seal_sink: Optional[Callable[[str, int], None]] = None
        # Batch rows pad to a multiple of dp (dp*tp under dp_attention,
        # whose batch shards over both axes; times ep under dispatch,
        # whose tokens shard over dp x ep): the grid's decode buckets are
        # the scheduler's, padded so.  A packed prefill takes one group a
        # dp row (a rank under dp_attention), each row's total a multiple
        # of `_ep_split`.  pp's rows pad to a multiple of its microbatch
        # count and its packed prefill is one microbatch.
        self._pack_groups = (config.dp * (config.tp if config.dp_attention
                                          else 1)
                             if self.grid is not None else 1)
        self._ep_split = config.ep if self.moe_mode == "dispatch" else 1
        self._row_mult = (config.pp_microbatches if self.stages is not None
                          else self._pack_groups * self._ep_split)
        if self._dp_local:
            # Every decode step runs the whole fixed row grid.
            rows_per_shard = self._dp_rows // self._n_local_shards
            sched_cfg = dataclasses.replace(
                sched_cfg, decode_buckets=(self._dp_rows,),
                shard_of_slot=lambda s: s // rows_per_shard)
        elif self._row_mult > 1:
            m = self._row_mult
            sched_cfg = dataclasses.replace(
                sched_cfg, decode_buckets=tuple(sorted(
                    {-(-b // m) * m for b in sched_cfg.decode_buckets})))
        if config.enable_prefix_cache:
            self.allocator = ManagedBlockSource(
                TieredConfig(device_blocks=config.num_blocks,
                             host_blocks=config.host_blocks,
                             disk_blocks=config.disk_blocks,
                             block_size=self.block_size),
                on_removed=self._on_block_evicted,
                extract_fn=self._extract_pages,
                inject_fn=self._inject_pages,
                remote_fetch_fn=config.remote_fetch_fn,
                wire_shape=self.cache_cfg.block_wire_shape,
                wire_dtype=self.cache_cfg.block_wire_dtype,
                device=self.device)
        else:
            self.allocator = BlockAllocator(
                config.num_blocks, num_shards=self._n_local_shards)
        self.scheduler = Scheduler(sched_cfg, self.allocator)
        # QoS preemption: the scheduler picks victims, the engine executes
        # the preempt so seal bookkeeping resets and the victim's sealed
        # KV demotes down-tier.
        self.scheduler.qos_preempt_sink = self._qos_preempt
        self.qos_demoted_blocks = 0
        # Seal bookkeeping for the prefix cache: each request's chained
        # block hashes and how many of its blocks are registered.
        self._hash_seqs: Dict[str, TokenBlockSequence] = {}
        self._published_blocks: Dict[str, int] = {}
        self._pad_position = sched_cfg.max_pages_per_seq * self.block_size
        self._requests: Dict[str, Request] = {}
        # Seeds for unseeded stochastic rows (one per request).
        self._rng = np.random.default_rng(config.seed + 1)
        self._row_seeds: Dict[str, int] = {}
        # Serving-loop counters (runtime/metrics.py), the flight
        # recorder's first-dispatch breadcrumbs on their first-seen hook.
        self.counters = EngineStepCounters()
        self.step_count = 0
        # Flight recorder: step() stamps its heartbeat unconditionally
        # (the stall watchdog reads it); dispatch-shape and preemption
        # breadcrumbs record only while the process enabled the ring, and
        # every record site passes pre-computed scalars only.
        self.flight = flight_recorder.get_recorder()
        self.counters.on_recompile = self._flight_recompile
        # Device-truth plane: first-seen dispatch shapes record their
        # modeled cost (_harvest_program); on a card each window's span
        # on the stream is timed by CUDA events read at its sync.
        self.profiler = device_profiler.get_profiler()
        # Modeled KV bytes a decode step reads per context token, per chip.
        # (tp divides Hkv, so every rank's share is whole.)
        self._ctx_token_bytes = (self.cache_cfg.bytes_per_context_token
                                 // self.kv_traffic_shards)
        # First-token timings parked for the serving layer's ledger
        # stamps (request id -> scalars), behind the ledger's guard.
        self._ledger_timings: Dict[str, tuple] = {}
        self.metrics = ForwardPassMetrics(
            worker_stats=WorkerStats(request_total_slots=sched_cfg.max_seqs),
            kv_stats=KvStats(kv_total_blocks=config.num_blocks - 1),
            spec_decode_stats=(SpecDecodeStats()
                               if config.speculative_tokens > 0 else None))
        self._drafter: Drafter = (config.drafter if config.drafter is not None
                                  else NgramDrafter(config.speculative_ngram))
        # The embeddings step (built at first use).
        self._embed_step = None
        self._windows_since_prefill = 0
        self._mixed_duty = MIXED_PREFILL_DUTY
        self._mixed_ctl = MixedPrefillController()
        # Measured mixed-prefill cost: prefill tokens dispatched since the
        # last window dispatch (charged to the next window, whose sync
        # interval absorbs them), the last steady window sync's clock
        # (None across drains) and the cost samples already folded.
        self._prefill_cost_tokens = 0
        self._last_window_sync_ts: Optional[float] = None
        self._mixed_cost_seen = 0

    def lockstep_stats(self) -> Optional[dict]:
        """The `lockstep` block of `/debug/stats` (None in one process):
        the backend, this process's id and count, the flat ranks it
        owns, its collectives across processes and the leader's
        broadcasts by op."""
        if not self._mh:
            return None
        out = self._fabric.describe()
        out["owned_ranks"] = [f for f, m in enumerate(self.grid.mine) if m]
        if self._lockstep is not None:
            out["broadcasts"] = self._lockstep.broadcasts
            out["broadcasts_by_op"] = dict(self._lockstep.sent)
        return out

    @property
    def _meshed(self) -> bool:
        return self.config.dp * self.config.ep * self.config.tp > 1

    def _resolve_dp(self, config: EngineConfig) -> bool:
        """dp-attention locality, JAX's auto rule and its refusals."""
        local = config.dp_attention_local
        if local is None:
            local = (config.dp_attention and self._meshed
                     and not config.enable_prefix_cache)
        if local and not (self._meshed and config.dp_attention):
            raise ValueError("dp_attention_local needs a mesh with "
                             "dp_attention")
        if local and config.enable_prefix_cache:
            raise ValueError("dp_attention_local needs the plain "
                             "allocator (enable_prefix_cache=False); the "
                             "tiered source has no shard concept yet")
        if config.dp_attention and not self._meshed:
            check_plane(PlaneSpec(dp_attention=True))
        return bool(local)

    def _slot_perm(self, reqs: List[Request], bucket: int) -> np.ndarray:
        """dp-local's decode rows: row j of a compact batch (request j,
        then the pad rows) goes to row `perm[j]`, request j's slot, so its
        rows stay on its pages' shard for its whole life; the pad rows take
        the slots left."""
        slots = np.asarray([r.slot for r in reqs], np.int64)
        return np.concatenate([slots, np.setdiff1d(np.arange(bucket), slots)])

    @staticmethod
    def _to_slots(perm: np.ndarray, *rows):
        """Compact per-row arrays (or lists) laid out on `perm`'s rows."""
        out = []
        for a in rows:
            if isinstance(a, list):
                b = list(a)
                for j, p in enumerate(perm.tolist()):
                    b[p] = a[j]
            else:
                b = np.empty_like(a)
                b[perm] = a
            out.append(b)
        return out

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _build_sp_step(self) -> None:
        """The ring over `config.sp` ranks (on a grid: a ring a dp row
        and tp slice) and the whole-prompt prefill step on it; what the
        capability table rules out raises in `make_sp_prefill_step`."""
        config, cfg = self.config, self.config.model
        bad = [b for b in config.scheduler.prefill_buckets
               if b >= config.sp_prefill_threshold and b % config.sp]
        if bad:
            raise ValueError(f"sp={config.sp} must divide the prefill "
                             f"buckets the ring can see; {bad} do not")
        if self.grid is not None:
            # (dp row 0, tp slice 0)'s ring stands for all of them in the
            # stats; each attends its heads.
            self.ring = self.grid.rings[0][0]
            ring = self.grid
        else:
            self.ring = ring = SpRing.for_mesh(
                MeshConfig(sp=config.sp), self.device, config.sp_devices)
        # The kernel's ring; per dispatch the geometry rule decides
        # between it and the plain ring (llama._sp_ring_attention).
        self._sp_step = make_sp_prefill_step(
            cfg, self.block_size, ring,
            kv_quant=self.cache_cfg.quantized, use_kernel=True)
        if self.grid is not None:
            logger.info("sp prefill on the grid %s: %d rings of %d ranks, "
                        "ranks on %s", self.mesh.describe(),
                        config.dp * config.tp, config.sp,
                        self.grid.describe())
        else:
            logger.info("sp prefill ring: %d ranks on %s", self.ring.sp,
                        self.ring.describe())

    # -- request lifecycle ------------------------------------------------

    @engine_thread_only
    def add_request(self, request_id: str, prompt_tokens: List[int],
                    sampling: SamplingParams,
                    arrival_ts: Optional[float] = None,
                    priority: int = 1, prompt_embeds=None) -> None:
        """`arrival_ts`: when the request was submitted (monotonic; default
        now) — InferenceEngine passes its submission time, so the wait for
        the engine thread counts as queueing in the spans and the ledger.
        `prompt_embeds` ([n, hidden], n <= len(prompt_tokens)): embeddings
        that take prompt positions [0, n) in place of the token lookup
        (the multimodal path; those positions hold placeholder ids)."""
        if request_id in self._requests:
            raise ValueError(f"duplicate request id {request_id}")
        if not prompt_tokens:
            raise ValueError("empty prompt")
        vocab = self.config.model.vocab_size
        if any(not 0 <= int(t) < vocab for t in prompt_tokens):
            raise ValueError(f"prompt token outside the vocabulary [0, {vocab})")
        if prompt_embeds is not None:
            # pp and multihost refuse them, in the capability table's
            # words.
            check_plane(PlaneSpec(role="mm"), self.mesh, self._mh)
            prompt_embeds = np.asarray(prompt_embeds)
            if (prompt_embeds.ndim != 2
                    or prompt_embeds.shape[0] > len(prompt_tokens)
                    or prompt_embeds.shape[1]
                    != self.config.model.hidden_size):
                raise ValueError(
                    f"prompt_embeds shape {prompt_embeds.shape} must be "
                    f"[n <= {len(prompt_tokens)}, "
                    f"{self.config.model.hidden_size}]")
        if self._lockstep is not None:
            self._lockstep.broadcast({
                "op": "add", "rid": request_id,
                "prompt": [int(t) for t in prompt_tokens],
                "sampling": multihost.encode_sampling(sampling),
                "priority": int(priority)})
        req = Request(request_id=request_id,
                      prompt_tokens=list(prompt_tokens), sampling=sampling,
                      priority=int(priority), prompt_embeds=prompt_embeds)
        if prompt_embeds is not None:
            # Placeholder tokens must neither match nor seed the prefix
            # cache (different images share placeholder ids).
            req.block_hashes = ()
        if arrival_ts is not None:
            req.arrival_ts = arrival_ts
        self._requests[request_id] = req
        self.scheduler.add_request(req)

    @engine_thread_only
    def cancel(self, request_id: str) -> None:
        req = self._requests.get(request_id)
        if req and req.state is not RequestState.FINISHED:
            if self._lockstep is not None:
                self._lockstep.broadcast({"op": "cancel",
                                          "rid": request_id})
            self._finish(req, FinishReason.CANCELLED)

    @property
    def has_work(self) -> bool:
        """True while any request needs a step(), including finished ones
        whose terminal delta has not been collected yet."""
        return bool(self._requests)

    @property
    def has_pending_prefill(self) -> bool:
        """True while any request still owes prefill work (queued or
        mid-chunk): the "drain prefill before timing decode" loop that
        profilers need, without reaching into `_requests`."""
        return any(r.state in (RequestState.WAITING, RequestState.PREFILL)
                   for r in self._requests.values())

    # -- stepping ---------------------------------------------------------

    @engine_thread_only
    @hot_path
    def step(self) -> List[TokenDelta]:
        """Run one engine iteration; returns token deltas (may be empty).

        Steady decode runs through the pipelined window path: dispatch one
        K-token window, sync the window from `WINDOW_PIPELINE_DEPTH`
        dispatches ago.  A bounded prefill chunk dispatches behind every
        `duty`-th window; newly prefilled requests park until their first
        token's copy lands and merge into the window cohort in batches.
        Any change the windows cannot absorb drains the pipeline first."""
        self.flight.beat()  # stall-watchdog heartbeat: one float store
        if self._lockstep is not None:
            self._lockstep.broadcast({"op": "step"})
        deltas: List[TokenDelta] = []
        self._settle_first_tokens(deltas, block=False)
        self._plan_mixed_budget()
        plan = self.scheduler.plan()

        work = self._window_work(plan)
        if self._inflight and work is None:
            deltas.extend(self._drain_inflight())
            plan = self.scheduler.plan()
            work = self._window_work(plan)

        if work is not None:
            d = self._dispatch_window(work)
            if d is None:
                # Capacity refused under lookahead: drain and take the
                # single-step path this iteration (it preempts properly).
                deltas.extend(self._drain_inflight())
                plan = self.scheduler.plan()
                work = None
            else:
                deltas.extend(d)
                self._windows_since_prefill += 1
                if (plan.prefill and self._windows_since_prefill
                        >= self._mixed_duty):
                    self._windows_since_prefill = 0
                    # Multihost settles first tokens at once: a copy's
                    # readiness is per process, and the plan must derive
                    # from replicated state alone.
                    deltas.extend(self._run_prefill_batch(
                        plan.prefill, async_first=not self._mh))
        if work is None and not plan.empty:
            # Settle pending first tokens before single-step decode reads
            # output_tokens; settling can finish requests, so replan.
            if self._pending_batches:
                self._settle_first_tokens(deltas, block=True)
                plan = self.scheduler.plan()
            if plan.prefill:
                deltas.extend(self._run_prefill_batch(plan.prefill))
            if plan.decode:
                d = (self._run_decode_spec(plan.decode)
                     if self._spec_eligible(plan) else None)
                if d is None:
                    d = self._run_decode(plan.decode)
                deltas.extend(d)

        self._collect_dead(deltas)
        self.step_count += 1
        if self.flight.enabled and self.step_count % 64 == 0:
            # Periodic cumulative-counter breadcrumb: consecutive events
            # give a postmortem reader per-interval deltas.
            self._flight_counters()
        self._refresh_metrics()
        return deltas

    def _flight_recompile(self, key) -> None:
        """EngineStepCounters first-seen-shape hook: the dispatch may
        build a kernel library or meet a shape's first allocation — leave
        a breadcrumb naming the program and shape.  The compile stamp
        runs regardless of recording: the stall watchdog widens its
        threshold while a step is legitimately stuck in a first use."""
        self.flight.note_compile()
        if self.flight.enabled:
            self.flight.record("recompile", tag=str(key[0]),
                               sig=repr(key[1:]))

    def _harvest_program(self, first_seen: bool, tag: str, sig: tuple, *,
                         steps: int, tokens: int, kv_tokens: int) -> None:
        """Feed the device profiler's registry on a first-seen shape
        (note_dispatch returned True) with the modeled cost of one
        dispatch of it; one branch on every warm dispatch."""
        if first_seen and self.profiler.enabled:
            flops, nbytes = device_profiler.modeled_step_cost(
                self.config.model, steps=steps, tokens=tokens,
                kv_tokens=kv_tokens,
                kv_bytes_per_token=self._ctx_token_bytes,
                shards=self.config.tp * self.config.pp)
            self.profiler.harvest(tag, sig, flops, nbytes)

    @hot_path
    def _flight_counters(self) -> None:
        """Cumulative EngineStepCounters breadcrumb (pre-computed host
        ints only); the dump reader diffs consecutive events."""
        c = self.counters
        self.flight.record(
            "counters", step=self.step_count,
            host_syncs=c.host_syncs, recompiles=c.xla_cache_misses,
            windows=c.window_dispatches,
            singles=c.single_step_dispatches,
            prefills=c.prefill_dispatches, spec=c.spec_dispatches,
            uploads=c.h2d_uploads)

    def _plan_mixed_budget(self) -> None:
        """This step's (duty, chunk budget) from the controller, after
        folding in a new measured cost sample, once per sample (the ratio
        only moves at window syncs; folding it every step would weigh it
        at nearly full weight)."""
        samples = self.counters.prefill_cost_samples
        # Multihost keeps the static prior: a measured cost is per
        # process, and folding it in would part the processes' plans.
        if not self._mh and samples != self._mixed_cost_seen:
            self._mixed_cost_seen = samples
            measured = self.counters.measured_prefill_cost_ratio
            if measured is not None:
                self._mixed_ctl.observe_cost_ratio(measured)
        decoding = sum(1 for r in self.scheduler.running
                       if r.state is RequestState.DECODE)
        backlog = sum(len(r.prompt_tokens) - r.prefilled
                      for r in self.scheduler.running
                      if r.state is RequestState.PREFILL)
        backlog += sum(len(r.prompt_tokens) for r in self.scheduler.waiting)
        if not decoding or not backlog:
            self.scheduler.mixed_budget_override = None
            self._mixed_duty = MIXED_PREFILL_DUTY
            return
        want = min(backlog, self.scheduler.config.max_prefill_chunk)
        self._mixed_duty, chunk = self._mixed_ctl.plan(
            decoding, DECODE_WINDOW, want)
        self.scheduler.mixed_budget_override = chunk

    def _window_work(self, plan) -> Optional[DecodeWork]:
        """Decode work for the window path, or None when the engine must
        leave (or drain) window mode.  The cohort is the request set of
        the in-flight windows; requests ready mid-flight merge in batches
        (each merge costs a pipeline drain)."""
        if not self._window_eligible(plan):
            return None
        reqs = [r for r in plan.decode.requests
                if r.request_id not in self._pending_first]
        if not reqs:
            return None
        if self._inflight:
            by_id = {r.request_id: r for r in reqs}
            rids = self._inflight[-1]["rids"]
            cohort = [by_id[rid] for rid in rids if rid in by_id]
            if len(cohort) != len(rids):
                return None  # a cohort member left: drain, then remerge
            ready = len(reqs) - len(cohort)
            if ready and (ready >= max(1, len(cohort) // 4)
                          or not self._has_prefill_backlog()):
                return None
        else:
            cohort = reqs
        if len(cohort) == len(plan.decode.requests):
            return plan.decode
        bs = self.block_size
        return DecodeWork(
            requests=cohort,
            bucket=self.scheduler.config.bucket_for_decode(len(cohort)),
            pages=self.scheduler.config.bucket_for_pages(max(
                (r.context_len + bs - 1) // bs for r in cohort)),
        )

    def _has_prefill_backlog(self) -> bool:
        return bool(self.scheduler.waiting) or any(
            r.state is RequestState.PREFILL for r in self.scheduler.running)

    def _settle_first_tokens(self, deltas: List[TokenDelta],
                             block: bool) -> None:
        if not self._pending_batches:
            return
        remaining = []
        for copies, reqs in self._pending_batches:
            if not all(c.done() for c in copies if c is not None):
                if not block:
                    remaining.append((copies, reqs))
                    continue
                self.counters.host_syncs += 1
            toks = copies[0].result()
            lps = copies[1].result() if copies[1] is not None else None
            for j, req in enumerate(reqs):
                self._pending_first.discard(req.request_id)
                if (req.request_id not in self._requests
                        or req.state is not RequestState.DECODE):
                    continue  # finished/cancelled while in flight
                self._publish_completed_blocks(req)
                deltas.append(self._append_token(
                    req, int(toks[j]),
                    float(lps[j]) if lps is not None else None))
        self._pending_batches = remaining

    def _window_eligible(self, plan) -> bool:
        # Speculative decode, when configured, takes the place of windows.
        if plan.decode is None or self.config.speculative_tokens > 0:
            return False
        # Logprob rows take the single-step path.
        if any(r.sampling.logprobs for r in plan.decode.requests):
            return False
        # End-of-life guard: a window mostly past every request's budget
        # would be discarded tokens; the single step is cheaper then.
        lookahead = len(self._inflight) * DECODE_WINDOW
        return any(
            (r.sampling.max_tokens - r.prior_output - len(r.output_tokens)
             - lookahead) > DECODE_WINDOW // 2
            for r in plan.decode.requests)

    def _refresh_metrics(self) -> None:
        """Host counts only; the MoE expert load is read on demand
        (`InferenceEngine.metrics`), so this adds no device sync."""
        ws = self.metrics.worker_stats
        ws.request_active_slots = len(self.scheduler.running)
        ws.num_requests_waiting = len(self.scheduler.waiting)
        ks = self.metrics.kv_stats
        ks.kv_active_blocks = (self.allocator.num_blocks - 1
                               - self.allocator.free_blocks)
        ks.gpu_cache_usage_perc = self.allocator.usage
        # Fraction of admitted prompt tokens whose prefill the prefix
        # cache skipped, from the scheduler's admission-time matches.
        matched = self.scheduler.prefix_hit_tokens
        total = matched + self.scheduler.prefix_miss_tokens
        ks.gpu_prefix_cache_hit_rate = matched / total if total else 0.0

    def _collect_dead(self, deltas: List[TokenDelta]) -> None:
        for rid, req in list(self._requests.items()):
            if req.state is RequestState.FINISHED and req.finish_reason is not None:
                deltas.append(TokenDelta(
                    request_id=rid, token_ids=[], finished=True,
                    finish_reason=req.finish_reason))
                self._drop(req)

    # -- sequence-parallel whole-prompt prefill -----------------------------

    def _sp_eligible(self, batch: PrefillBatch) -> bool:
        """The ring prefill takes FULL prompts (it reads no cached
        context): every item a whole prompt at or past the threshold."""
        if self._sp_step is None:
            return False
        thr = self.config.sp_prefill_threshold
        return all(
            w.start == 0 and w.length == len(w.request.prompt_tokens)
            and w.length >= thr and w.request.prompt_embeds is None
            for w in batch.items)

    def _run_prefill_batch(self, batch: PrefillBatch,
                           async_first: bool = False) -> List[TokenDelta]:
        """All scheduled prefill chunks: the packed plane, unless the
        batch is sp-eligible; then ONE padded [R, T] step over the ring
        (ragged rows padded to the chunk bucket and R to a multiple of dp,
        pad rows and tails write the null block)."""
        if not self._sp_eligible(batch):
            return self._run_packed_prefill(batch, async_first)
        sched = self.scheduler.config
        bs = self.block_size
        items = batch.items
        R = sched.bucket_for_decode(len(items))
        R = -(-R // self._row_mult) * self._row_mult
        T = sched.bucket_for_prefill(max(w.length for w in items))
        P = sched.bucket_for_pages(max(
            (w.length + bs - 1) // bs for w in items))
        tokens = np.zeros((R, T), np.int32)
        positions = np.full((R, T), self._pad_position, np.int32)
        seq_lens = np.zeros((R,), np.int32)
        bts = np.zeros((R, P), np.int32)
        sample_pos = np.zeros((R,), np.int32)
        for i, work in enumerate(items):
            req = work.request
            L = work.length
            tokens[i, :L] = req.prompt_tokens[:L]
            positions[i, :L] = np.arange(L)
            seq_lens[i] = L
            sample_pos[i] = L - 1
            n = min(len(req.pages), P)
            bts[i, :n] = req.pages[:n]
        c = self.counters
        c.prefill_dispatches += 1
        c.model_rows += R * T
        self._prefill_cost_tokens += sum(w.length for w in items)
        fl = self.flight
        if fl.enabled:
            fl.record("prefill", rows=R, chunk=T, pages=P)
        # JAX's padded-prefill signature: (rows, chunk, pages, multimodal,
        # sp-eligible); only the sp batch takes this plane here.
        sig = (R, T, P, False, True)
        first = c.note_dispatch("prefill", *sig)
        c.sp_prefill_dispatches += 1
        c.sp_prefill_count += len(items)
        sp = self.config.sp
        c.note_ring_exchange(
            sum(w.length for w in items)
            * self.cache_cfg.ring_payload_bytes_per_token * (sp - 1) // sp)
        self._harvest_program(first, "prefill", sig, steps=1, tokens=R * T,
                              kv_tokens=R * P * bs)
        # The rank's heads: a tp rank's ring carries its slice only.
        cfg, tp = self.config.model, self.config.tp
        if ring_kernel_supported(
                cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim,
                T // sp, self.device, cfg.dtype):
            c.ring_kernel_prefills += len(items)
        logits, self.cache = self._sp_step(
            self.params, self.cache, self._dev(tokens), self._dev(positions),
            self._dev(seq_lens), self._dev(bts), self._dev(sample_pos))
        return self._finish_prefill_items(items, logits, async_first)

    # -- packed ragged prefill ---------------------------------------------

    def _run_packed_prefill(self, batch: PrefillBatch,
                            async_first: bool = False) -> List[TokenDelta]:
        """The scheduler's chunks pack into flat [T] dispatches (each
        sized to the packed token budget with PACK_ALIGN'd segment
        starts), each one call of the packed step."""
        sched = self.scheduler.config
        deltas: List[TokenDelta] = []
        if self._pack_groups * self._ep_split > 1:
            for groups in self._grid_packs(batch.items):
                deltas.extend(self._dispatch_grid_prefill(groups,
                                                          async_first))
            return deltas
        for items in pack_prefill_chunks(
                batch.items, sched.packed_prefill_budget(),
                PACKED_PREFILL_SEGMENTS, align=PACK_ALIGN):
            deltas.extend(self._dispatch_packed_prefill(items, async_first))
        return deltas

    def _dispatch_packed_prefill(self, items,
                                 async_first: bool) -> List[TokenDelta]:
        sched = self.scheduler.config
        bs = self.block_size
        aligned = sum(-(-w.length // PACK_ALIGN) * PACK_ALIGN for w in items)
        T = sched.bucket_for_packed(aligned)
        P = sched.bucket_for_pages(max(
            (w.start + w.length + bs - 1) // bs for w in items))
        logits = self._packed_call(items, T, P,
                                   self._pack_items(items, T, P))
        return self._finish_prefill_items(items, logits, async_first)

    def _pack_items(self, items, T: int, P: int) -> Dict[str, np.ndarray]:
        """The packed step's host arrays for `items` over T tokens and
        PACKED_PREFILL_SEGMENTS segment rows (PACK_ALIGN'd starts)."""
        R = PACKED_PREFILL_SEGMENTS
        tokens = np.zeros((T,), np.int32)
        positions = np.full((T,), self._pad_position, np.int32)
        seg_ids = np.zeros((T,), np.int32)
        bts = np.zeros((R, P), np.int32)
        q_starts = np.zeros((R,), np.int32)
        q_lens = np.zeros((R,), np.int32)
        seq_lens = np.zeros((R,), np.int32)
        sample_pos = np.zeros((R,), np.int32)
        # Multimodal rows: chunk positions inside a request's embedding
        # span take its embeddings in place of the token lookup.
        embeds = mask = None
        if any(w.request.prompt_embeds is not None for w in items):
            embeds = np.zeros((T, self.config.model.hidden_size), np.float32)
            mask = np.zeros((T,), bool)
        off = 0
        for i, work in enumerate(items):
            req = work.request
            L = work.length
            pe = req.prompt_embeds
            if pe is not None:
                hi = min(work.start + L, pe.shape[0])
                if hi > work.start:
                    embeds[off: off + hi - work.start] = pe[work.start:hi]
                    mask[off: off + hi - work.start] = True
            tokens[off: off + L] = req.prompt_tokens[work.start: work.start + L]
            positions[off: off + L] = np.arange(work.start, work.start + L)
            seg_ids[off: off + L] = i
            q_starts[i] = off
            q_lens[i] = L
            seq_lens[i] = work.start + L
            sample_pos[i] = off + L - 1
            n = min(len(req.pages), P)
            bts[i, :n] = req.pages[:n]
            off += -(-L // PACK_ALIGN) * PACK_ALIGN
        return {"tokens": tokens, "positions": positions, "seg_ids": seg_ids,
                "bts": bts, "q_starts": q_starts, "q_lens": q_lens,
                "seq_lens": seq_lens, "sample_pos": sample_pos,
                "embeds": embeds, "mask": mask}

    def _packed_call(self, items, T: int, P: int,
                     a: Dict[str, np.ndarray]) -> torch.Tensor:
        """One call of the packed step on `_pack_items`' arrays: the
        segment rows' logits."""
        bs = self.block_size
        R = a["bts"].shape[0]
        c = self.counters
        c.prefill_dispatches += 1
        c.packed_prefill_dispatches += 1
        c.model_rows += T
        first = c.note_dispatch("prefill_packed", T, R, P)
        fl = self.flight
        if fl.enabled:
            fl.record("prefill_packed", tokens=T, segs=R, pages=P)
        self._prefill_cost_tokens += sum(w.length for w in items)
        self._harvest_program(first, "prefill_packed", (T, R, P), steps=1,
                              tokens=T, kv_tokens=R * P * bs)
        mm = {}
        if a["embeds"] is not None:
            mm = {"input_embeds": self._dev(a["embeds"]),
                  "embed_mask": self._dev(a["mask"])}
        logits, self.cache = self._take_load(self._packed_step(
            self.params, self.cache, self._dev(a["tokens"]),
            self._dev(a["positions"]), self._dev(a["seg_ids"]),
            self._dev(a["bts"]), self._dev(a["q_starts"]),
            self._dev(a["q_lens"]), self._dev(a["seq_lens"]),
            self._dev(a["sample_pos"]), **mm))
        return logits

    def _grid_packs(self, items) -> List[List[list]]:
        """Grid-shaped packs: each a list of one item group per dp row
        (per rank under dp-attention), each group at most one packed
        budget and PACKED_PREFILL_SEGMENTS chunks.  dp-local puts a chunk
        in its request's locality shard, the other modes in the least
        loaded group."""
        n = self._pack_groups
        budget = self.scheduler.config.packed_prefill_budget()
        packs: List[List[list]] = []
        cur: List[list] = [[] for _ in range(n)]
        load = [0] * n

        def fits(g, need):
            return (len(cur[g]) < PACKED_PREFILL_SEGMENTS
                    and (not cur[g] or load[g] + need <= budget))

        for w in items:
            need = -(-w.length // PACK_ALIGN) * PACK_ALIGN
            g = (w.request.locality_shard if self._dp_local
                 else min(range(n), key=lambda k: load[k]))
            if not fits(g, need):
                packs.append(cur)
                cur, load = [[] for _ in range(n)], [0] * n
                if not self._dp_local:
                    g = 0
            cur[g].append(w)
            load[g] += need
        if any(cur):
            packs.append(cur)
        return packs

    def _dispatch_grid_prefill(self, groups,
                               async_first: bool) -> List[TokenDelta]:
        """One grid-shaped packed prefill: group g (a dp row's, a rank's
        under dp-attention) packed by `_pack_items` into its own equal
        token range and segment rows, the groups end to end."""
        sched = self.scheduler.config
        bs = self.block_size
        Rg = PACKED_PREFILL_SEGMENTS
        items = [w for g in groups for w in g]
        Tg = sched.bucket_for_packed(max(
            sum(-(-w.length // PACK_ALIGN) * PACK_ALIGN for w in g)
            for g in groups))
        # Under dispatch a dp row's tokens split over its ep ranks.
        per_row = self._pack_groups // self.config.dp
        while (Tg * per_row) % self._ep_split:
            Tg += PACK_ALIGN
        P = sched.bucket_for_pages(max(
            (w.start + w.length + bs - 1) // bs for w in items))
        parts = [self._pack_items(g, Tg, P) for g in groups]
        for g, a in enumerate(parts):
            a["seg_ids"] += g * Rg
            for k in ("q_starts", "sample_pos"):
                a[k] += g * Tg
        a = {k: (None if all(p[k] is None for p in parts)
                 else np.concatenate([self._pack_part(p, k, Tg)
                                      for p in parts]))
             for k in parts[0]}
        logits = self._packed_call(items, Tg * len(groups), P, a)
        rows = [g * Rg + j for g, grp in enumerate(groups)
                for j in range(len(grp))]
        return self._finish_prefill_items(
            items, logits[torch.tensor(rows, device=logits.device)],
            async_first)

    def _pack_part(self, part: Dict, key: str, T: int) -> np.ndarray:
        """A group's array `key`, a multimodal pair filled in for a group
        with no embeddings."""
        if part[key] is not None:
            return part[key]
        if key == "embeds":
            return np.zeros((T, self.config.model.hidden_size), np.float32)
        return np.zeros((T,), bool)

    def _finish_prefill_items(self, items, logits,
                              async_first: bool) -> List[TokenDelta]:
        """Advance scheduler state and sample first tokens for rows whose
        prompt completed (row i of `logits` belongs to items[i])."""
        deltas: List[TokenDelta] = []
        done_rows: List[int] = []
        for i, work in enumerate(items):
            self.scheduler.prefill_done(work)
            self._publish_completed_blocks(work.request)
            if work.request.state is RequestState.DECODE:
                done_rows.append(i)
        if not done_rows:
            return deltas
        sel = logits[torch.tensor(done_rows, device=logits.device)]
        reqs = [items[i].request for i in done_rows]
        toks, lps = self._sample_rows(sel, reqs)
        copies = (_HostCopy(toks, self._copy_stream, self._fabric),
                  _HostCopy(lps, self._copy_stream, self._fabric)
                  if lps is not None else None)
        if async_first:
            for req in reqs:
                self._pending_first.add(req.request_id)
            self._pending_batches.append((copies, reqs))
            return deltas
        self.counters.host_syncs += 1
        sampled = copies[0].result()
        lp_host = copies[1].result() if copies[1] is not None else None
        for j, req in enumerate(reqs):
            deltas.append(self._append_token(
                req, int(sampled[j]),
                float(lp_host[j]) if lp_host is not None else None))
        return deltas

    # -- single-step decode ------------------------------------------------

    def _run_decode(self, work: DecodeWork) -> List[TokenDelta]:
        reqs = work.requests
        bucket = work.bucket
        tokens = np.zeros((bucket, 1), np.int32)
        positions = np.full((bucket, 1), self._pad_position, np.int32)
        seq_lens = np.zeros((bucket,), np.int32)
        bts = np.zeros((bucket, work.pages), np.int32)
        live: List[Request] = []
        for req in reqs:
            # The fed token is the last sampled one; its KV lands at
            # position context_len - 1 and the context becomes context_len.
            ctx = req.context_len
            if not self.scheduler.ensure_capacity(req, ctx):
                self._preempt_or_finish(req)
                continue
            i = len(live)
            tokens[i, 0] = (req.output_tokens[-1] if req.output_tokens
                            else req.prompt_tokens[-1])
            positions[i, 0] = ctx - 1
            seq_lens[i] = ctx
            n = min(len(req.pages), work.pages)
            bts[i, :n] = req.pages[:n]
            live.append(req)
        if not live:
            return []
        perm = None
        if self._dp_local:
            perm = self._slot_perm(live, bucket)
            tokens, positions, seq_lens, bts = self._to_slots(
                perm, tokens, positions, seq_lens, bts)
        c = self.counters
        c.single_step_dispatches += 1
        c.model_rows += bucket
        fl = self.flight
        if fl.enabled:
            fl.record("decode1", bucket=bucket, pages=work.pages)
        # Modeled KV bytes: this step's attention reads each live row's
        # whole context once.
        c.note_kv_read(sum(r.context_len for r in live)
                       * self._ctx_token_bytes, len(live))
        fused = (all(r.sampling.temperature <= 0 for r in live)
                 and not any(r.sampling.logprobs for r in live))
        tag = "decode1g" if fused else "decode1"
        first = c.note_dispatch(tag, bucket, work.pages)
        self._harvest_program(first, tag, (bucket, work.pages), steps=1,
                              tokens=bucket,
                              kv_tokens=bucket * work.pages * self.block_size)
        zeros = torch.zeros((bucket,), dtype=torch.int32, device=self.device)
        args = (self.params, self.cache, self._dev(tokens),
                self._dev(positions), self._dev(seq_lens), self._dev(bts),
                zeros)
        lps_dev = None
        if fused and self._greedy_step is not None:
            # pp's fused greedy step (parallel/pipeline.py).
            toks_dev, self.cache = self._greedy_step(*args)
        else:
            logits, self.cache = self._take_load(self._step(*args))
            if perm is not None:
                logits = logits[torch.from_numpy(perm).to(logits.device)]
            if fused:
                # Fused greedy step: argmax on the device, one [bucket] copy.
                toks_dev = greedy_sample(logits)
            else:
                toks_dev, lps_dev = self._sample_rows(logits[: len(live)],
                                                      live)
        self.counters.host_syncs += 1
        sampled = multihost.fetch(toks_dev, self._fabric)
        lps = (multihost.fetch(lps_dev, self._fabric)
               if lps_dev is not None else None)
        deltas = []
        for i, req in enumerate(live):
            # Blocks sealed by earlier tokens publish before this token
            # appends (it may finish the request and drop its state).
            self._publish_completed_blocks(req)
            deltas.append(self._append_token(
                req, int(sampled[i]),
                float(lps[i]) if lps is not None else None))
        return deltas

    # -- speculative decode -------------------------------------------------

    def _spec_eligible(self, plan) -> bool:
        """Spec decode takes a decode-only plan with nobody waiting.  Rows
        asking for logprobs take the plain step (the verify does not
        carry them), and so do seeded stochastic rows: their stream
        depends only on (seed, token index), which a burst accepted
        jointly cannot keep."""
        return (self.config.speculative_tokens > 0
                and plan.decode is not None
                and plan.prefill is None
                and not self.scheduler.waiting
                and all(not r.sampling.logprobs
                        and not (r.sampling.temperature > 0
                                 and r.sampling.seed is not None)
                        for r in plan.decode.requests))

    def _run_decode_spec(self, work: DecodeWork) -> Optional[List[TokenDelta]]:
        """One speculative step: feed [last, d_0 .. d_{K-1}] as a T = K+1
        chunk (the gathered-context path), take logits at every position
        and emit what speculative_verify accepts: up to K+1 tokens a row
        for one forward and one host sync.

        Every fed token's KV is written (seq_len = ctx + K); a rejected
        draft's row sits at a position the request's next fed token
        overwrites before anything attends to it, since contexts only
        grow and attention masks positions at or past seq_len.

        None when capacity cannot cover ctx + T (the plain step then
        preempts properly) or no row drafted (a K+1-wide forward for about
        one token a row loses to the plain step)."""
        K = self.config.speculative_tokens
        T = K + 1
        reqs = work.requests
        bucket = work.bucket
        vocab = self.config.model.vocab_size
        drafts: List[List[int]] = []
        draft_lens: List[int] = []   # tokens the drafter really proposed
        for req in reqs:
            if not self.scheduler.ensure_capacity(req, req.context_len + T):
                return None
            hist = req.prompt_tokens[: req.prefilled] + req.output_tokens
            d: List[int] = []
            for t in self._drafter.propose(hist, K)[:K]:
                # A drafter is untrusted: an id outside the vocabulary
                # would be clamped in the gathers and could be streamed;
                # cut the draft at it (what follows is conditioned on it).
                if not 0 <= int(t) < vocab:
                    break
                d.append(int(t))
            draft_lens.append(len(d))
            drafts.append((d + [0] * K)[:K])
        if not any(draft_lens):
            return None

        bs = self.block_size
        width = self.scheduler.config.bucket_for_pages(
            max((r.context_len + T + bs - 1) // bs for r in reqs))
        tokens = np.zeros((bucket, T), np.int32)
        positions = np.full((bucket, T), self._pad_position, np.int32)
        seq_lens = np.zeros((bucket,), np.int32)
        bts = np.zeros((bucket, width), np.int32)
        temp = np.zeros((bucket,), np.float32)
        top_k = np.zeros((bucket,), np.int32)
        top_p = np.ones((bucket,), np.float32)
        draft_arr = np.zeros((bucket, K), np.int32)
        seeds: List[Optional[int]] = [None] * bucket
        indices = [0] * bucket
        for i, req in enumerate(reqs):
            ctx = req.context_len
            last = (req.output_tokens[-1] if req.output_tokens
                    else req.prompt_tokens[-1])
            tokens[i] = [last] + drafts[i]
            positions[i] = np.arange(ctx - 1, ctx - 1 + T)
            seq_lens[i] = ctx + K
            n = min(len(req.pages), width)
            bts[i, :n] = req.pages[:n]
            temp[i] = req.sampling.temperature
            top_k[i] = req.sampling.top_k
            top_p[i] = req.sampling.top_p
            draft_arr[i] = drafts[i]
            if req.sampling.temperature > 0:
                seeds[i] = self._row_seed(req)
                indices[i] = self._draw_index(req)
        perm = None
        if self._dp_local:
            # The forward runs on the slots' rows; the verify reads the
            # logits back in request order.
            perm = self._slot_perm(reqs, bucket)
            tokens, positions, seq_lens, bts = self._to_slots(
                perm, tokens, positions, seq_lens, bts)
        c = self.counters
        first = c.note_dispatch("spec", bucket, T, width)
        c.spec_dispatches += 1
        c.model_rows += bucket * T
        fl = self.flight
        if fl.enabled:
            fl.record("spec", bucket=bucket, chunk=T, width=width)
        # One sweep of each row's KV serves up to T emitted tokens (the
        # tokens are tallied below, from what reaches the stream).
        c.note_kv_read(sum(r.context_len + K for r in reqs)
                       * self._ctx_token_bytes, 0)
        self._harvest_program(first, "spec", (bucket, T, width), steps=1,
                              tokens=bucket * T,
                              kv_tokens=bucket * width * self.block_size)
        logits, self.cache = self._take_load(self._step(
            self.params, self.cache, self._dev(tokens), self._dev(positions),
            self._dev(seq_lens), self._dev(bts), None))
        if perm is not None:
            logits = logits[torch.from_numpy(perm).to(logits.device)]
        emitted_dev, n_emit_dev = speculative_verify(
            logits, self._dev(draft_arr), self._dev(temp), self._dev(top_k),
            self._dev(top_p), seeds, indices,
            greedy_only=all(r.sampling.temperature <= 0 for r in reqs))
        c.host_syncs += 1
        both = torch.cat([emitted_dev, n_emit_dev[:, None]], 1).cpu().numpy()
        emitted, n_emit = both[:, :T], both[:, T]

        deltas: List[TokenDelta] = []
        stats = self.metrics.spec_decode_stats
        for i, req in enumerate(reqs):
            n = int(n_emit[i])
            appended = 0
            for tok in emitted[i, :n]:
                if req.request_id not in self._requests:
                    break  # finished mid-burst (stop token / max_tokens)
                self._publish_completed_blocks(req)
                deltas.append(self._append_token(req, int(tok)))
                appended += 1
            c.note_kv_read(0, appended)
            # Counted as JAX counts them: what reached the stream, over
            # the tokens the drafter really proposed.
            if draft_lens[i] and stats is not None:
                stats.num_spec_tokens += draft_lens[i]
                stats.num_drafts += draft_lens[i]
                used = min(n - 1, appended, draft_lens[i])
                stats.num_accepted_tokens += used
                per_pos = stats.num_accepted_tokens_per_pos
                while len(per_pos) < K:
                    per_pos.append(0)
                for j in range(used):
                    per_pos[j] += 1
        return deltas

    # -- pipelined decode windows ------------------------------------------

    def _window_fn(self, greedy_only: bool):
        fn = self._window_fns.get(greedy_only)
        if fn is None:
            fn = self._window_fns[greedy_only] = make_decode_window(
                self.config.model, self.block_size, DECODE_WINDOW,
                use_decode_kernel=self._use_kernel, greedy_only=greedy_only,
                moe_mode=self.moe_mode, with_expert_load=self._moe,
                tp=self.group)
        return fn

    def _dispatch_window(self, work: DecodeWork) -> Optional[List[TokenDelta]]:
        """Dispatch one K-token window (no host sync); sync and emit the
        window from pipeline_depth dispatches ago.  None if page capacity
        cannot cover the lookahead.  Per-row state stays on the device
        across windows and is rebuilt only when the request set (or a
        row's pages) changes."""
        K = DECODE_WINDOW
        reqs = work.requests
        bucket = work.bucket
        rows = list(range(len(reqs)))
        perm = None
        if self._dp_local:
            # The window's rows are the requests' slots (the device feeds
            # each row's token back on its row).
            perm = self._slot_perm(reqs, bucket)
            rows = perm[:len(reqs)].tolist()
        lag = len(self._inflight)  # windows dispatched but unsynced

        # Host bookkeeping lags the device by lag * K tokens.
        shadows = []
        for req in reqs:
            shadow = req.context_len + lag * K
            if not self.scheduler.ensure_capacity(req, shadow + K):
                return None
            shadows.append(shadow)

        bs = self.block_size
        width = self.scheduler.config.bucket_for_pages(
            max((s + K + bs - 1) // bs for s in shadows))
        greedy_only = all(r.sampling.temperature <= 0 for r in reqs)
        sig = (tuple(r.request_id for r in reqs), bucket, width, greedy_only,
               tuple((r.sampling.temperature, r.sampling.top_k,
                      r.sampling.top_p, r.sampling.seed) for r in reqs))
        want_pos = np.asarray([s - 1 for s in shadows], np.int32)
        st = self._window_state
        if (st is None or st["sig"] != sig
                or not np.array_equal(st["pos_host"][rows], want_pos)):
            st = self._build_window_state(reqs, bucket, width, shadows, lag,
                                          K, sig, perm)
            self.counters.h2d_uploads += 1
        pages_sig = tuple(len(r.pages) for r in reqs)
        if st["pages_sig"] != pages_sig:
            bts = np.zeros((bucket, width), np.int32)
            for i, req in enumerate(reqs):
                n = min(len(req.pages), width)
                bts[i, :n] = req.pages[:n]
            if perm is not None:
                bts, = self._to_slots(perm, bts)
            st["bts"] = self._dev(bts)
            st["pages_sig"] = pages_sig
            self.counters.h2d_uploads += 1
        self._window_state = st
        c = self.counters
        c.window_dispatches += 1
        c.model_rows += bucket * K
        first = c.note_dispatch("window", greedy_only, bucket, width)
        fl = self.flight
        if fl.enabled:
            # The one ring write a window dispatch makes.
            fl.record("window", bucket=bucket, width=width, lag=lag)
        # Modeled KV bytes: window step i of K reads context shadow + i a
        # row; the tokens are tallied at the sync, from what reaches the
        # stream (a finished row's discarded tail is not emitted).
        c.note_kv_read(sum(sh * K + K * (K - 1) // 2 for sh in shadows)
                       * self._ctx_token_bytes, 0)
        self._harvest_program(first, "window", (greedy_only, bucket, width),
                              steps=K, tokens=bucket,
                              kv_tokens=bucket * width * bs)
        # The window's span on its stream, read at its sync (no sync of
        # its own): the measured side of the device profiler's
        # window_time series.
        span = None
        if self.profiler.enabled and self.device.type == "cuda":
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()

        if lag:
            last_tokens = self._inflight[-1]["out"][K - 1]  # on device
        else:
            toks = np.zeros((bucket,), np.int32)
            for i, req in enumerate(reqs):
                toks[i] = (req.output_tokens[-1] if req.output_tokens
                           else req.prompt_tokens[-1])
            if perm is not None:
                toks, = self._to_slots(perm, toks)
            last_tokens = self._dev(toks)

        (self.cache, out, st["pos"], st["seq"], st["off"]) = self._take_load(
            self._window_fn(greedy_only)(
                self.params, self.cache, last_tokens, st["pos"], st["seq"],
                st["bts"], st["temp"], st["topk"], st["topp"], st["seeds"],
                st["off"]))
        st["pos_host"][rows] += K
        if span is not None:
            span[1].record()
        self._inflight.append({
            "rids": [r.request_id for r in reqs],
            "reqs": list(reqs),
            "out": out,
            "span": span,
            # The host reads the window in request order.
            "copy": _HostCopy(out if perm is None else out[
                :, torch.from_numpy(perm).to(out.device)], self._copy_stream,
                self._fabric),
            # Prefill dispatched since the previous window runs on the
            # device before this one: its sync interval absorbs it.
            "prefill_tokens": self._prefill_cost_tokens,
        })
        self._prefill_cost_tokens = 0
        if len(self._inflight) > WINDOW_PIPELINE_DEPTH:
            return self._sync_one_window()
        return []

    def _row_seed(self, req: Request) -> int:
        """The request's draw seed: its own, or one drawn once from the
        engine's generator."""
        if req.sampling.seed is not None:
            return int(req.sampling.seed)
        seed = self._row_seeds.get(req.request_id)
        if seed is None:
            seed = self._row_seeds[req.request_id] = int(
                self._rng.integers(0, 2 ** 63))
        return seed

    def _draw_index(self, req: Request) -> int:
        """Token index of the request's next draw."""
        return (req.sampling.seed_offset + req.prior_output
                + len(req.output_tokens))

    def _build_window_state(self, reqs, bucket, width, shadows, lag, K,
                            sig, perm=None) -> Dict:
        """The per-row window arrays (on `perm`'s rows under dp-local)."""
        positions0 = np.full((bucket,), self._pad_position, np.int32)
        seq_lens0 = np.zeros((bucket,), np.int32)
        bts = np.zeros((bucket, width), np.int32)
        temp = np.zeros((bucket,), np.float32)
        top_k = np.zeros((bucket,), np.int32)
        top_p = np.ones((bucket,), np.float32)
        seeds: List[Optional[int]] = [None] * bucket
        offsets = [0] * bucket
        for i, req in enumerate(reqs):
            positions0[i] = shadows[i] - 1
            seq_lens0[i] = shadows[i]
            n = min(len(req.pages), width)
            bts[i, :n] = req.pages[:n]
            temp[i] = req.sampling.temperature
            top_k[i] = req.sampling.top_k
            top_p[i] = req.sampling.top_p
            if req.sampling.temperature > 0:
                seeds[i] = self._row_seed(req)
            offsets[i] = self._draw_index(req) + lag * K
        if perm is not None:
            (positions0, seq_lens0, bts, temp, top_k, top_p, seeds,
             offsets) = self._to_slots(perm, positions0, seq_lens0, bts,
                                       temp, top_k, top_p, seeds, offsets)
        return {
            "sig": sig,
            "pages_sig": tuple(len(r.pages) for r in reqs),
            "pos_host": positions0.copy(),
            "pos": self._dev(positions0),
            "seq": self._dev(seq_lens0),
            "bts": self._dev(bts),
            "temp": self._dev(temp),
            "topk": self._dev(top_k),
            "topp": self._dev(top_p),
            "seeds": seeds,
            "off": offsets,
        }

    def _sync_one_window(self) -> List[TokenDelta]:
        entry = self._inflight.pop(0)
        self.counters.host_syncs += 1
        self.counters.window_syncs += 1
        tokens = entry["copy"].result()                    # [K, bucket]
        span = entry["span"]
        # The copy waited on the window's stream past its end event, so
        # both events are complete (query() confirms without blocking).
        if span is not None and span[1].query():
            self.counters.note_window_device_time(
                span[0].elapsed_time(span[1]) / 1000.0)
        # Measured mixed-prefill cost: with the pipeline full, the wall
        # interval between consecutive syncs tracks the device's window
        # time, and a window with prefill before it carries that cost.
        now = time.monotonic()
        if self._last_window_sync_ts is not None:
            self.counters.note_window_interval(
                now - self._last_window_sync_ts,
                tokens.shape[0] * len(entry["reqs"]),
                entry["prefill_tokens"])
        # A draining pipeline's next interval is a fill, not a sample.
        self._last_window_sync_ts = now if self._inflight else None
        deltas: List[TokenDelta] = []
        for i in range(tokens.shape[0]):
            for col, req in enumerate(entry["reqs"]):
                if (req.request_id not in self._requests
                        or req.state is not RequestState.DECODE):
                    continue  # finished/cancelled mid-window: discard tail
                self._publish_completed_blocks(req)
                deltas.append(self._append_token(req, int(tokens[i, col])))
                self.counters.note_kv_read(0, 1)  # real emission only
        return deltas

    def _drain_inflight(self) -> List[TokenDelta]:
        deltas: List[TokenDelta] = []
        while self._inflight:
            deltas.extend(self._sync_one_window())
        return deltas

    # -- MoE expert load ----------------------------------------------------

    def _take_load(self, out: tuple) -> tuple:
        """A step's outputs without the MoE [E+1] stats, which join the
        device-side sum (no host sync; int64, since nothing bounds the
        steps between two snapshots)."""
        if not self._moe:
            return out
        load = out[-1].long()
        with self._load_lock:
            self._load_dev = (load if self._load_dev is None
                              else self._load_dev + load)
        return out[:-1]

    def snapshot_expert_load(self) -> Optional[np.ndarray]:
        """Cumulative per-expert assignment counts (None for dense
        models).  Syncs the device stats sum once per call, splitting it
        into the per-expert load and `moe_dropped_tokens`."""
        if not self._moe:
            return None
        with self._load_lock:
            if self._load_dev is not None:
                self.counters.host_syncs += 1
                stats = self._load_dev.cpu().numpy().astype(np.int64)
                self.expert_load += stats[:-1]
                self.moe_dropped_tokens += int(stats[-1])
                self._load_dev = None
            return self.expert_load.copy()

    def reset_expert_load(self) -> None:
        """Start the expert-load totals again from zero (the device sum
        is dropped unread: no host sync)."""
        if self._moe:
            with self._load_lock:
                self._load_dev = None
                self.expert_load[:] = 0
                self.moe_dropped_tokens = 0

    # -- shared tails -------------------------------------------------------

    def _preempt_or_finish(self, req: Request) -> None:
        """KV blocks exhausted mid-decode: preempt-and-recompute when other
        requests hold pages; a lone request that would only thrash
        finishes with LENGTH."""
        total_need = self.scheduler._pages_needed(req.total_len + 1)
        if (len(self.scheduler.running) <= 1
                or total_need > self.allocator.num_blocks - 1):
            self._finish(req, FinishReason.LENGTH)
            return
        logger.info("preempting %s: out of KV blocks", req.request_id)
        fl = self.flight
        if fl.enabled:
            fl.record("preempt", rid=req.request_id, need_pages=total_need)
        if not self._managed_cache:
            # Plain allocator: the pages really are gone; they are
            # published again on the recompute pass.  (The managed source
            # keeps sealed blocks resident as inactive entries; its
            # eviction hook reports removals.)
            self._publish_removed_blocks(req)
        # Seal tracking restarts: publication must follow the recomputed
        # KV, never the pre-preemption block list.
        self._hash_seqs.pop(req.request_id, None)
        self._published_blocks.pop(req.request_id, None)
        self.scheduler.preempt(req)

    def _qos_preempt(self, req: Request) -> None:
        """Scheduler-chosen QoS victim: recompute-preempt it, then demote
        its sealed blocks into the host tier through the block manager (a
        no-op without one), so its resumption onboards them.  Resets the
        seal bookkeeping as `_preempt_or_finish` does."""
        rid = req.request_id
        seq = self._hash_seqs.get(rid)
        published = self._published_blocks.get(rid, 0)
        sealed = ([b.block_hash for b in seq.blocks[:published]]
                  if seq is not None else [])
        n_sealed = len(sealed)
        if not self._managed_cache:
            self._publish_removed_blocks(req)
        self._hash_seqs.pop(rid, None)
        self._published_blocks.pop(rid, None)
        self.scheduler.preempt(req)
        demoted = 0
        if self._managed_cache and sealed:
            demoted = self.allocator.manager.demote_blocks(sealed)
            self.qos_demoted_blocks += demoted
        fl = self.flight
        if fl.enabled:
            fl.record("qos_preempt", rid=rid, prio=req.priority,
                      sealed=n_sealed, demoted=demoted)
        logger.info("qos-preempted %s (priority %d): %d sealed blocks, "
                    "%d demoted to host tier", rid, req.priority,
                    n_sealed, demoted)

    def _sample_rows(self, logits: torch.Tensor, reqs: List[Request]):
        """(tokens[n], logprobs[n] or None) on the device."""
        n = logits.shape[0]
        reqs = reqs[:n]
        want_lp = any(r.sampling.logprobs for r in reqs)
        self.counters.note_dispatch(
            "sample", n, all(r.sampling.temperature <= 0 for r in reqs),
            want_lp)
        if all(r.sampling.temperature <= 0 for r in reqs):
            toks = greedy_sample(logits)
        else:
            dev = logits.device
            toks = sample(
                logits,
                torch.tensor([r.sampling.temperature for r in reqs],
                             dtype=torch.float32, device=dev),
                torch.tensor([r.sampling.top_k for r in reqs],
                             dtype=torch.int32, device=dev),
                torch.tensor([r.sampling.top_p for r in reqs],
                             dtype=torch.float32, device=dev),
                [self._row_seed(r) if r.sampling.temperature > 0 else None
                 for r in reqs],
                [self._draw_index(r) for r in reqs])
        lps = chosen_logprobs(logits, toks) if want_lp else None
        return toks, lps

    @hot_path
    def _append_token(self, req: Request, token: int,
                      logprob: Optional[float] = None) -> TokenDelta:
        if req.first_token_ts is None:
            req.first_token_ts = time.monotonic()
            self._trace_first_token(req)
            if request_ledger.enabled():
                self._note_ledger_timings(req)
        req.output_tokens.append(token)
        lp = ([logprob] if (logprob is not None and req.sampling.logprobs)
              else None)
        cached = (req.cached_prompt_tokens if len(req.output_tokens) == 1
                  else None)
        stop = token in req.sampling.stop_token_ids
        length = (req.prior_output + len(req.output_tokens)
                  >= req.sampling.max_tokens)
        if stop or length:
            self._finish(req, FinishReason.STOP if stop else FinishReason.LENGTH)
            delta = TokenDelta(req.request_id, [token], finished=True,
                               finish_reason=req.finish_reason, logprobs=lp,
                               cached_tokens=cached)
            self._drop(req)
            return delta
        return TokenDelta(req.request_id, [token], logprobs=lp,
                          cached_tokens=cached)

    def _trace_first_token(self, req: Request) -> None:
        """Admission→first-token spans, recorded on the engine thread when
        the request's first token lands, from timestamps the scheduler
        already stamps: no device work, no host sync, and nothing unless
        tracing is on AND the serving layer bound a context for this
        request id (LocalEngineClient / engine_wire_handler)."""
        tracer = tracing.get_tracer()
        if not tracer.enabled:
            return
        ctx = tracer.ctx_for(req.request_id)
        if ctx is None:
            return
        first = req.first_token_ts
        pf_start = req.prefill_start_ts or req.arrival_ts
        pf_end = req.prefill_end_ts or first
        tracer.record_span("engine.queue_wait", ctx,
                           req.arrival_ts, pf_start,
                           attrs={"request_id": req.request_id})
        tracer.record_span(
            "engine.prefill", ctx, pf_start, pf_end,
            attrs={"request_id": req.request_id,
                   "prompt_tokens": len(req.prompt_tokens)})
        tracer.record_span("engine.ttft", ctx, req.arrival_ts, first,
                           attrs={"request_id": req.request_id})

    def _note_ledger_timings(self, req: Request) -> None:
        """Park this request's admission→first-token scalars for the
        serving layer's ledger stamps: one bounded dict insert per
        request lifetime, no device work, behind the ledger's guard."""
        t = self._ledger_timings
        if len(t) >= 1024:
            t.pop(next(iter(t)))     # oldest never-popped entry out
        t[req.request_id] = (
            req.arrival_ts,
            req.prefill_start_ts or req.arrival_ts,
            req.prefill_end_ts or req.first_token_ts,
            req.first_token_ts,
            len(req.prompt_tokens),
            req.cached_prompt_tokens,
            req.preempts)

    def pop_ledger_timings(self, request_id: str):
        """(arrival, prefill_start, prefill_end, first_token,
        prompt_tokens, cached_tokens, preempts) or None — popped once by
        the serving layer when the first token-bearing delta crosses the
        event loop."""
        return self._ledger_timings.pop(request_id, None)

    def _finish(self, req: Request, reason: FinishReason) -> None:
        # With the managed source, sealed blocks stay resident (inactive,
        # matchable) after finish: REMOVED comes from its eviction hook.
        if not self._managed_cache:
            self._publish_removed_blocks(req)
        self.scheduler.finish(req, reason)

    def _drop(self, req: Request) -> None:
        self._requests.pop(req.request_id, None)
        self._row_seeds.pop(req.request_id, None)
        self._hash_seqs.pop(req.request_id, None)
        self._published_blocks.pop(req.request_id, None)

    # -- prefix cache and KV events -------------------------------------------

    @property
    def _managed_cache(self) -> bool:
        return isinstance(self.allocator, ManagedBlockSource)

    @property
    def _events_on(self) -> bool:
        return (self._kv_event_sink is not None
                and self.config.enable_kv_events)

    @hot_path
    def _publish_completed_blocks(self, req: Request) -> None:
        """Register the blocks this request has sealed since the last call
        with the block source, so later prompts can match them, and emit
        them as one STORED event.  Callers run it before appending a new
        token: every token it covers has its KV written (the newest one's
        is written by the step that sampled the token being appended)."""
        events_on = self._events_on
        if not self._managed_cache and not events_on:
            return  # nobody consumes seals: skip the hashing
        if req.prompt_embeds is not None:
            # A multimodal prompt's blocks hash its placeholder ids:
            # sealing them would prefix-match another image's request.
            return
        if req.request_id not in self._requests:
            return  # already finished and dropped
        seq = self._hash_seqs.get(req.request_id)
        if seq is None:
            seq = self._hash_seqs[req.request_id] = TokenBlockSequence(
                block_size=self.block_size)
        # The tokens past the hashed ones, of prompt[:prefilled] + output.
        n, p = len(seq), req.prefilled
        seq.extend(req.prompt_tokens[n:p] + req.output_tokens[max(0, n - p):])
        done = self._published_blocks.get(req.request_id, 0)
        complete = seq.blocks
        if len(complete) <= done:
            return
        for bi in range(done, len(complete)):
            if bi < len(req.pages):
                self.allocator.register_block(req.pages[bi],
                                              complete[bi].block_hash)
        if events_on:
            parent = complete[done - 1].block_hash if done else None
            self._emit(KvCacheEventData.stored(
                [b.block_hash for b in complete[done:]], parent_hash=parent))
        self._published_blocks[req.request_id] = len(complete)
        if self.seal_sink is not None:
            # Fires only when blocks sealed; the sink is a dict miss
            # unless a watcher registered this request.
            self.seal_sink(req.request_id, len(complete))

    def _on_block_evicted(self, block_hash: int) -> None:
        """The managed source evicted a block from the device: the router
        must forget it."""
        if self._events_on:
            self._emit(KvCacheEventData.removed([block_hash]))

    def _publish_removed_blocks(self, req: Request) -> None:
        if not self._events_on:
            return
        seq = self._hash_seqs.get(req.request_id)
        done = self._published_blocks.get(req.request_id, 0)
        if not seq or not done:
            return
        self._emit(KvCacheEventData.removed(
            [b.block_hash for b in seq.blocks[:done]]))

    def _emit(self, data: KvCacheEventData) -> None:
        self._event_id += 1
        self._kv_event_sink(KvCacheEvent(event_id=self._event_id, data=data))

    # -- cross-worker block transfer (engine thread only) -------------------

    def _page_ids(self, pages: List[int]) -> torch.Tensor:
        """Page ids on the device, uploaded from pinned memory without a
        host sync (an eviction's offload must not stall the step loop)."""
        ids = torch.tensor(pages, dtype=torch.long,
                           pin_memory=self.device.type == "cuda")
        return ids.to(self.device, non_blocking=True)

    @hot_path
    def _extract_pages(self, pages: List[int]) -> torch.Tensor:
        if self.stages is not None:
            return self._pp_extract(self.cache, self._page_ids(pages))
        if self.grid is not None:
            return kvc.extract_grid_blocks(self.cache, self.grid,
                                           self._page_ids(pages),
                                           self.block_size)
        return kvc.extract_blocks(self.cache, self._page_ids(pages),
                                  self.block_size)

    def _inject_pages(self, pages: List[int], data: torch.Tensor) -> None:
        self._validate_block(data[0])   # a stacked batch: one format
        if self.stages is not None:
            self._pp_inject(self.cache, self._page_ids(pages),
                            data.to(self.device))
            return
        if self.grid is not None:
            kvc.inject_grid_blocks(self.cache, self.grid,
                                   self._page_ids(pages),
                                   data.to(self.device), self.block_size)
            return
        kvc.inject_blocks(self.cache, self._page_ids(pages),
                          data.to(self.device), self.block_size)

    def _validate_block(self, data: torch.Tensor) -> None:
        """Loud mixed-mode guard on every injected block: a bf16 peer's
        block in an int8 cache (or the reverse) would write garbage into
        live pages.  Float-to-float casts are tolerated; an int8 packed
        block round-trips only into an int8 cache."""
        want = self.cache_cfg.block_wire_shape
        got = tuple(data.shape)
        got_int8 = data.dtype == torch.int8
        if got != want or got_int8 != self.cache_cfg.quantized:
            raise ValueError(
                f"KV block format mismatch: peer sent {data.dtype}"
                f"{list(got)} but this cache stores "
                f"{self.cache_cfg.block_wire_dtype}{list(want)} "
                f"(kv_quant={self.cache_cfg.kv_quant!r}) — prefill and "
                "decode workers must run the same --kv-quant mode; "
                "refusing to inject")

    @engine_thread_only
    def export_blocks_device(self, hashes) -> Dict[int, torch.Tensor]:
        """Resident blocks' wire bytes on the device, one extract for the
        batch (views of one staging tensor that shares nothing with the
        cache)."""
        if not self._managed_cache:
            return {}
        return self.allocator.manager.export_blocks_device(hashes)

    @engine_thread_only
    def export_blocks(self, hashes) -> Dict[int, torch.Tensor]:
        """The wire bytes on the host of requested blocks resident in any
        tier (G1 -> G2 -> G3): one extract and one device-to-host copy for
        the G1 blocks."""
        if not self._managed_cache:
            return {}
        if self._lockstep is not None:
            # The followers join the extract's gathers across processes.
            self._lockstep.broadcast({"op": "export",
                                      "hashes": [int(h) for h in hashes]})
        return self.allocator.manager.export_blocks(hashes)

    @engine_thread_only
    def resident_prefix_blocks(self, hashes) -> int:
        """Length of the contiguous prefix of `hashes` resident in any
        local tier (G1/G2/G3; host lookups only): the prefix-share pull
        never fetches what a lower tier would onboard."""
        if not self._managed_cache:
            return 0
        return self.allocator.manager.resident_prefix(hashes)

    @engine_thread_only
    def import_blocks(self, blocks: Dict[int, torch.Tensor]) -> int:
        """Inject fetched blocks as registered prefix-cache entries; a
        later request with the matching prompt prefix skips their
        prefill (the decode-side onboard of disaggregated P/D)."""
        if not self._managed_cache or not blocks:
            return 0
        for data in blocks.values():    # before anything is allocated
            self._validate_block(data)
        if self._lockstep is not None:
            self._lockstep.broadcast({"op": "import",
                                      "blocks": multihost.encode_blocks(
                                          blocks)})
        return self.allocator.manager.import_blocks(blocks)

    @engine_thread_only
    def clear_prefix_cache(self) -> int:
        """Admin flush of every reusable cached block (engine thread);
        returns how many were dropped, each reported REMOVED."""
        if self._lockstep is not None:
            self._lockstep.broadcast({"op": "clear"})
        clear = getattr(self.allocator, "clear_cache", None)
        return clear() if clear is not None else 0

    # -- embeddings (engine thread only) --------------------------------------

    @engine_thread_only
    def embed_tokens(self, token_lists: List[List[int]]) -> np.ndarray:
        """The final-norm hidden state of each prompt's last token: [n, H]
        f32.  One padded prefill per group of R prompts (the gathered
        path), on pages allocated for it and released afterwards (the
        /v1/embeddings surface).  The capability table refuses it under
        pp, in JAX's words."""
        check_plane(PlaneSpec(role="embed"), self.mesh, self._mh)
        cfg = self.config.model
        if self._embed_step is None:
            self._embed_step = make_forward_step(
                cfg, self.block_size, moe_mode=self.moe_mode,
                return_hidden=True, tp=self.group)
        sched = self.scheduler.config
        vocab = cfg.vocab_size
        for toks in token_lists:
            if len(toks) == 0:
                raise ValueError("empty embedding input")
            if len(toks) > sched.max_prefill_chunk:
                raise ValueError(
                    f"embedding input of {len(toks)} tokens exceeds the "
                    f"prefill chunk ceiling {sched.max_prefill_chunk}")
            if any(not 0 <= int(t) < vocab for t in toks):
                raise ValueError(
                    f"embedding token outside the vocabulary [0, {vocab})")
        out = np.zeros((len(token_lists), cfg.hidden_size), np.float32)
        # Prompts a call: one, as the JAX engine without a mesh; a grid
        # takes a row for each of its batch shares.
        R = self._row_mult
        bs = self.block_size
        for start in range(0, len(token_lists), R):
            group = token_lists[start: start + R]
            T = sched.bucket_for_prefill(max(len(t) for t in group))
            per_pages = [(len(t) + bs - 1) // bs for t in group]
            width = sched.bucket_for_pages(max(per_pages))
            # Allocated inside the guarded region: a failure part way
            # through the group releases what was taken.
            pages: List[List[int]] = []
            try:
                for n in per_pages:
                    pages.append(self.allocator.allocate(n))
                tokens = np.zeros((R, T), np.int32)
                positions = np.full((R, T), self._pad_position, np.int32)
                bts = np.zeros((R, width), np.int32)
                seq_lens = np.zeros((R,), np.int32)
                sample_pos = np.zeros((R,), np.int32)
                for i, toks in enumerate(group):
                    L = len(toks)
                    tokens[i, :L] = toks
                    positions[i, :L] = np.arange(L)
                    bts[i, : per_pages[i]] = pages[i]
                    seq_lens[i] = L
                    sample_pos[i] = L - 1
                self.counters.model_rows += R * T
                hidden, self.cache = self._embed_step(
                    self.params, self.cache, self._dev(tokens),
                    self._dev(positions), self._dev(seq_lens),
                    self._dev(bts), self._dev(sample_pos))
                self.counters.host_syncs += 1
                out[start: start + len(group)] = (
                    hidden[: len(group)].cpu().numpy())
            finally:
                for p in pages:
                    self.allocator.release(p)
        return out

    def prefix_cache_stats(self) -> Dict[str, object]:
        """Admission hit and miss tokens, the hit rate, and the block
        pool's state."""
        hit = self.scheduler.prefix_hit_tokens
        miss = self.scheduler.prefix_miss_tokens
        out = {"enabled": self._managed_cache,
               "hit_tokens": hit, "miss_tokens": miss,
               "hit_rate": hit / (hit + miss) if hit + miss else 0.0,
               "pool_usage": self.allocator.usage,
               "free_blocks": self.allocator.free_blocks}
        if out["enabled"]:
            out["pool"] = self.allocator.stats
        return out

    def mixed_prefill_stats(self) -> Dict[str, object]:
        """The mixed-prefill controller's cost: the measured prefill-token
        / decode-token ratio (None before a sample), the ratio its plans
        use, the samples taken and the duty of the last plan."""
        ctl, c = self._mixed_ctl, self.counters
        return {"prior_cost_ratio": ctl.cost_ratio,
                "measured_cost_ratio": ctl.measured_cost,
                "effective_cost_ratio": ctl.effective_cost_ratio,
                "cost_samples": c.prefill_cost_samples,
                "decode_token_cost_ewma_s": c.decode_token_cost_ewma,
                "prefill_token_cost_ewma_s": c.prefill_token_cost_ewma,
                "duty": self._mixed_duty}

    def reset_prefix_stats(self) -> None:
        self.scheduler.prefix_hit_tokens = 0
        self.scheduler.prefix_miss_tokens = 0


class InferenceEngine:
    """Async facade: background step-loop thread + per-request streams.

    The event loop never touches the core: submissions and cancellations
    queue under a small lock and the engine thread drains them before
    each step."""

    def __init__(self, core: EngineCore) -> None:
        self.core = core
        self._queues: Dict[str, asyncio.Queue] = {}
        self._seal_watchers: Dict[str, asyncio.Queue] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._cmd_lock = threading.Lock()
        self._pending_adds: List[tuple] = []
        self._pending_cancels: List[str] = []
        self._pending_calls: List[tuple] = []   # (fn, asyncio.Future)
        self._stop = threading.Event()
        self._wake = threading.Event()

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self.core.seal_sink = self._on_seal
        # Ownership transfer: the core (and its pools) may have been built
        # and stepped on the constructing thread; the step-loop thread
        # owns them from here on (thread-affinity pins re-pin).
        contracts.release_owner(*self._contract_owned())
        self._thread = threading.Thread(
            target=self._run_loop, name="engine-step-loop", daemon=True)
        self._thread.start()

    @property
    def metrics(self) -> ForwardPassMetrics:
        """The core's load snapshot, with the MoE expert load read from the
        device now (on the caller's thread, never the engine's)."""
        m = self.core.metrics
        load = self.core.snapshot_expert_load()
        if load is not None:
            m.expert_load = [int(x) for x in load]
            m.moe_dropped_tokens = self.core.moe_dropped_tokens
        return m

    def _contract_owned(self):
        """Everything whose @engine_thread_only pin follows the step loop:
        the core, its block source and the tiered pools behind it."""
        owned = [self.core, self.core.allocator]
        manager = getattr(self.core.allocator, "manager", None)
        if manager is not None:
            owned += [manager, manager.device, manager.host, manager.disk]
        return [o for o in owned if o is not None]

    async def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            await asyncio.to_thread(self._thread.join, 10.0)
        # The step loop is gone: tests may drive the core directly.
        contracts.release_owner(*self._contract_owned())
        # Settle the offload copies in flight and remove the disk tier's
        # file, off the engine thread.
        manager = getattr(self.core.allocator, "manager", None)
        if manager is not None:
            await asyncio.to_thread(manager.close)

    def _run_loop(self) -> None:
        contracts.register_engine_thread()
        try:
            self._step_loop()
        finally:
            contracts.unregister_engine_thread()
            # Engine-thread calls nobody will run fail rather than hang.
            with self._cmd_lock:
                calls, self._pending_calls = self._pending_calls, []
            for _, fut in calls:
                self._loop.call_soon_threadsafe(
                    self._resolve, fut, None,
                    RuntimeError("the engine stopped"))

    def _step_loop(self) -> None:
        while not self._stop.is_set():
            self._drain_commands()
            busy = self.core.has_work
            try:
                deltas = self.core.step() if busy else []
            except Exception:
                # A failed step cannot be retried against a half-updated
                # cache: end every open stream with an error and stop.
                logger.exception("engine step failed; stopping the engine")
                for rid in list(self._queues):
                    self._dispatch(TokenDelta(rid, [], finished=True,
                                              finish_reason=FinishReason.ERROR))
                return
            for d in deltas:
                self._dispatch(d)
            if not busy:
                self._wake.wait(timeout=0.005)
                self._wake.clear()

    def _drain_commands(self) -> None:
        with self._cmd_lock:
            adds, self._pending_adds = self._pending_adds, []
            cancels, self._pending_cancels = self._pending_cancels, []
            calls, self._pending_calls = self._pending_calls, []
        for fn, fut in calls:
            try:
                result, exc = fn(), None
            except Exception as e:   # raised to the awaiting caller
                result, exc = None, e
            self._loop.call_soon_threadsafe(self._resolve, fut, result, exc)
        for rid, prompt, sampling, arrival, priority, embeds in adds:
            try:
                self.core.add_request(rid, prompt, sampling,
                                      arrival_ts=arrival, priority=priority,
                                      prompt_embeds=embeds)
            except ValueError as e:
                self._dispatch(TokenDelta(
                    request_id=rid, token_ids=[], finished=True,
                    finish_reason=FinishReason.ERROR))
                logger.warning("rejecting request %s: %s", rid, e)
        for rid in cancels:
            self.core.cancel(rid)

    @staticmethod
    def _resolve(fut: asyncio.Future, result, exc) -> None:
        if fut.done():
            return   # the awaiting caller was cancelled
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    def _dispatch(self, delta: TokenDelta) -> None:
        q = self._queues.get(delta.request_id)
        if q is None:
            return
        self._loop.call_soon_threadsafe(q.put_nowait, delta)

    @never_engine_thread
    async def generate(self, request_id: str, prompt_tokens: List[int],
                       sampling: SamplingParams, prompt_embeds=None,
                       priority: int = 1) -> AsyncIterator[TokenDelta]:
        """Submit and stream deltas until the request finishes; closing
        the generator cancels the request.  `prompt_embeds`: see
        EngineCore.add_request."""
        q: asyncio.Queue = asyncio.Queue()
        self._queues[request_id] = q
        with self._cmd_lock:
            self._pending_adds.append((request_id, prompt_tokens, sampling,
                                       time.monotonic(), priority,
                                       prompt_embeds))
        self._wake.set()
        try:
            while True:
                delta = await q.get()
                yield delta
                if delta.finished:
                    return
        finally:
            self._queues.pop(request_id, None)
            with self._cmd_lock:
                self._pending_cancels.append(request_id)
            self._wake.set()

    def pop_ledger_timings(self, request_id: str):
        """Event-loop read of the core's parked first-token timings (the
        request ledger's engine phases): a bounded dict pop of host
        scalars, safe off the engine thread."""
        return self.core.pop_ledger_timings(request_id)

    # -- seal-progress stream (disagg eager KV streaming) -------------------

    @hot_path
    def _on_seal(self, request_id: str, sealed_blocks: int) -> None:
        """Engine-thread callback: forward a request's sealed-block count
        to its watcher; a dict miss when nobody watches."""
        q = self._seal_watchers.get(request_id)
        if q is None or self._loop is None:
            return
        self._loop.call_soon_threadsafe(q.put_nowait, sealed_blocks)

    @never_engine_thread
    def watch_seals(self, request_id: str) -> asyncio.Queue:
        """Subscribe to a request's prefill progress: the queue yields its
        count of sealed (registered) blocks so far."""
        q: asyncio.Queue = asyncio.Queue()
        self._seal_watchers[request_id] = q
        return q

    def unwatch_seals(self, request_id: str) -> None:
        self._seal_watchers.pop(request_id, None)

    # -- engine-thread calls ------------------------------------------------

    @never_engine_thread
    async def run_in_engine(self, fn):
        """Run fn() on the engine thread between steps (the cache is
        updated in place, so no read or write may race a step); returns
        its result.  Never await this from the engine thread."""
        if self._stop.is_set():
            raise RuntimeError("the engine stopped")
        fut = asyncio.get_running_loop().create_future()
        with self._cmd_lock:
            self._pending_calls.append((fn, fut))
        self._wake.set()
        return await fut

    @never_engine_thread
    async def export_blocks(self, hashes) -> Dict[int, torch.Tensor]:
        return await self.run_in_engine(
            lambda: self.core.export_blocks(hashes))

    @never_engine_thread
    async def export_blocks_device(self, hashes) -> Dict[int, torch.Tensor]:
        return await self.run_in_engine(
            lambda: self.core.export_blocks_device(hashes))

    @never_engine_thread
    async def import_blocks(self, blocks) -> int:
        return await self.run_in_engine(
            lambda: self.core.import_blocks(blocks))

    @never_engine_thread
    async def resident_prefix_blocks(self, hashes) -> int:
        return await self.run_in_engine(
            lambda: self.core.resident_prefix_blocks(hashes))

    @never_engine_thread
    async def clear_kv_blocks(self) -> int:
        return await self.run_in_engine(self.core.clear_prefix_cache)

    @never_engine_thread
    async def embed(self, token_lists) -> np.ndarray:
        """[n, H] f32 embeddings, one engine-thread call an input, so the
        decode steps of streams in flight run between the inputs."""
        rows = []
        for toks in token_lists:
            rows.append(await self.run_in_engine(
                lambda t=toks: self.core.embed_tokens([t])))
        return (np.concatenate(rows, axis=0) if rows
                else np.zeros((0, 0), np.float32))
