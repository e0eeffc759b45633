"""The inference engine: device state, step loop and async streaming (port
of `dynamo_tpu/engine/engine.py`, meshless subset).

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

Padding discipline as in JAX: block tables are sliced to the batch's page
bucket, unallocated entries are the null block 0, and pad writes target
position `max_pages * block_size`, which indexes past every table width
and resolves to the null block.

Not ported yet: the prefix cache and KV events, speculative decode,
meshes (and with them MoE all-to-all dispatch), multimodal prefill and
embeddings.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, List, Optional

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine import kv_cache as kvc
from dynamo_tpu_torch.engine.sampling import (
    SamplingParams,
    chosen_logprobs,
    greedy as greedy_sample,
    sample,
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
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import (
    make_decode_window,
    make_forward_step,
    make_packed_prefill_step,
)
from dynamo_tpu_torch.models.weights import init_params
from dynamo_tpu_torch.ops.cuda import PACK_ALIGN
from dynamo_tpu_torch.ops.moe import resolve_moe_mode

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


@dataclass
class EngineCounters:
    """Serving-loop counters (the JAX EngineStepCounters' core)."""

    window_dispatches: int = 0
    window_syncs: int = 0
    single_step_dispatches: int = 0
    prefill_dispatches: int = 0
    host_syncs: int = 0
    h2d_uploads: int = 0
    # Token rows the model ran, padding rows included: each is routed to
    # k experts in every MoE layer.
    model_rows: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class _HostCopy:
    """A small device tensor copied to pinned host memory on a side stream,
    so the engine thread enqueues the copy and reads it later.  CPU
    tensors are ready at once."""

    def __init__(self, t: torch.Tensor, stream: Optional[torch.cuda.Stream]):
        self._event = None
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
        return self._host.numpy()


class EngineCore:
    """Synchronous engine: one `step()` = one scheduler plan executed."""

    def __init__(self, config: EngineConfig, params: Optional[dict] = None) -> None:
        self.config = config
        cfg = config.model
        sched_cfg = config.scheduler
        self.device = resolve_device(config.device)
        self.block_size = sched_cfg.block_size
        self.cache_cfg = kvc.KvCacheConfig.for_model(
            cfg, num_blocks=config.num_blocks, block_size=self.block_size)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self.cache = kvc.init_cache(self.cache_cfg, self.device)
        self._moe = cfg.is_moe
        self.moe_mode = resolve_moe_mode(cfg, self.device, config.moe_mode)
        self._step = make_forward_step(
            cfg, self.block_size, use_decode_kernel=True,
            moe_mode=self.moe_mode, with_expert_load=self._moe)
        self._packed_step = make_packed_prefill_step(
            cfg, self.block_size, moe_mode=self.moe_mode)
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
        self.allocator = BlockAllocator(config.num_blocks)
        self.scheduler = Scheduler(sched_cfg, self.allocator)
        self._pad_position = sched_cfg.max_pages_per_seq * self.block_size
        self._requests: Dict[str, Request] = {}
        # Seeds for unseeded stochastic rows (one per request).
        self._rng = np.random.default_rng(config.seed + 1)
        self._row_seeds: Dict[str, int] = {}
        self.counters = EngineCounters()
        self._windows_since_prefill = 0
        self._mixed_duty = MIXED_PREFILL_DUTY
        self._mixed_ctl = MixedPrefillController()

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    # -- request lifecycle ------------------------------------------------

    def add_request(self, request_id: str, prompt_tokens: List[int],
                    sampling: SamplingParams) -> None:
        if request_id in self._requests:
            raise ValueError(f"duplicate request id {request_id}")
        if not prompt_tokens:
            raise ValueError("empty prompt")
        vocab = self.config.model.vocab_size
        if any(not 0 <= int(t) < vocab for t in prompt_tokens):
            raise ValueError(f"prompt token outside the vocabulary [0, {vocab})")
        req = Request(request_id=request_id,
                      prompt_tokens=list(prompt_tokens), sampling=sampling)
        self._requests[request_id] = req
        self.scheduler.add_request(req)

    def cancel(self, request_id: str) -> None:
        req = self._requests.get(request_id)
        if req and req.state is not RequestState.FINISHED:
            self.scheduler.finish(req, FinishReason.CANCELLED)

    @property
    def has_work(self) -> bool:
        """True while any request needs a step(), including finished ones
        whose terminal delta has not been collected yet."""
        return bool(self._requests)

    # -- stepping ---------------------------------------------------------

    def step(self) -> List[TokenDelta]:
        """Run one engine iteration; returns token deltas (may be empty).

        Steady decode runs through the pipelined window path: dispatch one
        K-token window, sync the window from `WINDOW_PIPELINE_DEPTH`
        dispatches ago.  A bounded prefill chunk dispatches behind every
        `duty`-th window; newly prefilled requests park until their first
        token's copy lands and merge into the window cohort in batches.
        Any change the windows cannot absorb drains the pipeline first."""
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
                    deltas.extend(self._run_packed_prefill(
                        plan.prefill, async_first=True))
        if work is None and not plan.empty:
            # Settle pending first tokens before single-step decode reads
            # output_tokens; settling can finish requests, so replan.
            if self._pending_batches:
                self._settle_first_tokens(deltas, block=True)
                plan = self.scheduler.plan()
            if plan.prefill:
                deltas.extend(self._run_packed_prefill(plan.prefill))
            if plan.decode:
                deltas.extend(self._run_decode(plan.decode))

        self._collect_dead(deltas)
        return deltas

    def _plan_mixed_budget(self) -> None:
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
                deltas.append(self._append_token(
                    req, int(toks[j]),
                    float(lps[j]) if lps is not None else None))
        self._pending_batches = remaining

    def _window_eligible(self, plan) -> bool:
        if plan.decode is None:
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

    def _collect_dead(self, deltas: List[TokenDelta]) -> None:
        for rid, req in list(self._requests.items()):
            if req.state is RequestState.FINISHED and req.finish_reason is not None:
                deltas.append(TokenDelta(
                    request_id=rid, token_ids=[], finished=True,
                    finish_reason=req.finish_reason))
                self._drop(req)

    # -- packed ragged prefill ---------------------------------------------

    def _run_packed_prefill(self, batch: PrefillBatch,
                            async_first: bool = False) -> List[TokenDelta]:
        """The scheduler's chunks pack into flat [T] dispatches (each
        sized to the packed token budget with PACK_ALIGN'd segment
        starts), each one call of the packed step."""
        sched = self.scheduler.config
        deltas: List[TokenDelta] = []
        for items in pack_prefill_chunks(
                batch.items, sched.packed_prefill_budget(),
                PACKED_PREFILL_SEGMENTS, align=PACK_ALIGN):
            deltas.extend(self._dispatch_packed_prefill(items, async_first))
        return deltas

    def _dispatch_packed_prefill(self, items,
                                 async_first: bool) -> List[TokenDelta]:
        sched = self.scheduler.config
        bs = self.block_size
        R = PACKED_PREFILL_SEGMENTS
        aligned = sum(-(-w.length // PACK_ALIGN) * PACK_ALIGN for w in items)
        T = sched.bucket_for_packed(aligned)
        P = sched.bucket_for_pages(max(
            (w.start + w.length + bs - 1) // bs for w in items))
        tokens = np.zeros((T,), np.int32)
        positions = np.full((T,), self._pad_position, np.int32)
        seg_ids = np.zeros((T,), np.int32)
        bts = np.zeros((R, P), np.int32)
        q_starts = np.zeros((R,), np.int32)
        q_lens = np.zeros((R,), np.int32)
        seq_lens = np.zeros((R,), np.int32)
        sample_pos = np.zeros((R,), np.int32)
        off = 0
        for i, work in enumerate(items):
            req = work.request
            L = work.length
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
        self.counters.prefill_dispatches += 1
        self.counters.model_rows += T
        logits, self.cache = self._take_load(self._packed_step(
            self.params, self.cache, self._dev(tokens), self._dev(positions),
            self._dev(seg_ids), self._dev(bts), self._dev(q_starts),
            self._dev(q_lens), self._dev(seq_lens), self._dev(sample_pos)))
        return self._finish_prefill_items(items, logits, async_first)

    def _finish_prefill_items(self, items, logits,
                              async_first: bool) -> List[TokenDelta]:
        """Advance scheduler state and sample first tokens for rows whose
        prompt completed (row i of `logits` belongs to items[i])."""
        deltas: List[TokenDelta] = []
        done_rows: List[int] = []
        for i, work in enumerate(items):
            self.scheduler.prefill_done(work)
            if work.request.state is RequestState.DECODE:
                done_rows.append(i)
        if not done_rows:
            return deltas
        sel = logits[torch.tensor(done_rows, device=logits.device)]
        reqs = [items[i].request for i in done_rows]
        toks, lps = self._sample_rows(sel, reqs)
        copies = (_HostCopy(toks, self._copy_stream),
                  _HostCopy(lps, self._copy_stream) if lps is not None else None)
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
        self.counters.single_step_dispatches += 1
        self.counters.model_rows += bucket
        zeros = torch.zeros((bucket,), dtype=torch.int32, device=self.device)
        logits, self.cache = self._take_load(self._step(
            self.params, self.cache, self._dev(tokens), self._dev(positions),
            self._dev(seq_lens), self._dev(bts), zeros))
        if (all(r.sampling.temperature <= 0 for r in live)
                and not any(r.sampling.logprobs for r in live)):
            # Fused greedy step: argmax on the device, one [bucket] copy.
            toks_dev, lps_dev = greedy_sample(logits), None
        else:
            toks_dev, lps_dev = self._sample_rows(logits[: len(live)], live)
        self.counters.host_syncs += 1
        sampled = toks_dev.cpu().numpy()
        lps = lps_dev.cpu().numpy() if lps_dev is not None else None
        return [self._append_token(req, int(sampled[i]),
                                   float(lps[i]) if lps is not None else None)
                for i, req in enumerate(live)]

    # -- pipelined decode windows ------------------------------------------

    def _window_fn(self, greedy_only: bool):
        fn = self._window_fns.get(greedy_only)
        if fn is None:
            fn = self._window_fns[greedy_only] = make_decode_window(
                self.config.model, self.block_size, DECODE_WINDOW,
                use_decode_kernel=True, greedy_only=greedy_only,
                moe_mode=self.moe_mode, with_expert_load=self._moe)
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
                                          K, sig)
            self.counters.h2d_uploads += 1
        pages_sig = tuple(len(r.pages) for r in reqs)
        if st["pages_sig"] != pages_sig:
            bts = np.zeros((bucket, width), np.int32)
            for i, req in enumerate(reqs):
                n = min(len(req.pages), width)
                bts[i, :n] = req.pages[:n]
            st["bts"] = self._dev(bts)
            st["pages_sig"] = pages_sig
            self.counters.h2d_uploads += 1
        self._window_state = st
        self.counters.window_dispatches += 1
        self.counters.model_rows += bucket * K

        if lag:
            last_tokens = self._inflight[-1]["out"][K - 1]  # on device
        else:
            toks = np.zeros((bucket,), np.int32)
            for i, req in enumerate(reqs):
                toks[i] = (req.output_tokens[-1] if req.output_tokens
                           else req.prompt_tokens[-1])
            last_tokens = self._dev(toks)

        (self.cache, out, st["pos"], st["seq"], st["off"]) = self._take_load(
            self._window_fn(greedy_only)(
                self.params, self.cache, last_tokens, st["pos"], st["seq"],
                st["bts"], st["temp"], st["topk"], st["topp"], st["seeds"],
                st["off"]))
        st["pos_host"][rows] += K
        self._inflight.append({
            "rids": [r.request_id for r in reqs],
            "reqs": list(reqs),
            "out": out,
            "copy": _HostCopy(out, self._copy_stream),
        })
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
                            sig) -> Dict:
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
        deltas: List[TokenDelta] = []
        for i in range(tokens.shape[0]):
            for col, req in enumerate(entry["reqs"]):
                if (req.request_id not in self._requests
                        or req.state is not RequestState.DECODE):
                    continue  # finished/cancelled mid-window: discard tail
                deltas.append(self._append_token(req, int(tokens[i, col])))
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
            self.scheduler.finish(req, FinishReason.LENGTH)
            return
        logger.info("preempting %s: out of KV blocks", req.request_id)
        self.scheduler.preempt(req)

    def _sample_rows(self, logits: torch.Tensor, reqs: List[Request]):
        """(tokens[n], logprobs[n] or None) on the device."""
        n = logits.shape[0]
        reqs = reqs[:n]
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
        lps = (chosen_logprobs(logits, toks)
               if any(r.sampling.logprobs for r in reqs) else None)
        return toks, lps

    def _append_token(self, req: Request, token: int,
                      logprob: Optional[float] = None) -> TokenDelta:
        req.output_tokens.append(token)
        lp = ([logprob] if (logprob is not None and req.sampling.logprobs)
              else None)
        stop = token in req.sampling.stop_token_ids
        length = (req.prior_output + len(req.output_tokens)
                  >= req.sampling.max_tokens)
        if stop or length:
            self.scheduler.finish(
                req, FinishReason.STOP if stop else FinishReason.LENGTH)
            delta = TokenDelta(req.request_id, [token], finished=True,
                               finish_reason=req.finish_reason, logprobs=lp)
            self._drop(req)
            return delta
        return TokenDelta(req.request_id, [token], logprobs=lp)

    def _drop(self, req: Request) -> None:
        self._requests.pop(req.request_id, None)
        self._row_seeds.pop(req.request_id, None)


class InferenceEngine:
    """Async facade: background step-loop thread + per-request streams.

    The event loop never touches the core: submissions and cancellations
    queue under a small lock and the engine thread drains them before
    each step."""

    def __init__(self, core: EngineCore) -> None:
        self.core = core
        self._queues: Dict[str, asyncio.Queue] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._cmd_lock = threading.Lock()
        self._pending_adds: List[tuple] = []
        self._pending_cancels: List[str] = []
        self._stop = threading.Event()
        self._wake = threading.Event()

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=self._run_loop, name="engine-step-loop", daemon=True)
        self._thread.start()

    async def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            await asyncio.to_thread(self._thread.join, 10.0)

    def _run_loop(self) -> None:
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
        for rid, prompt, sampling in adds:
            try:
                self.core.add_request(rid, prompt, sampling)
            except ValueError as e:
                self._dispatch(TokenDelta(
                    request_id=rid, token_ids=[], finished=True,
                    finish_reason=FinishReason.ERROR))
                logger.warning("rejecting request %s: %s", rid, e)
        for rid in cancels:
            self.core.cancel(rid)

    def _dispatch(self, delta: TokenDelta) -> None:
        q = self._queues.get(delta.request_id)
        if q is None:
            return
        self._loop.call_soon_threadsafe(q.put_nowait, delta)

    async def generate(self, request_id: str, prompt_tokens: List[int],
                       sampling: SamplingParams) -> AsyncIterator[TokenDelta]:
        """Submit and stream deltas until the request finishes; closing
        the generator cancels the request."""
        q: asyncio.Queue = asyncio.Queue()
        self._queues[request_id] = q
        with self._cmd_lock:
            self._pending_adds.append((request_id, prompt_tokens, sampling))
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
