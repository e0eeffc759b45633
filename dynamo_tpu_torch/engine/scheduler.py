"""Continuous-batching scheduler (copy of `dynamo_tpu/engine/scheduler.py`,
which needs no device).

The scheduler is synchronous and deviceless: it decides what each engine
iteration runs; the engine owns the tensors.  Decode runs at batch
buckets, prefill chunks are capped at `max_prefill_chunk` and packed into
flat token buckets, and block tables are sliced to power-of-two page
buckets.  Eager PyTorch compiles nothing per shape, so today the buckets
only pad; they stay because the CUDA graphs that ROADMAP queues for the
decode window and the packed prefill capture one graph per shape, and
the bucket set is what bounds the number of graphs.

Left out of this copy: the flight-recorder breadcrumbs, QoS classes and
SLO-pressure preemption, the dp-attention sharded allocator, the prefix
cache's match/register hooks, the padded-prefill row buckets and the
tracing/ledger timestamps (none is ported yet).  Admission is FCFS, which
is what the JAX scheduler does when every request has the default
priority and no SLO pressure is wired.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from dynamo_tpu_torch.engine.sampling import SamplingParams

# Policy constants, the JAX package's defaults.
MAX_BATCHED_TOKENS = 8192      # token budget of one step
WATERMARK = 0.01               # min free-block fraction left after admission
MIXED_PREFILL_FLOOR = 64       # smallest chunk the mixed controller grants
PACKED_PREFILL_SEGMENTS = 8    # segment slots of one packed prefill


class FinishReason(str, enum.Enum):
    STOP = "stop"            # stop token / stop string hit
    LENGTH = "length"        # max_tokens or context limit
    CANCELLED = "cancelled"  # client disconnected / cancelled
    ERROR = "error"


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclass
class Request:
    """One in-flight generation."""

    request_id: str
    prompt_tokens: List[int]
    sampling: SamplingParams
    state: RequestState = RequestState.WAITING
    prefilled: int = 0                    # prompt tokens already processed
    output_tokens: List[int] = field(default_factory=list)
    pages: List[int] = field(default_factory=list)
    slot: Optional[int] = None            # decode slot index while active
    finish_reason: Optional[FinishReason] = None
    # Tokens emitted before a preemption folded them into the prompt —
    # keeps max_tokens budgeting and seeded draw indices monotonic.
    prior_output: int = 0

    @property
    def total_len(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)

    @property
    def context_len(self) -> int:
        """Prompt+output tokens the model has consumed.  All but the newest
        sampled token have KV in cache; the newest one's KV is written by
        the decode step that feeds it (at position context_len - 1)."""
        return self.prefilled + len(self.output_tokens)


class BlockAllocator:
    """Free-list page allocator over the paged cache (block 0 reserved
    null).  No prefix reuse."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"out of KV blocks: want {n}, free {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == 0:
                raise ValueError("attempt to free the null block")
            self._free.append(p)


@dataclass(frozen=True)
class SchedulerConfig:
    """Batch and cache geometry, defaults as the JAX package's."""

    max_seqs: int = 64
    max_prefill_chunk: int = 512
    block_size: int = 64
    max_pages_per_seq: int = 128          # static block-table width
    decode_buckets: tuple = (1, 2, 4, 8, 16, 32, 64)
    prefill_buckets: tuple = (16, 32, 64, 128, 256, 512)

    def __post_init__(self):
        if self.max_seqs > max(self.decode_buckets):
            raise ValueError(
                f"max_seqs={self.max_seqs} exceeds largest decode bucket "
                f"{max(self.decode_buckets)}; padded arrays would overflow")
        if self.max_prefill_chunk > max(self.prefill_buckets):
            raise ValueError(
                f"max_prefill_chunk={self.max_prefill_chunk} exceeds largest "
                f"prefill bucket {max(self.prefill_buckets)}")
        align = 8  # ops.cuda.PACK_ALIGN (not imported: no torch op dep)
        bad = [b for b in self.packed_buckets() if b % align]
        if bad:
            raise ValueError(
                f"packed prefill buckets must be multiples of {align} "
                f"(PACK_ALIGN); got {bad}")

    def bucket_for_decode(self, n: int) -> int:
        for b in self.decode_buckets:
            if n <= b:
                return b
        return self.decode_buckets[-1]

    def bucket_for_prefill(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def packed_buckets(self) -> tuple:
        """Token-axis buckets for packed prefill: a small one for mixed
        chunks behind decode windows and the top one covering
        max_prefill_chunk."""
        top = self.bucket_for_prefill(self.max_prefill_chunk)
        small = min(128, top)
        return (small, top) if small < top else (top,)

    def bucket_for_packed(self, n: int) -> int:
        for b in self.packed_buckets():
            if n <= b:
                return b
        return self.packed_buckets()[-1]

    def packed_prefill_budget(self) -> int:
        """Aligned-token capacity of one packed prefill dispatch."""
        return self.packed_buckets()[-1]

    def bucket_for_pages(self, n: int) -> int:
        """Block-table width bucket: the smallest power-of-two page count
        covering the batch, capped at max_pages_per_seq."""
        b = 2
        while b < n:
            b *= 2
        return min(b, self.max_pages_per_seq)


def pack_prefill_chunks(items: List["PrefillWork"], budget: int,
                        max_segments: int,
                        align: int = 8) -> List[List["PrefillWork"]]:
    """Greedy in-order first-fit of prefill chunks into packs of at most
    `max_segments` chunks whose `align`-rounded lengths sum to at most
    `budget` tokens.  A chunk longer than the budget gets a pack of its
    own."""
    packs: List[List[PrefillWork]] = []
    cur: List[PrefillWork] = []
    cur_tokens = 0
    for w in items:
        need = -(-w.length // align) * align
        if cur and (cur_tokens + need > budget
                    or len(cur) >= max_segments):
            packs.append(cur)
            cur, cur_tokens = [], 0
        cur.append(w)
        cur_tokens += need
    if cur:
        packs.append(cur)
    return packs


class MixedPrefillController:
    """Adaptive mixed-mode admission: picks (duty, chunk budget) from the
    modeled interference ratio duty·n·K / (duty·n·K + C·cost_ratio).

    The port keeps the static cost prior; the JAX engine's measured-cost
    EWMA (fed from window-sync intervals) is not ported yet."""

    target = 0.85
    cost_ratio = 1.15
    max_duty = 8
    floor_tokens = MIXED_PREFILL_FLOOR

    def budget_for(self, duty: int, n_decoding: int, window: int) -> int:
        w = duty * n_decoding * window
        return int(w * (1.0 - self.target) / (self.target * self.cost_ratio))

    def modeled_interference(self, duty: int, n_decoding: int, window: int,
                             chunk_tokens: int) -> float:
        w = duty * n_decoding * window
        c = chunk_tokens * self.cost_ratio
        return w / (w + c) if (w + c) > 0 else 1.0

    def plan(self, n_decoding: int, window: int,
             want_tokens: int) -> Tuple[int, int]:
        """(duty, chunk_tokens) for this step's mixed admission."""
        if n_decoding <= 0 or window <= 0 or want_tokens <= 0:
            return 1, max(want_tokens, 0)
        for duty in range(1, self.max_duty + 1):
            if self.budget_for(duty, n_decoding, window) >= want_tokens:
                return duty, want_tokens
        return self.max_duty, max(
            self.floor_tokens, self.budget_for(self.max_duty,
                                               n_decoding, window))


@dataclass
class PrefillWork:
    """One prefill chunk for one sequence."""

    request: Request
    start: int        # absolute position of chunk start
    length: int       # real tokens in chunk


@dataclass
class PrefillBatch:
    """All of this iteration's prefill chunks (packed by the engine)."""

    items: List[PrefillWork]


@dataclass
class DecodeWork:
    """One decode step over all decoding sequences (padded to bucket)."""

    requests: List[Request]
    bucket: int
    pages: int        # padded block-table width (page bucket)


@dataclass
class StepPlan:
    prefill: Optional[PrefillBatch]
    decode: Optional[DecodeWork]

    @property
    def empty(self) -> bool:
        return self.prefill is None and self.decode is None


class Scheduler:
    """Decides, each engine iteration, which chunks to run."""

    def __init__(self, config: SchedulerConfig, allocator: BlockAllocator) -> None:
        self.config = config
        self.allocator = allocator
        self.waiting: List[Request] = []
        self.running: List[Request] = []       # PREFILL or DECODE
        self._slots: List[Optional[Request]] = [None] * config.max_seqs
        # Engine-installed mixed-mode budget (MixedPrefillController);
        # None = the static caps.
        self.mixed_budget_override: Optional[int] = None

    # -- admission --------------------------------------------------------

    def add_request(self, req: Request) -> None:
        max_ctx = self.config.max_pages_per_seq * self.config.block_size
        if len(req.prompt_tokens) + req.sampling.max_tokens > max_ctx:
            req.state = RequestState.FINISHED
            req.finish_reason = FinishReason.LENGTH
            return
        self.waiting.append(req)

    def _pages_needed(self, tokens: int) -> int:
        return (tokens + self.config.block_size - 1) // self.config.block_size

    def _try_admit(self) -> None:
        usable = self.allocator.num_blocks - 1
        while self.waiting and len(self.running) < self.config.max_seqs:
            req = self.waiting[0]
            slot = next(
                (i for i, s in enumerate(self._slots) if s is None), None)
            if slot is None:
                break
            need = self._pages_needed(len(req.prompt_tokens) + 1)
            # Admit only if the pages fit and leave the watermark.
            if self.allocator.free_blocks - need < WATERMARK * usable:
                # Nothing running means nothing will ever free pages — the
                # head request can never fit; fail it instead of spinning.
                if not self.running:
                    self.waiting.pop(0)
                    req.state = RequestState.FINISHED
                    req.finish_reason = FinishReason.LENGTH
                break
            self.waiting.pop(0)
            req.pages = self.allocator.allocate(need)
            req.prefilled = 0
            req.slot = slot
            self._slots[slot] = req
            req.state = RequestState.PREFILL
            self.running.append(req)

    # -- page growth ------------------------------------------------------

    def ensure_capacity(self, req: Request, new_len: int) -> bool:
        """Grow req's page list to cover new_len tokens; False if OOM."""
        need = self._pages_needed(new_len)
        if need > self.config.max_pages_per_seq:
            return False
        while len(req.pages) < need:
            if self.allocator.free_blocks == 0:
                return False
            req.pages.extend(self.allocator.allocate(1))
        return True

    # -- planning ---------------------------------------------------------

    def plan(self) -> StepPlan:
        """Decode-first: every DECODE sequence takes one step; the remaining
        token budget goes to prefill chunks, FCFS."""
        self._try_admit()
        bs = self.config.block_size
        budget = MAX_BATCHED_TOKENS
        decoding = [r for r in self.running if r.state is RequestState.DECODE]
        decode = None
        if decoding:
            decode = DecodeWork(
                requests=decoding,
                bucket=self.config.bucket_for_decode(len(decoding)),
                pages=self.config.bucket_for_pages(max(
                    (r.context_len + bs - 1) // bs for r in decoding)),
            )
            budget -= len(decoding)
            # The engine installs the controller's chunk whenever requests
            # decode while prompt tokens wait.
            if self.mixed_budget_override is not None:
                budget = min(budget, max(0, self.mixed_budget_override))

        items: List[PrefillWork] = []
        for req in self.running:
            if req.state is not RequestState.PREFILL:
                continue
            if budget <= 0 or len(items) >= self.config.max_seqs:
                break
            remaining = len(req.prompt_tokens) - req.prefilled
            chunk = min(remaining, self.config.max_prefill_chunk, budget)
            if chunk <= 0:
                continue
            items.append(PrefillWork(
                request=req, start=req.prefilled, length=chunk))
            budget -= chunk
        return StepPlan(prefill=PrefillBatch(items) if items else None,
                        decode=decode)

    # -- preemption -------------------------------------------------------

    def preempt(self, req: Request) -> None:
        """Release the request's pages and requeue it (front of line) for
        recompute: generated tokens fold into the prompt, and the recompute
        prefill's completion samples the next token exactly as if decode
        had continued."""
        if req in self.running:
            self.running.remove(req)
        if req.slot is not None:
            self._slots[req.slot] = None
            req.slot = None
        if req.pages:
            self.allocator.release(req.pages)
            req.pages = []
        req.prior_output += len(req.output_tokens)
        req.prompt_tokens = req.prompt_tokens + req.output_tokens
        req.output_tokens = []
        req.prefilled = 0
        req.state = RequestState.WAITING
        self.waiting.insert(0, req)

    # -- completion callbacks --------------------------------------------

    def prefill_done(self, work: PrefillWork) -> None:
        req = work.request
        req.prefilled += work.length
        if req.prefilled >= len(req.prompt_tokens):
            req.state = RequestState.DECODE

    def finish(self, req: Request, reason: FinishReason) -> None:
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)
        if req.slot is not None:
            self._slots[req.slot] = None
            req.slot = None
        if req.pages:
            self.allocator.release(req.pages)
            req.pages = []
