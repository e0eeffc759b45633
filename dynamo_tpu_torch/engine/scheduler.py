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

Admission matches each prompt against the prefix cache first (the
engine's ManagedBlockSource; the plain BlockAllocator here never hits):
cached pages are pinned and reused, only the remainder is allocated, and
`prefix_hit_tokens` / `prefix_miss_tokens` count the prompt tokens whose
prefill was skipped and computed.

Requests carry the JAX scheduler's timestamps (arrival, prefill start
and end, first token) and preemption count, which the engine's tracing
spans and ledger stamps read.

QoS classes as JAX's: admission takes the highest `Request.priority`
first (FCFS within a class); a capacity-blocked request preempts the
newest running request of a strictly lower class; and under SLO-burn
pressure (`qos_pressure_fn` at or above `qos_threshold`) best-effort
requests hold at admission and one running best-effort request is shed
per plan.  The flight recorder gets JAX's `admit` and `sched_preempt`
breadcrumbs.

Left out of this copy: the dp-attention sharded allocator (A7) and the
padded-prefill row buckets (the port's prefill is always packed).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.runtime import flight_recorder

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
    # Prompt tokens the prefix cache served at admission.
    cached_prompt_tokens: int = 0
    # Memoized chained hashes of the sealed prompt blocks (admission
    # retries must not re-hash); None = not computed yet.
    block_hashes: Optional[tuple] = None
    # Lifecycle timestamps (monotonic) for the tracing spans and the
    # request ledger, and the recompute preemptions this request took.
    arrival_ts: float = field(default_factory=time.monotonic)
    first_token_ts: Optional[float] = None
    prefill_start_ts: Optional[float] = None
    prefill_end_ts: Optional[float] = None
    preempts: int = 0
    # QoS class: 0 = best-effort (preemptible under SLO burn, held at
    # admission while the budget burns), 1 = standard (default), 2 =
    # interactive.  Admission picks the highest class first (FCFS within
    # a class); capacity shortfalls preempt strictly-lower classes before
    # refusing a higher one.
    priority: int = 1
    # Multimodal: [n, hidden] embeddings taking prompt positions [0, n).
    prompt_embeds: Optional[object] = None

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
    null).  No prefix reuse: its prefix-cache interface never matches."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))

    # Prefix-cache interface (no-ops here).
    def prompt_hashes(self, prompt_tokens: Sequence[int]) -> tuple:
        return ()

    def match(self, prompt_tokens: Sequence[int], hashes=None):
        """Returns (cached_tokens, pinned_pages)."""
        return 0, []

    def register_block(self, page: int, block_hash: int) -> None:
        pass

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def usage(self) -> float:
        return 1.0 - self.free_blocks / (self.num_blocks - 1)

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

    `cost_ratio` (one chunked-prefill token's cost in window-decode
    tokens) is only the prior: the engine feeds `observe_cost_ratio` the
    measured ratio (EngineCounters.measured_prefill_cost_ratio, from
    window-sync intervals) and an EWMA of those replaces the prior in
    every model query."""

    target = 0.85
    cost_ratio = 1.15              # prior until measurements arrive
    max_duty = 8
    floor_tokens = MIXED_PREFILL_FLOOR
    cost_ewma_alpha = 0.25

    def __init__(self) -> None:
        self.measured_cost: Optional[float] = None

    @property
    def effective_cost_ratio(self) -> float:
        """Measured EWMA when available, the static prior otherwise."""
        return (self.measured_cost if self.measured_cost is not None
                else self.cost_ratio)

    def observe_cost_ratio(self, ratio: float) -> None:
        """Fold one measured cost ratio into the EWMA, clamped to
        [0.1, 10] so one mistimed interval cannot swing duty to an
        extreme."""
        ratio = min(max(float(ratio), 0.1), 10.0)
        if self.measured_cost is None:
            self.measured_cost = ratio
        else:
            a = self.cost_ewma_alpha
            self.measured_cost = (1.0 - a) * self.measured_cost + a * ratio

    def budget_for(self, duty: int, n_decoding: int, window: int) -> int:
        """Largest chunk (tokens) whose modeled interference stays at or
        above target when dispatched behind every `duty`-th window."""
        w = duty * n_decoding * window
        return int(w * (1.0 - self.target)
                   / (self.target * self.effective_cost_ratio))

    def modeled_interference(self, duty: int, n_decoding: int, window: int,
                             chunk_tokens: int) -> float:
        w = duty * n_decoding * window
        c = chunk_tokens * self.effective_cost_ratio
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
        # Admission prefix-match accounting (tokens): hit = prompt tokens
        # whose prefill the cache skipped, miss = tokens computed.  A
        # re-admission after preemption counts again.
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        # Flight-recorder breadcrumbs for admissions and preemptions (the
        # module singleton is a no-op until the process enables it).
        self.flight = flight_recorder.get_recorder()
        # QoS pressure: `qos_pressure_fn() -> float` is the SLO monitor's
        # worst fast-window burn rate (the worker wires
        # `SloMonitor.last_max_burn`); at or above `qos_threshold`
        # best-effort (priority <= 0) admissions hold and running
        # best-effort requests are shed one per plan() while a higher
        # class waits.  `qos_preempt_sink(req)` executes the preempt (the
        # engine's `_qos_preempt`); without a sink it is plain preempt().
        self.qos_pressure_fn: Optional[Callable[[], float]] = None
        self.qos_threshold: float = 1.0
        self.qos_preempt_sink: Optional[Callable[[Request], None]] = None
        self.qos_preemptions = 0          # cumulative victims
        self.qos_active = False           # pressure state at last plan()

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

    def _qos_pressure(self) -> bool:
        """True while the installed SLO burn signal is at or above the
        QoS threshold (a broken or missing signal reads as no pressure:
        QoS must never wedge admission)."""
        fn = self.qos_pressure_fn
        if fn is None:
            return False
        try:
            burn = fn()
        except Exception:
            return False
        return burn is not None and burn >= self.qos_threshold

    def _next_admit_index(self, pressure: bool) -> Optional[int]:
        """Waiting index to admit next: highest priority class first,
        FCFS within a class; under SLO-burn pressure best-effort
        (priority <= 0) requests hold in the queue."""
        best = None
        best_p = None
        for i, r in enumerate(self.waiting):
            if pressure and r.priority <= 0:
                continue
            if best is None or r.priority > best_p:
                best, best_p = i, r.priority
        return best

    def _qos_victim(self, min_priority: int) -> Optional[Request]:
        """Newest running request of the lowest class strictly below
        `min_priority`: the least-progressed work of the most
        preemptible class."""
        victims = [r for r in self.running if r.priority < min_priority]
        if not victims:
            return None
        low = min(r.priority for r in victims)
        return [r for r in victims if r.priority == low][-1]

    def _qos_preempt(self, req: Request) -> None:
        """One QoS preemption through the engine's sink; a bare
        scheduler preempts in place."""
        self.qos_preemptions += 1
        sink = self.qos_preempt_sink
        if sink is not None:
            sink(req)
        else:
            self.preempt(req)

    def _qos_shed(self) -> None:
        """SLO burn at or above threshold: shed ONE running best-effort
        request per plan(), but only while a higher class is running or
        waiting (an all-best-effort fleet has nobody to yield to)."""
        if not (any(r.priority > 0 for r in self.waiting)
                or any(r.priority > 0 for r in self.running)):
            return
        victims = [r for r in self.running if r.priority <= 0]
        if victims:
            self._qos_preempt(victims[-1])

    def _try_admit(self) -> None:
        usable = self.allocator.num_blocks - 1
        pressure = self.qos_active
        while self.waiting and len(self.running) < self.config.max_seqs:
            idx = self._next_admit_index(pressure)
            if idx is None:
                break  # only held best-effort requests remain queued
            req = self.waiting[idx]
            slot = next(
                (i for i, s in enumerate(self._slots) if s is None), None)
            if slot is None:
                break
            # Prefix-cache match first: cached pages are pinned and reused,
            # only the remainder needs fresh pages.
            if req.block_hashes is None:
                req.block_hashes = self.allocator.prompt_hashes(
                    req.prompt_tokens)
            cached_tokens, cached_pages = self.allocator.match(
                req.prompt_tokens, req.block_hashes)
            need = self._pages_needed(len(req.prompt_tokens) + 1)
            need_new = max(0, need - len(cached_pages))
            # Admit only if the new pages fit and leave the watermark.
            if self.allocator.free_blocks - need_new < WATERMARK * usable:
                if cached_pages:
                    self.allocator.release(cached_pages)
                # Priority preemption: a capacity-blocked higher class
                # displaces the newest strictly-lower-class request and
                # the admission retries with the freed pages.
                victim = self._qos_victim(req.priority)
                if victim is not None:
                    self._qos_preempt(victim)
                    continue
                # Nothing running means nothing will ever free pages — the
                # head request can never fit; fail it instead of spinning.
                if not self.running:
                    self.waiting.pop(idx)
                    req.state = RequestState.FINISHED
                    req.finish_reason = FinishReason.LENGTH
                break
            self.waiting.pop(idx)
            req.pages = list(cached_pages) + self.allocator.allocate(need_new)
            # The cached prefix skips prefill, but the last prompt token is
            # always recomputed so admission yields logits (a fully cached
            # prompt rewrites that token's slot in its shared last page).
            req.prefilled = min(cached_tokens, len(req.prompt_tokens) - 1)
            req.cached_prompt_tokens = req.prefilled
            self.prefix_hit_tokens += req.prefilled
            self.prefix_miss_tokens += len(req.prompt_tokens) - req.prefilled
            req.slot = slot
            self._slots[slot] = req
            req.state = RequestState.PREFILL
            self.running.append(req)
            fl = self.flight
            if fl.enabled:
                fl.record("admit", rid=req.request_id,
                          prompt=len(req.prompt_tokens),
                          cached=cached_tokens, new_pages=need_new)

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
        self.qos_active = self._qos_pressure()
        if self.qos_active:
            self._qos_shed()
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
            if req.prefill_start_ts is None:
                req.prefill_start_ts = time.monotonic()
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
        req.preempts += 1
        fl = self.flight
        if fl.enabled:
            fl.record("sched_preempt", rid=req.request_id,
                      output=len(req.output_tokens),
                      pages=len(req.pages))
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
        req.block_hashes = None  # prompt changed: re-hash on re-admission
        req.state = RequestState.WAITING
        self.waiting.insert(0, req)

    # -- completion callbacks --------------------------------------------

    def prefill_done(self, work: PrefillWork) -> None:
        req = work.request
        req.prefilled += work.length
        if req.prefilled >= len(req.prompt_tokens):
            req.state = RequestState.DECODE
            req.prefill_end_ts = time.monotonic()

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
