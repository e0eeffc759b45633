"""Fleet-wide prefix reuse: pull a peer worker's sealed prefix blocks
(port of `dynamo_tpu/llm/block_manager/prefix_share.py`).  A pull is a
`kv.prefix_share` span, and a hinted request's pull stamps its ledger's
`kv_transfer` phase.

KV-carrying migration: a stream that a draining worker handed off is
re-issued by the frontend's MigrationClient with a `migrate_kv`
annotation (`MIGRATE_ANNOTATION`) naming the draining worker's address
and the stream's sealed high-water mark; `PrefixShareClient` pulls that
prefix before admission, ahead of any router hint, so the resumed stream
prefills only its unsealed tail.

When the KV router sends a request to a worker whose own overlap is poor
while a peer's is deep, it attaches a remote-prefix hint
(`kv_router/scheduler.py pick_donor`): the donor's RPC address and its
covered-token high-water mark.  The serving worker consumes the hint
here, before admission:

- `PrefixFetcher` pulls the donor's sealed blocks in bounded in-flight
  batches, injects contiguous runs as they land, and mops up with a
  `pull_prefix(covered_tokens=...)` residual.  With a `KvTransferPlane`
  it pulls device first: each batch probes the donor's `kv_offer`, and
  only the gaps — batches the holder refused (offer cap, unreachable
  fabric) or blocks it no longer holds — ride the host-staged
  `kv_blocks` wire in a gap-only refetch;
- `PrefixShareClient` wraps the worker's serving EngineClient: hint ->
  pull -> delegate, so the engine's admission prefix match skips prefill
  for every pulled token.

A dead donor, a hash-chain gap or a timeout leaves the landed contiguous
prefix injected and falls back to local prefill; a kv-quant mismatch
between peers is refused loudly at inject.  Prefix sharing is an
optimisation, never a correctness dependency.  Every worker with an
engine serves `kv_blocks` and `kv_offer`, so every worker is a donor.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Callable, Dict, List, Optional

import torch

from dynamo_tpu_torch.llm.block_manager.device_transfer import (
    note_plane,
    try_pull_device,
)
from dynamo_tpu_torch.llm.block_manager.transfer import (
    BATCH_BLOCKS,
    PULL_INFLIGHT,
    fetch_blocks,
    inject_run,
    pull_prefix,
    resident_blocks,
    sealed_hashes,
)
from dynamo_tpu_torch.runtime import flight_recorder, tracing
from dynamo_tpu_torch.runtime.contracts import never_engine_thread
from dynamo_tpu_torch.runtime.ledger import ledger_of
from dynamo_tpu_torch.runtime.rpc import RpcError

logger = logging.getLogger(__name__)

# Annotation key the router sets and the worker consumes; riding the
# request's annotations keeps the wire codec unchanged.
HINT_ANNOTATION = "remote_prefix"
# KV-carrying migration: the frontend's MigrationClient sets this on a
# drain-handoff re-issue.  A key of its own, because the KV router
# rewrites HINT_ANNOTATION on every routing decision.
MIGRATE_ANNOTATION = "migrate_kv"


def encode_hint(address: str, covered_tokens: int, worker_id=None) -> str:
    """Router side: the hint as the annotation's string value."""
    d = {"address": address, "covered_tokens": int(covered_tokens)}
    if worker_id is not None:
        d["worker"] = str(worker_id)
    return json.dumps(d)


def decode_hint(raw: Optional[str]) -> Optional[dict]:
    """Worker side: parse the hint; a malformed one decodes to None
    (never fail a request over a hint)."""
    if not raw:
        return None
    try:
        d = json.loads(raw)
        address = d.get("address")
        covered = int(d.get("covered_tokens", 0))
        if not address or covered <= 0:
            return None
        return {"address": address, "covered_tokens": covered,
                "worker": d.get("worker")}
    except (ValueError, TypeError, AttributeError):
        logger.warning("ignoring malformed remote_prefix hint: %r", raw)
        return None


def attach_hint(request, address: str, covered_tokens: int,
                worker_id=None) -> None:
    """Attach a remote-prefix hint to a PreprocessedRequest."""
    request.annotations[HINT_ANNOTATION] = encode_hint(
        address, covered_tokens, worker_id)


class PrefixFetcher:
    """Pulls a peer's sealed prefix blocks into the local engine.  One per
    worker; it owns the cumulative counters the worker reports.

    `rpc_for(address)` returns a (cached) RpcClient."""

    def __init__(self, engine, rpc_for: Callable[[str], object],
                 block_size: int, *,
                 max_inflight: int = PULL_INFLIGHT,
                 batch_blocks: int = BATCH_BLOCKS,
                 pull_timeout: Optional[float] = None,
                 plane=None) -> None:
        """`pull_timeout`: hard per-pull budget in seconds; by default
        2 s + 50 ms a block, at most 30 s, so a trickling donor cannot
        hold TTFT far past a local prefill.  `plane`: a started
        KvTransferPlane, for device-first pulls."""
        self.engine = engine
        self._rpc_for = rpc_for
        self.block_size = block_size
        self.max_inflight = max(1, max_inflight)
        self.batch_blocks = max(1, batch_blocks)
        self.pull_timeout = pull_timeout
        self.plane = plane
        # One pull per prefix head at a time: a burst sharing a root
        # fetches it once; the rest wait and find the blocks resident.
        self._inflight: Dict[int, List] = {}   # head hash -> [lock, refs]
        self.reset_stats()

    def reset_stats(self) -> None:
        self.remote_hits = 0            # pulls that landed >= 1 new block
        self.pulled_blocks = 0          # blocks injected from peers
        self.pulled_tokens = 0
        self.device_pulled_blocks = 0   # of them, device to device
        self.fallbacks = 0              # failed/refused pulls
        # Hinted requests at admission: the prefix tokens their pull left
        # resident, and the prefix-cache hits admission then found.  A
        # covered token admission missed was prefilled again.
        self.hinted_admissions = 0
        self.hinted_covered_tokens = 0
        self.hinted_hit_tokens = 0
        self.reprefilled_tokens = 0
        # KV-carrying migration landings: migrate hints consumed with
        # >= 1 block pulled (`dynamo_requests_migrated_in_total`).
        self.migrated_in = 0
        self.migrated_in_blocks = 0

    def stats(self) -> dict:
        return {"remote_hits": self.remote_hits,
                "pulled_blocks": self.pulled_blocks,
                "pulled_tokens": self.pulled_tokens,
                "device_pulled_blocks": self.device_pulled_blocks,
                "fallbacks": self.fallbacks,
                "hinted_admissions": self.hinted_admissions,
                "hinted_covered_tokens": self.hinted_covered_tokens,
                "hinted_hit_tokens": self.hinted_hit_tokens,
                "reprefilled_tokens": self.reprefilled_tokens}

    def note_admission(self, prompt_len: int, covered: int,
                       cached: int) -> None:
        """Account one hinted request's admission: `covered` prompt tokens
        were resident after its pull, `cached` the prefix cache served
        (admission always recomputes the last prompt token)."""
        covered = min(covered, prompt_len - 1)
        self.hinted_admissions += 1
        self.hinted_covered_tokens += covered
        self.hinted_hit_tokens += cached
        self.reprefilled_tokens += max(0, covered - cached)

    def _timeout_for(self, blocks: int) -> float:
        if self.pull_timeout is not None:
            return self.pull_timeout
        return min(30.0, 2.0 + 0.05 * blocks)

    async def pull(self, prompt_tokens: List[int], address: str,
                   covered_tokens: int = 0,
                   stats: Optional[dict] = None) -> int:
        """Pull up to `covered_tokens` (the donor's high-water mark; <= 0:
        every sealed block) of the prompt's sealed prefix from the peer at
        `address`.  Returns the tokens now covered locally.  Never raises:
        errors count a fallback and return the landed prefix.  `stats`
        gets this call's `gained_blocks`."""
        if stats is None:
            stats = {}
        stats["gained_blocks"] = 0
        hashes = sealed_hashes(list(prompt_tokens), self.block_size)
        want_blocks = len(hashes)
        if covered_tokens > 0:
            want_blocks = min(want_blocks, covered_tokens // self.block_size)
        if want_blocks <= 0:
            return 0
        hashes = hashes[:want_blocks]
        entry = self._inflight.get(hashes[0])
        if entry is None:
            entry = self._inflight[hashes[0]] = [asyncio.Lock(), 0]
        entry[1] += 1
        try:
            async with entry[0]:
                return await self._pull_locked(prompt_tokens, address,
                                               hashes, want_blocks, stats)
        finally:
            entry[1] -= 1
            if entry[1] == 0:
                self._inflight.pop(hashes[0], None)

    async def _pull_locked(self, prompt_tokens, address: str,
                           hashes: List[int], want_blocks: int,
                           stats: dict) -> int:
        # A locally resident prefix needs no wire work (a repeat, an
        # earlier pull, or a disagg onboard already landed it).
        local = await resident_blocks(self.engine, hashes)
        if local >= want_blocks:
            return local * self.block_size
        # The frontier survives a failed pull: blocks that landed stay
        # injected, and the local prefill fallback matches them.
        progress = {"frontier": local}
        with tracing.get_tracer().start_span(
                "kv.prefix_share",
                attrs={"donor": address, "blocks_wanted": want_blocks,
                       "blocks_local": local}) as span:
            try:
                covered = await asyncio.wait_for(
                    self._pull_batches(hashes, local, address,
                                       list(prompt_tokens), progress),
                    self._timeout_for(want_blocks - local))
            except (asyncio.TimeoutError, ConnectionError, OSError,
                    RpcError) as e:
                self.fallbacks += 1
                covered = progress["frontier"] * self.block_size
                span.set_attr(fallback="local", error=type(e).__name__)
                logger.warning(
                    "remote-prefix pull from %s failed (%s); prefilling "
                    "locally%s", address, e,
                    f" (reusing {covered} landed tokens)" if covered else "")
            except ValueError as e:
                # A kv-quant mismatch between peers: refuse the donor
                # loudly and prefill locally rather than serve corrupt KV.
                self.fallbacks += 1
                covered = progress["frontier"] * self.block_size
                span.set_attr(fallback="local", error="kv_mode_mismatch")
                logger.error(
                    "remote-prefix pull from %s REFUSED — the peer's KV "
                    "blocks are not injectable here (mixed --kv-quant "
                    "modes?): %s", address, e)
            gained = covered // self.block_size - local
            if gained > 0:
                self.remote_hits += 1
                self.pulled_blocks += gained
                self.pulled_tokens += gained * self.block_size
            stats["gained_blocks"] = max(0, gained)
            span.set_attr(blocks_pulled=max(0, gained),
                          tokens_covered=covered)
            return covered

    async def _pull_batches(self, hashes: List[int], local: int,
                            address: str, prompt_tokens: List[int],
                            progress: Dict[str, int]) -> int:
        """Bounded in-flight batch pulls over [local, len(hashes)) with an
        ordered inject frontier; gaps a failed batch left are refetched
        gap-only (post-gap blocks on hand are reused), then one
        `pull_prefix` residual.  Mirrors the frontier into `progress`.
        kv-quant ValueErrors and terminal transfer errors propagate."""
        sem = asyncio.Semaphore(self.max_inflight)
        ready: Dict[int, torch.Tensor] = {}
        inject_lock = asyncio.Lock()
        frontier = local
        refused: List[ValueError] = []
        stalled = [False]             # the pool refused injects
        rpc = self._rpc_for(address)

        async def inject_ready():
            nonlocal frontier
            async with inject_lock:
                run: Dict[int, torch.Tensor] = {}
                i = frontier
                while i in ready:
                    run[hashes[i]] = ready.pop(i)
                    i += 1
                frontier, short = await inject_run(
                    self.engine, hashes, run, frontier, i)
                if short:
                    stalled[0] = True   # no capacity: stop pulling
                progress["frontier"] = frontier

        use_device = [self.plane is not None]
        host_reason = ["no_plane" if self.plane is None else "fallback"]

        async def pull_batch(lo: int, hi: int):
            async with sem:
                if refused or stalled[0]:
                    return
                blocks = None
                if use_device[0]:
                    # A holder refusal switches the rest of this pull to
                    # the host wire; a subset grant keeps what it got and
                    # the gap refetch fetches the rest.
                    blocks, refusal = await try_pull_device(
                        self.plane, rpc, hashes[lo:hi], context="prefix",
                        site=f"prefix share from {address}")
                    if refusal is not None:
                        use_device[0] = False
                        host_reason[0] = refusal
                    else:
                        self.device_pulled_blocks += len(blocks)
                if blocks is None:
                    note_plane("host", host_reason[0])
                    try:
                        blocks = await fetch_blocks(
                            rpc, hashes[lo:hi], batch=self.batch_blocks)
                    except (ConnectionError, OSError, RpcError) as e:
                        logger.warning("prefix-share batch [%d, %d) from "
                                       "%s failed: %s", lo, hi, address, e)
                        return   # a gap: the refetch pass covers it
                for j, h in enumerate(hashes[lo:hi]):
                    if h in blocks:
                        ready[lo + j] = blocks[h]
                try:
                    await inject_ready()
                except ValueError as e:
                    refused.append(e)
                    ready.clear()

        tasks = [asyncio.ensure_future(pull_batch(
                    lo, min(lo + self.batch_blocks, len(hashes))))
                 for lo in range(local, len(hashes), self.batch_blocks)]
        if tasks:
            await asyncio.gather(*tasks)
        if refused:
            raise refused[0]
        # Gap refetch: fetch only the missing ranges and let the frontier
        # run through the held islands; a donor that lost the gap head
        # ends the pass.
        while frontier < len(hashes) and not stalled[0]:
            gap_end = frontier
            while gap_end < len(hashes) and gap_end not in ready:
                gap_end += 1
            before = frontier
            if gap_end > frontier:
                try:
                    blocks = await fetch_blocks(
                        rpc, hashes[frontier:gap_end],
                        batch=self.batch_blocks)
                except (ConnectionError, OSError, RpcError):
                    break   # donor gone: pull_prefix below judges
                if blocks:
                    note_plane("host", "gap_refetch")
                for j, h in enumerate(hashes[frontier:gap_end]):
                    if h not in blocks:
                        break
                    ready[frontier + j] = blocks[h]
            await inject_ready()
            if frontier <= before:
                break
        ready.clear()
        if stalled[0] or frontier >= len(hashes):
            return frontier * self.block_size
        # Terminal residual from the contiguous frontier; a dead donor
        # raises here, which makes the pull a counted fallback.
        before_resid = frontier * self.block_size
        covered = await pull_prefix(
            self.engine, rpc,
            prompt_tokens[: len(hashes) * self.block_size],
            self.block_size, covered_tokens=before_resid)
        if covered > before_resid:
            note_plane("host", "residual")
        return covered


class PrefixShareClient:
    """EngineClient wrapper: consume the routed request's remote-prefix
    hint, then delegate.  The worker installs it innermost, in front of
    the local engine and inside any disagg decode client, so on a decode
    worker the pull runs after a remote-prefill onboard (whose blocks are
    then resident, and the residency check skips the wire)."""

    def __init__(self, inner, fetcher: PrefixFetcher) -> None:
        self.inner = inner
        self.fetcher = fetcher

    @never_engine_thread
    async def generate(self, request):
        led = ledger_of(request)
        covered = None
        # KV-carrying migration first: the migrate hint covers prompt +
        # already-generated tokens of a handed-off stream, so it
        # supersedes any router hint for the same blocks (the residency
        # check makes the second pull a no-op anyway).
        mig = decode_hint(request.annotations.get(MIGRATE_ANNOTATION))
        if mig is not None:
            pull_stats: dict = {}
            t0 = time.monotonic()
            dev0 = self.fetcher.device_pulled_blocks
            covered = await self.fetcher.pull(
                request.token_ids, mig["address"], mig["covered_tokens"],
                stats=pull_stats)
            gained = pull_stats.get("gained_blocks", 0)
            if gained > 0:
                self.fetcher.migrated_in += 1
                self.fetcher.migrated_in_blocks += gained
            if led is not None and gained > 0:
                led.stamp(
                    "kv_transfer", dur=time.monotonic() - t0,
                    reason="migrate",
                    plane=("device" if self.fetcher.device_pulled_blocks
                           > dev0 else "host"),
                    blocks=gained, tokens=covered)
            fl = flight_recorder.get_recorder()
            if fl.enabled:
                fl.record("migrate_in", rid=request.request_id,
                          covered=covered, pulled=gained)
        hint = decode_hint(request.annotations.get(HINT_ANNOTATION))
        if hint is not None:
            pull_stats = {}
            t0 = time.monotonic()
            dev0 = self.fetcher.device_pulled_blocks
            covered = max(covered or 0, await self.fetcher.pull(
                request.token_ids, hint["address"], hint["covered_tokens"],
                stats=pull_stats))
            gained = pull_stats.get("gained_blocks", 0)
            if led is not None and gained > 0:
                led.stamp(
                    "kv_transfer", dur=time.monotonic() - t0,
                    reason="prefix",
                    plane=("device" if self.fetcher.device_pulled_blocks
                           > dev0 else "host"),
                    blocks=gained, tokens=covered,
                    donor=str(hint.get("worker") or hint["address"]))
        async for delta in self.inner.generate(request):
            if covered is not None and delta.cached_tokens is not None:
                self.fetcher.note_admission(len(request.token_ids), covered,
                                            delta.cached_tokens)
                covered = None
            yield delta
