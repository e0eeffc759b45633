"""Eager KV-block streaming: pull sealed blocks WHILE a remote prefill runs
(port of `dynamo_tpu/llm/block_manager/eager.py`).

- the prefill worker publishes incremental announcements (its sealed-hash
  high-water mark and RPC address) as chunks seal (disagg.py
  `prefill_worker_loop` over the engine's seal-progress stream);
- the `EagerPuller` here pulls the newly sealed blocks with bounded
  in-flight concurrency while the prefill is still running, injecting
  contiguous prefixes as they land;
- at prefill-done only the residual tail is fetched, so disagg TTFT is
  about `max(prefill, transfer) + tail`.

Given a `KvTransferPlane` the stream rides the device plane: each batch
is one `pull_blocks_device` round (offer -> device pull -> ack).  The
first holder refusal (offer cap, unreachable fabric, nothing resident)
switches the rest of the request to the host-staged wire, counted by
`note_plane`, and never fails the request.

A prefill worker that dies mid-stream (`abort()`) leaves whatever
contiguous prefix landed injected and registered; the caller's local
prefill fallback prefix-matches those blocks and recomputes the rest.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Dict, List

import torch

from dynamo_tpu_torch.llm.block_manager.device_transfer import (
    note_plane,
    pull_prefix_device,
    try_pull_device,
)
from dynamo_tpu_torch.llm.block_manager.transfer import (
    BATCH_BLOCKS,
    PULL_INFLIGHT,
    fetch_blocks,
    inject_run,
    nbytes,
    pull_prefix,
    sealed_hashes,
)
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.rpc import RpcError

logger = logging.getLogger(__name__)


class EagerPuller:
    """Streams one pending request's sealed KV blocks from its prefill
    worker as seal-progress announcements arrive.

    `rpc_for(address)` returns a (cached) RpcClient for a peer: the
    announcements carry the address.  Every method runs on the caller's
    event loop; `on_progress` is synchronous and only schedules bounded
    pull tasks."""

    def __init__(self, engine, rpc_for: Callable[[str], object],
                 prompt_tokens: List[int], block_size: int, *,
                 plane=None) -> None:
        """`plane`: a started KvTransferPlane; batches then pull device to
        device (host-staged stays the per-request fallback)."""
        self.engine = engine
        self._rpc_for = rpc_for
        self.prompt_tokens = list(prompt_tokens)
        self.block_size = block_size
        self.hashes = sealed_hashes(self.prompt_tokens, block_size)
        self.plane = plane
        self._device_off = plane is None   # sticky host fallback
        # Why host batches ride the host plane.
        self._host_reason = "no_plane" if plane is None else "fallback"
        self.device_blocks = 0     # blocks that crossed device to device
        self._sem = asyncio.Semaphore(PULL_INFLIGHT)
        self._tasks: List[asyncio.Task] = []
        self._ready: Dict[int, torch.Tensor] = {}   # block index -> data
        self._inject_lock = asyncio.Lock()
        self._scheduled = 0        # blocks handed to pull tasks
        self._closed = False       # abort() called: stop pulling
        self._announced = False    # finish() entered: no new schedules
        self.covered_blocks = 0    # contiguous prefix injected locally
        self.streamed_blocks = 0   # blocks fetched by progress-driven pulls
        self.streamed_bytes = 0
        # Snapshotted at finish(): what had landed when prefill-done came.
        self.early_blocks = 0
        self.early_bytes = 0
        # Pull rounds begun before and after prefill-done.
        self.early_pulls = 0
        self.done_pulls = 0

    @property
    def covered_tokens(self) -> int:
        return self.covered_blocks * self.block_size

    @property
    def overlap_ratio(self) -> float:
        """Blocks pulled before prefill-done over the sealed blocks (the
        blocks are one size, so it is the byte ratio too)."""
        return self.early_blocks / len(self.hashes) if self.hashes else 0.0

    # -- streaming (while the remote prefill runs) --------------------------

    def on_progress(self, sealed_blocks: int, address: str) -> None:
        """A progress announcement: schedule pulls for every newly sealed
        block, in hash-chain order, in bounded batches.  A no-op once
        finish() or abort() has begun (the residual pull covers late
        blocks)."""
        if self._closed or self._announced or not address:
            return
        hwm = min(int(sealed_blocks), len(self.hashes))
        while self._scheduled < hwm:
            lo = self._scheduled
            hi = min(hwm, lo + BATCH_BLOCKS)
            self._scheduled = hi
            self._tasks.append(asyncio.ensure_future(
                self._pull_batch(lo, hi, address)))

    async def _pull_batch(self, lo: int, hi: int, address: str) -> None:
        async with self._sem:
            if self._closed:
                return
            self.early_pulls += 1
            blocks = None
            if not self._device_off:
                blocks, refusal = await try_pull_device(
                    self.plane, self._rpc_for(address),
                    self.hashes[lo:hi], context="eager",
                    site=f"eager stream from {address}")
                if refusal is not None:
                    self._device_off = True
                    self._host_reason = refusal
                else:
                    self.device_blocks += len(blocks)
            if blocks is None:
                note_plane("host", self._host_reason)
                try:
                    blocks = await fetch_blocks(
                        self._rpc_for(address), self.hashes[lo:hi],
                        batch=BATCH_BLOCKS)
                except (ConnectionError, OSError, RpcError) as e:
                    # A gap; the residual pass (or the local prefill
                    # fallback) covers it.
                    logger.warning("eager pull of blocks [%d, %d) from "
                                   "%s failed: %s", lo, hi, address, e)
                    return
            for j, h in enumerate(self.hashes[lo:hi]):
                if h in blocks:
                    self._ready[lo + j] = blocks[h]
            self.streamed_blocks += len(blocks)
            self.streamed_bytes += sum(nbytes(a) for a in blocks.values())
            try:
                await self._inject_ready()
            except ValueError as e:
                # Un-injectable blocks (a kv-quant mismatch): every block
                # would fail the same way; the residual pull in finish()
                # raises again, so the caller prefills locally.
                logger.error("eager pull from %s aborted — the peer's KV "
                             "blocks are not injectable here: %s",
                             address, e)
                self._closed = True
                self._ready.clear()

    async def _inject_ready(self) -> None:
        """Inject the longest new contiguous run; serialised so batch
        completions cannot race the frontier."""
        async with self._inject_lock:
            run: Dict[int, torch.Tensor] = {}
            i = self.covered_blocks
            while i in self._ready:
                run[self.hashes[i]] = self._ready.pop(i)
                i += 1
            self.covered_blocks, _ = await inject_run(
                self.engine, self.hashes, run, self.covered_blocks, i)

    async def _drain_tasks(self) -> None:
        while self._tasks:
            tasks, self._tasks = self._tasks, []
            await asyncio.gather(*tasks, return_exceptions=True)

    # -- completion / failure ------------------------------------------------

    async def finish(self, address: str) -> int:
        """Prefill-done: snapshot the overlap, let in-flight pulls land,
        then fetch only the residual tail.  Returns the tokens covered
        locally.  Transfer errors propagate: the caller falls back to a
        local prefill that reuses whatever landed."""
        self._announced = True
        self.early_blocks = min(self.streamed_blocks, len(self.hashes))
        self.early_bytes = self.streamed_bytes
        # `with` makes the span task-current: the residual pulls' spans
        # (and their RPC children) nest under the overall pull.
        with tracing.get_tracer().start_span(
                "kv.pull",
                attrs={"blocks_total": len(self.hashes),
                       "blocks_streamed": self.early_blocks,
                       "bytes_streamed": self.early_bytes}) as span:
            await self._drain_tasks()
            await self._inject_ready()
            self._ready.clear()  # non-contiguous islands: residual refetches
            covered = self.covered_tokens
            if covered < len(self.hashes) * self.block_size:
                self.done_pulls += 1
            if not self._device_off:
                # Device-first residual; a kv-quant ValueError propagates,
                # transport errors fall to the host residual.
                try:
                    covered = await pull_prefix_device(
                        self.engine, self.plane, self._rpc_for(address),
                        self.prompt_tokens, self.block_size,
                        covered_tokens=covered, context="eager")
                except (ConnectionError, OSError, RpcError,
                        RuntimeError) as e:
                    self._device_off = True
                    self._host_reason = "pull_failed"
                    logger.warning("eager device residual from %s failed "
                                   "(%s); host-staged residual", address, e)
                gained = covered // self.block_size - self.covered_blocks
                if gained > 0:
                    self.device_blocks += gained
                self.covered_blocks = max(self.covered_blocks,
                                          covered // self.block_size)
            before = covered
            covered = await pull_prefix(
                self.engine, self._rpc_for(address), self.prompt_tokens,
                self.block_size, covered_tokens=covered)
            if covered > before:
                note_plane("host", self._host_reason)
            span.set_attr(overlap_ratio=round(self.overlap_ratio, 4),
                          tokens_covered=covered)
        self._closed = True   # late announcements are no-ops now
        return covered

    async def abort(self) -> int:
        """Mid-stream failure: cancel outstanding pulls and keep the landed
        contiguous prefix.  Returns the tokens covered (injected and
        registered, so the caller's local prefill matches them)."""
        self._closed = True
        for t in self._tasks:
            t.cancel()
        await self._drain_tasks()
        try:
            await self._inject_ready()
        except Exception:
            logger.exception("eager pull: injecting the landed prefix failed")
        self._ready.clear()
        return self.covered_tokens
