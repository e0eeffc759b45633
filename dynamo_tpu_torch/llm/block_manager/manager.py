"""Tiered KV block manager: G1 device / G2 pinned host / G3 disk, and the
G4 remote hook (port of `dynamo_tpu/llm/block_manager/manager.py`).

The device tier's KV bytes live in the engine's paged cache; the manager
keeps the pool of its pages: prefix matching, pinning, allocation,
registration of sealed blocks and release.  The engine hands it its
batched `extract_fn(pages) -> [n, *wire]` and `inject_fn(pages, data)`
so the manager stays agnostic of the cache layout.  Below G1:

- G2 is one pinned host tensor `[host_blocks, *wire]` at the wire dtype
  (the shape is known from the cache config, so no offload waits to
  learn it);
- G3 is a raw-byte memmap `[disk_blocks, block_nbytes]` (numpy has no
  bfloat16), viewed back at the wire dtype and shape; its file is
  created under the temp dir unless `disk_path` names one, and `close`
  removes it;
- G4 is `remote_fetch_fn(block_hash) -> Optional[tensor]`, consulted when
  a prefix block misses every local tier (synchronous and bounded: the
  caller is the engine thread).

**Offload** (G1 eviction -> G2, G2 eviction -> G3).  The pool's eviction
hook does the host-side bookkeeping per block, in JAX's order (G2
allocation, registration, counts, breadcrumbs), and queues the block.
The copies run once per call that can evict (`allocate`,
`demote_blocks`, `match_and_onboard`, `import_blocks`), before it
returns: one `extract_fn` over the batch on the engine's stream (before
anything can rewrite the evicted pages), then on a dedicated copy stream,
which first waits on an event recorded on the engine's stream, one
device-to-host copy per run of consecutive G2 slots.  Each pending block
keeps its staging tensor and the copy's event until the event completes;
a host reader of its G2 bytes (a spill to G3, an export) synchronizes
that event only, a device reader (an onboard) makes the engine's stream
wait on it.  At most `MAX_PENDING_BLOCKS` blocks stay pending: completed
copies are reaped by query, and only a backlog past the cap waits on the
oldest.  On the CPU the copies are plain synchronous `copy_`s.

**Onboard** (`match_and_onboard`): the G1 prefix, then G2 -> G3 -> G4
block by block (capacity and inject guards first, as in JAX), the run of
lower-tier hits copied to the device together and injected with one
`inject_fn` call on the engine's stream.
"""

from __future__ import annotations

import logging
import math
import os
import tempfile
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.llm.block_manager.pool import BlockPool
from dynamo_tpu_torch.runtime import flight_recorder
from dynamo_tpu_torch.runtime.contracts import (
    engine_thread_only,
    hot_path,
    never_engine_thread,
)

logger = logging.getLogger(__name__)

ExtractFn = Callable[[List[int]], torch.Tensor]
InjectFn = Callable[[List[int], torch.Tensor], None]
RemoteFetchFn = Callable[[int], Optional[torch.Tensor]]

# Blocks whose device-to-host copy may be in flight at once (JAX's cap):
# each pins its share of a device staging tensor.
MAX_PENDING_BLOCKS = 16


@dataclass(frozen=True)
class TieredConfig:
    """Capacities per tier, in blocks."""

    device_blocks: int           # G1, includes the reserved null block 0
    host_blocks: int = 0         # G2; 0 disables the tier
    disk_blocks: int = 0         # G3; 0 disables
    block_size: int = 64
    disk_path: Optional[str] = None   # default: a file in the temp dir


class _Landing:
    """One flushed batch's device-to-host copy: its completion event on
    the copy stream and the staging tensor it reads, kept alive until a
    reader settles the event (the tensor is also recorded on the copy
    stream, so a G2 eviction may drop the entry without waiting)."""

    __slots__ = ("event", "staged")

    def __init__(self, event, staged: torch.Tensor) -> None:
        self.event = event
        self.staged = staged


class KvBlockManager:
    """Owns the pools of every tier and the copies between them (page 0
    of G1, the null block, is never handed out)."""

    def __init__(self, config: TieredConfig,
                 extract_fn: Optional[ExtractFn] = None,
                 inject_fn: Optional[InjectFn] = None,
                 remote_fetch_fn: Optional[RemoteFetchFn] = None,
                 wire_shape: Optional[Tuple[int, ...]] = None,
                 wire_dtype: Optional[torch.dtype] = None,
                 device=None) -> None:
        """`wire_shape` / `wire_dtype` are one block's wire format (the
        engine's `KvCacheConfig.block_wire_shape` / `block_wire_dtype`),
        needed to size G2 and G3; `device` is the cache's: a CUDA device
        takes pinned G2 memory and the copy stream, anything else the
        synchronous CPU copies."""
        self.config = config
        self.extract_fn = extract_fn
        self.inject_fn = inject_fn
        self.remote_fetch_fn = remote_fetch_fn
        self.device = BlockPool(config.device_blocks, name="G1-device",
                                on_evict=self._on_device_evict,
                                reserve_null=True)
        self.host: Optional[BlockPool] = None
        self.disk: Optional[BlockPool] = None
        self.offloaded_blocks = 0
        self.onboarded_blocks = 0
        self.remote_fetched_blocks = 0
        # Host seconds the allocations that offloaded spent, and the
        # blocks they offloaded (the engine thread's cost per eviction).
        self.host_alloc_s = 0.0
        self.offload_host_s = 0.0
        self.offload_host_blocks = 0
        self.backpressure_waits = 0
        # With a list here, each offload and onboard copy on a card
        # appends (kind, start event, end event, bytes): CUDA events on
        # the copy's own stream, read by the caller after a sync.
        self.copy_log: Optional[list] = None
        self._wire_shape = tuple(wire_shape) if wire_shape else None
        self._wire_dtype = wire_dtype
        self._dev = torch.device(device) if device is not None else None
        self._cuda = self._dev is not None and self._dev.type == "cuda"
        self._copy_stream = None
        self._host_data: Optional[torch.Tensor] = None
        self._disk_np: Optional[np.ndarray] = None
        self._disk_file: Optional[str] = None
        # Evicted G1 blocks whose copies are not enqueued yet:
        # (hash, G1 page, G2 slot), and their hashes.
        self._evicted: List[Tuple[int, int, int]] = []
        self._evicted_hashes: set = set()
        # hash -> its copy in flight, oldest first.
        self._pending: "OrderedDict[int, _Landing]" = OrderedDict()
        # Lower-tier blocks matched but not copied up yet:
        # (G1 page, hash, source, G2 slot or None).
        self._run: List[tuple] = []
        if config.host_blocks or config.disk_blocks:
            if self._wire_shape is None or self._wire_dtype is None:
                raise ValueError("the host and disk tiers need the block "
                                 "wire shape and dtype")
        if config.host_blocks:
            self.host = BlockPool(config.host_blocks, name="G2-host",
                                  on_evict=self._on_host_evict)
            t0 = time.monotonic()
            self._host_data = torch.empty(
                (config.host_blocks, *self._wire_shape),
                dtype=self._wire_dtype, pin_memory=self._cuda)
            self.host_alloc_s = time.monotonic() - t0
            if self._cuda:
                self._copy_stream = torch.cuda.Stream(self._dev)
        if config.disk_blocks:
            self.disk = BlockPool(config.disk_blocks, name="G3-disk")
            nbytes = (math.prod(self._wire_shape)
                      * torch.empty((), dtype=self._wire_dtype).element_size())
            path = config.disk_path
            if path is None:
                fd, path = tempfile.mkstemp(prefix="dynamo_tpu_torch_kv_",
                                            suffix=".npy")
                os.close(fd)
            self._disk_file = path
            self._disk_np = np.lib.format.open_memmap(
                path, mode="w+", dtype=np.uint8,
                shape=(config.disk_blocks, nbytes))

    # -- tier storage -------------------------------------------------------

    def _disk_block(self, dslot: int) -> torch.Tensor:
        """G3 slot `dslot` as a CPU tensor of the wire format (a view of
        the memmap)."""
        return (torch.from_numpy(self._disk_np[dslot])
                .view(self._wire_dtype).view(self._wire_shape))

    # -- offload path (down-tier) -------------------------------------------

    @hot_path
    def _on_device_evict(self, block_hash: int, page: int) -> None:
        """G1 eviction: take a G2 slot for the block and queue its copy
        (flushed before the evicting call returns)."""
        if self.host is None or self.extract_fn is None:
            return
        if self.host.registry.lookup(block_hash) is not None:
            return  # already resident down-tier
        if not self.host.can_allocate(1):
            return  # G2 fully pinned
        [hslot] = self.host.allocate(1)
        self.host.register(hslot, block_hash)
        self.host.release([hslot])       # -> inactive: resident, evictable
        self._evicted.append((block_hash, page, hslot))
        self._evicted_hashes.add(block_hash)
        self.offloaded_blocks += 1
        fl = flight_recorder.get_recorder()
        if fl.enabled:
            fl.record("tier_demote", src="G1", dst="G2", slot=hslot)

    @hot_path
    def _stage(self) -> Optional[tuple]:
        """Enqueue the extract of every queued evicted page on the engine's
        stream (before any later write to those pages); returns what
        `_land` copies down, or None when nothing was evicted."""
        if not self._evicted:
            return None
        batch, self._evicted = self._evicted, []
        self._evicted_hashes = set()
        return batch, self.extract_fn([page for _, page, _ in batch])

    @hot_path
    def _land(self, staged: Optional[tuple]) -> None:
        """Copy a staged batch into its G2 slots: on the copy stream after
        an event on the engine's stream, so it follows the extract and
        every onboard copy already enqueued there.  A later offload into a
        G2 slot that an onboard still reads therefore never overtakes that
        read: keep this wait on every offload."""
        if staged is None:
            return
        batch, data = staged
        runs = []                        # (first batch row, first slot, n)
        for i, (_, _, hslot) in enumerate(batch):
            if runs and runs[-1][1] + runs[-1][2] == hslot:
                runs[-1][2] += 1
            else:
                runs.append([i, hslot, 1])
        if not self._cuda:
            for i, s, n in runs:
                self._host_data[s:s + n].copy_(data[i:i + n])
            return
        self._reap()
        while self._pending and (len(self._pending) + len(batch)
                                 > MAX_PENDING_BLOCKS):
            self.backpressure_waits += 1
            self._settle_host(next(iter(self._pending)))
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self._dev))
        stream = self._copy_stream
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            timed = self._timed_start(stream)
            for i, s, n in runs:
                self._host_data[s:s + n].copy_(data[i:i + n],
                                               non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            self._timed_end(timed, stream, "offload", data)
        data.record_stream(stream)   # the allocator must not reuse it early
        landing = _Landing(done, data)
        for h, _, _ in batch:
            self._pending.pop(h, None)
            self._pending[h] = landing

    def _timed_start(self, stream):
        if self.copy_log is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _timed_end(self, start, stream, kind: str, data) -> None:
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self.copy_log.append(
                (kind, start, end, data.numel() * data.element_size()))

    def _flush(self) -> None:
        """Enqueue every queued copy, in the one safe order: the evicted
        pages' extract (before the onboard overwrites them), the onboard
        run (reading G2 slots before any new offload lands in them), the
        offload's copies into G2."""
        staged = self._stage()
        try:
            self._onboard()
        finally:
            self._land(staged)

    def _reap(self) -> None:
        """Forget the pending copies that completed (by query: no wait)."""
        while self._pending:
            landing = next(iter(self._pending.values()))
            if not landing.event.query():
                return
            self._pending.popitem(last=False)

    def _settle_host(self, block_hash: int) -> bool:
        """Make `block_hash`'s G2 bytes readable on the host: enqueue its
        copy if it is still queued, then wait for that copy's event only.
        Returns False, and drops the G2 entry, when the copy failed."""
        if block_hash in self._evicted_hashes:
            self._flush()
        landing = self._pending.pop(block_hash, None)
        if landing is None:
            return True
        try:
            landing.event.synchronize()
            return True
        except Exception:
            logger.exception("offload of block %x failed; dropping its G2 "
                             "entry", block_hash)
            if self.host is not None:
                self.host.discard(block_hash)
            return False

    def _on_host_evict(self, block_hash: int, slot: int) -> None:
        """G2 eviction: spill the block to G3 (when there is one), after
        settling its pending copy, since the spill reads it on the host."""
        if self.disk is None:
            # Nobody reads these bytes again: the slot's next copy follows
            # this one on the copy stream, so no wait is needed.
            self._pending.pop(block_hash, None)
            return
        ok = self._settle_host(block_hash)
        if not ok or self.disk.registry.lookup(block_hash) is not None:
            return
        if not self.disk.can_allocate(1):
            return
        [dslot] = self.disk.allocate(1)
        self._disk_block(dslot).copy_(self._host_data[slot])
        self.disk.register(dslot, block_hash)
        fl = flight_recorder.get_recorder()
        if fl.enabled:
            fl.record("tier_demote", src="G2", dst="G3", slot=dslot)
        self.disk.release([dslot])
        self.offloaded_blocks += 1

    # -- onboard path (up-tier) ---------------------------------------------

    def _check_remote(self, data: torch.Tensor) -> None:
        """A G4 block must have this cache's format: an int8 packed block
        and a float block never convert into each other."""
        got_int8 = data.dtype == torch.int8
        if (tuple(data.shape) != self._wire_shape
                or got_int8 != (self._wire_dtype == torch.int8)):
            raise ValueError(
                f"KV block format mismatch: the remote tier sent "
                f"{data.dtype}{list(data.shape)} but this cache stores "
                f"{self._wire_dtype}{list(self._wire_shape)}; refusing to "
                "inject")

    def _lower_tier(self, block_hash: int):
        """(source, G2 slot or None) of a block resident below G1, searched
        G2 -> G3 -> G4, or None.  A G2 source is read from its slot when
        the run is copied up; G3 and G4 bytes are taken now."""
        if self.host is not None:
            hslot = self.host.registry.lookup(block_hash)
            if hslot is not None:
                if block_hash in self._evicted_hashes:
                    self._flush()        # evicted from G1 in this call
                landing = self._pending.get(block_hash)
                if landing is not None:
                    # The onboard copy reads after the offload copy lands.
                    torch.cuda.current_stream(self._dev).wait_event(
                        landing.event)
                return self._host_data[hslot.index], hslot.index
        if self.disk is not None:
            dslot = self.disk.registry.lookup(block_hash)
            if dslot is not None:
                return self._disk_block(dslot.index).clone(), None
        if self.remote_fetch_fn is not None:
            data = self.remote_fetch_fn(block_hash)
            if data is not None:
                self.remote_fetched_blocks += 1
                if self._wire_shape is not None:
                    self._check_remote(data)
                return data, None
        return None

    def _onboard(self) -> None:
        """Copy the queued run of lower-tier blocks to the device (one copy
        per run of consecutive G2 slots) and inject it with one call, on
        the engine's stream.  A page whose inject fails is dropped, never
        left registered over bytes it never got."""
        run, self._run = self._run, []
        if not run:
            return
        pages = [page for page, _, _, _ in run]
        try:
            if not self._cuda:
                self.inject_fn(pages, torch.stack([s for _, _, s, _ in run]))
                return
            data = torch.empty((len(run), *self._wire_shape),
                               dtype=self._wire_dtype, device=self._dev)
            stream = torch.cuda.current_stream(self._dev)
            timed = self._timed_start(stream)
            i = 0
            while i < len(run):
                _, _, src, hslot = run[i]
                n = 1
                if hslot is not None:
                    while i + n < len(run) and run[i + n][3] == hslot + n:
                        n += 1
                    src = self._host_data[hslot:hslot + n]
                data[i:i + n].copy_(src, non_blocking=True)
                i += n
            self._timed_end(timed, stream, "onboard", data)
            self.inject_fn(pages, data)
        except Exception:
            for _, h, _, _ in run:
                self.device.discard(h)
            self.device.release(pages)
            self.onboarded_blocks -= len(run)
            raise

    @engine_thread_only
    def match_and_onboard(self, hashes: Sequence[int]
                          ) -> Tuple[int, List[int]]:
        """The longest prefix of `hashes` resident in any tier, lower-tier
        blocks injected into fresh G1 pages, all pinned for the caller
        (release with `release`): (blocks, page ids)."""
        ids = self.device.acquire_matched(
            self.device.match_sequence_hashes(hashes))
        n = len(ids)
        # Capacity and inject guards come first: tiers below G2 read disk
        # or the network, wasted work for a block with nowhere to go.
        try:
            while n < len(hashes):
                if self.inject_fn is None or not self.device.can_allocate(1):
                    break
                h = hashes[n]
                found = self._lower_tier(h)
                if found is None:
                    break
                [page] = self.device.allocate(1)
                self.device.register(page, h)
                self._run.append((page, h, *found))
                ids.append(page)
                n += 1
                self.onboarded_blocks += 1
        finally:
            self._flush()
        return n, ids

    # -- cross-worker transfer ----------------------------------------------

    def resident_pages(self, hashes: Sequence[int]) -> Dict[int, int]:
        """hash -> page of every requested block resident in G1, in
        request order."""
        out: Dict[int, int] = {}
        for h in hashes:
            slot = self.device.registry.lookup(h)
            if slot is not None:
                out[h] = slot.index
        return out

    def resident_prefix(self, hashes: Sequence[int]) -> int:
        """Length of the contiguous prefix of `hashes` resident in any
        local tier (host lookups only)."""
        n = 0
        for h in hashes:
            if (self.device.registry.lookup(h) is None
                    and (self.host is None
                         or self.host.registry.lookup(h) is None)
                    and (self.disk is None
                         or self.disk.registry.lookup(h) is None)):
                break
            n += 1
        return n

    def extract(self, hashes: Sequence[int]
                ) -> Tuple[List[int], Optional[torch.Tensor]]:
        """(the G1-resident requested hashes in request order, their wire
        blocks as one [n, ...] staging tensor on the device that shares no
        storage with the cache), or ([], None): one extract a batch."""
        pages = self.resident_pages(hashes)
        if not pages or self.extract_fn is None:
            return [], None
        return list(pages), self.extract_fn(list(pages.values()))

    def export_blocks_device(self, hashes: Sequence[int]
                             ) -> Dict[int, torch.Tensor]:
        """The G1-resident requested blocks as device tensors: views of
        one staging tensor the caller owns.  Blocks only in G2/G3 are
        host-resident anyway: the host-staged plane serves them."""
        present, staged = self.extract(hashes)
        return dict(zip(present, staged.unbind(0))) if present else {}

    def export_block_device(self, block_hash: int) -> Optional[torch.Tensor]:
        """A G1-resident block as a device tensor, None otherwise."""
        return self.export_blocks_device([block_hash]).get(block_hash)

    def export_blocks(self, hashes: Sequence[int]) -> Dict[int, torch.Tensor]:
        """The wire bytes on the host (CPU tensors of their own) of every
        requested block resident in any tier, searched G1 -> G2 -> G3, in
        request order: one extract and one copy for the G1 blocks."""
        present, staged = self.extract(hashes)
        g1 = dict(zip(present, staged.cpu().unbind(0))) if present else {}
        out: Dict[int, torch.Tensor] = {}
        for h in hashes:
            if h in g1:
                out[h] = g1[h]
                continue
            if self.host is not None:
                hslot = self.host.registry.lookup(h)
                if hslot is not None and self._settle_host(h):
                    out[h] = self._host_data[hslot.index].clone()
                    continue
            if self.disk is not None:
                dslot = self.disk.registry.lookup(h)
                if dslot is not None:
                    out[h] = self._disk_block(dslot.index).clone()
        return out

    def export_block(self, block_hash: int) -> Optional[torch.Tensor]:
        """One resident block's wire bytes on the host (any tier)."""
        return self.export_blocks([block_hash]).get(block_hash)

    def import_blocks(self, blocks: Dict[int, torch.Tensor]) -> int:
        """Inject peer blocks into fresh G1 pages and register them
        (inactive, matchable), in the dict's order: one inject for the
        batch.  Blocks already resident are skipped; the batch stops at
        the pool's capacity.  Returns how many were injected.  An inject
        that raises (a format the engine refuses) leaves no page
        allocated and nothing registered."""
        todo = [(h, d) for h, d in blocks.items()
                if self.device.registry.lookup(h) is None]
        if self.inject_fn is None:
            return 0
        n = min(len(todo), self.device.reusable_slots)
        if n == 0:
            return 0
        todo = todo[:n]
        pages = self.device.allocate(n)
        staged = self._stage()
        try:
            self.inject_fn(pages, torch.stack([d for _, d in todo]))
        except Exception:
            self.device.release(pages)     # no page keeps junk bytes
            self._land(staged)
            raise
        self._land(staged)
        done = 0
        for page, (h, _) in zip(pages, todo):
            if self.device.register(page, h):
                done += 1
        self.device.release(pages)         # -> inactive: resident, matchable
        self.onboarded_blocks += done
        return done

    @engine_thread_only
    def import_block(self, block_hash: int, data: torch.Tensor) -> bool:
        """Inject one fetched block (see `import_blocks`); False when it
        is already resident or the pool has no room."""
        return self.import_blocks({block_hash: data}) == 1

    @engine_thread_only
    def demote_blocks(self, hashes: Sequence[int]) -> int:
        """QoS preemption demotion: push the given G1-resident inactive
        blocks down to the host tier now, freeing their pages.  Without a
        host tier this is a no-op: the blocks stay inactive in G1,
        resumable until LRU pressure reclaims them ("demoted, not lost").
        Returns how many blocks moved."""
        if self.host is None:
            return 0
        # device.on_evict is the chained hook (ManagedBlockSource): the
        # offload first, then the REMOVED KV event.
        n = sum(1 for h in hashes if self.device.demote_hash(h))
        self._flush()
        return n

    def set_eviction_bias(self, fn, scan: int = 8) -> None:
        """Install the eviction-bias hook on every demoting tier: G1
        eviction chooses what rides down to G2, G2 eviction what spills
        to G3.  G3 has nowhere to demote to, so it stays pure LRU."""
        self.device.set_eviction_bias(fn, scan)
        if self.host is not None:
            self.host.set_eviction_bias(fn, scan)

    @never_engine_thread
    def close(self) -> None:
        """Settle the copies in flight and remove the disk tier's file.
        Never on the engine thread: it waits for the whole backlog."""
        self._flush()
        for h in list(self._pending):
            self._settle_host(h)
        if self._disk_np is not None:
            self._disk_np = None
            if self.disk is not None:
                self.disk.clear_inactive()
            try:
                os.remove(self._disk_file)
            except FileNotFoundError:
                pass

    # -- passthrough G1 ops -------------------------------------------------

    def allocate(self, n: int) -> List[int]:
        """Take n fresh G1 pages; the blocks their eviction offloads are
        copied down before this returns."""
        if self.host is None:
            return self.device.allocate(n)
        t0, before = time.perf_counter(), self.offloaded_blocks
        pages = self.device.allocate(n)
        if self._evicted:
            self._flush()
        if self.offloaded_blocks != before:
            self.offload_host_s += time.perf_counter() - t0
            self.offload_host_blocks += self.offloaded_blocks - before
        return pages

    def register(self, slot: int, block_hash: int) -> bool:
        return self.device.register(slot, block_hash)

    def release(self, slots: Sequence[int]) -> None:
        self.device.release(slots)

    @property
    def stats(self) -> Dict[str, float]:
        s = {"g1_active": self.device.active_slots,
             "g1_free": self.device.free_slots,
             "g1_inactive": len(self.device.registry.inactive),
             "g1_hits": self.device.hits,
             "g1_misses": self.device.misses,
             "g1_evictions": self.device.evictions,
             "offloaded": self.offloaded_blocks,
             "onboarded": self.onboarded_blocks,
             "remote_fetched": self.remote_fetched_blocks}
        if self.host is not None:
            s["g2_resident"] = len(self.host.registry.by_hash)
        if self.disk is not None:
            s["g3_resident"] = len(self.disk.registry.by_hash)
        return s

    def clear_cache(self) -> List[int]:
        """Admin flush: drop every reusable cached block in every tier;
        returns the G1 hashes dropped (the ones routers index)."""
        self._flush()
        for h in list(self._pending):
            self._settle_host(h)
        dropped = self.device.clear_inactive()
        if self.host is not None:
            self.host.clear_inactive()
        if self.disk is not None:
            self.disk.clear_inactive()
        return dropped
