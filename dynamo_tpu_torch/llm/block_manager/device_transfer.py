"""Device-direct KV data plane (port of
`dynamo_tpu/llm/block_manager/device_transfer.py`, the NIXL analog).

The protocol is JAX's descriptor exchange:

- the HOLDER extracts G1-resident blocks into one staging tensor the
  offer owns (never a view of the cache), keeps it under a fresh uuid,
  and answers a `kv_offer` RPC with the descriptor {uuid, address,
  transport, hashes, shape, dtype, ...};
- the PULLER pulls the blocks device to device, injects them into its G1
  as registered prefix-cache entries, and acks with `kv_pulled`, which
  frees the holder's staging tensor.  An offer nobody acks retires after
  its TTL; at most MAX_OUTSTANDING_OFFERS are live, and one past the cap
  is refused.

Offers carry the canonical wire block (`engine/kv_cache.py`): bf16
`[2, L, bs, F]` or the packed int8 `[2, L, bs, F + 4*Hkv]`, so an int8
fleet transfers with no second format and the puller's inject refuses a
kv-quant mismatch as it does on the host-staged wire.

Two transports, in place of JAX's pjrt and local fabrics:

- **cuda_ipc** — processes on one card.  The holder sends the staging
  tensor's CUDA IPC handle (`torch.multiprocessing.reductions.
  reduce_tensor`: the allocation's handle and offset, its reference
  counter and the IPC event recorded after the extract) as bytes and
  ints in the reply.  The puller maps it (the event orders the read
  after the holder's extract), copies it into a tensor of its own on the
  device, and then releases the mapping on a worker thread — torch's
  release synchronizes the stream before it drops the holder's
  reference count, which must block neither the event loop nor the
  engine thread — and only then acks, so the holder frees memory the
  puller no longer reads.  torch counts each send until a receiver
  releases it, so an offer nobody mapped (its TTL expired, or the ack
  says `mapped: false`) is released by the holder itself; a puller maps
  an offer only while its `expires_at` is more than MAP_MARGIN_S away,
  so the holder never frees memory a puller is about to read.  Its
  fabric id is `cuda_ipc:<boot id>:<GPU UUID>`: a peer on another host
  or card differs and is refused at the offer, and that pull rides the
  host-staged plane with its reason.
- **local** — one process (CPU engines, tests, co-located engines): the
  staged tensor is copied puller-side.  Fabric `local:<pid>`, so
  cross-process peers are refused, as JAX's local fabric refuses them.

Every plane choice is counted (`note_plane` -> `plane_counts()`, by
(plane, reason)) so a fleet silently degraded to host staging shows in
the worker's `/debug/stats`.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from dynamo_tpu_torch.llm.block_manager.transfer import (
    BATCH_BLOCKS,
    PULL_INFLIGHT,
    dtype_name,
    inject_run,
    nbytes,
    sealed_hashes,
    wire_dtype,
)
from dynamo_tpu_torch.runtime.logutil import warn_rate_limited
from dynamo_tpu_torch.runtime.rpc import RpcError

logger = logging.getLogger(__name__)

KV_OFFER_ENDPOINT = "kv_offer"
KV_PULLED_ENDPOINT = "kv_pulled"

# Staged offers pin device memory until the peer acks (or the offer
# expires), so the cap bounds the strandable memory.  Offers past it are
# refused; callers fall back to the host-staged plane.
MAX_OUTSTANDING_OFFERS = 32
# Per-offer deadline: a puller that dies between offer and ack must not
# wedge the cap (or the memory) forever.
OFFER_TTL_S = 120.0
# A cuda_ipc puller maps an offer only while this much of its TTL is left
# (the holder releases an expired offer's memory); at most a quarter of
# the TTL.
MAP_MARGIN_S = 5.0


# -- plane-choice accounting ------------------------------------------------
# Process-wide (one serving worker per process): every bulk-pull site
# records which plane moved the blocks and, for host fallbacks, why.

_plane_counts: Dict[Tuple[str, str], int] = {}
_plane_lock = threading.Lock()


def note_plane(plane: str, reason: str) -> None:
    """Record one bulk-transfer plane choice."""
    with _plane_lock:
        key = (plane, reason)
        _plane_counts[key] = _plane_counts.get(key, 0) + 1


def plane_counts() -> Dict[Tuple[str, str], int]:
    """Snapshot of the cumulative plane-choice tallies."""
    with _plane_lock:
        return dict(_plane_counts)


def plane_counts_by_plane() -> Dict[str, Dict[str, int]]:
    """The tallies as {plane: {reason: count}} (the stats payloads')."""
    out: Dict[str, Dict[str, int]] = {}
    for (plane, reason), n in plane_counts().items():
        out.setdefault(plane, {})[reason] = n
    return out


def reset_plane_counts() -> None:
    with _plane_lock:
        _plane_counts.clear()


# Process-wide staging registry and uuid space: same-process pulls read
# the staged tensor directly, whichever plane staged it.
_uuid_counter = itertools.count(1)
_staged: Dict[int, torch.Tensor] = {}


def cuda_fabric(device: torch.device) -> str:
    """`cuda_ipc:<host boot id>:<GPU UUID>`: the peers that can map this
    process's IPC handles are those on the same host and card."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        import socket

        boot = socket.gethostname()
    props = torch.cuda.get_device_properties(device)
    card = getattr(props, "uuid", None)
    if card is None:
        card = (f"pci{props.pci_domain_id}:{props.pci_bus_id}:"
                f"{props.pci_device_id}")
    return f"cuda_ipc:{boot}:{card}"


class _LocalTransport:
    """One process's fabric: staged tensors are copied puller-side."""

    kind = "local"

    def __init__(self) -> None:
        self.address = f"local:{os.getpid()}"
        self.fabric = self.address

    def can_serve(self, peer_fabric: Optional[str]) -> bool:
        # None: a direct same-process stage() call (tests).  RPC probes
        # always carry the puller's fabric id.
        return peer_fabric is None or peer_fabric == self.fabric

    def describe(self, staged: torch.Tensor) -> dict:
        return {}

    def unsend(self, desc: dict, device: torch.device) -> None:
        pass

    async def pull(self, meta: dict, device: torch.device
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the puller's own copy, None: nothing mapped to release)."""
        if meta.get("address") != self.address:
            raise RuntimeError(
                f"the local fabric cannot pull from {meta.get('address')!r}"
                " (a cross-process peer needs the cuda_ipc fabric)")
        return _copy_staged(meta, device), None


class _CudaIpcTransport:
    """Processes on one card: CUDA IPC handles of the staging tensors."""

    kind = "cuda_ipc"

    def __init__(self, device: torch.device) -> None:
        self.fabric = cuda_fabric(device)
        self.address = f"{self.fabric}:{os.getpid()}"

    def can_serve(self, peer_fabric: Optional[str]) -> bool:
        return peer_fabric is None or peer_fabric == self.fabric

    def describe(self, staged: torch.Tensor) -> dict:
        """The IPC descriptor of `staged`, as bytes and ints the RPC codec
        carries.  Called right after the extract on the same stream: the
        IPC event torch records here orders the puller's read after it."""
        from torch.multiprocessing.reductions import reduce_tensor

        (_, _, stride, offset, _, _, _, handle, size_bytes, offset_bytes,
         _, ref_handle, ref_offset, event_handle,
         event_sync) = reduce_tensor(staged)[1]
        return {"pid": os.getpid(), "ipc": {
            "stride": list(stride), "offset": int(offset),
            "handle": handle, "storage_size": int(size_bytes),
            "storage_offset": int(offset_bytes),
            "ref_handle": ref_handle, "ref_offset": int(ref_offset),
            "event_handle": event_handle, "event_sync": bool(event_sync)}}

    def unsend(self, desc: dict, device: torch.device) -> None:
        """Release the count torch keeps for a send nobody received, so
        the staging tensor frees when the holder drops it."""
        ipc = desc["ipc"]
        torch.storage.TypedStorage._release_ipc_counter(
            ipc["ref_handle"], ipc["ref_offset"], device=device)

    async def pull(self, meta: dict, device: torch.device
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the puller's own device copy, the mapped tensor to release
        once that copy is done).  Same-process offers skip the IPC (CUDA
        cannot map a handle in the process that exported it)."""
        if meta.get("pid") == os.getpid():
            return _copy_staged(meta, device), None
        left = meta["expires_at"] - time.time()
        if left < min(MAP_MARGIN_S, meta["ttl_s"] / 4):
            raise RuntimeError(f"offer {meta['uuid']} expires in {left:.3f}"
                               " s; not mapping it")
        from torch.multiprocessing.reductions import rebuild_cuda_tensor

        ipc = meta["ipc"]
        idx = device.index if device.index is not None else \
            torch.cuda.current_device()
        with torch.cuda.device(idx):
            mapped = rebuild_cuda_tensor(
                torch.Tensor, torch.Size(meta["stage_shape"]),
                tuple(ipc["stride"]), ipc["offset"],
                torch.storage.TypedStorage, wire_dtype(meta["dtype"]), idx,
                ipc["handle"], ipc["storage_size"], ipc["storage_offset"],
                False, ipc["ref_handle"], ipc["ref_offset"],
                ipc["event_handle"], ipc["event_sync"])
            own = torch.empty_like(mapped)
            own.copy_(mapped)          # device to device, after the event
        return own, mapped


def _copy_staged(meta: dict, device: torch.device) -> torch.Tensor:
    staged = _staged.get(meta["uuid"])
    if staged is None:
        raise RuntimeError(f"transfer {meta['uuid']} is not staged "
                           "(expired or already pulled)")
    return staged.to(device, copy=True)


def _owned_stack(arrays: List[torch.Tensor]) -> torch.Tensor:
    """One [n, ...] tensor holding `arrays` in order: their common base
    when they are exactly its rows in order (the engine's extract), else
    a stacked copy.  Either way storage the offer alone owns."""
    base = arrays[0]._base
    if (base is not None and base.dim() == arrays[0].dim() + 1
            and base.shape[0] == len(arrays) and base.is_contiguous()
            and all(a._base is base and a.data_ptr() == base[i].data_ptr()
                    for i, a in enumerate(arrays))):
        return base
    return torch.stack(arrays)


class KvTransferPlane:
    """One per worker process: holder and puller halves of the device
    plane.  `engine` is an InferenceEngine (device export and import on
    its thread); engineless planes (tests) pass `device` and use
    stage/pull directly."""

    def __init__(self, engine=None, *, offer_ttl_s: float = OFFER_TTL_S,
                 device: Optional[torch.device] = None) -> None:
        self.engine = engine
        self.device = torch.device(
            device if device is not None else
            engine.core.device if engine is not None else "cpu")
        self.offer_ttl_s = offer_ttl_s
        self._transport = None
        # uuid -> (staged blocks, monotonic deadline, staged bytes)
        self._outstanding: Dict[int, Tuple[int, float, int]] = {}
        # uuid -> the transport's descriptor fields of a live offer
        self._sent: Dict[int, dict] = {}
        # uuid -> mapped IPC tensor awaiting release (puller side)
        self._mapped: Dict[int, torch.Tensor] = {}
        # Observability (tests and /debug/stats).
        self.offers = 0
        self.refused_offers = 0
        self.expired_offers = 0
        self.pulled_blocks = 0
        self.pulled_bytes = 0
        self.outstanding_high_water = 0        # live offers
        self.staged_bytes_high_water = 0       # their staged bytes
        self.last_refusal: Optional[str] = None

    def start(self) -> str:
        self._transport = (_CudaIpcTransport(self.device)
                           if self.device.type == "cuda"
                           else _LocalTransport())
        return self.address

    @property
    def address(self) -> str:
        return self._transport.address

    @property
    def transport_kind(self) -> str:
        return self._transport.kind

    @property
    def fabric(self) -> str:
        """What a puller advertises in its kv_offer probe, so the holder
        refuses an unreachable transport before staging anything."""
        return self._transport.fabric

    def stop(self) -> None:
        for uid in list(self._outstanding):
            self._retire(uid, mapped=False)
        self._mapped.clear()
        self._transport = None

    def stats(self) -> dict:
        return {"transport": (self._transport.kind if self._transport
                              else None),
                "offers": self.offers, "refused_offers": self.refused_offers,
                "expired_offers": self.expired_offers,
                "outstanding": len(self._outstanding),
                "outstanding_high_water": self.outstanding_high_water,
                "staged_bytes": sum(b for _, _, b in
                                    self._outstanding.values()),
                "staged_bytes_high_water": self.staged_bytes_high_water,
                "pulled_blocks": self.pulled_blocks,
                "pulled_bytes": self.pulled_bytes}

    def reset_stats(self) -> None:
        self.offers = self.refused_offers = self.expired_offers = 0
        self.pulled_blocks = self.pulled_bytes = 0
        self.outstanding_high_water = len(self._outstanding)
        self.staged_bytes_high_water = sum(
            b for _, _, b in self._outstanding.values())

    # -- holder side -------------------------------------------------------

    def _retire(self, uid: int, mapped: bool) -> None:
        """Drop an offer; `mapped` False: no puller received it, so its
        send is released here."""
        self._outstanding.pop(uid, None)
        desc = self._sent.pop(uid, None)
        if desc and not mapped:
            self._transport.unsend(desc, self.device)
        _staged.pop(uid, None)
        if self.device.type == "cuda":
            # Frees staging memory a puller released after our drop.
            torch.cuda.ipc_collect()

    def expire_offers(self) -> int:
        """Retire offers past their deadline; returns how many."""
        now = time.monotonic()
        expired = [uid for uid, (_, deadline, _) in self._outstanding.items()
                   if deadline <= now]
        for uid in expired:
            # A live puller maps only well before the deadline and acks
            # once done, so an expired offer is one nobody reads.
            self._retire(uid, mapped=False)
        self.expired_offers += len(expired)
        if expired:
            logger.warning("device transfer: %d offer(s) expired unpulled "
                           "(puller died between offer and ack); staging "
                           "freed", len(expired))
        return len(expired)

    def stage(self, blocks: Dict[int, torch.Tensor], order: Iterable[int],
              peer_fabric: Optional[str] = None,
              ttl_s: Optional[float] = None) -> Optional[dict]:
        """Stage blocks for one pull; returns the descriptor, or None when
        nothing can be offered — `last_refusal` then says why:
        'not_resident' (no requested block), 'transport' (the peer cannot
        reach this fabric), 'offer_cap' (MAX_OUTSTANDING_OFFERS live even
        after TTL expiry).  `ttl_s` overrides the plane's offer TTL for
        this offer: an ack-less protocol (the multimodal encode
        descriptor) stages with a short one so its offers leave the cap
        accounting on their own."""
        self.last_refusal = None
        present = [h for h in order if h in blocks]
        if not present:
            self.last_refusal = "not_resident"
            return None
        if not self._transport.can_serve(peer_fabric):
            self.refused_offers += 1
            self.last_refusal = "transport"
            return None
        self.expire_offers()
        if len(self._outstanding) >= MAX_OUTSTANDING_OFFERS:
            self.refused_offers += 1
            self.last_refusal = "offer_cap"
            logger.warning("device transfer: %d offers outstanding "
                           "(unpulled, none expired); refusing until "
                           "peers ack", len(self._outstanding))
            return None
        staged = _owned_stack([blocks[h] for h in present])
        uid = next(_uuid_counter)
        _staged[uid] = staged
        ttl = self.offer_ttl_s if ttl_s is None else ttl_s
        self._outstanding[uid] = (len(present), time.monotonic() + ttl,
                                  nbytes(staged))
        self.offers += 1
        desc = self._transport.describe(staged)
        if desc:
            self._sent[uid] = desc
        self.outstanding_high_water = max(self.outstanding_high_water,
                                          len(self._outstanding))
        self.staged_bytes_high_water = max(
            self.staged_bytes_high_water,
            sum(b for _, _, b in self._outstanding.values()))
        return {
            "uuid": uid,
            "address": self.address,
            "transport": self._transport.kind,
            "hashes": present,
            "shape": list(staged.shape[1:]),
            "stage_shape": list(staged.shape),
            "dtype": dtype_name(staged.dtype),
            "ttl_s": ttl,
            "expires_at": time.time() + ttl,
            **desc,
        }

    def mark_pulled(self, uid: int, mapped: bool = True) -> None:
        if uid in self._outstanding:
            self._retire(uid, mapped)

    async def offer(self, hashes: List[int],
                    peer_fabric: Optional[str] = None) -> Optional[dict]:
        """Extract the G1-resident requested blocks and stage them.  The
        transport check runs first: an unreachable peer must not cost an
        engine-thread extract thrown away."""
        if not self._transport.can_serve(peer_fabric):
            self.refused_offers += 1
            self.last_refusal = "transport"
            return None
        blocks = await self.engine.export_blocks_device(hashes)
        return self.stage(blocks, hashes, peer_fabric=peer_fabric)

    def make_offer_handler(self):
        """RPC handler for KV_OFFER_ENDPOINT: {"hashes": [...], "fabric":
        <puller fabric>} -> one descriptor delta, or {"reason": ...} when
        nothing can be offered (the caller falls back to kv_blocks).  A
        probe without a fabric id is refused as unreachable."""

        async def handler(payload: dict):
            meta = await self.offer(payload.get("hashes", []),
                                    peer_fabric=payload.get("fabric") or "")
            if meta is not None:
                yield meta
            else:
                yield {"reason": self.last_refusal or "no_offer"}

        return handler

    def make_pulled_handler(self):
        """RPC handler for KV_PULLED_ENDPOINT: the puller's ack, which
        retires the offer and frees its staging tensor.  `mapped` (default
        true, as JAX's acks carry none) says whether the puller received
        the send; false releases it here."""

        async def handler(payload: dict):
            self.mark_pulled(payload.get("uuid"),
                             mapped=bool(payload.get("mapped", True)))
            yield {"ok": True}

        return handler

    # -- puller side -------------------------------------------------------

    async def pull(self, meta: dict) -> Dict[int, torch.Tensor]:
        """Pull the staged blocks device to device; returns hash -> block
        on this plane's device (views of one tensor of the puller's own).
        A mapped IPC tensor stays in `_mapped` until `release(uuid)`."""
        if not meta or meta.get("uuid") is None:
            return {}
        kind = meta.get("transport")
        if kind != self._transport.kind:
            raise RuntimeError(
                f"descriptor names the {kind!r} fabric but this plane runs "
                f"{self._transport.kind!r}; use the host-staged plane")
        own, mapped = await self._transport.pull(meta, self.device)
        if mapped is not None:
            self._mapped[meta["uuid"]] = mapped
            del mapped
        self.pulled_blocks += own.shape[0]
        self.pulled_bytes += nbytes(own)
        return dict(zip(meta["hashes"], own.unbind(0)))

    async def release(self, uid: int) -> bool:
        """Drop the IPC mapping of a pulled offer on a worker thread (the
        release synchronizes the stream: the copy out of the mapping must
        finish before the holder may reuse the memory).  Returns whether
        there was a mapping."""
        box = [self._mapped.pop(uid, None)]
        if box[0] is None:
            return False

        def drop() -> None:
            box.clear()
            torch.cuda.ipc_collect()

        await asyncio.to_thread(drop)
        return True


async def _ack_pulled(rpc_client, uid: int, mapped: bool) -> None:
    """Retire the holder's offer.  A lost ack only holds the offer until
    its TTL, so failures log once a minute and are otherwise dropped."""
    try:
        async for _ in rpc_client.call(KV_PULLED_ENDPOINT,
                                       {"uuid": uid, "mapped": mapped}):
            pass
    except (ConnectionError, OSError, RpcError) as e:
        warn_rate_limited(
            logger, "kv_pulled_ack", 60.0,
            "kv_pulled ack to the holder failed (its offer retires by "
            "TTL): %s", e)


# Strong refs keep the spawned release/ack tasks alive until done (the
# loop holds running tasks weakly).
_ack_tasks: set = set()


def _release_then_ack(plane: KvTransferPlane, rpc_client, uid: int) -> None:
    """Off the pull's critical path: release the mapping, then ack, so the
    holder frees only memory the puller no longer reads."""

    async def run() -> None:
        mapped = False
        try:
            mapped = await plane.release(uid)
        finally:
            await _ack_pulled(rpc_client, uid, mapped)

    task = asyncio.ensure_future(run())
    _ack_tasks.add(task)
    task.add_done_callback(_ack_tasks.discard)


async def pull_blocks_device(plane: KvTransferPlane, rpc_client,
                             hashes: List[int], *,
                             context: str = "pull"
                             ) -> Tuple[Dict[int, torch.Tensor],
                                        Optional[str]]:
    """One offer -> pull -> ack round over the device plane.  Returns
    (blocks, refusal): refusal None means a descriptor was granted
    (`blocks` may be a subset: only G1-resident hashes stage); a reason
    means the holder declined and the caller should use the host-staged
    plane.  Transport errors raise; the caller counts the fallback."""
    meta = None
    async for msg in rpc_client.call(KV_OFFER_ENDPOINT,
                                     {"hashes": list(hashes),
                                      "fabric": plane.fabric}):
        meta = msg
    if not meta or meta.get("uuid") is None:
        return {}, (meta or {}).get("reason") or "no_offer"
    try:
        blocks = await plane.pull(meta)
    finally:
        _release_then_ack(plane, rpc_client, meta["uuid"])
    note_plane("device", context)
    return blocks, None


async def try_pull_device(plane: KvTransferPlane, rpc_client,
                          hashes: List[int], *, context: str,
                          site: str) -> Tuple[Optional[Dict[int, torch.Tensor]],
                                              Optional[str]]:
    """One device-first batch attempt with the fallback discipline every
    pull site shares: (blocks, None) when the device plane served the
    batch, or (None, reason) when the caller should switch to the
    host-staged wire — transport errors are logged here and become
    'pull_failed'."""
    try:
        blocks, refusal = await pull_blocks_device(
            plane, rpc_client, hashes, context=context)
    except (ConnectionError, OSError, RpcError, RuntimeError) as e:
        logger.warning("%s: device pull of %d block(s) failed (%s); "
                       "host-staged from here", site, len(hashes), e)
        return None, "pull_failed"
    if refusal is not None:
        return None, refusal
    return blocks, None


async def pull_prefix_device(engine, plane: KvTransferPlane, rpc_client,
                             prompt_tokens: List[int], block_size: int,
                             covered_tokens: int = 0, *,
                             context: str = "disagg") -> int:
    """Device-direct onboard of a peer's sealed prompt blocks: batched
    offers, double-buffered pulls (batch N+1 in flight while batch N
    injects), contiguous-frontier inject.  Returns the tokens covered;
    `covered_tokens` unchanged when the peer offered nothing (the caller
    falls back to the host-staged pull or local prefill).  A failed batch
    leaves a gap the host residual covers; a kv-quant mismatch (an inject
    ValueError) propagates, since every block would fail the same way.

    `covered_tokens`: a block-aligned prefix already resident here (e.g.
    landed by an eager stream): neither offered nor pulled."""
    hashes = sealed_hashes(prompt_tokens, block_size)
    hashes = hashes[covered_tokens // block_size:]
    if not hashes:
        return covered_tokens
    sem = asyncio.Semaphore(PULL_INFLIGHT)
    ready: Dict[int, torch.Tensor] = {}
    inject_lock = asyncio.Lock()
    state = {"frontier": 0, "refusal": None}

    async def inject_ready() -> None:
        async with inject_lock:
            run: Dict[int, torch.Tensor] = {}
            i = state["frontier"]
            while i in ready:
                run[hashes[i]] = ready.pop(i)
                i += 1
            state["frontier"], stalled = await inject_run(
                engine, hashes, run, state["frontier"], i)
            if stalled:
                state["refusal"] = state["refusal"] or "inject_stall"

    async def one(lo: int, hi: int) -> None:
        async with sem:
            if state["refusal"]:
                return
            try:
                blocks, refusal = await pull_blocks_device(
                    plane, rpc_client, hashes[lo:hi], context=context)
            except (ConnectionError, OSError, RpcError, RuntimeError) as e:
                state["refusal"] = "pull_failed"
                logger.warning("device pull of blocks [%d, %d) failed: %s",
                               lo, hi, e)
                return
            if refusal is not None:
                state["refusal"] = refusal
                return
            for j, h in enumerate(hashes[lo:hi]):
                if h in blocks:
                    ready[lo + j] = blocks[h]
            await inject_ready()

    tasks = [asyncio.ensure_future(
                one(lo, min(lo + BATCH_BLOCKS, len(hashes))))
             for lo in range(0, len(hashes), BATCH_BLOCKS)]
    results = await asyncio.gather(*tasks, return_exceptions=True)
    await inject_ready()
    ready.clear()   # non-contiguous islands: the host residual refetches
    for r in results:
        if isinstance(r, BaseException):
            raise r   # a kv-quant ValueError: no host retry
    if state["refusal"] and state["frontier"] < len(hashes):
        note_plane("host", state["refusal"])
    return covered_tokens + state["frontier"] * block_size
