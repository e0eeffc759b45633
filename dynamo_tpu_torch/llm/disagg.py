"""Disaggregated prefill/decode orchestration (port of
`dynamo_tpu/llm/disagg.py`).

Long prefills run on dedicated prefill workers so decode batches never
stall behind them; KV crosses workers on the data plane.

- **DisaggRouter** (decode-side admission): the local/remote decision,
  its threshold under `disagg/<namespace>/config` on the control plane,
  watched and hot-reloaded.
- **Prefill queue**: an acked work queue on the control plane,
  at-least-once, so a prefill worker dying mid-job redelivers the job.
- **prefill_worker_loop**: pops jobs and prefills each through the local
  engine (one token, discarded), which seals and registers the prompt's
  blocks.  While it prefills, it forwards the engine's seal-progress
  stream (`InferenceEngine.watch_seals`) as incremental announcements
  (request id, its RPC address, the sealed-block high-water mark), then
  announces completion and acks.
- **DisaggDecodeClient**: the decode worker's EngineClient.  A long
  prompt goes to the prefill queue, and an `EagerPuller` streams its
  sealed blocks while the remote prefill runs (device to device when the
  worker runs a KvTransferPlane), so at the done message only the tail
  is pulled.  Then the local engine runs it, and its prefix-cache match
  skips everything but the partial last block.  A remote failure
  (timeout, a prefill worker dead even mid-stream, a kv-quant mismatch)
  falls back to local prefill seeded with the contiguous prefix that
  landed: disagg is an optimisation, never a correctness dependency.
  Each remote prefill is a `disagg.remote_prefill` span (the pulls'
  spans nest under it) and stamps the request ledger's
  `prefill_remote` and `kv_transfer` phases; with `request_metrics` the
  onboard time and the eager overlap are observed.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import AsyncIterator, Dict, List, Optional

from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.llm.block_manager.device_transfer import (
    note_plane,
    pull_prefix_device,
)
from dynamo_tpu_torch.llm.block_manager.eager import EagerPuller
from dynamo_tpu_torch.llm.block_manager.transfer import pull_prefix
from dynamo_tpu_torch.llm.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.ledger import ledger_of
from dynamo_tpu_torch.runtime.rpc import RpcClient, RpcError

logger = logging.getLogger(__name__)

PREFILL_DONE_SUBJECT = "prefill_done"
PREFILL_PROGRESS_SUBJECT = "prefill_progress"


class _KvModeRefused(Exception):
    """A pull's inject refused the peer's blocks (kv-quant mismatch,
    `EngineCore._validate_block`).  Raised only at the pull call sites: a
    bare ValueError elsewhere in remote prefill is a bug and propagates."""


def prefill_queue_name(namespace: str) -> str:
    return f"{namespace}/prefill_queue"


def disagg_config_key(namespace: str) -> str:
    return f"disagg/{namespace}/config"


@dataclass
class DisaggConfig:
    """`max_local_prefill_length`: prompts longer than this (tokens)
    prefill remotely; None disables disagg."""

    max_local_prefill_length: Optional[int] = None

    @staticmethod
    def from_dict(d: Optional[dict]) -> "DisaggConfig":
        if not d:
            return DisaggConfig()
        return DisaggConfig(
            max_local_prefill_length=d.get("max_local_prefill_length"))


class DisaggRouter:
    """Decode-side local/remote prefill decision, hot-reloaded from the
    control plane."""

    def __init__(self, cp, namespace: str) -> None:
        self.cp = cp
        self.namespace = namespace
        self.config = DisaggConfig()
        self._watch = None
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        key = disagg_config_key(self.namespace)
        self.config = DisaggConfig.from_dict(await self.cp.get(key))
        self._watch = await self.cp.watch_prefix(key)
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._watch:
            self._watch.cancel()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        async for ev in self._watch:
            self.config = DisaggConfig.from_dict(
                ev.value if ev.kind == "put" else None)
            logger.info("disagg config now %s", self.config)

    def prefill_remotely(self, prompt_len: int) -> bool:
        limit = self.config.max_local_prefill_length
        return limit is not None and prompt_len > limit


async def _publish_progress(cp, rid: str, address: str,
                            seal_q: asyncio.Queue) -> None:
    """Forward a prefilling prompt's seal high-water marks as progress
    announcements; bursts coalesce to the latest mark."""
    hwm = 0
    while True:
        sealed = await seal_q.get()
        while not seal_q.empty():
            sealed = max(sealed, seal_q.get_nowait())
        if sealed <= hwm:
            continue
        hwm = sealed
        await cp.publish(PREFILL_PROGRESS_SUBJECT, {
            "request_id": rid, "address": address, "sealed_blocks": hwm})


async def prefill_worker_loop(cp, namespace: str, engine_client,
                              address: str, *,
                              visibility_timeout: float = 60.0) -> None:
    """The prefill worker's service loop (`--role prefill`): pop ->
    prefill (max_tokens=1, output discarded) -> announce done -> ack.
    The ack comes last: a crash mid-prefill redelivers the job
    (re-prefilling a sealed prompt is a cheap prefix-cache hit).  While
    the prompt prefills, the engine's seal stream feeds incremental
    PREFILL_PROGRESS announcements; an engine without `watch_seals` only
    announces done."""
    queue = prefill_queue_name(namespace)
    seal_engine = getattr(engine_client, "engine", engine_client)
    if not hasattr(seal_engine, "watch_seals"):
        seal_engine = None
    while True:
        # The whole iteration is guarded: an exception here (a control
        # plane hiccup in pop/publish/ack) would otherwise end the task
        # and orphan the queue.
        try:
            msg_id, job = await cp.queue_pop(queue, visibility_timeout)
            rid = job["request_id"]
            prid = f"prefill-{rid}"
            t0 = time.monotonic()
            progress: Optional[asyncio.Task] = None
            if seal_engine is not None:
                progress = asyncio.create_task(_publish_progress(
                    cp, rid, address, seal_engine.watch_seals(prid)))
            try:
                req = PreprocessedRequest(
                    request_id=prid, model=job.get("model", ""),
                    token_ids=list(job["token_ids"]),
                    sampling=SamplingParams(max_tokens=1))
                async for _ in engine_client.generate(req):
                    pass
            except Exception:
                logger.exception("prefill job %s failed (will redeliver)",
                                 rid)
                continue   # no ack: redelivered after the timeout
            finally:
                if seal_engine is not None:
                    seal_engine.unwatch_seals(prid)
                if progress is not None:
                    progress.cancel()
                    # gather absorbs the child's cancellation but still
                    # propagates the loop's own.
                    await asyncio.gather(progress, return_exceptions=True)
            await cp.publish(PREFILL_DONE_SUBJECT, {
                "request_id": rid, "address": address,
                "prefill_s": time.monotonic() - t0})
            await cp.queue_ack(queue, msg_id)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("prefill loop: control-plane error; retrying")
            await asyncio.sleep(1.0)


class DisaggDecodeClient:
    """EngineClient for a decode-role worker: remote-prefill admission in
    front of the local engine."""

    def __init__(self, inner, engine, cp, namespace: str,
                 block_size: int, *,
                 prefill_timeout: float = 120.0,
                 transfer_plane=None,
                 request_metrics=None,
                 eager: bool = True) -> None:
        """`inner`: the local EngineClient; `engine`: the InferenceEngine
        (the import side of the data plane); `transfer_plane`: this
        worker's KvTransferPlane, if it runs one — blocks then cross
        device to device, the host-staged pull the fallback.  `eager`:
        stream sealed blocks while the remote prefill runs; without it,
        the whole prefix is pulled at prefill-done.  `request_metrics`
        (runtime/metrics.RequestMetrics): observes the onboard time by
        path and the eager overlap ratio."""
        self.inner = inner
        self.engine = engine
        self.cp = cp
        self.namespace = namespace
        self.block_size = block_size
        self.prefill_timeout = prefill_timeout
        self.transfer_plane = transfer_plane
        self.request_metrics = request_metrics
        self.eager = eager
        self._waiters: Dict[str, asyncio.Future] = {}
        self._pullers: Dict[str, EagerPuller] = {}
        self._rpc_clients: Dict[str, RpcClient] = {}
        self._sub = None
        self._progress_sub = None
        self._task: Optional[asyncio.Task] = None
        self._progress_task: Optional[asyncio.Task] = None
        self.router = DisaggRouter(cp, namespace)
        self.reset_stats()

    def reset_stats(self) -> None:
        self.remote_prefills = 0
        self.local_fallbacks = 0
        self.tokens_onboarded = 0
        self.tokens_streamed = 0        # pulled before prefill-done
        self.device_pulls = 0           # requests whose blocks rode the device
        self.eager_blocks_before_done = 0
        self.eager_blocks_after_done = 0
        self.eager_pulls = 0            # pull rounds begun before done
        self.done_pulls = 0             # residual pulls at done
        self.last_overlap_ratio = 0.0
        self.overlap_ratios: List[float] = []

    def stats(self) -> dict:
        return {"remote_prefills": self.remote_prefills,
                "local_fallbacks": self.local_fallbacks,
                "tokens_onboarded": self.tokens_onboarded,
                "tokens_streamed": self.tokens_streamed,
                "device_pulls": self.device_pulls,
                "eager_blocks_before_done": self.eager_blocks_before_done,
                "eager_blocks_after_done": self.eager_blocks_after_done,
                "eager_pulls": self.eager_pulls,
                "done_pulls": self.done_pulls,
                "overlap_ratio": self.last_overlap_ratio,
                "overlap_ratios": list(self.overlap_ratios),
                "threshold": self.router.config.max_local_prefill_length}

    async def start(self) -> None:
        await self.router.start()
        self._sub = await self.cp.subscribe(PREFILL_DONE_SUBJECT)
        self._task = asyncio.create_task(self._done_loop())
        self._progress_sub = await self.cp.subscribe(PREFILL_PROGRESS_SUBJECT)
        self._progress_task = asyncio.create_task(self._progress_loop())

    async def stop(self) -> None:
        await self.router.stop()
        for sub in (self._sub, self._progress_sub):
            if sub:
                sub.cancel()
        for task in (self._task, self._progress_task):
            if task:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        for c in self._rpc_clients.values():
            await c.close()

    async def _done_loop(self) -> None:
        async for msg in self._sub:
            fut = self._waiters.pop(msg.get("request_id", ""), None)
            if fut and not fut.done():
                fut.set_result(msg)

    async def _progress_loop(self) -> None:
        """Route progress announcements to the pending request's
        EagerPuller; unknown ids (another decode worker's) cost a dict
        miss."""
        try:
            async for msg in self._progress_sub:
                try:
                    puller = self._pullers.get(msg.get("request_id", ""))
                    if puller is not None:
                        puller.on_progress(msg.get("sealed_blocks", 0),
                                           msg.get("address", ""))
                except Exception:
                    # One malformed announcement must not end streaming
                    # for every later request.
                    logger.exception("bad prefill-progress message: %r", msg)
        except ConnectionError:
            # Control plane gone: pulls degrade to done-only, and the done
            # waiter times out into the local fallback on its own.
            logger.warning("prefill-progress subscription lost")

    def _rpc(self, address: str) -> RpcClient:
        client = self._rpc_clients.get(address)
        if client is None:
            client = self._rpc_clients[address] = RpcClient(address)
        return client

    async def _remote_prefill(self, request: PreprocessedRequest) -> None:
        rid = request.request_id
        fut = asyncio.get_running_loop().create_future()
        self._waiters[rid] = fut
        try:
            # `with` makes the span current for the whole admission: the
            # pulls' spans and their RPC children nest under it.
            with tracing.get_tracer().start_span(
                    "disagg.remote_prefill",
                    attrs={"request_id": rid,
                           "prompt_tokens": len(request.token_ids)}) as span:
                await self._remote_prefill_inner(request, rid, fut, span)
        finally:
            self._waiters.pop(rid, None)

    async def _remote_prefill_inner(self, request, rid, fut, span) -> None:
        led = ledger_of(request)
        t_wait = time.monotonic()
        puller = None
        if self.eager:
            # Registered before the queue push: a fast prefill worker's
            # first announcement must find its puller.
            puller = EagerPuller(
                self.engine, self._rpc, list(request.token_ids),
                self.block_size, plane=self.transfer_plane)
            self._pullers[rid] = puller
        settled = False   # success or a handled fallback reached abort()
        try:
            await self.cp.queue_push(prefill_queue_name(self.namespace), {
                "request_id": rid, "model": request.model,
                "token_ids": list(request.token_ids)})
            done = await asyncio.wait_for(fut, self.prefill_timeout)
            span.set_attr(prefill_s=round(done.get("prefill_s", 0.0), 4),
                          prefill_worker=done.get("address"))
            t_pull = time.monotonic()
            bytes0 = (self.transfer_plane.pulled_bytes
                      if self.transfer_plane is not None else 0)
            if led is not None:
                # Decode-side wait for the remote prefill worker: queue
                # push → done announcement (the eager stream overlaps it).
                led.stamp("prefill_remote", dur=t_pull - t_wait,
                          prefill_s=round(done.get("prefill_s", 0.0), 4),
                          worker=str(done.get("address", "")))
            onboarded = 0
            path = "host-staged"
            if puller is not None:
                # Whatever streamed during prefill is injected; finish()
                # drains in-flight pulls and fetches only the tail.
                streamed = puller.streamed_blocks * self.block_size
                try:
                    onboarded = await puller.finish(done["address"])
                except ValueError as e:
                    raise _KvModeRefused(e) from e
                if puller.device_blocks:
                    self.device_pulls += 1
                    path = "device-stream"
                elif streamed:
                    path = "eager-stream"
                self.tokens_streamed += streamed
                self.last_overlap_ratio = puller.overlap_ratio
                self.overlap_ratios.append(puller.overlap_ratio)
                self.eager_blocks_before_done += puller.early_blocks
                self.eager_blocks_after_done += max(
                    0, onboarded // self.block_size - puller.early_blocks)
                self.eager_pulls += puller.early_pulls
                self.done_pulls += puller.done_pulls
                if self.request_metrics is not None:
                    self.request_metrics.kv_transfer_overlap.observe(
                        puller.overlap_ratio)
                span.set_attr(overlap_ratio=round(puller.overlap_ratio, 4),
                              tokens_streamed=streamed)
            else:
                onboarded, path = await self._done_pull(request, done)
            self.remote_prefills += 1
            self.tokens_onboarded += onboarded
            settled = True
            transfer_s = time.monotonic() - t_pull
            if self.request_metrics is not None:
                self.request_metrics.kv_transfer.observe(
                    transfer_s, labels={"path": path})
            span.set_attr(tokens_onboarded=onboarded, path=path,
                          kv_transfer_s=round(transfer_s, 4))
            if led is not None:
                dev_bytes = (self.transfer_plane.pulled_bytes - bytes0
                             if self.transfer_plane is not None else 0)
                led.stamp(
                    "kv_transfer", dur=transfer_s, reason="disagg",
                    plane=("device" if path.startswith("device")
                           else "host"),
                    path=path, blocks=onboarded // self.block_size,
                    tokens=onboarded, device_bytes=dev_bytes)
            logger.info("remote prefill %s: %d tokens onboarded from %s "
                        "(%s)", rid, onboarded, done["address"], path)
        except (asyncio.TimeoutError, ConnectionError, OSError,
                RpcError, _KvModeRefused) as e:
            # The peer's handler failed, it died, or its blocks are not
            # injectable here: prefill locally, reusing what landed.
            self.local_fallbacks += 1
            if isinstance(e, _KvModeRefused):
                note_plane("host", "quant_mismatch")
            landed = 0
            if puller is not None:
                landed = await puller.abort()
                self.tokens_onboarded += landed
            settled = True
            span.set_attr(fallback="local", error=type(e).__name__,
                          landed_tokens=landed)
            if led is not None:
                led.stamp("prefill_remote", dur=time.monotonic() - t_wait,
                          fallback="local", error=type(e).__name__,
                          landed_tokens=landed)
            logger.warning(
                "remote prefill %s failed (%s); prefilling locally%s", rid,
                e, f" (reusing {landed} landed tokens)" if landed else "")
        finally:
            self._pullers.pop(rid, None)
            if puller is not None and not settled:
                # Unwinding through an unhandled path (cancellation, an
                # unexpected error): the pull tasks must not outlive it.
                try:
                    await puller.abort()
                except Exception:
                    logger.exception("eager puller cleanup failed (%s)", rid)

    async def _done_pull(self, request, done: dict):
        """Non-eager onboard at prefill-done: device first, then the
        host-staged plane for whatever the device pull did not cover.
        Returns (tokens covered, path)."""
        onboarded = 0
        path = "host-staged"
        if self.transfer_plane is not None:
            try:
                onboarded = await pull_prefix_device(
                    self.engine, self.transfer_plane,
                    self._rpc(done["address"]), list(request.token_ids),
                    self.block_size)
            except ValueError as e:
                raise _KvModeRefused(e) from e
            except (ConnectionError, OSError, RpcError, RuntimeError) as e:
                note_plane("host", "pull_failed")
                logger.warning("device-direct pull %s failed (%s); using "
                               "the host-staged plane", request.request_id,
                               e)
            if onboarded:
                self.device_pulls += 1
                path = "device-direct"
        sealed = len(request.token_ids) // self.block_size * self.block_size
        if onboarded < sealed:
            before = onboarded
            try:
                onboarded = await pull_prefix(
                    self.engine, self._rpc(done["address"]),
                    list(request.token_ids), self.block_size,
                    covered_tokens=onboarded)
            except ValueError as e:
                raise _KvModeRefused(e) from e
            if onboarded > before:
                note_plane("host", "no_plane" if self.transfer_plane is None
                           else "residual")
        return onboarded, path

    async def generate(self, request: PreprocessedRequest
                       ) -> AsyncIterator[TokenDelta]:
        if self.router.prefill_remotely(len(request.token_ids)):
            await self._remote_prefill(request)
        async for delta in self.inner.generate(request):
            yield delta
