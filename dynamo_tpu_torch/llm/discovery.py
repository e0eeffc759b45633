"""Dynamic model discovery: register_llm + ModelWatcher + remote clients
(port of `dynamo_tpu/llm/discovery.py`).

The worker side opens a hop ledger for requests that opted in and
returns it on the final delta (`ledger` key), observes the worker's
`RequestMetrics` (TTFT / TPOT / outcomes at the RPC boundary) and binds
the RPC server span to the request id for the engine thread's spans;
the frontend side folds a returned hop ledger into the live one.

The reference flow (`discovery/watcher.rs:39`, `rust/lib.rs:136
register_llm`): a worker serves its engine endpoint, then writes a
ModelEntry under `models/` in etcd; every frontend watches that prefix and
builds/tears down routed pipelines as entries come and go.  Same here,
over our control plane.

Wire protocol engine-side (`PreprocessedRequest` ↔ dict, `TokenDelta` ↔
dict) lives in this module so worker and frontend agree by construction.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import AsyncIterator, Callable, Dict, Optional

import numpy as np

from dynamo_tpu_torch.engine.engine import TokenDelta
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import FinishReason
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor, PreprocessedRequest
from dynamo_tpu_torch.llm.service import ModelHandle, ModelManager
from dynamo_tpu_torch.runtime.distributed import (
    MODEL_ROOT,
    Client,
    DistributedRuntime,
    Endpoint,
    Instance,
)
from dynamo_tpu_torch.runtime import ledger as ledger_mod
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.rpc import RpcError

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Wire codecs


def request_to_wire(req: PreprocessedRequest) -> dict:
    s = req.sampling
    d = {
        "request_id": req.request_id,
        "model": req.model,
        "token_ids": list(req.token_ids),
        "sampling": {
            "temperature": s.temperature, "top_k": s.top_k, "top_p": s.top_p,
            "max_tokens": s.max_tokens,
            "stop_token_ids": list(s.stop_token_ids), "seed": s.seed,
            "logprobs": s.logprobs,
            "seed_offset": s.seed_offset,
        },
        "stop_sequences": list(req.stop_sequences),
        "annotations": dict(req.annotations),
    }
    if req.prompt_embeds is not None:
        # Multimodal embeddings ride the request frame as raw float32
        # bytes (the frontend -> worker leg of encode -> prefill).
        emb = np.ascontiguousarray(np.asarray(req.prompt_embeds,
                                              dtype=np.float32))
        d["prompt_embeds"] = emb.tobytes()
        d["prompt_embeds_shape"] = list(emb.shape)
    return d


def request_from_wire(d: dict) -> PreprocessedRequest:
    s = d.get("sampling", {})
    embeds = None
    if d.get("prompt_embeds") is not None:
        embeds = np.frombuffer(d["prompt_embeds"], dtype=np.float32) \
            .reshape(d["prompt_embeds_shape"]).copy()
    return PreprocessedRequest(
        request_id=d["request_id"], model=d.get("model", ""),
        token_ids=list(d["token_ids"]),
        sampling=SamplingParams(
            temperature=s.get("temperature", 0.0),
            top_k=s.get("top_k", 0), top_p=s.get("top_p", 1.0),
            max_tokens=s.get("max_tokens", 16),
            stop_token_ids=tuple(s.get("stop_token_ids", ())),
            seed=s.get("seed"),
            logprobs=bool(s.get("logprobs", False)),
            seed_offset=int(s.get("seed_offset", 0))),
        stop_sequences=list(d.get("stop_sequences", [])),
        annotations=dict(d.get("annotations", {})),
        prompt_embeds=embeds,
    )


def delta_to_wire(delta: TokenDelta) -> dict:
    d = {
        "token_ids": list(delta.token_ids),
        "finished": delta.finished,
        "finish_reason": delta.finish_reason.value if delta.finish_reason else None,
    }
    if delta.logprobs is not None:
        d["logprobs"] = list(delta.logprobs)
    if delta.migrate is not None:
        # Drain handoff marker (llm/drain.py): old frontends never see it
        # set; old workers never set it.
        d["migrate"] = dict(delta.migrate)
    if delta.ledger is not None:
        # The worker hop's ledger rides the final delta; old peers never
        # read the key, and garbage is dropped at the merge, never the
        # request.
        d["ledger"] = delta.ledger
    return d


def delta_from_wire(d: dict) -> TokenDelta:
    fr = d.get("finish_reason")
    lp = d.get("logprobs")
    mig = d.get("migrate")
    return TokenDelta(
        request_id="", token_ids=list(d.get("token_ids", [])),
        finished=bool(d.get("finished")),
        finish_reason=FinishReason(fr) if fr else None,
        logprobs=list(lp) if lp is not None else None,
        migrate=dict(mig) if mig is not None else None,
        # Carried raw: ledger.decode_wire validates at the merge point.
        ledger=d.get("ledger"))


EMBED_ENDPOINT = "embed"
CLEAR_KV_ENDPOINT = "clear_kv"


def engine_wire_handler(engine_client, request_metrics=None) -> Callable:
    """Wrap any EngineClient as an RPC handler (worker side).

    `request_metrics` (runtime/metrics.RequestMetrics): when given, the
    handler observes worker-side TTFT / TPOT and terminal outcomes — the
    worker's own SLO sources, measured at the RPC boundary.  A few
    monotonic reads per delta on the event loop; nothing touches the
    engine thread."""

    async def handler(payload: dict) -> AsyncIterator[dict]:
        req = request_from_wire(payload)
        # This hop's ledger, when the worker has the plane on AND the
        # request opted in; inner stages (disagg, prefix share, the
        # local client) stamp it, and it rides back on the final delta.
        hop_ledger = ledger_mod.begin_hop(req)
        # The frontend's request id arrives in the RPC frame; logging it
        # here gives one grep-able id across frontend and worker logs
        # (reference `logging.rs:73-79`).  The RPC server span is this
        # task's current span; binding it to the request id lets the
        # engine thread parent its spans under this hop.
        logger.info("request %s: %d prompt tokens, max_tokens=%d",
                    req.request_id, len(req.token_ids),
                    req.sampling.max_tokens)
        tracer = tracing.get_tracer()
        span = tracing.current_span()
        if span is not None:
            tracer.bind(req.request_id, span.ctx)
        n_out = 0
        start = time.monotonic()
        last_t = None
        finished_ok = None
        observe = True
        if hop_ledger is not None:
            # The hop's intake up to the engine's submission: with the
            # engine's stamps it tiles the hop's time to its first token,
            # which the frontend's `rpc` stamp takes off its round trip.
            hop_ledger.stamp("receive", dur=start - hop_ledger.anchor,
                             t=start)
        try:
            async for delta in engine_client.generate(req):
                if delta.migrate is not None:
                    # Drain handoff: the peer serves (and observes) the
                    # rest of this stream: one request, one outcome.
                    observe = False
                if request_metrics is not None and delta.token_ids:
                    now = time.monotonic()
                    if last_t is None:
                        request_metrics.ttft.observe(now - start)
                    else:
                        request_metrics.tpot.observe(now - last_t)
                    last_t = now
                if delta.finished:
                    finished_ok = delta.finish_reason is not FinishReason.ERROR
                if hop_ledger is not None and (
                        delta.finished or delta.migrate is not None):
                    # The stream's last delta out of this worker carries
                    # the hop's stamps, a drain's migrate delta too.
                    delta.ledger = hop_ledger.to_wire()
                n_out += len(delta.token_ids)
                yield delta_to_wire(delta)
        except (GeneratorExit, asyncio.CancelledError):
            raise  # client disconnect / teardown: not an engine failure
        except Exception as e:
            from dynamo_tpu_torch.llm.drain import DRAIN_REFUSAL

            if DRAIN_REFUSAL in str(e):
                # A draining worker refusing an admission: the peer the
                # request re-routes to serves and observes it.
                observe = False
            else:
                # A raising generate() (a dead disagg peer, an engine
                # fault) is a served-request failure: it burns budget.
                finished_ok = False
            raise
        finally:
            tracer.unbind(req.request_id)
            if request_metrics is not None and observe:
                # A stream torn down without a terminal delta (client
                # disconnect mid-generation) is not an engine failure.
                request_metrics.observe_outcome(
                    ok=finished_ok if finished_ok is not None else True)
        logger.info("request %s: finished, %d tokens", req.request_id, n_out)

    return handler


def clear_kv_wire_handler(engine_client) -> Callable:
    """Worker-side `clear_kv` admin endpoint."""

    async def handler(payload: dict) -> AsyncIterator[dict]:
        n = await engine_client.clear_kv_blocks()
        yield {"cleared": int(n)}

    return handler


def embed_wire_handler(engine_client) -> Callable:
    """Worker-side `embed` RPC endpoint: one delta per input row."""

    async def handler(payload: dict) -> AsyncIterator[dict]:
        vecs = await engine_client.embed(payload["token_lists"])
        for i, vec in enumerate(vecs):
            yield {"index": i, "embedding": [float(x) for x in vec]}

    return handler


class RemoteEngineClient:
    """EngineClient over a runtime Client (frontend side)."""

    def __init__(self, client: Client) -> None:
        self.client = client

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[TokenDelta]:
        sent = time.monotonic()
        first = None
        async for d in self.client.generate(request_to_wire(request)):
            delta = delta_from_wire(d)
            delta.request_id = request.request_id
            if first is None and delta.token_ids:
                first = time.monotonic()
            # Fold a returned hop ledger into the frontend's live one.
            ledger_mod.absorb_delta(request, delta, where="remote_client",
                                    sent=sent, first=first)
            yield delta

    async def clear_kv_blocks(self) -> int:
        """Flush every live instance's reusable KV blocks, the workers of
        the sibling `<component>-prefill` component included (their warm
        caches would survive otherwise).  A worker without the endpoint
        is skipped; unreachable ones make the call raise, naming them,
        after the others are flushed."""
        runtime = self.client.endpoint.runtime
        ep = self.client.endpoint
        addresses = [inst.address for inst in self.client.instances()]
        prefill_prefix = (f"instances/{ep.namespace}/"
                          f"{ep.component}-prefill/")
        for entry in (await runtime.cp.get_prefix(prefill_prefix)).values():
            addr = entry.get("address")
            if addr:
                addresses.append(addr)
        total = 0
        unreachable = []
        for address in addresses:
            rpc = runtime.client_for(address)
            try:
                async for d in rpc.call(CLEAR_KV_ENDPOINT, {}):
                    total += int(d.get("cleared", 0))
            except RpcError:
                continue  # the endpoint is absent on this worker
            except ConnectionError:
                await runtime.evict_client(address)
                unreachable.append(address)
        if unreachable:
            # A partial flush is loud: the operator must know which
            # workers kept their warm caches.
            raise ConnectionError(
                f"flushed {total} blocks but {len(unreachable)} instances "
                f"were unreachable: {', '.join(unreachable)}")
        return total

    async def embed(self, token_lists):
        """Forward to one worker's `embed` endpoint (round-robin over the
        live instances); [n, hidden] f32."""
        inst = self.client._pick()
        rpc = self.client.endpoint.runtime.client_for(inst.address)
        rows = {}
        try:
            async for d in rpc.call(
                    EMBED_ENDPOINT,
                    {"token_lists": [list(t) for t in token_lists]}):
                rows[d["index"]] = d["embedding"]
        except ConnectionError:
            # As Client.generate does: drop the cached client so the next
            # attempt reconnects.
            await self.client.endpoint.runtime.evict_client(inst.address)
            raise
        if len(rows) != len(token_lists):
            raise ConnectionError(
                f"embed stream ended early: {len(rows)}/{len(token_lists)} "
                "rows (worker died mid-request?)")
        return np.asarray([rows[i] for i in range(len(token_lists))],
                          dtype=np.float32)


# ---------------------------------------------------------------------------
# Registration (worker side)


def model_key(name: str, instance_id: int) -> str:
    return f"{MODEL_ROOT}/{name}/{instance_id}"


async def register_llm(
    endpoint: Endpoint,
    instance: Instance,
    card: ModelDeploymentCard,
) -> None:
    """Publish the model entry bound to this instance's lease: when the
    worker dies, the entry dies with it (reference ModelEntry under
    MODEL_ROOT_PATH + lease semantics).  The instance record's published
    SliceSpec (`fleet.topology`) rides along so frontends see
    a worker's mesh/role/HBM without a second lookup."""
    entry = {
        "card": card.to_dict(),
        "namespace": endpoint.namespace,
        "component": endpoint.component,
        "endpoint": endpoint.name,
        "instance_id": instance.instance_id,
    }
    slice_spec = (instance.metadata or {}).get("slice")
    if slice_spec is not None:
        entry["slice"] = slice_spec

    async def _put():
        # Bound to the endpoint's CURRENT lease so a control-plane
        # restart replays the model entry too (Endpoint re-registration).
        await endpoint.runtime.cp.put(
            model_key(card.name, instance.instance_id), entry,
            lease=endpoint._lease)

    await _put()
    endpoint.add_registration_put(_put)


# ---------------------------------------------------------------------------
# ModelWatcher (frontend side)


class ModelWatcher:
    """Watches `models/`; maintains the frontend's ModelManager."""

    def __init__(self, runtime: DistributedRuntime,
                 manager: ModelManager,
                 router_mode: str = "round_robin",
                 migration_limit: int = 3,
                 registry=None, mm_plane=None) -> None:
        """`mm_plane`: the device transfer plane (or a zero-argument
        callable making it at first use) the multimodal hook pulls
        encode workers' embeddings over; None sends them inline."""
        self.runtime = runtime
        self.mm_plane = mm_plane
        self.manager = manager
        self.router_mode = router_mode
        self.migration_limit = migration_limit
        # The frontend's MetricsRegistry: the router's and migration's
        # series land on its /metrics.
        self.registry = registry
        self._instances: Dict[str, set] = {}       # model → instance ids
        self._clients: Dict[str, Client] = {}
        self._kv_clients: Dict[str, object] = {}   # model → KvRoutedEngineClient
        self._task: Optional[asyncio.Task] = None
        self._watch = None

    async def start(self) -> None:
        self._watch = await self.runtime.cp.watch_prefix(f"{MODEL_ROOT}/")
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
        for c in self._clients.values():
            await c.stop()
        for kv in self._kv_clients.values():
            await kv.stop()

    async def wait_for_model(self, name: str, timeout: float = 10.0) -> None:
        """Return once `name` is registered; TimeoutError after `timeout`
        seconds."""
        async def poll():
            while self.manager.get(name) is None:
                await asyncio.sleep(0.01)
        await asyncio.wait_for(poll(), timeout)

    def kv_index_blocks(self) -> Dict[str, Dict[str, int]]:
        """Per model, the blocks this frontend's KV router indexes for
        each worker (kv router mode only; workers with none are left
        out)."""
        out = {}
        for name, kv in self._kv_clients.items():
            tree = kv.router.indexer.tree if kv.router.indexer else None
            out[name] = ({str(w): len(tree.blocks_for_worker(w))
                          for w in tree.workers()} if tree else {})
        return out

    async def _loop(self) -> None:
        while True:
            try:
                async for ev in self._watch:
                    try:
                        if ev.kind == "put" and ev.value:
                            await self._on_put(ev.key, ev.value)
                        elif ev.kind == "delete":
                            await self._on_delete(ev.key)
                    except Exception:
                        logger.exception("model watcher event failed: %s",
                                         ev.key)
                return
            except ConnectionError:
                # One poison per control-plane outage; the client's
                # reconnect re-registers the watch and replays state
                # into the same queue — resume consuming (stop()
                # cancels this task at shutdown).  Unhandled, this was
                # "Task exception was never retrieved" teardown noise.
                logger.debug("model watcher: control plane connection "
                             "lost; resuming on replay")
                continue

    async def _on_put(self, key: str, entry: dict) -> None:
        card = ModelDeploymentCard.from_dict(entry["card"])
        name = card.name
        ids = self._instances.setdefault(name, set())
        ids.add(entry["instance_id"])
        if self.manager.get(name) is not None:
            return  # additional replica of a known model
        endpoint = (self.runtime.namespace(entry["namespace"])
                    .component(entry["component"])
                    .endpoint(entry["endpoint"]))
        client = await endpoint.client(
            "round_robin" if self.router_mode == "kv" else self.router_mode)
        self._clients[name] = client
        tokenizer = card.build_tokenizer()
        # Declarative operator pipeline (runtime/pipeline.py; reference
        # build_routed_pipeline, `entrypoint/input/common.rs:213`):
        # Migration (retry across worker death) wraps the router
        # (KV-aware or plain round-robin), which wraps the instance set.
        from dynamo_tpu_torch.runtime.pipeline import (
            KvRouterOp, MigrationOp, Pipeline, RemoteOp)

        router_op = (KvRouterOp(self.runtime, block_size=card.kv_block_size,
                                registry=self.registry)
                     if self.router_mode == "kv" else RemoteOp())
        pipeline = Pipeline([
            MigrationOp(limit=self.migration_limit, registry=self.registry),
            router_op])
        engine_client = await pipeline.attach(client)
        if self.router_mode == "kv":
            from dynamo_tpu_torch.llm.kv_router.client import KvRoutedEngineClient

            self._kv_clients[name] = pipeline.stage_of(KvRoutedEngineClient)
        # Multimodal: every model's hook points at the namespace's
        # encoder endpoint (`encoder/encode`); a chat without image parts
        # never touches it, one with them gets a 502 while no encode
        # worker is live.
        from dynamo_tpu_torch.llm.multimodal import MultimodalAttach

        mm = MultimodalAttach(
            endpoint=(self.runtime.namespace(entry["namespace"])
                      .component("encoder").endpoint("encode")),
            transfer_plane=self.mm_plane)
        self.manager.register(ModelHandle(
            name=name, tokenizer=tokenizer,
            preprocessor=OpenAIPreprocessor(
                tokenizer, chat_template=card.chat_template,
                default_max_tokens=card.default_max_tokens),
            client=engine_client,
            max_context=card.max_context,
            multimodal=mm))
        logger.info("model %r registered (instance %d)", name,
                    entry["instance_id"])

    async def _on_delete(self, key: str) -> None:
        # models/{name}/{instance_id}
        _, name, iid = key.rsplit("/", 2)
        ids = self._instances.get(name)
        if ids is None:
            return
        ids.discard(int(iid))
        if not ids:
            self.manager.remove(name)
            client = self._clients.pop(name, None)
            if client:
                await client.stop()
            kv = self._kv_clients.pop(name, None)
            if kv:
                await kv.stop()
            logger.info("model %r removed (no instances left)", name)
