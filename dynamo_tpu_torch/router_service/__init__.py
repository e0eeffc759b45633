"""Standalone KV-router service (port of `dynamo_tpu/router_service/`).

Role of the reference's `components/router` binary
(`components/router/src/main.rs:27-44`): host the KV-aware router as its
own `dyn://` endpoint so multiple simple frontends (or non-HTTP clients)
share ONE routing brain instead of each running their own indexer.

Composition: the service discovers a model's workers, builds the same
KvRoutedEngineClient the frontend embeds, then REGISTERS ITSELF as a
worker for that model under its own component.  Any frontend in plain
round-robin mode that discovers the router's entry routes through it and
transparently gets KV-aware placement; the router's replica-sync keeps
multiple router instances consistent (client.py ACTIVE_SEQS).
"""

from __future__ import annotations

import logging
from typing import Optional

from dynamo_tpu_torch.llm.discovery import (
    ModelWatcher,
    engine_wire_handler,
    register_llm,
)
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.service import ModelManager
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

logger = logging.getLogger(__name__)


class RouterService:
    """Discover workers for `model_name`, serve a kv-routed endpoint for
    it, and register that endpoint as a model instance."""

    def __init__(self, runtime: DistributedRuntime, model_name: str,
                 namespace: str = "dynamo",
                 component: str = "router",
                 serve_as: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None) -> None:
        """`serve_as`: public model name of the routed endpoint (default
        `<model>-routed`) — distinct from the raw workers' name so a
        frontend discovering both never mixes routed and unrouted
        replicas of one model, and the router can never discover
        itself."""
        self.runtime = runtime
        self.model_name = model_name
        self.serve_as = serve_as or f"{model_name}-routed"
        self.namespace = namespace
        self.component = component
        self.models = ModelManager()
        self.watcher = ModelWatcher(self.runtime, self.models,
                                    router_mode="kv")
        self.instance = None
        self._endpoint = None
        # Routing-brain observability (`/metrics` via the shared
        # registry on a StatusServer; satellite of the tracing PR —
        # frontend/worker/aggregator already expose one, the router did
        # not).
        self.registry = registry or MetricsRegistry()
        self._requests = self.registry.counter(
            "router_requests_total", "Requests routed through this "
            "router service")
        self._streams = self.registry.gauge(
            "router_inflight_streams", "Streams currently routed")
        self._route_latency = self.registry.histogram(
            "router_request_seconds", "Full routed-stream duration")

    async def start(self, wait_for_model_s: float = 30.0) -> None:
        await self.watcher.start()
        await self.watcher.wait_for_model(self.model_name,
                                          timeout=wait_for_model_s)
        handle = self.models.get(self.model_name)
        self._endpoint = (self.runtime.namespace(self.namespace)
                          .component(self.component).endpoint("generate"))
        self.instance = await self._endpoint.serve(
            engine_wire_handler(self._counted(handle.client)))
        # Reuse the discovered card so tokenizer/template survive the hop,
        # re-advertised under the routed name.
        card_dict = None
        entries = await self.runtime.cp.get_prefix("models/")
        for entry in entries.values():
            if entry.get("card", {}).get("name") == self.model_name:
                card_dict = dict(entry["card"])
                break
        if card_dict is not None:
            card_dict["name"] = self.serve_as
            card = ModelDeploymentCard.from_dict(card_dict)
        else:
            card = ModelDeploymentCard(name=self.serve_as)
        await register_llm(self._endpoint, self.instance, card)
        logger.info("router service for %r at %s", self.model_name,
                    self.instance.address)

    def _counted(self, client):
        """Wrap the routed EngineClient so every stream through the
        router lands in the registry (request count, in-flight gauge,
        stream duration)."""
        svc = self

        class _Counted:
            async def generate(self, request):
                import time

                svc._requests.inc()
                svc._streams.add(1)
                t0 = time.monotonic()
                try:
                    async for delta in client.generate(request):
                        yield delta
                finally:
                    svc._streams.add(-1)
                    svc._route_latency.observe(time.monotonic() - t0)

            def __getattr__(self, name):  # embed / clear_kv passthrough
                return getattr(client, name)

        return _Counted()

    async def stop(self) -> None:
        if self._endpoint is not None:
            await self._endpoint.leave()
        await self.watcher.stop()
