"""Declarative operator pipeline over the EngineClient contract (port of
`dynamo_tpu/runtime/pipeline.py`).

Role of the reference's `lib/runtime/src/pipeline/nodes.rs` (351 LoC:
`Operator` / `ServiceFrontend` / `ServiceBackend` / `SegmentSource` with
forward/backward edges): the frontend assembles
Frontend→Preproc→Backend→Migration→Router as a LINKED graph rather than
hand-nested constructors (`entrypoint/input/common.rs:183,213`).

Here the streaming contract is `EngineClient.generate(PreprocessedRequest)
-> AsyncIterator[TokenDelta]` (llm/service.py — the AsyncEngine analog),
and an Operator is anything that wraps one EngineClient into another:

    pipeline = Pipeline([
        MigrationOp(limit=3),
        KvRouterOp(runtime, block_size=64),
    ])
    engine_client = await pipeline.attach(instance_client)

Operators compose right-to-left (the last op sits closest to the wire),
matching the reference's build_routed_pipeline ordering.
"""

from __future__ import annotations

import inspect
from typing import List, Protocol


class Operator(Protocol):
    """Wraps the downstream EngineClient; may return an awaitable when
    the wrapper needs async startup (e.g. the KV router's event
    subscriptions)."""

    def wrap(self, inner): ...


class MigrationOp:
    """Retry/resume streams across worker death (llm/migration.py;
    reference `migration.rs:27`).  `registry` counts
    `dynamo_migrations_total{reason}` on the frontend's /metrics."""

    def __init__(self, limit: int = 3, registry=None) -> None:
        self.limit = limit
        self.registry = registry

    def wrap(self, inner):
        from dynamo_tpu_torch.llm.migration import MigrationClient

        return MigrationClient(inner, migration_limit=self.limit,
                               registry=self.registry)


class KvRouterOp:
    """KV-aware worker selection over the instance set (llm/kv_router/
    client.py; reference `kv_router.rs:304` KvPushRouter)."""

    def __init__(self, runtime, block_size: int = 64,
                 registry=None) -> None:
        self.runtime = runtime
        self.block_size = block_size
        self.registry = registry

    async def wrap(self, inner):
        from dynamo_tpu_torch.llm.kv_router.client import KvRoutedEngineClient

        routed = KvRoutedEngineClient(inner, self.runtime,
                                      block_size=self.block_size,
                                      registry=self.registry)
        await routed.start()
        return routed


class RemoteOp:
    """Instance-set Client → EngineClient (wire codec boundary;
    llm/discovery.RemoteEngineClient)."""

    def wrap(self, inner):
        from dynamo_tpu_torch.llm.discovery import RemoteEngineClient

        return RemoteEngineClient(inner)


class Pipeline:
    """Ordered operator list; `attach(sink)` folds them around the sink
    right-to-left and returns the outermost EngineClient.

    `stages` records every built client (innermost first) so owners can
    reach a specific stage without knowing the wrapper nesting
    (`stage_of(SomeClientClass)`)."""

    def __init__(self, operators: List[Operator]) -> None:
        self.operators = operators
        self.stages: List = []

    async def attach(self, sink):
        client = sink
        self.stages = [sink]
        for op in reversed(self.operators):
            client = op.wrap(client)
            if inspect.isawaitable(client):
                client = await client
            self.stages.append(client)
        return client

    def stage_of(self, cls):
        """The built stage of the given class, or None."""
        for st in self.stages:
            if isinstance(st, cls):
                return st
        return None
