"""DistributedRuntime: Namespace → Component → Endpoint → Client.

Port of `dynamo_tpu/runtime/distributed.py`.

Role of the reference's `lib/runtime/src/{distributed,component}.rs`
(SURVEY.md §2.1): a cluster handle owning the control-plane connection and
one RpcServer; components register endpoint instances under

    instances/{namespace}/{component}/{endpoint}:{lease_id}

with lease-backed liveness (value carries the worker's RPC address +
metadata); clients watch that prefix, keep a live instance set, and route
with the PushRouter modes (random / round-robin / direct / KV —
`pipeline/network/egress/push_router.rs:31-62`).
"""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, List, Optional

from dynamo_tpu_torch.runtime.rpc import Handler, RpcClient, RpcServer

logger = logging.getLogger(__name__)

INSTANCE_ROOT = "instances"
MODEL_ROOT = "models"  # reference MODEL_ROOT_PATH (`discovery.rs:14`)


@dataclass(frozen=True)
class Instance:
    """One live endpoint instance (reference `component.rs` Instance)."""

    instance_id: int           # lease id doubles as instance id
    namespace: str
    component: str
    endpoint: str
    address: str               # host:port of the worker's RpcServer
    metadata: dict = field(default_factory=dict)

    @property
    def key(self) -> str:
        return (f"{INSTANCE_ROOT}/{self.namespace}/{self.component}/"
                f"{self.endpoint}:{self.instance_id}")

    def to_dict(self) -> dict:
        return {"instance_id": self.instance_id, "namespace": self.namespace,
                "component": self.component, "endpoint": self.endpoint,
                "address": self.address, "metadata": self.metadata}

    @staticmethod
    def from_dict(d: dict) -> "Instance":
        return Instance(
            instance_id=d["instance_id"], namespace=d["namespace"],
            component=d["component"], endpoint=d["endpoint"],
            address=d["address"], metadata=d.get("metadata", {}))


class DistributedRuntime:
    """Per-process cluster handle (reference `DistributedRuntime`,
    `lib/runtime/src/lib.rs:153`)."""

    def __init__(self, control_plane, rpc_host: str = "127.0.0.1") -> None:
        self.cp = control_plane
        self.rpc = RpcServer()
        self._rpc_host = rpc_host
        self._started = False
        self._clients: Dict[str, RpcClient] = {}

    async def start(self) -> None:
        if not self._started:
            await self.rpc.start(self._rpc_host)
            self._started = True

    async def shutdown(self) -> None:
        for c in self._clients.values():
            await c.close()
        await self.rpc.stop()

    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, name)

    def client_for(self, address: str) -> RpcClient:
        c = self._clients.get(address)
        if c is None:
            c = RpcClient(address)
            self._clients[address] = c
        return c

    async def evict_client(self, address: str) -> None:
        """Drop the cached client for a dead address (workers use ephemeral
        ports, so churn would otherwise grow the cache unboundedly)."""
        c = self._clients.pop(address, None)
        if c is not None:
            await c.close()


@dataclass
class Namespace:
    runtime: DistributedRuntime
    name: str

    def component(self, name: str) -> "Component":
        return Component(self.runtime, self.name, name)


@dataclass
class Component:
    runtime: DistributedRuntime
    namespace: str
    name: str

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.runtime, self.namespace, self.name, name)


class Endpoint:
    def __init__(self, runtime: DistributedRuntime, namespace: str,
                 component: str, name: str) -> None:
        self.runtime = runtime
        self.namespace = namespace
        self.component = component
        self.name = name
        self._lease: Optional[int] = None
        self._instance: Optional[Instance] = None
        self._session_cb = None
        # Extra leased puts replayed on re-registration (register_llm's
        # model entry rides here).
        self._extra_puts: List = []

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.name}"

    @property
    def rpc_name(self) -> str:
        return self.path

    # -- serving ----------------------------------------------------------

    async def serve(self, handler: Handler,
                    metadata: Optional[dict] = None,
                    lease_ttl: float = 10.0) -> Instance:
        """Register the handler and announce the instance (reference
        `endpoint.serve_endpoint`)."""
        await self.runtime.start()
        self.runtime.rpc.register(self.rpc_name, handler)
        lease = await self.runtime.cp.lease_grant(lease_ttl)
        inst = Instance(
            instance_id=lease, namespace=self.namespace,
            component=self.component, endpoint=self.name,
            address=self.runtime.rpc.address, metadata=metadata or {})
        await self.runtime.cp.put(inst.key, inst.to_dict(), lease=lease)
        self._lease, self._instance = lease, inst
        # Survive a control-plane restart: when the client reports the
        # server-side session lost (reconnect done, or keepalive found
        # the lease dead), grant a fresh lease and replay every
        # registration under the SAME instance id — router state, KV
        # events and in-flight streams all key on it (reference
        # `transports/etcd.rs` lease recovery).
        on_loss = getattr(self.runtime.cp, "on_session_loss", None)
        if on_loss is not None:
            async def _reregister():
                if self._instance is None or self._lease is None:
                    return  # left gracefully; do not resurrect
                new_lease = await self.runtime.cp.lease_grant(lease_ttl)
                self._lease = new_lease
                await self.runtime.cp.put(self._instance.key,
                                          self._instance.to_dict(),
                                          lease=new_lease)
                for put in list(self._extra_puts):
                    await put()
                logger.warning(
                    "re-registered %s (instance %d) under lease %d after "
                    "control-plane session loss", self.path,
                    self._instance.instance_id, new_lease)

            self._session_cb = _reregister
            on_loss(_reregister)
        logger.info("serving %s as instance %d at %s",
                    self.path, lease, inst.address)
        return inst

    def add_registration_put(self, put) -> None:
        """Register an async callable replayed (bound to the current
        lease) whenever the endpoint re-registers after a control-plane
        session loss."""
        self._extra_puts.append(put)

    async def leave(self) -> None:
        """Graceful deregistration: revoke lease (instant removal from
        routing — reference decode-worker scale-down semantics,
        `load_planner.md:21`), keep serving in-flight streams."""
        if self._session_cb is not None:
            remove = getattr(self.runtime.cp, "remove_session_callback",
                             None)
            if remove is not None:
                remove(self._session_cb)
            self._session_cb = None
        self._instance = None  # a later session loss must not resurrect
        if self._lease is not None:
            await self.runtime.cp.lease_revoke(self._lease)
            self._lease = None

    # -- client side ------------------------------------------------------

    async def client(self, router_mode: str = "round_robin") -> "Client":
        c = Client(self, router_mode)
        await c.start()
        return c


class Client:
    """Instance-set watcher + push router (reference `component/client.rs`
    InstanceSource::Dynamic + `push_router.rs` modes)."""

    def __init__(self, endpoint: Endpoint, router_mode: str = "round_robin"):
        self.endpoint = endpoint
        self.router_mode = router_mode
        self._instances: Dict[int, Instance] = {}
        self._watch = None
        self._watch_task: Optional[asyncio.Task] = None
        self._rr = 0
        self._ready = asyncio.Event()

    @property
    def prefix(self) -> str:
        e = self.endpoint
        return f"{INSTANCE_ROOT}/{e.namespace}/{e.component}/{e.name}:"

    async def start(self) -> None:
        # watch_prefix delivers current state as synthetic put events
        # before live updates, so the watch loop alone maintains the set.
        self._watch = await self.endpoint.runtime.cp.watch_prefix(self.prefix)
        self._watch_task = asyncio.create_task(self._watch_loop())

    async def stop(self) -> None:
        if self._watch:
            self._watch.cancel()
        if self._watch_task:
            self._watch_task.cancel()
            try:
                await self._watch_task
            except asyncio.CancelledError:
                pass

    async def _watch_loop(self) -> None:
        while True:
            try:
                await self._watch_events()
                return
            except ConnectionError:
                # One poison per control-plane outage.  The client's
                # reconnect path re-registers the watch and replays
                # current state as synthetic puts into this SAME queue,
                # so the consumer must RESUME iterating, not exit —
                # exiting froze discovery for the process lifetime.
                # (At shutdown stop() cancels this task, which breaks
                # the loop via CancelledError.)  Unhandled, the error
                # also surfaced as "Task exception was never retrieved"
                # noise at loop close in every distributed test.
                continue

    async def _watch_events(self) -> None:
        async for ev in self._watch:
            if ev.kind == "put" and ev.value:
                inst = Instance.from_dict(ev.value)
                self._instances[inst.instance_id] = inst
                self._ready.set()
            elif ev.kind == "delete":
                iid = int(ev.key.rsplit(":", 1)[1])
                self._instances.pop(iid, None)
                if not self._instances:
                    self._ready.clear()

    # -- instance views ---------------------------------------------------

    def instance_ids(self) -> List[int]:
        return sorted(self._instances)

    def instances(self) -> List[Instance]:
        return [self._instances[i] for i in sorted(self._instances)]

    async def wait_for_instances(self, timeout: float = 10.0) -> None:
        await asyncio.wait_for(self._ready.wait(), timeout)

    # -- routing ----------------------------------------------------------

    def _pick(self, instance_id: Optional[int] = None) -> Instance:
        if not self._instances:
            raise NoInstancesError(f"no instances for {self.endpoint.path}")
        if instance_id is not None:  # direct
            inst = self._instances.get(instance_id)
            if inst is None:
                raise NoInstancesError(
                    f"instance {instance_id} gone from {self.endpoint.path}")
            return inst
        ids = sorted(self._instances)
        if self.router_mode == "random":
            return self._instances[random.choice(ids)]
        # round_robin default
        inst = self._instances[ids[self._rr % len(ids)]]
        self._rr += 1
        return inst

    async def generate(
        self, payload: dict, instance_id: Optional[int] = None
    ) -> AsyncIterator[dict]:
        """Route one streaming request (push router).  Raises
        ConnectionError mid-stream if the instance dies — the migration
        operator's retry signal."""
        inst = self._pick(instance_id)
        client = self.endpoint.runtime.client_for(inst.address)
        try:
            async for delta in client.call(self.endpoint.rpc_name, payload):
                yield delta
        except ConnectionError:
            # Dead address: evict the cached client so churned workers
            # don't accumulate, then let migration handle the retry.
            await self.endpoint.runtime.evict_client(inst.address)
            raise

    async def direct(self, payload: dict,
                     instance_id: int) -> AsyncIterator[dict]:
        async for d in self.generate(payload, instance_id=instance_id):
            yield d


class NoInstancesError(RuntimeError):
    """No live instances (reference NATS NoResponders analog)."""
