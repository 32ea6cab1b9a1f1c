"""Component model: Namespace → Component → Endpoint → Instance.

Port of `dynamo_tpu/runtime/component.py` (the port keeps its own copy);
the health-canary hook waits with the health manager.

Reference: `lib/runtime/src/component.rs` (naming + registration) and
`component/{client,endpoint}.rs`. Instances register under
``v1/instances/{ns}/{component}/{endpoint}/{instance_id}`` attached to the
process lease, so a dead process's instances vanish from watches (liveness).
The endpoint "subject" (``ns.component.endpoint-<id>``) is what the transport
dispatches on — the analog of the reference's NATS subject
(`component.rs:521 Endpoint::subject`).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.runtime.engine import AsyncEngine, FnEngine
from dynamo_tpu_torch.runtime.store import DELETE, PUT, RESET, Watch

logger = logging.getLogger(__name__)

INSTANCE_PREFIX = "v1/instances/"


@dataclass(frozen=True)
class Instance:
    """A live registration of one endpoint served by one process."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int
    address: str  # transport address host:port
    metadata: dict = field(default_factory=dict, hash=False, compare=False)

    @property
    def subject(self) -> str:
        return f"{self.namespace}.{self.component}.{self.endpoint}-{self.instance_id:x}"

    @property
    def etcd_key(self) -> str:
        return (f"{INSTANCE_PREFIX}{self.namespace}/{self.component}/"
                f"{self.endpoint}/{self.instance_id:x}")

    def to_json(self) -> bytes:
        return json.dumps({
            "namespace": self.namespace, "component": self.component,
            "endpoint": self.endpoint, "instance_id": self.instance_id,
            "address": self.address, "metadata": self.metadata,
        }).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Instance":
        d = json.loads(raw)
        return cls(d["namespace"], d["component"], d["endpoint"],
                   d["instance_id"], d["address"], d.get("metadata", {}))


class Namespace:
    def __init__(self, runtime: "DistributedRuntime", name: str) -> None:  # noqa: F821
        self.runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)


class Component:
    def __init__(self, namespace: Namespace, name: str) -> None:
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    @property
    def path(self) -> str:
        return f"{self.namespace.name}/{self.name}"


class Endpoint:
    def __init__(self, component: Component, name: str) -> None:
        self.component = component
        self.name = name

    @property
    def runtime(self):
        return self.component.namespace.runtime

    @property
    def instance_prefix(self) -> str:
        return (f"{INSTANCE_PREFIX}{self.component.namespace.name}/"
                f"{self.component.name}/{self.name}/")

    async def serve(self, handler: AsyncEngine | Callable,
                    instance_id: Optional[int] = None,
                    metadata: Optional[dict] = None) -> "ServedEndpoint":
        """Register + serve this endpoint from the local process.

        Reference: `component/endpoint.rs:61` EndpointConfigBuilder::start —
        spawns a PushEndpoint and registers the instance under the lease."""
        rt = self.runtime
        engine = handler if isinstance(handler, AsyncEngine) else FnEngine(handler)
        if instance_id is None:
            # Reference uses the etcd lease id as instance id; we derive a
            # random 63-bit id (stable for the lifetime of this serve).
            instance_id = random.getrandbits(63)
        inst = Instance(
            namespace=self.component.namespace.name,
            component=self.component.name,
            endpoint=self.name,
            instance_id=instance_id,
            address=rt.transport_address,
            metadata=metadata or {},
        )
        rt.transport_server.register(inst.subject, engine)
        rt.register_local(inst.subject, engine)
        await rt.store.put(inst.etcd_key, inst.to_json(), rt.lease_id)
        served = ServedEndpoint(self, inst, engine)

        async def _reput() -> None:
            # coordinator restarted: the fresh store has no instance key
            # (and rt.lease_id is already the re-created lease)
            await rt.store.put(inst.etcd_key, inst.to_json(), rt.lease_id)

        served._reput = _reput
        rt.replay_on_reconnect(_reput)
        return served

    async def client(self, static_instances: Optional[list[Instance]] = None
                     ) -> "EndpointClient":
        return EndpointClient(self, static_instances)


class ServedEndpoint:
    def __init__(self, endpoint: Endpoint, instance: Instance,
                 engine: AsyncEngine) -> None:
        self.endpoint = endpoint
        self.instance = instance
        self.engine = engine
        self._reput = None      # reconnect re-registration (serve())

    async def shutdown(self) -> None:
        rt = self.endpoint.runtime
        if self._reput is not None:
            rt.drop_replay(self._reput)
        rt.transport_server.unregister(self.instance.subject)
        rt.unregister_local(self.instance.subject)
        await rt.store.delete(self.instance.etcd_key)


class EndpointClient:
    """Maintains the live instance set for an endpoint via a store watch.

    Reference: `component/client.rs` InstanceSource::{Static,Dynamic}; shared
    watchers per endpoint live in the runtime registry (`lib.rs:195-200`).
    """

    def __init__(self, endpoint: Endpoint,
                 static_instances: Optional[list[Instance]] = None) -> None:
        self.endpoint = endpoint
        self._static = static_instances
        self._instances: dict[int, Instance] = {
            i.instance_id: i for i in (static_instances or [])
        }
        self._watch: Optional[Watch] = None
        self._watch_task: Optional[asyncio.Task] = None
        self._ready = asyncio.Event()
        if static_instances is not None:
            self._ready.set()
        self._listeners: list[Callable[[str, Instance], None]] = []

    async def start(self) -> "EndpointClient":
        if self._static is not None or self._watch_task is not None:
            return self
        store = self.endpoint.runtime.store
        # Order matters: register the watch first (so no event is missed),
        # then seed from a get_prefix snapshot. Replayed PUTs arriving via
        # the watch are idempotent overwrites; DELETEs are strictly after
        # the snapshot in event order, so nothing is resurrected.
        self._watch = await store.watch_prefix(self.endpoint.instance_prefix)
        for kv in await store.get_prefix(self.endpoint.instance_prefix):
            inst = Instance.from_json(kv.value)
            self._instances[inst.instance_id] = inst
        self._ready.set()
        self._watch_task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def _run(self) -> None:
        assert self._watch is not None
        async for ev in self._watch:
            if ev.kind == PUT:
                inst = Instance.from_json(ev.value)
                self._instances[inst.instance_id] = inst
                self._emit(PUT, inst)
            elif ev.kind == DELETE:
                iid = int(ev.key.rsplit("/", 1)[-1], 16)
                inst = self._instances.pop(iid, None)
                if inst is not None:
                    self._purge_breaker(inst)
                    self._emit(DELETE, inst)
            elif ev.kind == RESET:
                # coordinator restarted: the empty store will never send
                # DELETEs for instances that died with it — drop the
                # whole view; the replay that follows rebuilds survivors
                for inst in list(self._instances.values()):
                    self._instances.pop(inst.instance_id, None)
                    self._purge_breaker(inst)
                    self._emit(DELETE, inst)
            self._ready.set()

    def _purge_breaker(self, inst: Instance) -> None:
        """A deregistered instance's breaker entry must not outlive it: a
        respawn under the same subject starts closed instead of waiting
        out the corpse's cooldown, and the entry map stays bounded under
        instance churn (breaker.reset)."""
        breaker = getattr(self.endpoint.runtime, "breaker", None)
        if breaker is not None:
            breaker.reset(inst.subject)

    def _emit(self, kind: str, inst: Instance) -> None:
        for fn in self._listeners:
            try:
                fn(kind, inst)
            except Exception:
                logger.exception("instance listener failed on %s %s",
                                 kind, inst.subject)

    def on_change(self, fn: Callable[[str, Instance], None]) -> None:
        """Call `fn(kind, instance)` on every PUT / DELETE the watch sees
        (the KV router's worker membership)."""
        self._listeners.append(fn)

    async def wait_ready(self, timeout: float = 5.0) -> None:
        await asyncio.wait_for(self._ready.wait(), timeout)

    def instances(self) -> list[Instance]:
        return sorted(self._instances.values(), key=lambda i: i.instance_id)

    async def stop(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
        if self._watch_task is not None:
            self._watch_task.cancel()
