"""Key-value store abstraction — the control plane seam.

Port of `dynamo_tpu/runtime/store.py` (the port keeps its own copy).

Reference: `lib/runtime/src/storage/key_value_store.rs` (trait with EtcdStore /
MemoryStore / NatsStore impls) plus the etcd transport's lease + watch
machinery (`lib/runtime/src/transports/etcd.rs:41`). The seam is what lets
the whole stack run in one process for tests and across hosts in production:
- `MemoryStore`: in-process, used directly or served over TCP by
  `store_net.StoreServer` (our etcd-equivalent single coordinator).
- `store_net.StoreClient`: same API over the wire.

Semantics kept from etcd because every subsystem leans on them:
- keys are strings, values bytes; revisions are monotonically increasing ints
- leases: keys attached to a lease vanish when the lease expires/revoked
  (instance liveness = lease keepalive; death = keys disappear from watches)
- watch on a prefix: stream of PUT/DELETE events, with initial state replay
"""

from __future__ import annotations

import asyncio
import time
import itertools
from dataclasses import dataclass, field
from typing import AsyncIterator, Optional

PUT = "put"
DELETE = "delete"
# synthetic event a reconnecting StoreClient injects into every live
# watch when the coordinator comes back: consumers must CLEAR their
# derived view (the restarted store is empty, so no DELETEs will ever
# arrive for keys that died with it) before the replayed PUTs rebuild it
RESET = "reset"


@dataclass
class StoreEvent:
    kind: str  # PUT | DELETE
    key: str
    value: bytes = b""
    revision: int = 0


@dataclass
class KeyValue:
    key: str
    value: bytes
    revision: int
    lease_id: int = 0


class KeyValueStore:
    """Async KV store interface. All methods may raise ConnectionError."""

    async def put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        raise NotImplementedError

    async def create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        """Put only if absent. Returns False if the key already exists."""
        raise NotImplementedError

    async def get(self, key: str) -> Optional[KeyValue]:
        raise NotImplementedError

    async def get_prefix(self, prefix: str) -> list[KeyValue]:
        raise NotImplementedError

    async def delete(self, key: str) -> bool:
        raise NotImplementedError

    async def delete_prefix(self, prefix: str) -> int:
        raise NotImplementedError

    async def create_lease(self, ttl: float) -> int:
        raise NotImplementedError

    async def keep_alive(self, lease_id: int) -> bool:
        raise NotImplementedError

    async def revoke_lease(self, lease_id: int) -> None:
        raise NotImplementedError

    async def watch_prefix(
        self, prefix: str, replay: bool = True
    ) -> "Watch":
        """Async so remote impls can confirm registration before returning —
        callers may rely on 'watch registered, then snapshot' ordering."""
        raise NotImplementedError

    async def close(self) -> None:
        pass


class Watch:
    """A prefix watch: async-iterate StoreEvents; `.cancel()` to stop.

    With replay=True the current state arrives first as synthetic PUT events
    (reference `kv_get_and_watch_prefix`, etcd.rs).
    """

    def __init__(self) -> None:
        self.queue: asyncio.Queue[Optional[StoreEvent]] = asyncio.Queue()
        self._cancelled = False

    def __aiter__(self) -> AsyncIterator[StoreEvent]:
        return self

    async def __anext__(self) -> StoreEvent:
        ev = await self.queue.get()
        if ev is None:
            raise StopAsyncIteration
        return ev

    def cancel(self) -> None:
        if not self._cancelled:
            self._cancelled = True
            self.queue.put_nowait(None)


@dataclass
class _Lease:
    lease_id: int
    ttl: float
    expires_at: float
    keys: set[str] = field(default_factory=set)


class MemoryStore(KeyValueStore):
    """In-process store with leases + watches; authoritative state for
    `StoreServer`. Reference analog: `storage/key_value_store/mem.rs`."""

    def __init__(self) -> None:
        self._data: dict[str, KeyValue] = {}
        self._leases: dict[int, _Lease] = {}
        self._watches: list[tuple[str, Watch]] = []
        self._revision = 0
        self._lease_ids = itertools.count(1)
        self._reaper_task: Optional[asyncio.Task] = None
        # seeded chaos seam (runtime/faults.py kind=store_outage): when
        # set, public ops consult it and raise ConnectionError while an
        # outage rule fires — the in-process model of an unreachable
        # coordinator. None (the default) costs one attribute check.
        self.fault_injector = None

    # -- internals ---------------------------------------------------------

    def _check(self, op: str, key: Optional[str] = None) -> None:
        inj = self.fault_injector
        if inj is not None and inj.on_store_op(op, key) is not None:
            raise ConnectionError(f"[fault] store outage: {op}")

    def _next_rev(self) -> int:
        self._revision += 1
        return self._revision

    def _notify(self, ev: StoreEvent) -> None:
        live = []
        for prefix, watch in self._watches:
            if watch._cancelled:
                continue  # prune dead watches so the list can't grow forever
            live.append((prefix, watch))
            if ev.key.startswith(prefix):
                watch.queue.put_nowait(ev)
        self._watches = live

    def _ensure_reaper(self) -> None:
        if self._reaper_task is None or self._reaper_task.done():
            self._reaper_task = asyncio.get_running_loop().create_task(
                self._reap_loop()
            )

    async def _reap_loop(self) -> None:
        while self._leases:
            # a down coordinator expires nothing — keepalives simply
            # never arrive — so the reaper pauses while an injected
            # outage is active rather than reaping leases whose owners
            # are healthy but cut off
            inj = self.fault_injector
            if inj is None or not inj.outage_active():
                now = time.monotonic()
                for lease in list(self._leases.values()):
                    if lease.expires_at <= now:
                        await self.revoke_lease(lease.lease_id)
            await asyncio.sleep(0.2)

    # -- KeyValueStore -----------------------------------------------------

    async def put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        self._check("put", key)
        return await self._put(key, value, lease_id)

    async def _put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        if lease_id and lease_id not in self._leases:
            raise KeyError(f"unknown lease {lease_id}")
        prev = self._data.get(key)
        if prev is not None and prev.lease_id and prev.lease_id != lease_id:
            # etcd semantics: a put replaces the lease association; the old
            # lease must no longer delete this key on expiry.
            old = self._leases.get(prev.lease_id)
            if old is not None:
                old.keys.discard(key)
        rev = self._next_rev()
        self._data[key] = KeyValue(key, value, rev, lease_id)
        if lease_id:
            self._leases[lease_id].keys.add(key)
        self._notify(StoreEvent(PUT, key, value, rev))
        return rev

    async def create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        self._check("create", key)
        if key in self._data:
            return False
        await self._put(key, value, lease_id)
        return True

    async def get(self, key: str) -> Optional[KeyValue]:
        self._check("get", key)
        return self._data.get(key)

    async def get_prefix(self, prefix: str) -> list[KeyValue]:
        self._check("get_prefix", prefix)
        return [kv for k, kv in sorted(self._data.items()) if k.startswith(prefix)]

    async def delete(self, key: str) -> bool:
        self._check("delete", key)
        return await self._delete(key)

    async def _delete(self, key: str) -> bool:
        kv = self._data.pop(key, None)
        if kv is None:
            return False
        if kv.lease_id and kv.lease_id in self._leases:
            self._leases[kv.lease_id].keys.discard(key)
        self._notify(StoreEvent(DELETE, key, b"", self._next_rev()))
        return True

    async def delete_prefix(self, prefix: str) -> int:
        self._check("delete_prefix", prefix)
        keys = [k for k in self._data if k.startswith(prefix)]
        for k in keys:
            await self._delete(k)
        return len(keys)

    async def create_lease(self, ttl: float) -> int:
        self._check("create_lease")
        lease_id = next(self._lease_ids)
        self._leases[lease_id] = _Lease(lease_id, ttl, time.monotonic() + ttl)
        self._ensure_reaper()
        return lease_id

    async def keep_alive(self, lease_id: int) -> bool:
        self._check("keep_alive")
        lease = self._leases.get(lease_id)
        if lease is None:
            return False
        lease.expires_at = time.monotonic() + lease.ttl
        return True

    async def revoke_lease(self, lease_id: int) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        for key in list(lease.keys):
            await self._delete(key)

    async def watch_prefix(self, prefix: str, replay: bool = True) -> Watch:
        self._check("watch_prefix", prefix)
        watch = Watch()
        if replay:
            for kv in self._data.values():
                if kv.key.startswith(prefix):
                    watch.queue.put_nowait(
                        StoreEvent(PUT, kv.key, kv.value, kv.revision)
                    )
        self._watches.append((prefix, watch))
        return watch

    async def close(self) -> None:
        if self._reaper_task is not None:
            self._reaper_task.cancel()
        for _, w in self._watches:
            w.cancel()
        self._watches.clear()


class _KeyWatch(Watch):
    """Watch on one exact key, pumped from a prefix watch or a poll loop."""

    def __init__(self) -> None:
        super().__init__()
        self._inner: Optional[Watch] = None
        self._task: Optional[asyncio.Task] = None

    def cancel(self) -> None:
        if self._inner is not None:
            self._inner.cancel()
        if self._task is not None:
            self._task.cancel()
        super().cancel()


async def watch_key(store: KeyValueStore, key: str, *, replay: bool = True,
                    poll_interval: float = 0.0) -> Watch:
    """Watch a single key. Events for other keys sharing the prefix are
    filtered out; RESET passes through so consumers can clear derived
    state on coordinator restart.

    With `poll_interval > 0` the store's watch machinery is bypassed for a
    bounded poll loop: `get(key)` every interval, synthesizing a PUT
    whenever the revision advances (and a DELETE when the key vanishes).
    The fallback is for stores/deployments where long-lived watch streams
    are unreliable; the event contract is identical, minus intermediate
    states the poll missed.
    """
    watch = _KeyWatch()

    if poll_interval > 0:
        async def _poll() -> None:
            last_rev = -1
            existed = False
            if not replay:
                kv0 = await store.get(key)
                if kv0 is not None:
                    last_rev, existed = kv0.revision, True
            while not watch._cancelled:
                try:
                    kv = await store.get(key)
                except ConnectionError:
                    await asyncio.sleep(poll_interval)
                    continue
                if kv is not None and kv.revision != last_rev:
                    last_rev, existed = kv.revision, True
                    watch.queue.put_nowait(
                        StoreEvent(PUT, key, kv.value, kv.revision))
                elif kv is None and existed:
                    existed = False
                    watch.queue.put_nowait(StoreEvent(DELETE, key))
                await asyncio.sleep(poll_interval)

        watch._task = asyncio.get_running_loop().create_task(_poll())
        return watch

    inner = await store.watch_prefix(key, replay=replay)
    watch._inner = inner

    async def _pump() -> None:
        async for ev in inner:
            if ev.kind == RESET or ev.key == key:
                watch.queue.put_nowait(ev)
        if not watch._cancelled:
            watch.queue.put_nowait(None)

    watch._task = asyncio.get_running_loop().create_task(_pump())
    return watch


async def connect_store(url: str) -> KeyValueStore:
    """Open a store from a config URL: "memory" or "tcp://host:port"."""
    if url == "memory":
        store = MemoryStore()
        # arm the seeded chaos seam for in-process stores; networked
        # stores inject at their own client/server layer instead
        from dynamo_tpu_torch.runtime.faults import FaultInjector

        store.fault_injector = FaultInjector.from_env()
        return store
    if url.startswith("tcp://"):
        from dynamo_tpu_torch.runtime.store_net import StoreClient

        hostport = url[len("tcp://"):]
        host, _, port = hostport.rpartition(":")
        client = StoreClient(host, int(port))
        await client.connect()
        return client
    raise ValueError(f"unsupported store url: {url}")
