"""TCP-served control-plane store: the etcd-equivalent coordinator.

Port of `dynamo_tpu/runtime/store_net.py` over the port's own MessagePack
codec (`runtime/codec.py`, standard library only); its frames are
byte-identical with the reference's, so either side's client talks to
either side's server.

One process (usually the frontend or a dedicated coordinator) runs
`StoreServer` around a `MemoryStore`; every other process connects with
`StoreClient`, which implements the same `KeyValueStore` API over the wire,
including prefix watches (server-push) and lease keepalive.

Reference analog: etcd itself plus `lib/runtime/src/transports/etcd.rs`.
A single coordinator (no raft) is an accepted availability trade-off for
this framework's control plane; the data plane never touches it.

Protocol: length-prefixed MessagePack frames (codec.py). Requests carry an `id`;
responses echo it. Watch events are server-initiated frames with the watch id.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Optional

from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.events import EventBus, LocalEventBus, Subscription
from dynamo_tpu_torch.runtime.store import (
    RESET,
    KeyValue,
    KeyValueStore,
    MemoryStore,
    StoreEvent,
    Watch,
)

logger = logging.getLogger(__name__)


class StoreServer:
    """Serves a MemoryStore over TCP. Lease lifetime is tied to server-side
    TTL timers refreshed by client keepalives — a client that dies stops
    refreshing, its leases expire, its keys vanish, watchers see DELETEs."""

    def __init__(self, store: Optional[MemoryStore] = None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.store = store or MemoryStore()
        self.events = LocalEventBus()
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._conn_writers: set[asyncio.StreamWriter] = set()

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for w in list(self._conn_writers):
            w.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)
            except asyncio.TimeoutError:
                pass
        await self.store.close()

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        watches: dict[int, tuple[Watch, asyncio.Task]] = {}
        subs: dict[int, tuple[Subscription, asyncio.Task]] = {}
        conn_leases: set[int] = set()
        write_lock = asyncio.Lock()
        self._conn_writers.add(writer)

        async def send(obj: dict) -> None:
            async with write_lock:
                codec.write_frame(writer, obj)
                await writer.drain()

        async def pump_watch(watch_id: int, watch: Watch) -> None:
            async for ev in watch:
                await send({
                    "watch": watch_id, "kind": ev.kind, "key": ev.key,
                    "value": ev.value, "rev": ev.revision,
                })

        async def pump_sub(sid: int, sub: Subscription) -> None:
            async for msg in sub:
                await send({"sub": sid, "seq": msg["seq"],
                            "payload": msg["payload"]})

        try:
            while True:
                try:
                    msg = await codec.read_frame(reader)
                except ConnectionError:
                    break
                try:
                    reply = await self._dispatch(msg, watches, conn_leases,
                                                 pump_watch, subs, pump_sub)
                except Exception as e:  # per-request fault isolation
                    reply = {"id": msg.get("id"), "error": repr(e)}
                if reply is not None:
                    await send(reply)
        finally:
            self._conn_writers.discard(writer)
            for watch, task in watches.values():
                watch.cancel()
                task.cancel()
            for sub, task in subs.values():
                sub.cancel()
                task.cancel()
            # Connection death revokes this connection's leases immediately —
            # faster failure detection than waiting out the TTL.
            for lease_id in conn_leases:
                await self.store.revoke_lease(lease_id)
            writer.close()

    async def _dispatch(self, msg, watches, conn_leases, pump_watch,
                        subs, pump_sub):
        op = msg["op"]
        mid = msg.get("id")
        s = self.store
        if op == "pub":
            await self.events.publish(msg["subject"], msg["payload"])
            return {"id": mid, "ok": True}
        if op == "sub":
            sub = self.events.subscribe_nowait(
                msg["subject"], from_start=msg.get("from_start", False))
            task = asyncio.get_running_loop().create_task(
                pump_sub(msg["sid"], sub))
            subs[msg["sid"]] = (sub, task)
            return {"id": mid, "ok": True}
        if op == "unsub":
            entry = subs.pop(msg["sid"], None)
            if entry:
                entry[0].cancel()
                entry[1].cancel()
            return {"id": mid, "ok": True}
        if op == "put":
            rev = await s.put(msg["key"], msg["value"], msg.get("lease", 0))
            return {"id": mid, "rev": rev}
        if op == "create":
            ok = await s.create(msg["key"], msg["value"], msg.get("lease", 0))
            return {"id": mid, "ok": ok}
        if op == "get":
            kv = await s.get(msg["key"])
            return {"id": mid, "kv": _kv_to_wire(kv)}
        if op == "get_prefix":
            kvs = await s.get_prefix(msg["prefix"])
            return {"id": mid, "kvs": [_kv_to_wire(kv) for kv in kvs]}
        if op == "delete":
            ok = await s.delete(msg["key"])
            return {"id": mid, "ok": ok}
        if op == "delete_prefix":
            n = await s.delete_prefix(msg["prefix"])
            return {"id": mid, "n": n}
        if op == "lease_create":
            lease_id = await s.create_lease(msg["ttl"])
            conn_leases.add(lease_id)
            return {"id": mid, "lease": lease_id}
        if op == "lease_keepalive":
            ok = await s.keep_alive(msg["lease"])
            return {"id": mid, "ok": ok}
        if op == "lease_revoke":
            await s.revoke_lease(msg["lease"])
            conn_leases.discard(msg["lease"])
            return {"id": mid, "ok": True}
        if op == "watch":
            watch = await s.watch_prefix(msg["prefix"],
                                         replay=msg.get("replay", True))
            task = asyncio.get_running_loop().create_task(
                pump_watch(msg["wid"], watch)
            )
            watches[msg["wid"]] = (watch, task)
            return {"id": mid, "ok": True}
        if op == "watch_cancel":
            entry = watches.pop(msg["wid"], None)
            if entry:
                entry[0].cancel()
                entry[1].cancel()
            return {"id": mid, "ok": True}
        return {"id": mid, "error": f"unknown op {op!r}"}


def _kv_to_wire(kv: Optional[KeyValue]):
    if kv is None:
        return None
    return {"key": kv.key, "value": kv.value, "rev": kv.revision,
            "lease": kv.lease_id}


def _kv_from_wire(w) -> Optional[KeyValue]:
    if w is None:
        return None
    return KeyValue(w["key"], w["value"], w["rev"], w.get("lease", 0))


class StoreClient(KeyValueStore, EventBus):
    """KeyValueStore + EventBus over one StoreServer connection, with auto
    lease keepalive and coordinator-restart resilience: when the
    connection dies (unless close() was called) the client reconnects
    with backoff, re-establishes every live watch and subscription
    (injecting a RESET event so watchers clear state the restarted —
    empty — store can never send DELETEs for), and runs registered
    `on_reconnect` hooks so the application layer can re-create leases
    and re-publish lease-attached keys. The reference gets this story
    from etcd client retry + compaction semantics; the no-raft
    coordinator needs it explicitly."""

    RECONNECT_BACKOFF = (0.2, 0.5, 1.0, 2.0, 5.0)

    def __init__(self, host: str, port: int,
                 auto_reconnect: bool = True) -> None:
        self.host = host
        self.port = port
        self.auto_reconnect = auto_reconnect
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: dict[int, asyncio.Future] = {}
        self._watches: dict[int, Watch] = {}
        self._watch_specs: dict[int, str] = {}     # wid -> prefix
        self._subs: dict[int, Subscription] = {}
        self._sub_specs: dict[int, str] = {}       # sid -> subject
        self._ids = itertools.count(1)
        self._wids = itertools.count(1)
        self._sids = itertools.count(1)
        self._rx_task: Optional[asyncio.Task] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._keepalive_task: Optional[asyncio.Task] = None
        self._leases: dict[int, float] = {}  # lease_id -> ttl
        self._write_lock = asyncio.Lock()
        self._closed = False          # close() called: permanent
        self._connected = asyncio.Event()
        self.on_reconnect: list = []  # async callables, run post-restore

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        self._connected.set()
        self._rx_task = asyncio.get_running_loop().create_task(self._rx_loop())

    async def _rx_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                msg = await codec.read_frame(self._reader)
                if "watch" in msg and "op" not in msg:
                    watch = self._watches.get(msg["watch"])
                    if watch is not None and not watch._cancelled:
                        watch.queue.put_nowait(StoreEvent(
                            msg["kind"], msg["key"], msg.get("value", b""),
                            msg.get("rev", 0),
                        ))
                    continue
                if "sub" in msg and "op" not in msg:
                    sub = self._subs.get(msg["sub"])
                    if sub is not None and not sub._cancelled:
                        sub.queue.put_nowait(
                            {"seq": msg.get("seq", 0),
                             "payload": msg.get("payload")})
                    continue
                fut = self._pending.pop(msg.get("id"), None)
                if fut is not None and not fut.done():
                    if "error" in msg:
                        fut.set_exception(RuntimeError(msg["error"]))
                    else:
                        fut.set_result(msg)
        except asyncio.CancelledError:
            pass
        except Exception:  # ConnectionError or a corrupt/undecodable frame
            if not self._closed:
                logger.warning("store connection lost", exc_info=True)
        finally:
            self._connected.clear()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("store connection lost"))
            self._pending.clear()
            if self._closed or not self.auto_reconnect:
                self._closed = True
                for watch in list(self._watches.values()):
                    watch.cancel()
                self._watches.clear()
                self._watch_specs.clear()
                for sub in list(self._subs.values()):
                    sub.cancel()
                self._subs.clear()
                self._sub_specs.clear()
            elif self._reconnect_task is None:
                # watches/subs stay registered client-side; the
                # reconnect loop re-establishes them server-side
                self._reconnect_task = asyncio.get_running_loop() \
                    .create_task(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        try:
            attempt = 0
            while not self._closed:
                delay = self.RECONNECT_BACKOFF[
                    min(attempt, len(self.RECONNECT_BACKOFF) - 1)]
                await asyncio.sleep(delay)
                attempt += 1
                try:
                    await self.connect()
                except Exception:
                    continue
                try:
                    await self._restore()
                except Exception:
                    logger.warning("store re-establish failed; retrying",
                                   exc_info=True)
                    self._connected.clear()
                    if self._writer is not None:
                        self._writer.close()
                    continue
                logger.info("store connection restored "
                            "(%d watches, %d subs)",
                            len(self._watch_specs), len(self._sub_specs))
                return
        finally:
            self._reconnect_task = None

    async def _restore(self) -> None:
        """Post-reconnect: RESET + re-register every live watch, re-sub
        every subscription, then run application hooks (lease and key
        re-registration — the restarted store is empty)."""
        # stale lease ids died with the old server
        self._leases.clear()
        for wid, prefix in list(self._watch_specs.items()):
            watch = self._watches.get(wid)
            if watch is None or watch._cancelled:
                continue
            watch.queue.put_nowait(StoreEvent(RESET, prefix, b"", 0))
            await self._call({"op": "watch", "prefix": prefix,
                              "wid": wid, "replay": True})
        for sid, subject in list(self._sub_specs.items()):
            sub = self._subs.get(sid)
            if sub is None or sub._cancelled:
                continue
            await self._call({"op": "sub", "subject": subject,
                              "sid": sid, "from_start": False})
        for hook in list(self.on_reconnect):
            await hook()

    async def _call(self, msg: dict) -> dict:
        if self._writer is None or self._closed \
                or not self._connected.is_set():
            raise ConnectionError("store connection lost")
        mid = next(self._ids)
        msg["id"] = mid
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[mid] = fut
        async with self._write_lock:
            codec.write_frame(self._writer, msg)
            await self._writer.drain()
        return await fut

    # -- KeyValueStore -----------------------------------------------------

    async def put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        r = await self._call({"op": "put", "key": key, "value": value,
                              "lease": lease_id})
        return r["rev"]

    async def create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        r = await self._call({"op": "create", "key": key, "value": value,
                              "lease": lease_id})
        return r["ok"]

    async def get(self, key: str) -> Optional[KeyValue]:
        r = await self._call({"op": "get", "key": key})
        return _kv_from_wire(r["kv"])

    async def get_prefix(self, prefix: str) -> list[KeyValue]:
        r = await self._call({"op": "get_prefix", "prefix": prefix})
        return [_kv_from_wire(w) for w in r["kvs"]]

    async def delete(self, key: str) -> bool:
        return (await self._call({"op": "delete", "key": key}))["ok"]

    async def delete_prefix(self, prefix: str) -> int:
        return (await self._call({"op": "delete_prefix", "prefix": prefix}))["n"]

    async def create_lease(self, ttl: float) -> int:
        r = await self._call({"op": "lease_create", "ttl": ttl})
        lease_id = r["lease"]
        self._leases[lease_id] = ttl
        if self._keepalive_task is None:
            self._keepalive_task = asyncio.get_running_loop().create_task(
                self._keepalive_loop()
            )
        return lease_id

    async def _keepalive_loop(self) -> None:
        while not self._closed:
            interval = min(self._leases.values(), default=5.0) / 3.0
            await asyncio.sleep(max(interval, 0.5))
            for lease_id in list(self._leases):
                try:
                    ok = await self.keep_alive(lease_id)
                except ConnectionError:
                    # disconnected: the reconnect loop re-creates leases
                    # via the application hooks; keep the loop alive for
                    # whatever lease comes next
                    break
                if not ok:
                    self._leases.pop(lease_id, None)

    async def keep_alive(self, lease_id: int) -> bool:
        return (await self._call({"op": "lease_keepalive", "lease": lease_id}))["ok"]

    async def revoke_lease(self, lease_id: int) -> None:
        self._leases.pop(lease_id, None)
        await self._call({"op": "lease_revoke", "lease": lease_id})

    async def watch_prefix(self, prefix: str, replay: bool = True) -> Watch:
        watch = Watch()
        wid = next(self._wids)
        self._watches[wid] = watch
        self._watch_specs[wid] = prefix
        orig_cancel = watch.cancel

        def cancel() -> None:
            orig_cancel()
            self._watches.pop(wid, None)
            self._watch_specs.pop(wid, None)
            # skip the server notification while disconnected: the
            # fire-and-forget _call would raise into an unawaited task
            # (the restarted server has no such watch anyway)
            if not self._closed and self._connected.is_set():
                asyncio.get_running_loop().create_task(
                    self._call({"op": "watch_cancel", "wid": wid})
                )

        watch.cancel = cancel  # type: ignore[method-assign]
        # Registration completes before we return, so a subsequent get_prefix
        # snapshot is guaranteed to be ordered after the watch server-side.
        try:
            await self._call({"op": "watch", "prefix": prefix, "wid": wid,
                              "replay": replay})
        except Exception:
            self._watches.pop(wid, None)
            raise
        return watch

    # -- EventBus (rides the same connection) ------------------------------

    async def publish(self, subject: str, payload: dict) -> None:
        await self._call({"op": "pub", "subject": subject, "payload": payload})

    async def subscribe(self, subject: str,
                        from_start: bool = False) -> Subscription:
        sid = next(self._sids)

        def on_cancel() -> None:
            self._subs.pop(sid, None)
            self._sub_specs.pop(sid, None)
            if not self._closed and self._connected.is_set():
                asyncio.get_running_loop().create_task(
                    self._call({"op": "unsub", "sid": sid}))

        sub = Subscription(on_cancel=on_cancel)
        self._subs[sid] = sub
        self._sub_specs[sid] = subject
        try:
            await self._call({"op": "sub", "subject": subject, "sid": sid,
                              "from_start": from_start})
        except Exception:
            self._subs.pop(sid, None)
            raise
        return sub

    async def close(self) -> None:
        self._closed = True
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        if self._rx_task is not None:
            self._rx_task.cancel()
        if self._writer is not None:
            self._writer.close()
