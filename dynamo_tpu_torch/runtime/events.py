"""Event bus: durable-ish pub/sub for KV events, metrics, and replica sync.

Port of `dynamo_tpu/runtime/events.py` (the port keeps its own copy).

Reference analog: NATS core + JetStream (`lib/runtime/src/transports/nats.rs`)
— engines publish KvCacheEvents and ForwardPassMetrics streams that routers
consume, with replay from a retained buffer after restart (the reference's
durable JetStream consumers, `kv_router/subscriber.rs:164`).

Two implementations behind one interface:
- `LocalEventBus` — in-process; also the authoritative state behind the
  coordinator's pub/sub ops (store_net.py wires it to the same TCP conn).
- `store_net.StoreClient` exposes the same API remotely (publish/subscribe
  ops ride the store connection).

Subjects are plain strings ("kv_events.<ns>", "metrics.<ns>"). Each subject
keeps a bounded replay buffer; subscribe(from_start=True) replays it first.
"""

from __future__ import annotations

import asyncio
import itertools
from collections import deque
from typing import AsyncIterator, Optional

DEFAULT_RETAIN = 4096


class Subscription:
    def __init__(self, on_cancel=None) -> None:
        self.queue: asyncio.Queue[Optional[dict]] = asyncio.Queue()
        self._cancelled = False
        self._on_cancel = on_cancel

    def __aiter__(self) -> AsyncIterator[dict]:
        return self

    async def __anext__(self) -> dict:
        item = await self.queue.get()
        if item is None:
            raise StopAsyncIteration
        return item

    def cancel(self) -> None:
        if not self._cancelled:
            self._cancelled = True
            self.queue.put_nowait(None)
            if self._on_cancel is not None:
                self._on_cancel()


class EventBus:
    async def publish(self, subject: str, payload: dict) -> None:
        raise NotImplementedError

    async def subscribe(self, subject: str,
                        from_start: bool = False) -> Subscription:
        """Async so remote impls can confirm registration before returning
        (a publish right after subscribe() must not overtake it)."""
        raise NotImplementedError


class LocalEventBus(EventBus):
    def __init__(self, retain: int = DEFAULT_RETAIN) -> None:
        self.retain = retain
        self._buffers: dict[str, deque] = {}
        self._subs: dict[str, list[Subscription]] = {}
        self._seq = itertools.count(1)

    async def publish(self, subject: str, payload: dict) -> None:
        self.publish_nowait(subject, payload)

    def publish_nowait(self, subject: str, payload: dict) -> None:
        msg = {"subject": subject, "seq": next(self._seq), "payload": payload}
        buf = self._buffers.setdefault(subject, deque(maxlen=self.retain))
        buf.append(msg)
        subs = self._subs.get(subject)
        if subs:
            live = []
            for sub in subs:
                if sub._cancelled:
                    continue
                live.append(sub)
                sub.queue.put_nowait(msg)
            self._subs[subject] = live

    async def subscribe(self, subject: str,
                        from_start: bool = False) -> Subscription:
        return self.subscribe_nowait(subject, from_start)

    def subscribe_nowait(self, subject: str,
                         from_start: bool = False) -> Subscription:
        sub = Subscription()
        if from_start:
            for msg in self._buffers.get(subject, ()):
                sub.queue.put_nowait(msg)
        self._subs.setdefault(subject, []).append(sub)
        return sub
