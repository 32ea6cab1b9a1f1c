"""Durable at-least-once work queue over the lease KV store.

Port of `dynamo_tpu/runtime/queue.py` (the port keeps its own copy, on
its own store, `runtime/store.py`). Keys, JSON payloads and claim
semantics are the reference's byte for byte, so a producer of either
package and a consumer of the other share one queue on one coordinator.

Reference: `lib/runtime/src/transports/nats.rs:427-770` — `NatsQueue`, a
JetStream work queue whose flagship use is the disaggregated PREFILL
QUEUE (decode workers enqueue prefill jobs; any prefill worker pulls,
`docs/architecture/dynamo_flow.md:23-52`). Here the same semantics ride
the control-plane store:

- items live under ``v1/queue/<ns>/<name>/items/<time_ns>.<nonce>`` —
  keys sort in enqueue order;
- a consumer claims an item with an atomic ``create`` of the matching
  claim key BOUND TO ITS LEASE: double-claims are impossible, and a
  consumer that dies mid-work drops its lease, the claim evaporates,
  and the item is redelivered to the next puller (at-least-once);
- ``ack`` deletes item+claim; ``nack`` deletes only the claim.
"""

from __future__ import annotations

import json
import secrets
import time
from dataclasses import dataclass
from typing import Any, Optional

QUEUE_PREFIX = "v1/queue/"


@dataclass
class WorkItem:
    item_id: str
    payload: Any
    _queue: "WorkQueue"

    async def ack(self) -> None:
        """Done: remove the item permanently."""
        await self._queue._store.delete(self._queue._item_key(self.item_id))
        await self._queue._store.delete(
            self._queue._claim_key(self.item_id))

    async def nack(self) -> None:
        """Give it back: the next puller gets it."""
        await self._queue._store.delete(
            self._queue._claim_key(self.item_id))


class WorkQueue:
    def __init__(self, runtime, name: str,
                 namespace: str = "dynamo") -> None:
        self._runtime = runtime
        self._store = runtime.store
        self._prefix = f"{QUEUE_PREFIX}{namespace}/{name}/"

    def _item_key(self, item_id: str) -> str:
        return f"{self._prefix}items/{item_id}"

    def _claim_key(self, item_id: str) -> str:
        return f"{self._prefix}claims/{item_id}"

    async def enqueue(self, payload: Any) -> str:
        item_id = f"{time.time_ns():020d}.{secrets.token_hex(4)}"
        await self._store.put(
            self._item_key(item_id),
            json.dumps(payload, separators=(",", ":")).encode())
        return item_id

    async def retract(self, item_id: str) -> None:
        """Producer-side withdrawal of an item (e.g. the requester gave
        up waiting). A claimed in-flight item is still cut short at its
        consumer's ack (which deletes idempotently)."""
        await self._store.delete(self._item_key(item_id))

    async def depth(self) -> int:
        """Unacked items (claimed + unclaimed)."""
        return len(await self._store.get_prefix(f"{self._prefix}items/"))

    async def try_dequeue(self) -> Optional[WorkItem]:
        """One claim attempt over the current backlog, oldest first."""
        items = sorted(await self._store.get_prefix(
            f"{self._prefix}items/"), key=lambda kv: kv.key)
        claimed = {kv.key.rsplit("/", 1)[-1] for kv in
                   await self._store.get_prefix(f"{self._prefix}claims/")}
        for kv in items:
            item_id = kv.key.rsplit("/", 1)[-1]
            if item_id in claimed:
                continue
            won = await self._store.create(
                self._claim_key(item_id), b"1",
                lease_id=self._runtime.lease_id)
            if not won:
                continue  # raced another consumer
            # the item may have been acked between listing and claiming
            cur = await self._store.get(self._item_key(item_id))
            if cur is None:
                await self._store.delete(self._claim_key(item_id))
                continue
            return WorkItem(item_id=item_id,
                            payload=json.loads(cur.value), _queue=self)
        return None

    async def dequeue(self, timeout: Optional[float] = None,
                      poll: float = 0.05) -> Optional[WorkItem]:
        """Claim the oldest available item, waiting up to ``timeout``
        (None = one non-blocking pass)."""
        import asyncio

        deadline = (time.monotonic() + timeout) if timeout else None
        item = await self.try_dequeue()
        if item is not None or deadline is None:
            return item
        # idle wait is EVENT-DRIVEN: a watch on the QUEUE prefix wakes us
        # on enqueue AND on claim releases (nack / dead-consumer lease
        # expiry deletes under claims/) — watching only items/ would
        # stall redelivery until the 60s backstop
        watch = await self._store.watch_prefix(self._prefix,
                                               replay=False)
        try:
            while True:
                item = await self.try_dequeue()
                if item is not None:
                    return item
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                try:
                    await asyncio.wait_for(watch.__anext__(),
                                           min(remaining, 60.0))
                except asyncio.TimeoutError:
                    continue
                except StopAsyncIteration:
                    await asyncio.sleep(poll)  # watch closed: degrade
        finally:
            watch.cancel()
