"""Distributed KVBM: cross-worker KV block reuse (the G4 remote tier).

Port of `dynamo_tpu/kvbm/distributed.py` (the port keeps its own copy).
Adverts, the `kvbm_pull` request and its frames (`{"seq_hash", "dtype":
"bfloat16", "shape", "data": raw bytes}`) are the reference's byte for
byte, so a worker of either package pulls from a worker of the other;
blocks are host tensors (`runtime/tensors.py`), not numpy arrays.

Reference: `lib/llm/src/block_manager/distributed/` — KvbmLeader ↔
KvbmWorker orchestrate multi-rank block transfers over ZMQ/NIXL. The TPU
redesign needs no separate leader process: each worker

- PUBLISHES which block hashes its host/disk tiers hold, under a
  lease-attached store key (`v1/kvbm/<ns>/<component>/<worker_id>`) —
  dead workers' adverts vanish with their lease, exactly like instance
  discovery;
- SERVES a `kvbm_pull` endpoint streaming contiguous runs of blocks
  from its tiers (the NIXL read analog, over the runtime transport);
- FETCHES at admission: when a prompt's block chain misses the local
  tiers, the longest-continuing peer is pulled and the blocks are
  onboarded into the sequence's fresh device pages before prefill, so a
  prompt cached ANYWHERE in the fleet skips its prefix everywhere.

Failure containment: pulls are time-boxed (a wedged peer must never
stall the scheduler loop — the canary would kill THIS worker), frames
with unexpected block shapes are dropped (rolling upgrades may mix
geometries in one namespace), and adverts are cached briefly so a batch
of admissions does one registry scan, not N.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Optional

import torch

from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.push import PushRouter
from dynamo_tpu_torch.runtime.tensors import tensor_bytes, tensor_from

logger = logging.getLogger(__name__)

KVBM_PULL_ENDPOINT = "kvbm_pull"


def registry_prefix(namespace: str, component: str) -> str:
    return f"v1/kvbm/{namespace}/{component}/"


def registry_key(namespace: str, component: str, worker_id: int) -> str:
    return f"{registry_prefix(namespace, component)}{worker_id}"


class KvbmDistributed:
    """Attaches the remote tier to a KvbmManager (see module docstring)."""

    def __init__(self, manager, runtime, namespace: str, component: str,
                 worker_id: int, publish_debounce: float = 0.2,
                 fetch_timeout: float = 2.0) -> None:
        self.manager = manager
        self.runtime = runtime
        self.namespace = namespace
        self.component = component
        self.worker_id = worker_id
        self.publish_debounce = publish_debounce
        self.fetch_timeout = fetch_timeout
        self._served = None
        self._client = None
        self._router = None
        self._publish_task: Optional[asyncio.Task] = None
        self._publish_dirty = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._adverts: Optional[list] = None
        self._adverts_at = 0.0
        manager.remote = self
        # EVERY tier mutation (offload, LRU displacement, disk demotion,
        # promote-drop) schedules a debounced re-advert — an advert that
        # over-claims blocks steals best-peer selection from workers that
        # genuinely hold them
        manager.store.on_change = self._schedule_publish

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        ep = (self.runtime.namespace(self.namespace)
              .component(self.component).endpoint(KVBM_PULL_ENDPOINT))
        self._served = await ep.serve(self._handle_pull,
                                      instance_id=self.worker_id)
        self._client = await ep.client()
        await self._client.start()
        self._router = PushRouter(self._client)
        await self._publish()

    async def close(self) -> None:
        if self._publish_task is not None:
            self._publish_task.cancel()
        if self._client is not None:
            await self._client.stop()
        if self._served is not None:
            await self._served.shutdown()

    # -- advertise ----------------------------------------------------------

    def _schedule_publish(self) -> None:
        if self._publish_task is not None and not self._publish_task.done():
            # a publish is pending or in flight; make sure the tier state
            # that just changed gets re-advertised after it finishes (a
            # change landing mid-`store.put` would otherwise never ship)
            self._publish_dirty = True
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # tier mutation from a KVBM pipeline worker thread (offload
            # demote, prefetch promote): hop onto our loop — dropping the
            # advert here would leave it stale until the next loop-side
            # mutation
            if self._loop is not None and not self._loop.is_closed():
                self._loop.call_soon_threadsafe(self._schedule_publish)
            return
        self._publish_task = loop.create_task(self._debounced_publish())

    async def _debounced_publish(self) -> None:
        while True:
            await asyncio.sleep(self.publish_debounce)
            self._publish_dirty = False
            try:
                await self._publish()
            except Exception:
                logger.exception("kvbm registry publish failed")
            if not self._publish_dirty:
                return

    async def _publish(self) -> None:
        hashes = self.manager.store.hashes()
        payload = json.dumps({"worker_id": self.worker_id,
                              "blocks": hashes}).encode()
        await self.runtime.store.put(
            registry_key(self.namespace, self.component, self.worker_id),
            payload, self.runtime.lease_id)

    # -- serve --------------------------------------------------------------

    async def _handle_pull(self, request: dict, context=None):
        """Stream the leading contiguous run of requested blocks this
        worker holds. Frames carry raw bytes + dtype/shape; stopping at
        the first miss keeps the chain contract (callers onboard
        prefix-contiguous runs only). Tier reads (possibly disk IO) and
        the bytes copy run in a thread — serving a pull must not stall
        THIS worker's scheduler loop."""

        def read_frame(h: int):
            data = self.manager.store.get(h)
            if data is None:
                return None
            raw, shape, dtype = tensor_bytes(data)
            return {"seq_hash": h, "dtype": dtype, "shape": shape,
                    "data": raw}

        for h in request.get("seq_hashes", []):
            # a thread: the G3 disk tier's get() sleeps on file I/O
            frame = await asyncio.to_thread(read_frame, int(h))
            if frame is None:
                break
            yield frame

    # -- fetch --------------------------------------------------------------

    def status(self) -> dict:
        """Controller view of the remote (G4) tier: blocks this worker
        advertises to peers (pulled counts live in manager.stats)."""
        return {"advertised_blocks": len(self.manager.store.hashes())}

    async def _peer_adverts(self) -> list:
        """Peers' adverts, cached for the debounce interval so one admit
        round scans the registry once, not once per sequence."""
        now = time.monotonic()
        if self._adverts is not None and \
                now - self._adverts_at < self.publish_debounce:
            return self._adverts
        kvs = await self.runtime.store.get_prefix(
            registry_prefix(self.namespace, self.component))
        adverts = []
        for kv in kvs:
            try:
                adverts.append(json.loads(kv.value))
            except (ValueError, TypeError):
                continue
        self._adverts = adverts
        self._adverts_at = now
        return adverts

    async def fetch(self, seq_hashes: list[int],
                    expect_shape: Optional[tuple] = None
                    ) -> list[torch.Tensor]:
        """Pull the longest available leading run of `seq_hashes` from
        the best-continuing peer, time-boxed. Frames whose shape differs
        from `expect_shape` are dropped (and end the run — the chain
        must stay contiguous). Returns the blocks (possibly empty)."""
        if self._router is None or not seq_hashes:
            return []
        best_id, best_n = None, 0
        for adv in await self._peer_adverts():
            wid = adv.get("worker_id")
            if wid == self.worker_id:
                continue
            held = set(adv.get("blocks", []))
            n = 0
            for h in seq_hashes:
                if h not in held:
                    break
                n += 1
            if n > best_n:
                best_id, best_n = wid, n
        if best_id is None:
            return []
        blocks: list[torch.Tensor] = []
        try:
            await asyncio.wait_for(
                self._pull(best_id, seq_hashes[:best_n], expect_shape,
                           blocks),
                self.fetch_timeout)
        except asyncio.TimeoutError:
            # a slow peer's partial leading run is still valid — keep it
            logger.warning("kvbm remote pull from %s timed out after "
                           "%.1fs with %d blocks", best_id,
                           self.fetch_timeout, len(blocks))
        return blocks

    async def _pull(self, peer_id: int, seq_hashes: list[int],
                    expect_shape: Optional[tuple],
                    out: list[torch.Tensor]) -> None:
        """Appends verified blocks to `out` as frames arrive (the caller
        keeps the partial run on timeout)."""
        try:
            i = 0
            async for frame in self._router.direct(
                    {"seq_hashes": seq_hashes}, peer_id, Context()):
                if i >= len(seq_hashes):
                    break
                if int(frame.get("seq_hash", -1)) != seq_hashes[i]:
                    # a skewed peer (e.g. one that skips a missing middle
                    # block instead of stopping) would misalign frames
                    # with hashes and poison the prefix cache
                    logger.warning(
                        "kvbm peer %s frame hash mismatch at %d; "
                        "dropping rest of run", peer_id, i)
                    break
                data = tensor_from(bytes(frame["data"]),
                                   list(frame["shape"]), frame["dtype"])
                if expect_shape is not None and \
                        tuple(data.shape) != tuple(expect_shape):
                    logger.warning(
                        "kvbm peer %s block shape %s != local %s "
                        "(mixed geometries?); dropping rest of run",
                        peer_id, data.shape, expect_shape)
                    break
                out.append(data)
                i += 1
        except Exception as e:
            # peer died or advert was stale: what we got is still a valid
            # leading run
            logger.warning("kvbm remote pull from %s failed after %d "
                           "blocks: %s", peer_id, len(out), e)
