"""KvbmManager: wires the multi-tier store into a TorchEngine.

Port of `dynamo_tpu/kvbm/manager.py` (the port keeps its own copy). On
the card the device work is two kernels the engine already runs: an
offload gathers the evicted pages with the KV gather
(`csrc/paged_kv_gather.cu`, `TorchEngine._read_kv_pages_sync`: one launch,
then one copy to a reused pinned buffer and a split into blocks that own
their storage); an onboard stacks the blocks into a reused pinned buffer,
copies it to the card once and writes the pages with K3
(`csrc/paged_kv_write_pages.cu`, `TorchEngine.write_kv_blocks`: one
launch per layer). Both run on the engine's stream, so an evicted page's
gather precedes, in stream order, any write into it by its next owner.
Where the reference's offload worker and remote onboard log a failure
of this device work and go on as on a cache miss, the port raises it
into the scheduler's iteration, which fails its requests: a tier or
network failure is a miss, a failed launch or pinned allocation is not.
With the process tracer on (`runtime/tracing.py`), a pipelined offload
batch, a prefetch and each onboard run under the reference's
`kvbm.offload`, `kvbm.prefetch` and `kvbm.onboard` spans (block counts
and source as attributes), and a traced request's root span gets the
`kvbm.prefetch_hit`, `kvbm.onboard` and `kvbm.onboard_remote` events;
host clocks only, no device wait. The memory ledger providers
(`kvbm_pinned`, `kvbm_staged`) register on an armed `engine/memory.py`
ledger.

Reference: `lib/llm/src/block_manager/offload.rs:86` (OffloadManager:
G1→G2→G3 offload + onboard pipeline) and the vLLM connector
(`connector/scheduler.rs`) that decides onboard/offload per scheduler
step. We own the engine, so no connector indirection: the manager hooks

- **offload**: PagePool eviction (a registered device page being
  recycled) copies the page's KV to the host tier *before* the device
  page is overwritten — offload-instead-of-drop;
- **onboard**: at admission, prompt blocks that miss the device prefix
  cache but hit a host/disk tier are DMA'd into the sequence's fresh
  pages and re-registered, extending ``cached_len`` so prefill skips
  them (the reference's +40%-TTFT headline path, BASELINE.md).

Both directions run in one of two modes (docs/kvbm.md):

- **synchronous** (every pipeline knob 0 — the default, byte-for-byte
  the original behavior): eviction gathers + host-syncs inline in the
  scheduler coroutine, onboard blocks admission on tier reads;
- **pipelined**: evicted pages take a *pending-offload pin*
  (pages.py) and enter a bounded staging queue drained by a background
  worker whose device gather + tier demotion run off the scheduler
  loop; waiting requests' tier hits are prefetched into a staged host
  buffer so admission-time onboard is a single batched device write.
  A full queue backpressures into the inline copy path, so tier
  durability never depends on the worker keeping up.

KV events stay consistent with the router's device-view: eviction still
emits KV_REMOVED (the device no longer holds the block) and onboarding
re-registers pages which emits KV_STORED.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Optional

import torch

from dynamo_tpu_torch.kvbm.tiers import TieredStore
from dynamo_tpu_torch.runtime.faults import FaultInjector
from dynamo_tpu_torch.runtime.tracing import tracer
from dynamo_tpu_torch.tokens import TokenBlockSequence

logger = logging.getLogger(__name__)


@dataclass
class KvbmConfig:
    host_blocks: int = 1024
    disk_blocks: int = 0
    disk_dir: Optional[str] = None
    # -- async pipeline knobs (docs/kvbm.md). All default to 0 = the
    # synchronous in-scheduler behavior, reproduced byte-for-byte.
    # Bound (in blocks) on evictions staged for background offload;
    # overflow falls back to the inline copy. 0 = always inline.
    offload_queue_depth: int = 0
    # Width of the tier-IO thread pool (disk writes/reads, host syncs
    # off the loop). 0 = a single thread once the pipeline engages.
    offload_workers: int = 0
    # Blocks prefetched into the staged host buffer per waiting
    # request. 0 = no prefetch (admission reads the tiers directly).
    prefetch_blocks: int = 0
    # Byte bound on evictions staged for background offload — block
    # counts lie under long-context spikes (every block of a big model
    # is megabytes), so this caps the HBM actually pinned against the
    # queue. Tightens offload_queue_depth when both are set; 0 = block
    # count only. Has no effect while offload_queue_depth is 0 (the
    # pipeline itself is off).
    offload_queue_bytes: int = 0


@dataclass
class KvbmStats:
    offloaded: int = 0
    onboarded: int = 0
    onboard_queries: int = 0
    remote_onboarded: int = 0
    # -- pipeline counters (docs/kvbm.md)
    offload_inline: int = 0     # backpressure fallbacks, blocks
    prefetched: int = 0         # blocks staged ahead of admission
    prefetch_hits: int = 0      # staged blocks consumed by onboard
    remote_prefetched: int = 0  # of prefetched, pulled from peers
    # of prefetch_hits, blocks that were staged off a router prefix
    # hint chain rather than a _waiting request's own hashes
    prefetch_hint_hits: int = 0


class KvbmManager:
    """Attaches G2/G3 tiers to a TorchEngine (see module docstring).

    The G4 remote tier (cross-worker pull) attaches separately:
    `kvbm.distributed.KvbmDistributed(manager, runtime, ...)` — it sets
    ``self.remote`` and subscribes to tier mutations via
    ``store.on_change``."""

    def __init__(self, engine, config: Optional[KvbmConfig] = None,
                 fault_injector=None) -> None:
        self.engine = engine
        self.config = config or KvbmConfig()
        self.store = TieredStore(self.config.host_blocks,
                                 self.config.disk_blocks,
                                 self.config.disk_dir)
        self.stats = KvbmStats()
        self.remote = None
        # chaos hook (runtime/faults.py on_offload): slow/stuck offload
        # worker; picked up from DYN_FAULTS unless injected explicitly
        if fault_injector is None:
            fault_injector = FaultInjector.from_env()
        self.faults = fault_injector
        # offload pipeline: queue of eviction batches awaiting their
        # background gather; blocks counted separately so the bound is
        # in blocks, not batches
        self._offload_q: deque = deque()
        self._offload_q_blocks = 0
        self._block_nbytes_cached: Optional[int] = None
        self._offload_task: Optional[asyncio.Task] = None
        self._offload_wake: Optional[asyncio.Event] = None
        self._io_pool = None
        # onboard staging: host-resident blocks prefetched for waiting
        # requests, consumed (popped) by onboard/onboard_remote. Only
        # mutated on the event loop; worker threads read membership at
        # most (benign: a stale read re-stages identical bytes).
        self._staged: "OrderedDict[int, torch.Tensor]" = OrderedDict()
        self._staged_bytes = 0
        self._prefetch_tasks: set = set()
        # router prefix hints (satellite of the fleet-reuse direction):
        # hashes staged off a hint chain, so their consumption counts as
        # prefetch_hint_hits; seen-chain LRU bounds re-stage churn
        self._hint_staged: set[int] = set()
        self._hint_seen: OrderedDict[tuple, None] = OrderedDict()
        self._closed = False
        # a failure of the offload worker's device read (the gather, its
        # copies, a pinned allocation), raised on the scheduler's thread
        # by `raise_device_error`: a fault of the device path must fail
        # requests, not pass as a cache miss
        self.device_error: Optional[BaseException] = None
        # lifecycle flight recorder: owned by the engine (None unless
        # DYN_KV_LIFECYCLE); the store shares it for tier transitions
        self.lifecycle = getattr(engine, "kv_lifecycle", None)
        self.store.lifecycle = self.lifecycle
        engine.pool.evict_hook = self._on_evict
        engine.kvbm = self
        # the memory ledger (engine/memory.py, None unless armed): the
        # device bytes KVBM's pipeline holds beyond the KV pool — pages
        # pinned against the offload queue (on the card until the drain
        # gathers them) and the staged onboard bytes plus the queue's;
        # live providers, read at every ledger poll
        led = getattr(engine, "memory_ledger", None)
        if led is not None:
            led.provider(
                "kvbm_pinned",
                lambda: engine.pool.pending_offload_pages
                * self._block_nbytes(),
                source="pool.pending_offload_pages * block_nbytes")
            led.provider(
                "kvbm_staged",
                lambda: self._staged_bytes
                + self._offload_q_blocks * self._block_nbytes(),
                source="staged onboard bytes + offload queue depth")

    # -- controller surface (reference block_manager/controller.rs) --------

    def status(self) -> dict:
        """Per-tier occupancy + lifetime stats (ControlMessage::Status).
        G1 is the engine's device page pool; G2/G3 the tiered store;
        G4 the remote advert set when distributed KVBM is attached."""
        pool = self.engine.pool
        out = {
            "g1": {"pages": pool.capacity, "active": pool.active_pages,
                   "used": pool.used_pages,
                   "usage": round(pool.usage(), 4)},
            **self.store.occupancy(),
            "stats": {
                "offloaded": self.stats.offloaded,
                "onboarded": self.stats.onboarded,
                "onboard_queries": self.stats.onboard_queries,
                "remote_onboarded": self.stats.remote_onboarded,
                "onboard_hit_rate": round(
                    self.stats.onboarded
                    / max(self.stats.onboard_queries, 1), 4),
            },
            "pipeline": self.pipeline_stats(),
        }
        if self.remote is not None:
            out["g4"] = self.remote.status()
        return out

    def pipeline_stats(self) -> dict:
        """Flat pipeline counters for the `_sys.stats` scrape and the
        Prometheus gauges (runtime/distributed.py wire_kvbm) — blocks
        unless suffixed _bytes/_ms/_pages."""
        perf = getattr(self.engine, "perf", None) or {}
        return {
            "offloaded": self.stats.offloaded,
            "onboarded": self.stats.onboarded,
            "remote_onboarded": self.stats.remote_onboarded,
            "offload_queue_depth": self._offload_q_blocks,
            "offload_queue_bytes":
                self._offload_q_blocks * self._block_nbytes(),
            "offload_inline": self.stats.offload_inline,
            "prefetched": self.stats.prefetched,
            "prefetch_hits": self.stats.prefetch_hits,
            "prefetch_hint_hits": self.stats.prefetch_hint_hits,
            "remote_prefetched": self.stats.remote_prefetched,
            "staged_blocks": len(self._staged),
            "staged_bytes": self._staged_bytes,
            "pending_offload_pages":
                self.engine.pool.pending_offload_pages,
            "admission_stall_ms":
                round(perf.get("admission_stall_ms", 0.0), 3),
        }

    def reset(self, level: str = "all") -> dict:
        """Manual flush (ControlMessage::ResetPool/ResetAll): "g1"
        drops the device prefix cache (inactive pages only — pages held
        by running sequences are never touched), "g2"/"g3" flush the
        host/disk tiers, "all" does everything."""
        if level not in ("g1", "g2", "g3", "all"):
            raise ValueError(f"unknown cache level {level!r}")
        dropped: dict = {}
        if level in ("g1", "all"):
            dropped["g1"] = self.engine.clear_kv_blocks()
        if level in ("g2", "g3", "all"):
            dropped.update(self.store.clear(level))
        return dropped

    # -- offload (G1 → G2) --------------------------------------------------

    def _on_evict(self, batch: list[tuple[int, int]]) -> None:
        """PagePool is about to recycle registered pages: stash their KV.

        Pipeline off (offload_queue_depth=0) or queue full: one batched
        device gather + host sync inline — runs synchronously inside the
        scheduler coroutine (allocation paths), never concurrent with a
        device step, so reading the cache without the engine's device
        lock is safe. Pipeline on with queue space: pin the pages
        (deferring their recycle) and enqueue; the background worker
        pays the gather off the scheduler loop."""
        batch = [(pid, h) for pid, h in batch if not self.store.contains(h)]
        if not batch:
            return
        depth = self._effective_queue_depth()
        if depth > 0 and not self._closed:
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                pass   # no loop (direct pool use): inline below
            else:
                if self._offload_q_blocks + len(batch) <= depth:
                    self.engine.pool.pin_for_offload(
                        [pid for pid, _ in batch])
                    self._offload_q.append(batch)
                    self._offload_q_blocks += len(batch)
                    self._ensure_offload_worker()
                    self._offload_wake.set()
                    return
                # bounded-queue backpressure: the worker is behind (or
                # stuck); pay the copy now rather than pin HBM pages
                # against a queue that isn't draining
                self.stats.offload_inline += len(batch)
        self._offload_inline(batch)

    def _block_nbytes(self) -> int:
        """Bytes one tier block occupies — constant per model, so the
        byte cap reduces to a derived block bound. Dtype comes from the
        live device cache when present (quantized caches shrink blocks),
        else bf16's 2 bytes."""
        if self._block_nbytes_cached is None:
            itemsize = 2
            cache = getattr(self.engine, "k_cache", None)
            if cache:
                itemsize = cache[0].element_size()
            n = itemsize
            for dim in self.block_shape():
                n *= dim
            self._block_nbytes_cached = n
        return self._block_nbytes_cached

    def _effective_queue_depth(self) -> int:
        """Staging bound in blocks after applying the byte cap. The
        byte cap only ever tightens an enabled queue: depth=0 keeps the
        pipeline off regardless (knobs-off stays byte-for-byte)."""
        depth = self.config.offload_queue_depth
        cap_bytes = self.config.offload_queue_bytes
        if depth <= 0 or cap_bytes <= 0:
            return depth
        return min(depth, cap_bytes // self._block_nbytes())

    def _offload_inline(self, batch: list[tuple[int, int]]) -> None:
        blocks = self.engine._read_kv_pages_sync([pid for pid, _ in batch])
        for (_, seq_hash), block in zip(batch, blocks):
            self.store.put(seq_hash, block)
            self.stats.offloaded += 1

    def flush_queued_offloads(self) -> int:
        """Emergency inline drain, called by the engine when page
        allocation fails while offload pins are outstanding (slow or
        stuck worker holding HBM the allocator needs): process every
        batch still in the staging queue synchronously — gather, tier
        put, release pins — so those pages recycle NOW. Batches the
        worker already claimed stay with it (their pins are bounded by
        one drain round). Returns the number of pages released."""
        released = 0
        while self._offload_q:
            batch = self._offload_q.popleft()
            self._offload_q_blocks -= len(batch)
            try:
                self._offload_inline(batch)
                self.stats.offload_inline += len(batch)
            finally:
                self.engine.pool.release_offload_pin(
                    [pid for pid, _ in batch])
            released += len(batch)
        return released

    def _ensure_offload_worker(self) -> None:
        if self._offload_wake is None:
            self._offload_wake = asyncio.Event()
        if self._offload_task is None or self._offload_task.done():
            self._offload_task = asyncio.get_running_loop().create_task(
                self._offload_worker())

    async def _offload_worker(self) -> None:
        """Drains the staging queue: ONE batched device gather for
        everything queued (under the device lock — steps donate the
        cache buffers), host sync in a thread, tier demotion on the IO
        pool, then the pins release and the pool recycles the pages."""
        while not self._closed:
            if not self._offload_q:
                self._offload_wake.clear()
                await self._offload_wake.wait()
                continue
            pairs: list[tuple[int, int]] = []
            while self._offload_q:
                pairs.extend(self._offload_q.popleft())
            page_ids = [pid for pid, _ in pairs]
            try:
                if self.faults is not None:
                    action = self.faults.on_offload()
                    if action is not None and action[0] == "delay":
                        await asyncio.sleep(action[1])
                    elif action is not None:
                        # stuck worker: park until cancelled; queued
                        # blocks keep their pins, new evictions
                        # backpressure into the inline path
                        await asyncio.Event().wait()
                t0 = time.perf_counter()
                tr = tracer()
                span = tr.start_span(
                    "kvbm.offload",
                    attributes={"kvbm.blocks": len(pairs)}) \
                    if tr.enabled else None
                try:
                    async with self.engine._device_lock:
                        try:
                            blocks = await asyncio.to_thread(
                                self.engine._read_kv_pages_sync, page_ids)
                        except Exception as e:
                            self.device_error = e
                            raise

                    def demote() -> None:
                        for (_, seq_hash), block in zip(pairs, blocks):
                            self.store.put(seq_hash, block)

                    await self._run_io(demote)
                finally:
                    if span is not None:
                        span.end()
                self.stats.offloaded += len(pairs)
                em = getattr(self.engine, "metrics", None)
                if em is not None:
                    em.offload_drain.observe(time.perf_counter() - t0)
            except Exception:
                logger.exception("kvbm offload batch failed; dropping "
                                 "%d block(s)", len(pairs))
            finally:
                # ALWAYS recycle, even on failure/cancel — a leaked pin
                # is permanently lost HBM
                self.engine.pool.release_offload_pin(page_ids)
                self._offload_q_blocks -= len(pairs)

    def raise_device_error(self) -> None:
        """Raise, once, the offload worker's last device failure. The
        engine's scheduler calls this every iteration; the inline offload
        and the onboards raise their own."""
        err, self.device_error = self.device_error, None
        if err is not None:
            raise RuntimeError("kvbm offload: the device read failed") \
                from err

    def _run_io(self, fn, *args):
        """Run blocking tier IO on the pipeline's thread pool."""
        if self._io_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._io_pool = ThreadPoolExecutor(
                max_workers=max(1, self.config.offload_workers),
                thread_name_prefix="kvbm-io")
        return asyncio.get_running_loop().run_in_executor(
            self._io_pool, lambda: fn(*args))

    # -- onboard staging (prefetch) ----------------------------------------

    def prefetch_waiting(self, waiting: list,
                         hints: Optional[list] = None) -> None:
        """Scheduler-loop kickoff: stage tier blocks for requests still
        queued in `_waiting` so their eventual admission onboard is one
        batched device write (disk reads and remote pulls happen here,
        off the admission path). No-op unless prefetch_blocks > 0.

        `hints` is an optional list of seq-hash chains carried on routed
        requests by the kv_router (request["extra"]["kv_hints"]) — the
        router computed the prompt's block chain anyway, so the tiers
        can warm up before admission even looks at the request; staged
        blocks consumed from a hint chain count as prefetch_hint_hits
        (the fleet-reuse direction's first measurable lever)."""
        if self.config.prefetch_blocks <= 0 or self._closed:
            return
        for seq in waiting[:8]:
            if getattr(seq, "import_kv", None) is not None:
                continue   # disagg import: KV arrives over the wire
            key = len(seq.prompt)   # re-prefetch after preemption grows it
            if getattr(seq, "_kvbm_prefetched", None) == key:
                continue
            seq._kvbm_prefetched = key
            task = asyncio.get_running_loop().create_task(
                self._prefetch_seq(seq))
            self._prefetch_tasks.add(task)
            task.add_done_callback(self._prefetch_tasks.discard)
        for chain in (hints or [])[:8]:
            if not chain:
                continue
            key = (chain[-1], len(chain))
            if key in self._hint_seen:
                continue
            self._hint_seen[key] = None
            while len(self._hint_seen) > 256:
                self._hint_seen.popitem(last=False)
            task = asyncio.get_running_loop().create_task(
                self._prefetch_hint([int(h) for h in chain]))
            self._prefetch_tasks.add(task)
            task.add_done_callback(self._prefetch_tasks.discard)

    async def _prefetch_hint(self, hashes: list[int]) -> None:
        """Stage the leading tier-resident run of a router hint chain.
        Same staging buffer as _prefetch_seq — admission onboard is the
        single convergence point — but staged hashes are tagged so
        their consumption is attributable to the router hint."""
        try:
            dev = len(self.engine.pool.match_prefix(hashes))
            limit = min(len(hashes), dev + self.config.prefetch_blocks)
            if dev >= limit:
                return
            got = await self._run_io(self._read_chain, hashes[dev:limit])
            fresh = [(h, d) for h, d in got if d is not None]
            for h, d in fresh:
                self._stage(h, d, hint=True)
            self.stats.prefetched += len(fresh)
        except Exception:
            logger.exception("kvbm hint prefetch failed; admission will "
                             "read the tiers directly")

    async def _prefetch_seq(self, seq) -> None:
        tr = tracer()
        span = tr.start_span("kvbm.prefetch") if tr.enabled else None
        try:
            ps = self.engine.model_cfg.page_size
            hashes = seq.prompt_hashes
            max_blocks = (len(seq.prompt) - 1) // ps
            dev = len(self.engine.pool.match_prefix(hashes))
            limit = min(len(hashes), max_blocks,
                        dev + self.config.prefetch_blocks)
            if dev >= limit:
                return
            got = await self._run_io(self._read_chain, hashes[dev:limit])
            fresh = [(h, d) for h, d in got if d is not None]
            for h, d in fresh:
                self._stage(h, d)
            self.stats.prefetched += len(fresh)
            # continue the chain from peer tiers where local ran out —
            # the staged buffer is the convergence point, so admission
            # (onboard) and post-admission (onboard_remote) both hit it
            n = dev + len(got)
            if self.remote is not None and n < limit:
                blocks = await self.remote.fetch(
                    hashes[n:limit], expect_shape=self.block_shape())
                for j, d in enumerate(blocks):
                    self._stage(hashes[n + j], d)
                self.stats.prefetched += len(blocks)
                self.stats.remote_prefetched += len(blocks)
        except Exception:
            logger.exception("kvbm prefetch failed; admission will read "
                             "the tiers directly")
        finally:
            if span is not None:
                span.end()

    def _read_chain(self, hashes: list[int]) -> list[tuple]:
        """(thread) leading run of tier reads; staged blocks count as
        present (None data) so a re-prefetch doesn't redo disk IO."""
        out = []
        for h in hashes:
            if h in self._staged:
                out.append((h, None))
                continue
            data = self.store.get(h)
            if data is None:
                break
            out.append((h, data))
        return out

    def _stage(self, seq_hash: int, data, hint: bool = False) -> None:
        if seq_hash in self._staged:
            self._staged.move_to_end(seq_hash)
            return
        self._staged[seq_hash] = data
        self._staged_bytes += data.nbytes
        if hint:
            self._hint_staged.add(seq_hash)
        if self.lifecycle is not None:
            self.lifecycle.on_prefetch(
                seq_hash, "hint_stage" if hint else "stage")
        # bound the buffer: a few waves' worth of prefetch, LRU-dropped
        # (dropping only costs a re-read — the tiers still hold the data)
        cap = max(self.config.prefetch_blocks, 1) * 8
        while len(self._staged) > cap:
            old_hash, old = self._staged.popitem(last=False)
            self._staged_bytes -= old.nbytes
            self._hint_staged.discard(old_hash)

    def _take_staged(self, seq_hash: int):
        data = self._staged.pop(seq_hash, None)
        if data is not None:
            self._staged_bytes -= data.nbytes
            if seq_hash in self._hint_staged:
                self._hint_staged.discard(seq_hash)
                self.stats.prefetch_hint_hits += 1
            if self.lifecycle is not None:
                self.lifecycle.on_prefetch(seq_hash, "consume")
        return data

    # -- onboard (G2/G3 → G1) -----------------------------------------------

    def onboard(self, seq) -> int:
        """Fill `seq`'s fresh pages from the staged buffer and the tiers
        where the prompt's block chain continues past the device prefix
        hit. Returns the new cached_len. Called by the engine at
        admission, after page allocation, before prefill — with
        prefetch on, the chain is already host-staged and this is one
        batched device write."""
        ps = self.engine.model_cfg.page_size
        hashes = seq.prompt_hashes
        # at least one prompt token must be computed for its logits
        max_blocks = (len(seq.prompt) - 1) // ps
        i = seq.cached_len // ps
        if i >= max_blocks:
            return seq.cached_len
        self.stats.onboard_queries += 1
        start = i
        hits = []
        staged_hits = 0
        while i < min(len(hashes), max_blocks):
            data = self._take_staged(hashes[i])
            if data is not None:
                self.stats.prefetch_hits += 1
                staged_hits += 1
            else:
                data = self.store.get(hashes[i])
            if data is None:
                break
            hits.append(data)
            i += 1
        if not hits:
            return seq.cached_len
        t0 = time.perf_counter()
        tr = tracer()
        span = tr.start_span(
            "kvbm.onboard",
            attributes={"kvbm.blocks": len(hits),
                        "kvbm.source": "local"}) if tr.enabled else None
        try:
            self._write_and_register(seq, start, hits)
        finally:
            if span is not None:
                span.end()
        self.stats.onboarded += len(hits)
        if self.lifecycle is not None:
            self.lifecycle.on_onboard(hashes[start:i], "local", ps)
        trace = getattr(seq, "trace", None)
        if trace is not None:
            if staged_hits:
                trace.event("kvbm.prefetch_hit", blocks=staged_hits)
            trace.event("kvbm.onboard", blocks=len(hits),
                        staged_hits=staged_hits,
                        ms=round((time.perf_counter() - t0) * 1e3, 3))
        return i * ps

    def _write_and_register(self, seq, start: int, blocks_data) -> None:
        """Shared onboard tail for the local AND remote paths: one
        batched device write of the contiguous run (stacked into the
        engine's pinned staging buffer, one host-to-device copy, K3), then
        page registration (emits KV_STORED for the router's view)."""
        ps = self.engine.model_cfg.page_size
        end = start + len(blocks_data)
        self.engine.write_kv_blocks(seq.pages[start:end], blocks_data)
        blocks = TokenBlockSequence(ps, seq.prompt).blocks
        for j in range(start, end):
            blk = blocks[j]
            self.engine.pool.register_page(
                seq.pages[j], blk.seq_hash, blk.local_hash,
                blk.parent_seq_hash)

    def block_shape(self) -> tuple:
        """(2, L, KVH, P, D) — the wire/tier shape of one block."""
        m = self.engine.model_cfg
        return (2, m.num_layers, m.num_kv_heads, m.page_size, m.head_dim)

    # -- remote onboard (G4 → G1) -------------------------------------------

    async def onboard_remote(self, seq) -> int:
        """Continue `seq`'s block chain from PEER workers' tiers where the
        local tiers ran out. Called by the engine scheduler after
        admission (async: it crosses the network), before prefill.
        Consumes prefetch-staged blocks first (the same staging path as
        local onboard), then pulls the rest. Updates ``seq.cached_len``
        and returns it. A remote-tier failure degrades to a cache miss;
        a failure of the device write (staging allocation, copy, K3)
        raises, as the local onboard's does."""
        if self.remote is None:
            return seq.cached_len
        ps = self.engine.model_cfg.page_size
        hashes = seq.prompt_hashes
        max_blocks = (len(seq.prompt) - 1) // ps
        start = seq.cached_len // ps
        if start >= max_blocks or start >= len(hashes):
            return seq.cached_len
        blocks_data = []
        try:
            i = start
            while i < min(len(hashes), max_blocks):
                data = self._take_staged(hashes[i])
                if data is None:
                    break
                self.stats.prefetch_hits += 1
                blocks_data.append(data)
                i += 1
            if i < min(len(hashes), max_blocks):
                blocks_data.extend(await self.remote.fetch(
                    hashes[i:max_blocks],
                    expect_shape=self.block_shape()))
        except Exception:
            logger.exception("kvbm remote fetch failed; continuing with "
                             "the %d staged block(s)", len(blocks_data))
        if not blocks_data:
            return seq.cached_len
        tr = tracer()
        span = tr.start_span(
            "kvbm.onboard",
            attributes={"kvbm.blocks": len(blocks_data),
                        "kvbm.source": "remote"}) if tr.enabled else None
        try:
            async with self.engine._device_lock:
                self._write_and_register(seq, start, blocks_data)
        finally:
            if span is not None:
                span.end()
        self.stats.remote_onboarded += len(blocks_data)
        if self.lifecycle is not None:
            self.lifecycle.on_onboard(
                hashes[start:start + len(blocks_data)], "remote", ps)
        seq.cached_len = (start + len(blocks_data)) * ps
        trace = getattr(seq, "trace", None)
        if trace is not None:
            trace.event("kvbm.onboard_remote", blocks=len(blocks_data))
        logger.info("kvbm: onboarded %d remote blocks (cached_len=%d)",
                    len(blocks_data), seq.cached_len)
        return seq.cached_len

    # -- lifecycle ----------------------------------------------------------

    async def close(self) -> None:
        """Tear down the pipeline: stop the workers, release any pins
        still staged (their data is dropped — the engine is going away)
        and stop the IO pool. Called by TorchEngine.close()."""
        self._closed = True
        for t in list(self._prefetch_tasks):
            t.cancel()
        if self._offload_task is not None:
            self._offload_task.cancel()
            if self._offload_wake is not None:
                self._offload_wake.set()
            # best-effort: let the worker's finally release in-flight
            # pins; a wedged device gather must not block close forever
            await asyncio.wait([self._offload_task], timeout=1.0)
            self._offload_task = None
        for batch in self._offload_q:
            self.engine.pool.release_offload_pin(
                [pid for pid, _ in batch])
        self._offload_q.clear()
        self._offload_q_blocks = 0
        self._staged.clear()
        self._staged_bytes = 0
        self._hint_staged.clear()
        if self._io_pool is not None:
            self._io_pool.shutdown(wait=False)
            self._io_pool = None
