"""KvRouter: combine the prefix index with the load scheduler; KvPushRouter
wraps it as an AsyncEngine over a worker endpoint.

Port of `dynamo_tpu/router/kv_router.py` (the port keeps its own copy),
on the port's own runtime: the event bus (`runtime/events.py`, or the
coordinator's over `StoreClient`), discovery and the push transport.
`kv_record_path` (or `DYN_KV_RECORD`) captures the consumed KV-event
stream to JSONL (`router/recorder.py`), row for row the reference's, and
`DYN_PREFIX_HEAT` arms the prefix-heat plane (`router/prefix_plane.py`),
whose shadow re-score never moves a placement. With the process tracer on, each decision
runs under a `router.decide` span (`runtime/tracing.py`) carrying the
chosen worker, its overlap and the margin, as the reference's does.

Reference: `lib/llm/src/kv_router/kv_router.rs` — `KvRouter.find_best_match`
(:203-320), `KvPushRouter` AsyncEngine (:479); event consumption
(subscriber.rs:164 durable consumer); replica sync — routers publish
AddRequest / MarkPrefillCompleted / Free so replicas' predicted loads
converge (kv_router.rs:66-68, subscriber.rs); snapshot of the radix tree
past an event threshold (kv_router.rs:70-74, NATS object store analog is
the runtime KV store here).

Event subjects (event bus):
- ``kv_events.{ns}.{component}``     — engine KvCacheEvents → indexer
- ``metrics.{ns}.{component}``       — ForwardPassMetrics → load correction
- ``router_sync.{ns}.{component}``   — replica sync between routers
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import time
import uuid
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.protocols import ForwardPassMetrics, KvCacheEvent
from dynamo_tpu_torch.router.decision_log import (
    DecisionRecorder,
    RouterMetrics,
    recorder_from_env,
    worker_label,
)
from dynamo_tpu_torch.router.indexer import (
    ApproxKvIndexer,
    KvIndexer,
    WorkerKey,
)
from dynamo_tpu_torch.router.prefix_plane import (
    PrefixHeatRecorder,
    prefix_heat_from_env,
)
from dynamo_tpu_torch.router.recorder import KvRecorder
from dynamo_tpu_torch.router.scheduler import (
    DefaultWorkerSelector,
    MultiWorkerSequences,
    SelectionResult,
    SelectorConfig,
    WorkerLoad,
)
from dynamo_tpu_torch.runtime.component import EndpointClient, Instance
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.events import EventBus
from dynamo_tpu_torch.runtime.push import PushRouter
from dynamo_tpu_torch.runtime.store import DELETE
from dynamo_tpu_torch.runtime.tracing import tracer
from dynamo_tpu_torch.tokens import compute_seq_hashes

logger = logging.getLogger(__name__)

SNAPSHOT_KEY_PREFIX = "v1/router_snapshot/"
# Events between snapshots (kv_router.rs:70-74). Must stay below the event
# bus replay retention (events.DEFAULT_RETAIN=4096): a restarting router
# restores the last snapshot and replays the retained tail, so the gap
# between snapshots must always fit in the retained buffer.
SNAPSHOT_THRESHOLD = 2048


def kv_events_subject(ns: str, component: str) -> str:
    return f"kv_events.{ns}.{component}"


def metrics_subject(ns: str, component: str) -> str:
    return f"metrics.{ns}.{component}"


def router_sync_subject(ns: str, component: str) -> str:
    return f"router_sync.{ns}.{component}"


@dataclass
class KvRouterConfig:
    block_size: int = 16
    overlap_weight: float = 1.0
    temperature: float = 0.0
    use_kv_events: bool = True        # False ⇒ ApproxKvIndexer
    replica_sync: bool = False
    snapshot_threshold: int = SNAPSHOT_THRESHOLD
    ttl_secs: float = 120.0           # approx-indexer TTL
    # JSONL capture of the consumed KV-event stream (router/recorder.py)
    # for offline replay; the DYN_KV_RECORD env applies when unset here
    # (KvPushRouter.start).
    kv_record_path: Optional[str] = None
    # Escalate KV-event gaps from counting to repair: drop the gapped
    # worker's blocks and rebuild its index slice by replaying the event
    # bus's retained tail. Off by default: gaps are counted only.
    gap_resync: bool = False


class KvRouter:
    """find_best_match + request lifecycle tracking (kv_router.rs:203)."""

    def __init__(self, config: KvRouterConfig) -> None:
        self.config = config
        self.router_id = uuid.uuid4().hex[:8]
        if config.use_kv_events:
            self.indexer: Any = KvIndexer(config.block_size)
        else:
            self.indexer = ApproxKvIndexer(config.block_size, config.ttl_secs)
        self.sequences = MultiWorkerSequences(config.block_size)
        self.selector = DefaultWorkerSelector(SelectorConfig(
            overlap_weight=config.overlap_weight,
            temperature=config.temperature,
            block_size=config.block_size,
        ), random.Random())
        # workers known from instance discovery: worker_id -> set of dp_ranks
        self._known: dict[int, int] = {}      # worker_id -> dp_size
        self._metrics: dict[WorkerKey, ForwardPassMetrics] = {}
        # Decision observability (router/decision_log.py): metrics are
        # always on (cheap counters/histograms with fixed names); the
        # per-decision ring is armed only by DYN_ROUTER_LOG.
        self.metrics = RouterMetrics()
        self.recorder: Optional[DecisionRecorder] = recorder_from_env()
        # Fleet prefix heatmap + shadow-routing counterfactual
        # (router/prefix_plane.py), armed only by DYN_PREFIX_HEAT: the
        # unarmed hot path costs one `is not None` check and routing
        # stays byte-identical (shadow scoring owns a private RNG).
        self.prefix_heat: Optional[PrefixHeatRecorder] = \
            prefix_heat_from_env(block_size=config.block_size)
        # KV-event stream gap detection (indexer.py): a missed event means
        # the index diverged from the worker's real cache until its blocks
        # churn out. Count per worker; log once per worker so a lossy bus
        # doesn't flood the log.
        self._gap_logged: set[WorkerKey] = set()
        # set by KvPushRouter when config.gap_resync: callable(worker)
        # that schedules a full per-worker index rebuild
        self.request_resync = None
        if config.use_kv_events:
            self.indexer.on_gap = self._on_event_gap

    def _on_event_gap(self, worker: WorkerKey, missed: int) -> None:
        self.metrics.kv_event_gaps.inc(missed, worker=worker_label(worker))
        if worker not in self._gap_logged:
            self._gap_logged.add(worker)
            logger.warning(
                "KV-event gap for worker %s: %d event(s) missed — prefix "
                "index may over/under-credit this worker until its blocks "
                "churn (logged once; further gaps only count in "
                "dynamo_router_kv_event_gaps_total)",
                worker_label(worker), missed)
        if self.config.gap_resync and self.request_resync is not None:
            self.request_resync(worker)

    def register_metrics(self, registry) -> None:
        """Adopt the router metrics into a runtime registry; the prefix-
        index gauges refresh at scrape time. The prefix-plane metrics
        register only when DYN_PREFIX_HEAT armed the recorder, so the
        unarmed /metrics surface is unchanged."""
        self.metrics.register(registry, index_stats=self.index_stats)
        ph = self.prefix_heat
        if ph is not None:
            def refresh() -> None:
                ph.observe_index(self.indexer)
                ph.refresh_gauges()
            ph.metrics.register(registry, callback=refresh)

    # -- worker membership (fed by instance watch) --------------------------

    def add_worker(self, worker_id: int, dp_size: int = 1) -> None:
        self._known[worker_id] = max(dp_size, 1)

    def remove_worker(self, worker_id: int) -> None:
        dp = self._known.pop(worker_id, 0)
        for r in range(dp):
            w = (worker_id, r)
            self.indexer.remove_worker(w)
            self.sequences.remove_worker(w)
            self._metrics.pop(w, None)

    def worker_keys(self) -> list[WorkerKey]:
        return [(wid, r) for wid, dp in sorted(self._known.items())
                for r in range(dp)]

    # -- event ingestion ----------------------------------------------------

    def apply_kv_event(self, ev: KvCacheEvent) -> None:
        if self.config.use_kv_events:
            self.indexer.apply_event(ev)

    def apply_metrics(self, m: ForwardPassMetrics) -> None:
        w = (m.worker_id, m.dp_rank)
        # Predicted-vs-actual load error: MultiWorkerSequences' predicted
        # active blocks against the worker's own KvStats, sampled at every
        # metrics arrival for workers the router has actually routed to
        # (peek, not worker(): no fabricated zero-load state).
        seqs = self.sequences.peek(w)
        kv = getattr(m, "kv_stats", None)
        if seqs is not None and kv is not None:
            predicted = seqs.active_blocks
            actual = kv.kv_active_blocks
            self.metrics.load_error.observe(
                abs(predicted - actual) / max(actual, 1))
            if self.recorder is not None:
                self.recorder.record_load_error(w, predicted, actual)
        self._metrics[w] = m

    # -- the decision (kv_router.rs:320 find_best_match) --------------------

    def find_best_match(self, request_id: str, token_ids: list[int],
                        update_states: bool = True) -> SelectionResult:
        workers = self.worker_keys()
        if not workers:
            raise ConnectionError("no workers registered with KvRouter")
        overlaps = self.indexer.find_matches_for_tokens(token_ids).scores
        request_blocks = max(
            (len(token_ids) + self.config.block_size - 1)
            // self.config.block_size, 1)
        candidates = []
        for w in workers:
            seqs = self.sequences.worker(w)
            m = self._metrics.get(w)
            candidates.append(WorkerLoad(
                worker=w,
                overlap_blocks=overlaps.get(w, 0),
                active_prefill_tokens=seqs.active_prefill_tokens,
                active_decode_blocks=seqs.active_blocks,
                total_kv_blocks=(m.kv_stats.kv_total_blocks if m else 0),
                metrics=m,
            ))
        result = self.selector.select(request_blocks, candidates)
        result.prefill_tokens = max(
            len(token_ids) - result.overlap_blocks * self.config.block_size, 0)
        result.total_blocks = request_blocks
        mode = "route" if update_states else "query"
        m = self.metrics
        m.decisions.inc(mode=mode)
        m.overlap_ratio.observe(
            result.overlap_blocks / max(result.total_blocks, 1))
        m.candidates.observe(len(candidates))
        m.logit_margin.observe(result.margin)
        # tokens the chosen worker will NOT prefill thanks to overlap;
        # query probes don't place work, so only routes count as saved
        saved = len(token_ids) - result.prefill_tokens
        if update_states and saved > 0:
            m.prefill_tokens_saved.inc(saved)
        if self.recorder is not None:
            self.recorder.record_decision(
                request_id, result, candidates, mode=mode,
                tokens_saved=max(saved, 0), n_tokens=len(token_ids))
        if self.prefix_heat is not None:
            # shadow counterfactual (prefix_plane.py): re-score through
            # a tier-aware augmented index; never changes `result` and
            # never touches self.selector.rng
            self.prefix_heat.observe_decision(
                request_id=request_id,
                seq_hashes=compute_seq_hashes(
                    token_ids, self.config.block_size),
                request_blocks=request_blocks,
                candidates=candidates, result=result,
                config=self.selector.config,
                n_tokens=len(token_ids), mode=mode)
        if update_states:
            self.sequences.add_request(
                request_id, result.worker,
                result.prefill_tokens, result.total_blocks)
            if not self.config.use_kv_events:
                self.indexer.process_routing_decision(result.worker, token_ids)
        return result

    def mark_prefill_completed(self, request_id: str) -> None:
        self.sequences.mark_prefill_completed(request_id)

    def free(self, request_id: str) -> None:
        self.sequences.free(request_id)

    # -- snapshot / restore -------------------------------------------------

    def dump_snapshot(self) -> list[dict]:
        if not self.config.use_kv_events:
            return []
        return [e.to_dict() for e in self.indexer.tree.dump_events()]

    def restore_snapshot(self, events: list[dict]) -> None:
        for d in events:
            self.apply_kv_event(KvCacheEvent.from_dict(d))

    # -- introspection -------------------------------------------------------

    def index_stats(self) -> dict:
        """Prefix-index composition for /debug/router and the scrape-time
        gauges: per-worker cached block counts plus event totals, and
        which radix tree serves the index (`tree`: "native", the C++ tree
        of `native/radix.cpp`, or "python")."""
        tree = getattr(self.indexer, "tree", None)
        blocks: dict[str, int] = {}
        if tree is not None:
            for w in tree.workers():
                blocks[worker_label(w)] = tree.block_count(w)
        out: dict[str, Any] = {
            "workers": len(self._known),
            "index_workers": len(blocks),
            "index_blocks": blocks,
            "total_blocks": sum(blocks.values()),
        }
        if tree is not None:
            out["tree"] = tree.kind
        applied = getattr(self.indexer, "events_applied", None)
        if applied is not None:
            out["events_applied"] = applied
        gaps = getattr(self.indexer, "gaps", None)
        if gaps:
            out["event_gaps"] = {worker_label(w): n
                                 for w, n in sorted(gaps.items())}
        return out


class KvPushRouter:
    """AsyncEngine: route a PreprocessedRequest to the KV-best worker and
    push it there (kv_router.rs:479). Also runs the background consumers.
    """

    def __init__(self, client: EndpointClient, bus: EventBus,
                 config: Optional[KvRouterConfig] = None) -> None:
        self.client = client
        self.bus = bus
        self.config = config or KvRouterConfig()
        self.router = KvRouter(self.config)
        self.push = PushRouter(client)
        ep = client.endpoint
        self._ns = ep.component.namespace.name
        self._component = ep.component.name
        self._tasks: list[asyncio.Task] = []
        self._started = False
        self._events_since_snapshot = 0
        # live KV-event capture (router/recorder.py), armed by config or
        # DYN_KV_RECORD at start(); replayable into any KvIndexer
        self.kv_recorder: Optional[KvRecorder] = None
        # consumer crash-proofing: first failure per stream logs with a
        # traceback, the rest only count in events_dropped
        self._logged_streams: set[str] = set()
        # workers with an index resync in flight (gap_resync): a gapped
        # stream keeps gapping while the rebuild runs — one at a time
        self._resyncing: set[WorkerKey] = set()

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "KvPushRouter":
        if self._started:
            return self
        self._started = True
        await self.client.start()
        for inst in self.client.instances():
            self.router.add_worker(
                inst.instance_id, inst.metadata.get("dp_size", 1))
        self.client.on_change(self._on_instance_change)
        record_path = self.config.kv_record_path \
            or os.environ.get("DYN_KV_RECORD")
        if record_path:
            self.kv_recorder = KvRecorder(record_path)
        reg = getattr(self.client.endpoint.runtime, "metrics", None)
        if reg is not None:
            # one /metrics scrape renders the router metrics; first
            # router wins a name (same contract as EngineMetrics)
            self.router.register_metrics(reg)
        await self._restore_snapshot()
        if self.config.gap_resync and self.config.use_kv_events:
            self.router.request_resync = self._schedule_resync
        loop = asyncio.get_running_loop()
        if self.config.use_kv_events:
            sub = await self.bus.subscribe(
                kv_events_subject(self._ns, self._component), from_start=True)
            self._tasks.append(loop.create_task(self._consume_kv_events(sub)))
        msub = await self.bus.subscribe(
            metrics_subject(self._ns, self._component))
        self._tasks.append(loop.create_task(self._consume_metrics(msub)))
        if self.config.replica_sync:
            ssub = await self.bus.subscribe(
                router_sync_subject(self._ns, self._component))
            self._tasks.append(loop.create_task(self._consume_sync(ssub)))
        return self

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        if self.kv_recorder is not None:
            await self.kv_recorder.close()
            self.kv_recorder = None

    def _on_instance_change(self, kind: str, inst: Instance) -> None:
        if kind == DELETE:
            self.router.remove_worker(inst.instance_id)
        else:
            self.router.add_worker(
                inst.instance_id, inst.metadata.get("dp_size", 1))

    # -- gap-triggered index resync (config.gap_resync) ----------------------

    def _schedule_resync(self, worker: WorkerKey) -> None:
        """Called from inside apply_event (the gap was just detected):
        must not block, must not recurse — schedule a task, one per
        worker at a time."""
        if worker in self._resyncing:
            return
        self._resyncing.add(worker)
        self._tasks.append(asyncio.get_running_loop().create_task(
            self._resync_worker(worker)))

    async def _resync_worker(self, worker: WorkerKey) -> None:
        """Rebuild one worker's slice of the prefix index from scratch:
        drop its blocks (a gap means we no longer know which of them are
        real), forget its event cursor, then replay the bus's retained
        tail filtered to this worker. Bounded divergence: events older
        than the retention window are gone, but so (overwhelmingly) are
        the blocks they described."""
        try:
            idx = self.router.indexer
            # remove_worker also forgets the event cursor + gap counter
            # (indexer.py) so the replayed tail re-seeds continuity
            idx.remove_worker(worker)
            sub = await self.bus.subscribe(
                kv_events_subject(self._ns, self._component),
                from_start=True)
            applied = 0
            try:
                while True:
                    try:
                        msg = sub.queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if msg is None:
                        break
                    try:
                        ev = KvCacheEvent.from_dict(msg["payload"])
                    except Exception:
                        continue
                    if (ev.worker_id, ev.dp_rank) != worker:
                        continue
                    self.router.apply_kv_event(ev)
                    applied += 1
            finally:
                sub.cancel()
            self.router.metrics.index_resyncs.inc(
                worker=worker_label(worker))
            logger.warning(
                "prefix index for worker %s resynced from the retained "
                "event tail (%d event(s) reapplied)",
                worker_label(worker), applied)
        except Exception:
            logger.exception("index resync failed for worker %s",
                             worker_label(worker))
        finally:
            self._resyncing.discard(worker)

    # -- background consumers ----------------------------------------------
    #
    # Each iteration is individually guarded: one malformed payload (or a
    # failing snapshot persist) must drop that message, not kill the
    # consumer task silently — the router would keep serving on a frozen
    # index/load view. First failure per stream logs a traceback; every
    # drop counts in dynamo_router_events_dropped_total{stream}.

    def _drop(self, stream: str, why: str) -> None:
        self.router.metrics.events_dropped.inc(stream=stream)
        if stream not in self._logged_streams:
            self._logged_streams.add(stream)
            logger.exception(
                "router %s consumer: %s (logged once; further drops only "
                "count in dynamo_router_events_dropped_total)", stream, why)

    async def _consume_kv_events(self, sub) -> None:
        m = self.router.metrics
        async for msg in sub:
            try:
                ev = KvCacheEvent.from_dict(msg["payload"])
                self.router.apply_kv_event(ev)
                if self.kv_recorder is not None:
                    self.kv_recorder.record(ev)
                m.events.inc(stream="kv")
            except Exception:
                self._drop("kv", "malformed KV event")
                continue
            self._events_since_snapshot += 1
            if self._events_since_snapshot >= self.config.snapshot_threshold:
                self._events_since_snapshot = 0
                t0 = time.perf_counter()
                try:
                    await self._save_snapshot()
                    m.snapshot_save.observe(time.perf_counter() - t0)
                except Exception:
                    # store hiccup: the snapshot is an optimization (a
                    # restart replays the retained event tail) — never
                    # worth the consumer's life
                    m.snapshot_failures.inc()
                    self._drop("snapshot", "snapshot persist failed")

    async def _consume_metrics(self, sub) -> None:
        m = self.router.metrics
        async for msg in sub:
            try:
                self.router.apply_metrics(
                    ForwardPassMetrics.from_dict(msg["payload"]))
                m.events.inc(stream="metrics")
            except Exception:
                self._drop("metrics", "malformed ForwardPassMetrics")

    async def _consume_sync(self, sub) -> None:
        m = self.router.metrics
        async for msg in sub:
            try:
                p = msg["payload"]
                if p.get("router_id") == self.router.router_id:
                    continue  # our own publication
                op = p.get("op")
                if op == "add":
                    self.router.sequences.add_request(
                        p["request_id"], tuple(p["worker"]),
                        p["prefill_tokens"], p["total_blocks"])
                elif op == "prefill_done":
                    self.router.mark_prefill_completed(p["request_id"])
                elif op == "free":
                    self.router.free(p["request_id"])
                m.events.inc(stream="sync")
            except Exception:
                self._drop("sync", "malformed replica-sync payload")

    async def _publish_sync(self, payload: dict) -> None:
        if not self.config.replica_sync:
            return
        payload["router_id"] = self.router.router_id
        await self.bus.publish(
            router_sync_subject(self._ns, self._component), payload)

    # -- snapshots ----------------------------------------------------------

    @property
    def _snapshot_key(self) -> str:
        return f"{SNAPSHOT_KEY_PREFIX}{self._ns}/{self._component}"

    async def _save_snapshot(self) -> None:
        store = self.client.endpoint.runtime.store
        data = json.dumps(self.router.dump_snapshot()).encode()
        await store.put(self._snapshot_key, data)

    async def _restore_snapshot(self) -> None:
        store = self.client.endpoint.runtime.store
        kv = await store.get(self._snapshot_key)
        if kv is not None:
            t0 = time.perf_counter()
            try:
                self.router.restore_snapshot(json.loads(kv.value))
                self.router.metrics.snapshot_restore.observe(
                    time.perf_counter() - t0)
            except Exception:
                logger.exception("router snapshot restore failed; starting cold")

    # -- engine contract ----------------------------------------------------

    async def best_worker_id(self, token_ids: list[int]
                             ) -> tuple[int, int, int, float]:
        """Query-only endpoint: (worker_id, dp_rank, overlap_blocks,
        logit_margin) — the standalone `dynamo.router` service's
        `best_worker_id`. The margin (second-best minus best logit, in
        block units) makes the answer self-explaining: ~0 means the
        placement was a coin flip, large means a clear winner."""
        r = self.router.find_best_match(
            uuid.uuid4().hex, token_ids, update_states=False)
        return r.worker[0], r.worker[1], r.overlap_blocks, r.margin

    def _select(self, request_id: str,
                token_ids: list[int]) -> SelectionResult:
        """find_best_match under a `router.decide` span so end-to-end
        traces explain placement. The disabled-tracer path calls the
        router directly: no span allocation on the hot path."""
        tr = tracer()
        if not tr.enabled:
            return self.router.find_best_match(request_id, token_ids)
        with tr.start_span("router.decide",
                           attributes={"request.id": request_id}) as span:
            sel = self.router.find_best_match(request_id, token_ids)
            span.set_attribute("router.worker", worker_label(sel.worker))
            span.set_attribute("router.overlap_blocks", sel.overlap_blocks)
            span.set_attribute(
                "router.prefix_hit_ratio",
                round(sel.overlap_blocks / max(sel.total_blocks, 1), 4))
            span.set_attribute("router.logit_margin", round(sel.margin, 4))
            span.set_attribute("router.prefill_tokens", sel.prefill_tokens)
            span.set_attribute("router.candidates", len(sel.logits))
            return sel

    async def generate(self, request: dict, context: Optional[Context] = None
                       ) -> AsyncIterator[dict]:
        ctx = context or Context()
        token_ids = list(request.get("token_ids", ()))
        request_id = ctx.request_id
        sel = self._select(request_id, token_ids)
        worker_id, dp_rank = sel.worker
        await self._publish_sync({
            "op": "add", "request_id": request_id,
            "worker": [worker_id, dp_rank],
            "prefill_tokens": sel.prefill_tokens,
            "total_blocks": sel.total_blocks,
        })
        request = dict(request)
        request["dp_rank"] = dp_rank
        if token_ids and self.config.use_kv_events:
            # Prefix hint for a worker's KVBM (the reference's
            # kvbm/manager.py prefetch_waiting; the port's engine ignores
            # it until KVBM): the prompt's seq-hash chain in `extra`, as
            # the reference's router sends it.
            extra = dict(request.get("extra") or {})
            extra["kv_hints"] = compute_seq_hashes(
                token_ids, self.config.block_size)
            request["extra"] = extra
        first = True
        try:
            async for item in self.push.direct(request, worker_id, ctx):
                if first:
                    first = False
                    self.router.mark_prefill_completed(request_id)
                    await self._publish_sync(
                        {"op": "prefill_done", "request_id": request_id})
                yield item
        finally:
            self.router.free(request_id)
            await self._publish_sync({"op": "free", "request_id": request_id})
