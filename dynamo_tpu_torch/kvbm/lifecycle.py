"""KV-cache lifecycle flight recorder: block provenance, tier residency,
reuse-distance profiling, and prefix hotness.

Port of `dynamo_tpu/kvbm/lifecycle.py` (the port keeps its own copy, on
its own `runtime/metrics.py`):

  * **KvbmMetrics** — always-on registry metrics with fixed
    ``dynamo_kv_lifecycle_*`` / ``dynamo_kvbm_tier_*`` names: lifecycle
    event counters by kind, eviction-cause counters, a reuse-distance
    histogram, premature-eviction and tokens-saved counters, and per-tier
    occupancy/byte gauges refreshed at scrape time.
  * **KvLifecycleRecorder** — a bounded ring of block-lifecycle
    transitions (allocate, register, prefix-reuse hit, evict with cause,
    offload pin/release, tier demote/promote/drop, prefetch
    stage/consume, onboard local/remote, KV-event emit) plus cumulative
    analytics that survive ring eviction: per-tier residency time, the
    reuse-distance histogram, premature evictions (a block back on the
    device ≤ N allocations after leaving it) and a top-K prefix hotness
    table. **Off by default** (``DYN_KV_LIFECYCLE``):
    `recorder_from_env()` returns None and every allocator/KVBM touch is
    one ``if rec is not None``, so eviction order, offload batching and
    KV-event bytes are identical armed or not.

Consumers: the worker's scrape (`KvbmMetrics`, registered with the
engine's metrics); `kv_payload` is the reference's ``GET /debug/kv``
body. The ``/debug/kv`` route, ``doctor kv``, the bench's lifecycle block
and the mocker's ``MockKvManager`` wait for the port's ops layer.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

from dynamo_tpu_torch.runtime.metrics import (Counter, Gauge, Histogram,
                                        MetricsRegistry, hist_quantile)

DEFAULT_RING = 2048
DEFAULT_PREMATURE_WINDOW = 256
_TRUTHY = {"1", "true", "yes", "on"}

# reuse distance in ALLOCATIONS between a block's register (or previous
# hit) and its next hit — power-of-two buckets: a distance past the pool
# size means LRU could never have kept it
_REUSE_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                  4096)
# deepest-tier ordering for the hotness table (g4 = remote peer)
_TIER_DEPTH = {"g1": 1, "g2": 2, "g3": 3, "g4": 4}


def _hex(seq_hash: int) -> str:
    return f"{seq_hash & (2 ** 64 - 1):016x}"


class KvbmMetrics:
    """Owned by one engine; fixed names so docs/observability.md rows
    hold whether or not a registry ever adopts them. The lifecycle
    counters only move while a recorder is armed; the tier gauges
    refresh at every scrape regardless (satellite: tier pressure should
    not require arming a ring)."""

    def __init__(self) -> None:
        self.events = Counter(
            "dynamo_kv_lifecycle_events_total",
            "block-lifecycle transitions by kind (allocate/register/hit/"
            "evict/pin/unpin/demote/promote/drop/prefetch_*/onboard/"
            "kv_event); moves only while DYN_KV_LIFECYCLE is armed")
        self.evictions = Counter(
            "dynamo_kv_lifecycle_evictions_total",
            "device-page evictions by cause (capacity-pressure = "
            "allocate_page LRU, admission-deficit = allocate_sequence "
            "pre-evict, clear = admin clear_kv_blocks)")
        self.premature = Counter(
            "dynamo_kv_lifecycle_premature_evictions_total",
            "blocks onboarded back within DYN_KV_LIFECYCLE_PREMATURE "
            "allocations of leaving the device — evicted the wrong "
            "block")
        self.tokens_saved = Counter(
            "dynamo_kv_lifecycle_tokens_saved_total",
            "prompt tokens NOT recomputed thanks to device prefix hits "
            "and tier onboards")
        self.reuse_distance = Histogram(
            "dynamo_kv_lifecycle_reuse_distance",
            "allocations between a block's register (or previous hit) "
            "and its next prefix hit", _REUSE_BUCKETS)
        self.tier_blocks = Gauge(
            "dynamo_kvbm_tier_blocks",
            "blocks resident per KVBM tier (g1 device / g2 host / "
            "g3 disk), refreshed at scrape time")
        self.tier_bytes = Gauge(
            "dynamo_kvbm_tier_bytes",
            "bytes resident per KVBM tier, refreshed at scrape time")

    def register(self, registry: MetricsRegistry,
                 occupancy=None) -> None:
        """Adopt into a runtime registry (idempotent; first engine wins
        a name, like EngineMetrics). `occupancy` is a zero-arg callable
        returning `tier_occupancy(engine)`; when given, the tier gauges
        refresh on every scrape."""
        for m in (self.events, self.evictions, self.premature,
                  self.tokens_saved, self.reuse_distance,
                  self.tier_blocks, self.tier_bytes):
            registry.register(m)
        if occupancy is not None:
            def update() -> None:
                for tier, row in (occupancy() or {}).items():
                    self.tier_blocks.set(row.get("blocks", 0), tier=tier)
                    self.tier_bytes.set(row.get("bytes", 0), tier=tier)
            registry.on_scrape(update)


def lifecycle_enabled(env: Optional[dict] = None) -> bool:
    env = os.environ if env is None else env
    return str(env.get("DYN_KV_LIFECYCLE", "")).lower() in _TRUTHY


def recorder_from_env(metrics: Optional[KvbmMetrics] = None,
                      env: Optional[dict] = None
                      ) -> Optional["KvLifecycleRecorder"]:
    """None unless DYN_KV_LIFECYCLE is truthy — holders store None and
    every hot-path touch is one `if rec is not None`."""
    env = os.environ if env is None else env
    if not lifecycle_enabled(env):
        return None
    try:
        cap = int(env.get("DYN_KV_LIFECYCLE_RING", DEFAULT_RING))
    except (TypeError, ValueError):
        cap = DEFAULT_RING
    try:
        window = int(env.get("DYN_KV_LIFECYCLE_PREMATURE",
                             DEFAULT_PREMATURE_WINDOW))
    except (TypeError, ValueError):
        window = DEFAULT_PREMATURE_WINDOW
    return KvLifecycleRecorder(capacity=cap, metrics=metrics,
                               premature_window=window)


class KvLifecycleRecorder:
    """Bounded ring of block-lifecycle records + cumulative analytics
    (exact for the whole run while the ring stays a fixed-size window —
    same contract as StepRecorder/DecisionRecorder).

    Thread-safe: transitions land from the scheduler coroutine AND the
    kvbm offload/prefetch worker threads, while summaries are read from
    HTTP handlers and scrape callbacks. The per-hash bookkeeping maps
    are themselves LRU-bounded so a long-lived armed engine cannot grow
    without bound."""

    def __init__(self, capacity: int = DEFAULT_RING,
                 metrics: Optional[KvbmMetrics] = None,
                 premature_window: int = DEFAULT_PREMATURE_WINDOW,
                 topk: int = 20) -> None:
        self.capacity = max(16, int(capacity))
        self.premature_window = max(1, int(premature_window))
        self.topk = topk
        self.metrics = metrics
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._recorded = 0
        self._events: dict[str, int] = {}          # ev kind -> count
        self._evictions: dict[str, int] = {}       # cause -> count
        self._allocs = 0                           # monotone alloc clock
        self._hits = 0
        self._tokens_saved = 0
        self._premature = 0
        self._pins = [0, 0]                        # [pinned, released]
        # seq_hash -> alloc-clock at register/last-hit (reuse distance)
        self._registered_at: OrderedDict[int, int] = OrderedDict()
        # seq_hash -> alloc-clock at device eviction (premature detect)
        self._demoted_at: OrderedDict[int, int] = OrderedDict()
        # reuse-distance histogram: counts per _REUSE_BUCKETS edge +Inf
        self._reuse = [0] * (len(_REUSE_BUCKETS) + 1)
        self._reuse_sum = 0
        self._reuse_n = 0
        # seq_hash -> [hits, tokens_saved, deepest_tier]
        self._hotness: OrderedDict[int, list] = OrderedDict()
        # tier -> {seq_hash: enter_monotonic}; tier -> [sum_s, samples]
        self._entered: dict[str, OrderedDict[int, float]] = {}
        self._residency: dict[str, list] = {}
        self._table_cap = max(4096, 4 * self.capacity)

    # -- internals (call with self._lock held) -------------------------------

    def _record(self, ev: str, **fields: Any) -> None:
        self._recorded += 1
        self._events[ev] = self._events.get(ev, 0) + 1
        rec = {"ev": ev, "at": time.time()}
        rec.update(fields)
        self._ring.append(rec)

    def _bound(self, table: OrderedDict) -> None:
        while len(table) > self._table_cap:
            table.popitem(last=False)

    def _touch_hotness(self, seq_hash: int, hits: int = 0,
                       tokens: int = 0, tier: Optional[str] = None
                       ) -> None:
        row = self._hotness.get(seq_hash)
        if row is None:
            row = self._hotness[seq_hash] = [0, 0, tier or "g1"]
        row[0] += hits
        row[1] += tokens
        if tier is not None:
            row[2] = tier
        self._hotness.move_to_end(seq_hash)
        self._bound(self._hotness)

    def _enter_tier(self, seq_hash: int, tier: str) -> None:
        ent = self._entered.setdefault(tier, OrderedDict())
        ent[seq_hash] = time.monotonic()
        self._bound(ent)

    def _exit_tier(self, seq_hash: int, tier: str) -> None:
        ent = self._entered.get(tier)
        t0 = ent.pop(seq_hash, None) if ent is not None else None
        if t0 is None:
            return
        acc = self._residency.setdefault(tier, [0.0, 0])
        acc[0] += time.monotonic() - t0
        acc[1] += 1

    def _observe_reuse(self, distance: int) -> None:
        idx = len(_REUSE_BUCKETS)
        for i, edge in enumerate(_REUSE_BUCKETS):
            if distance <= edge:
                idx = i
                break
        self._reuse[idx] += 1
        self._reuse_sum += distance
        self._reuse_n += 1

    # -- hot path (called only when armed) -----------------------------------

    def on_allocate(self, page_id: int) -> None:
        with self._lock:
            self._allocs += 1
            self._record("allocate", page=page_id, alloc=self._allocs)
        m = self.metrics
        if m is not None:
            m.events.inc(ev="allocate")

    def on_register(self, page_id: int, seq_hash: int) -> None:
        # A hash re-registered shortly after a device eviction means the
        # block was recomputed from scratch — on single-tier deployments
        # (no host/disk to onboard from) that is the premature-eviction
        # signal, same as a quick re-onboard on the tiered path. The
        # tiered path pops _demoted_at in on_onboard first, so a block
        # never counts twice.
        with self._lock:
            premature = 0
            at = self._demoted_at.pop(seq_hash, None)
            if at is not None \
                    and self._allocs - at <= self.premature_window:
                premature = 1
                self._premature += 1
            self._registered_at[seq_hash] = self._allocs
            self._registered_at.move_to_end(seq_hash)
            self._bound(self._registered_at)
            self._touch_hotness(seq_hash, tier="g1")
            self._enter_tier(seq_hash, "g1")
            self._record("register", page=page_id,
                         seq_hash=_hex(seq_hash), premature=premature)
        m = self.metrics
        if m is not None:
            m.events.inc(ev="register")
            if premature:
                m.premature.inc(premature)

    def on_hit(self, seq_hash: int, tokens_saved: int) -> None:
        """One registered device page reused for a new sequence's
        prefix (`match_prefix`/`acquire` in allocate_sequence)."""
        with self._lock:
            at = self._registered_at.get(seq_hash)
            distance = self._allocs - at if at is not None else None
            if distance is not None:
                self._observe_reuse(distance)
            self._registered_at[seq_hash] = self._allocs
            self._registered_at.move_to_end(seq_hash)
            self._hits += 1
            self._tokens_saved += tokens_saved
            self._touch_hotness(seq_hash, hits=1, tokens=tokens_saved,
                                tier="g1")
            self._record("hit", seq_hash=_hex(seq_hash),
                         distance=distance, tokens_saved=tokens_saved)
        m = self.metrics
        if m is not None:
            m.events.inc(ev="hit")
            m.tokens_saved.inc(tokens_saved)
            if distance is not None:
                m.reuse_distance.observe(distance)

    def on_evict(self, seq_hash: int, cause: str) -> None:
        with self._lock:
            self._evictions[cause] = self._evictions.get(cause, 0) + 1
            self._demoted_at[seq_hash] = self._allocs
            self._demoted_at.move_to_end(seq_hash)
            self._bound(self._demoted_at)
            self._exit_tier(seq_hash, "g1")
            self._record("evict", seq_hash=_hex(seq_hash), cause=cause)
        m = self.metrics
        if m is not None:
            m.events.inc(ev="evict")
            m.evictions.inc(cause=cause)

    def on_pin(self, blocks: int) -> None:
        with self._lock:
            self._pins[0] += blocks
            self._record("pin", blocks=blocks)
        if self.metrics is not None:
            self.metrics.events.inc(ev="pin")

    def on_unpin(self, blocks: int) -> None:
        with self._lock:
            self._pins[1] += blocks
            self._record("unpin", blocks=blocks)
        if self.metrics is not None:
            self.metrics.events.inc(ev="unpin")

    def on_demote(self, seq_hash: int, src: str, dst: str) -> None:
        with self._lock:
            self._exit_tier(seq_hash, src)
            self._enter_tier(seq_hash, dst)
            self._touch_hotness(seq_hash, tier=dst)
            self._record("demote", seq_hash=_hex(seq_hash), src=src,
                         dst=dst)
        if self.metrics is not None:
            self.metrics.events.inc(ev="demote")

    def on_promote(self, seq_hash: int, src: str, dst: str) -> None:
        with self._lock:
            self._exit_tier(seq_hash, src)
            self._enter_tier(seq_hash, dst)
            self._touch_hotness(seq_hash, tier=dst)
            self._record("promote", seq_hash=_hex(seq_hash), src=src,
                         dst=dst)
        if self.metrics is not None:
            self.metrics.events.inc(ev="promote")

    def on_drop(self, seq_hash: int, tier: str) -> None:
        """Block fell off the deepest available tier (disk capacity
        unlink, or host displacement with no disk configured)."""
        with self._lock:
            self._exit_tier(seq_hash, tier)
            self._record("drop", seq_hash=_hex(seq_hash), tier=tier)
        if self.metrics is not None:
            self.metrics.events.inc(ev="drop")

    def on_tier_clear(self, dropped: dict) -> None:
        with self._lock:
            for tier in dropped:
                ent = self._entered.get(tier)
                if ent:
                    for h in list(ent):
                        self._exit_tier(h, tier)
            self._record("tier_clear", dropped=dict(dropped))
        if self.metrics is not None:
            self.metrics.events.inc(ev="tier_clear")

    def on_prefetch(self, seq_hash: int, action: str) -> None:
        """action: "stage" (from _waiting), "hint_stage" (router hint
        chain), or "consume" (onboard popped a staged block)."""
        ev = f"prefetch_{action}"
        with self._lock:
            self._record(ev, seq_hash=_hex(seq_hash))
        if self.metrics is not None:
            self.metrics.events.inc(ev=ev)

    def on_onboard(self, seq_hashes, source: str, page_size: int
                   ) -> None:
        """Blocks restored to the device from host/disk ("local") or a
        peer worker ("remote") — each is a tier hit worth page_size
        prompt tokens, and a premature-eviction candidate."""
        premature = 0
        with self._lock:
            for h in seq_hashes:
                at = self._demoted_at.pop(h, None)
                if at is not None \
                        and self._allocs - at <= self.premature_window:
                    premature += 1
                self._touch_hotness(h, hits=1, tokens=page_size,
                                    tier="g1")
            self._premature += premature
            self._tokens_saved += page_size * len(seq_hashes)
            self._record("onboard", source=source,
                         blocks=len(seq_hashes), premature=premature)
        m = self.metrics
        if m is not None:
            m.events.inc(ev="onboard")
            m.tokens_saved.inc(page_size * len(seq_hashes))
            if premature:
                m.premature.inc(premature)

    def on_kv_event(self, kind: str, blocks: int) -> None:
        with self._lock:
            self._record("kv_event", kind=kind, blocks=blocks)
        if self.metrics is not None:
            self.metrics.events.inc(ev="kv_event")

    # -- views ---------------------------------------------------------------

    @property
    def recorded(self) -> int:
        return self._recorded

    def snapshot(self, limit: Optional[int] = None) -> list[dict]:
        with self._lock:
            recs = list(self._ring)
        if limit is not None and limit >= 0:
            recs = recs[-limit:]
        return [dict(r) for r in recs]

    def summary(self) -> dict:
        with self._lock:
            recs_len = len(self._ring)
            recorded = self._recorded
            events = dict(self._events)
            evictions = dict(self._evictions)
            reuse = list(self._reuse)
            reuse_sum, reuse_n = self._reuse_sum, self._reuse_n
            residency = {t: list(v) for t, v in self._residency.items()}
            live = {t: len(v) for t, v in self._entered.items() if v}
            hot = sorted(self._hotness.items(),
                         key=lambda kv: (-kv[1][0], -kv[1][1]))
            hot = hot[:self.topk]
            out = {
                "events": recorded,
                "in_ring": recs_len,
                "capacity": self.capacity,
                "evicted": recorded - recs_len,
                "by_event": events,
                "allocations": self._allocs,
                "hits": self._hits,
                "tokens_saved": self._tokens_saved,
                "evictions": evictions,
                "premature_evictions": self._premature,
                "premature_window": self.premature_window,
                "pins": {"pinned": self._pins[0],
                         "released": self._pins[1]},
            }
        res_rows = {}
        for tier, (s, n) in sorted(residency.items()):
            res_rows[tier] = {
                "mean_s": round(s / n, 4) if n else 0.0,
                "samples": n,
                "live": live.get(tier, 0),
            }
        for tier, n in live.items():
            res_rows.setdefault(tier, {"mean_s": 0.0, "samples": 0,
                                       "live": n})
        out["residency"] = res_rows
        out["reuse_distance"] = {
            "buckets": list(_REUSE_BUCKETS),
            "counts": reuse,
            "samples": reuse_n,
            "mean": round(reuse_sum / reuse_n, 2) if reuse_n else 0.0,
            "p50": hist_quantile(_REUSE_BUCKETS, reuse, 0.5),
            "p90": hist_quantile(_REUSE_BUCKETS, reuse, 0.9),
        }
        out["hotness"] = [{
            "seq_hash": _hex(h),
            "hits": row[0],
            "tokens_saved": row[1],
            "tier": row[2],
        } for h, row in hot if row[0] > 0]
        return out


# -- payload / summary helpers ------------------------------------------------


def tier_occupancy(engine) -> dict:
    """Per-tier {blocks, capacity, bytes} for one engine. g1 is the
    device page pool; g2/g3 come from the attached KvbmManager's
    TieredStore."""
    out: dict[str, dict] = {}
    kvbm = getattr(engine, "kvbm", None)
    nbytes = 0
    if kvbm is not None:
        try:
            nbytes = kvbm._block_nbytes()
        except Exception:
            nbytes = 0
    pool = getattr(engine, "pool", None)
    if pool is not None:
        used = pool.used_pages
        out["g1"] = {"blocks": used, "capacity": pool.capacity,
                     "bytes": used * nbytes}
    if kvbm is not None:
        for tier, row in kvbm.store.occupancy().items():
            out[tier] = {"blocks": row["blocks"],
                         "capacity": row["capacity"],
                         "bytes": row["blocks"] * nbytes}
    return out


def kv_payload(engine, limit: int = 256) -> dict:
    """The /debug/kv body for one engine: always-on tier map + pipeline
    counters, plus the ring and its summary when the recorder is
    armed."""
    rec = getattr(engine, "kv_lifecycle", None)
    cfg = getattr(engine, "config", None)
    out: dict[str, Any] = {
        "enabled": rec is not None,
        "worker_id": getattr(cfg, "worker_id", None),
        "tiers": tier_occupancy(engine),
    }
    kvbm = getattr(engine, "kvbm", None)
    if kvbm is not None:
        out["pipeline"] = kvbm.pipeline_stats()
    if rec is None:
        out["hint"] = "set DYN_KV_LIFECYCLE=1 to arm the lifecycle ring"
    else:
        out["summary"] = rec.summary()
        out["records"] = rec.snapshot(limit)
    return out
