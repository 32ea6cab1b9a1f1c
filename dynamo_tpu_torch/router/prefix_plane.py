"""Fleet prefix heatmap & shadow-routing recorder: measure the
fleet-wide reuse opportunity a tier-aware shared index would have.

Port of `dynamo_tpu/router/prefix_plane.py` (the port keeps its own
copy); records, payloads and metrics are the reference's, byte for byte.
It joins three planes chip-free: the KvIndexer's per-worker radix blocks
(router/indexer.py), tier residency fed through `observe_tiers`, and the
router's per-request candidate sets (router/kv_router.py):

  * **Fleet prefix map.** Keyed by the seq-hash chain: per block
    (workers, tiers, bytes, depth, hotness). Device residency syncs from
    the router's own radix tree (`observe_index`); host/disk residency
    arrives via `observe_tiers`.
  * **Duplication bytes.** A block resident on k workers costs
    (k−1)×block bytes of redundant storage —
    ``dynamo_prefix_duplicate_bytes{depth_bucket}``, bucketed by chain
    depth so shallow system-prompt blocks (duplicated by design) read
    separately from deep conversation tails.
  * **Tier-blind misses.** ``dynamo_prefix_tier_blind_total`` counts
    decisions where some worker held a deeper prefix run in host/disk
    tier than ANY candidate's device overlap — hits the radix index
    could not see.
  * **Shadow routing counterfactual.** On every armed kv-mode decision
    the candidate set is re-scored through the real
    `DefaultWorkerSelector` against an augmented index: per candidate,
    the deeper of its device overlap, its own tier-resident run
    (onboard over the "local" link), and the deepest run anywhere else
    in the fleet (pull over the remote link) — each credited only when
    the analytic pull time (bytes × `runtime/topology.py` link cost)
    beats recomputing the prefill. Placement divergence and
    ``dynamo_prefix_shadow_tokens_saved_total`` are recorded WITHOUT
    changing the actual placement: the shadow selector owns a private,
    per-decision-seeded RNG, so the live selector's draw order is
    byte-identical.

Off by default: `prefix_heat_from_env()` returns None unless
`DYN_PREFIX_HEAT` is truthy, every router touch is ``if rec is not
None``, and the unarmed serving path is byte-identical. Consumers:
`GET /debug/prefixes` (`prefix_payload`) and the fleet `prefix` block
(runtime/telemetry.py prefix_summary, fed by these metrics).
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import replace
from typing import Any, Optional

from dynamo_tpu_torch.router.decision_log import worker_label
from dynamo_tpu_torch.router.scheduler import (
    DefaultWorkerSelector,
    SelectorConfig,
)
from dynamo_tpu_torch.runtime.metrics import Counter, Gauge
from dynamo_tpu_torch.runtime.topology import link_bandwidths

ENV_GATE = "DYN_PREFIX_HEAT"
DEFAULT_RING = 1024
_TRUTHY = {"1", "true", "yes", "on"}

# chain-depth buckets for the duplication gauge: shallow blocks are
# system prompts (duplicated by design — every worker serves them);
# deep blocks are conversation tails whose duplication is pure waste
_DEPTH_EDGES = ((4, "1-4"), (8, "5-8"), (16, "9-16"), (32, "17-32"))

# link tiers for the shadow pull-cost model (runtime/topology.py):
# onboarding a worker's OWN host/disk-resident blocks crosses the local
# plane; pulling a peer's blocks crosses the datacenter network (the
# conservative cross-host assumption — an in-pod ICI pull only gets
# cheaper, so the shadow number is a floor)
HOST_LINK = "local"
REMOTE_LINK = "dcn"

# shadow RNG stream: private to the recorder so the live selector's
# draw order is untouched; per-decision seeding keeps armed runs
# byte-identical per seed regardless of ring wraparound
_SHADOW_SEED = 0x50F1E


def _hex(seq_hash: int) -> str:
    return f"{seq_hash & (2 ** 64 - 1):016x}"


def depth_bucket(depth: int) -> str:
    for edge, label in _DEPTH_EDGES:
        if depth <= edge:
            return label
    return "33+"


class PrefixMetrics:
    """Fixed-name metrics for the prefix plane; registered (and moving)
    only when DYN_PREFIX_HEAT arms the recorder, so the unarmed
    /metrics surface stays byte-identical."""

    def __init__(self) -> None:
        self.duplicate_bytes = Gauge(
            "dynamo_prefix_duplicate_bytes",
            "redundant prefix storage across the fleet: (k-1) x block "
            "bytes for a block resident on k workers, by chain-depth "
            "bucket")
        self.tier_blind = Counter(
            "dynamo_prefix_tier_blind_total",
            "decisions where a worker held a deeper prefix run in "
            "host/disk tier than any candidate's device overlap — hits "
            "invisible to the radix index")
        self.shadow_tokens_saved = Counter(
            "dynamo_prefix_shadow_tokens_saved_total",
            "prefill tokens a tier-aware shared index would have saved "
            "over the actual placement (shadow counterfactual; never "
            "changes routing)")
        self.shadow_divergence = Counter(
            "dynamo_prefix_shadow_divergence_total",
            "decisions where the shadow tier-aware selector picked a "
            "different worker than the live router")

    def register(self, registry, callback=None) -> None:
        """Adopt into a runtime registry (idempotent). `callback` runs
        on every /metrics scrape — the recorder uses it to refresh the
        duplication gauge from the current residency map."""
        for m in (self.duplicate_bytes, self.tier_blind,
                  self.shadow_tokens_saved, self.shadow_divergence):
            registry.register(m)
        if callback is not None:
            registry.on_scrape(callback)


def prefix_heat_enabled(env: Optional[dict] = None) -> bool:
    e = os.environ if env is None else env
    return str(e.get(ENV_GATE, "")).strip().lower() in _TRUTHY


def prefix_heat_from_env(block_size: int = 16, block_nbytes: int = 0,
                         env: Optional[dict] = None
                         ) -> Optional["PrefixHeatRecorder"]:
    """None unless `DYN_PREFIX_HEAT` is truthy — the off path allocates
    nothing and routing stays byte-identical. Ring size via
    `DYN_PREFIX_HEAT_RING` (default 1024, floor 16)."""
    if not prefix_heat_enabled(env):
        return None
    e = os.environ if env is None else env
    try:
        cap = int(e.get("DYN_PREFIX_HEAT_RING", DEFAULT_RING))
    except (TypeError, ValueError):
        cap = DEFAULT_RING
    return PrefixHeatRecorder(capacity=cap, block_size=block_size,
                              block_nbytes=block_nbytes, env=env)


class PrefixHeatRecorder:
    """Bounded ring of shadow-decision records + a fleet prefix map +
    cumulative totals that survive ring eviction. Thread-safe: decisions
    land from the router's event loop, residency feeds from engine
    threads, and summaries are read from HTTP handlers and scrape
    callbacks."""

    def __init__(self, capacity: int = DEFAULT_RING, metrics=None,
                 block_size: int = 16, block_nbytes: int = 0,
                 prefill_us_per_token: float = 20.0,
                 env: Optional[dict] = None) -> None:
        self.capacity = max(16, int(capacity))
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.metrics = metrics if metrics is not None else PrefixMetrics()
        self.block_size = max(1, int(block_size))
        # bytes one KV block occupies; 0 = unknown (pull always credited,
        # duplication counted in blocks only)
        self.block_nbytes = max(0, int(block_nbytes))
        self.prefill_us_per_token = float(prefill_us_per_token)
        bw = link_bandwidths(env)
        self._link_cost = {tier: 1.0 / b for tier, b in bw.items()}
        # device residency: worker label -> {seq_hash: chain depth}
        self._device: dict[str, dict[int, int]] = {}
        # tier residency: worker label -> {seq_hash: (tier, nbytes)}
        self._tiers: dict[str, dict[int, tuple[str, int]]] = {}
        # hotness: seq_hash of the deepest fleet-matched block ->
        # [hits, shadow tokens saved, depth]
        self._hot: OrderedDict[int, list] = OrderedDict()
        self._decisions = 0
        self._divergence = 0
        self._shadow_tokens_saved = 0
        self._tier_blind = 0
        self._recorded = 0

    # -- residency feeds -----------------------------------------------------

    def observe_index(self, indexer) -> None:
        """Sync device residency from a KvIndexer/ApproxKvIndexer radix
        tree: per worker, the set of cached seq-hashes with their chain
        depth. Uses the tree's public event dump (shared by the python
        and native trees). O(blocks) — called from payload/summary/
        scrape paths and the perf sim, never per decision."""
        from dynamo_tpu_torch.tokens import SEED_HASH

        tree = getattr(indexer, "tree", indexer)
        dump = getattr(tree, "dump_events", None)
        if dump is None:
            return
        parent: dict[int, int] = {}
        holders: dict[int, set] = {}
        for ev in dump():
            p = ev.parent_seq_hash if ev.parent_seq_hash is not None \
                else SEED_HASH
            for b in ev.blocks:
                parent[b.seq_hash] = p
                holders.setdefault(b.seq_hash, set()).add(
                    (ev.worker_id, ev.dp_rank))
        depths: dict[int, int] = {SEED_HASH: 0}

        def depth_of(h: int) -> int:
            chain = []
            while h not in depths:
                chain.append(h)
                h = parent.get(h, SEED_HASH)
            d = depths[h]
            for x in reversed(chain):
                d += 1
                depths[x] = d
            return depths[chain[0]] if chain else d

        built: dict[str, dict[int, int]] = {}
        for seq_hash, workers in holders.items():
            d = depth_of(seq_hash)
            for w in workers:
                built.setdefault(worker_label(w), {})[seq_hash] = d
        with self._lock:
            self._device = built

    def observe_worker_blocks(self, worker,
                              blocks: dict[int, int]) -> None:
        """Direct device-residency feed for one worker (perf sim / tests):
        {seq_hash: chain depth}."""
        label = worker_label(worker) if isinstance(worker, tuple) \
            else str(worker)
        with self._lock:
            self._device[label] = dict(blocks)

    def observe_tiers(self, worker,
                      resident: dict[int, tuple[str, int]]) -> None:
        """Host/disk residency snapshot for one worker:
        {seq_hash: (tier, nbytes)} — the `TieredStore.resident_hashes`
        shape. Replaces the worker's previous snapshot."""
        label = worker_label(worker) if isinstance(worker, tuple) \
            else str(worker)
        with self._lock:
            self._tiers[label] = dict(resident)

    # -- shadow pull-cost model ----------------------------------------------

    def _pull_beats_recompute(self, blocks: int, link: str) -> bool:
        """Analytic: moving `blocks` cached blocks over `link` vs
        recomputing their prefill. Unknown block bytes ⇒ credit the
        pull (the counterfactual then measures pure index blindness)."""
        if blocks <= 0:
            return False
        if self.block_nbytes <= 0:
            return True
        pull_s = blocks * self.block_nbytes * self._link_cost.get(
            link, self._link_cost.get(REMOTE_LINK, 8e-11))
        recompute_s = (blocks * self.block_size
                       * self.prefill_us_per_token * 1e-6)
        return pull_s < recompute_s

    @staticmethod
    def _run_length(seq_hashes, resident) -> int:
        """Longest leading run of the request's seq-hash chain present
        in a residency map."""
        n = 0
        for h in seq_hashes:
            if h not in resident:
                break
            n += 1
        return n

    # -- the decision hook (armed only) --------------------------------------

    def observe_decision(self, *, request_id: str, seq_hashes,
                         request_blocks: int, candidates, result,
                         config, n_tokens: int,
                         mode: str = "route") -> None:
        """Shadow counterfactual for one live decision. Never mutates
        the candidates or touches the live selector's RNG; the shadow
        selector is constructed per call with a deterministic
        per-decision seed."""
        seq_hashes = list(seq_hashes)
        with self._lock:
            seq = self._decisions
            self._decisions += 1
            device = {w: dict(m) for w, m in self._device.items()}
            tiers = {w: set(m) for w, m in self._tiers.items()}

        # fleet-wide deepest run per worker (device ∪ tier residency)
        fleet_runs: dict[str, int] = {}
        for label in set(device) | set(tiers):
            pool = set(device.get(label, ())) | tiers.get(label, set())
            fleet_runs[label] = self._run_length(seq_hashes, pool)

        best_device = max((c.overlap_blocks for c in candidates),
                          default=0)
        aug: dict[Any, int] = {}
        shadow_source: dict[Any, str] = {}
        tier_blind = False
        for c in candidates:
            label = worker_label(c.worker)
            best = c.overlap_blocks
            source = "index"
            # a worker's usable run walks its COMBINED device ∪ tier
            # chain (tier blocks extend a device-resident prefix; only
            # the tier part has to move, over the local link)
            dev_run = self._run_length(seq_hashes,
                                       device.get(label, {}))
            own_run = fleet_runs.get(label, 0)
            if own_run > best and self._pull_beats_recompute(
                    own_run - dev_run, HOST_LINK):
                best, source = own_run, "own-tier"
            remote = max((run for w, run in fleet_runs.items()
                          if w != label), default=0)
            if remote > best and self._pull_beats_recompute(
                    remote - best, REMOTE_LINK):
                best, source = remote, "remote-pull"
            if own_run > dev_run and own_run > best_device:
                tier_blind = True
            aug[c.worker] = min(best, request_blocks)
            shadow_source[c.worker] = source

        shadow_cands = [replace(c, overlap_blocks=aug[c.worker])
                        for c in candidates]
        selector = DefaultWorkerSelector(
            SelectorConfig(overlap_weight=config.overlap_weight,
                           temperature=0.0,
                           block_size=config.block_size),
            rng=random.Random(_SHADOW_SEED ^ (seq << 1)))
        shadow = selector.select(request_blocks, shadow_cands)

        # divergence only when the augmented index STRICTLY prefers a
        # different worker — the shadow RNG breaks argmin ties in its
        # own order, and an equal-logit tie is agreement, not a move.
        # On a tie the counterfactual keeps the actual placement and
        # credits that worker's own augmented overlap (a tier-aware
        # worker onboards its tier-resident run without re-routing).
        shadow_best = min(shadow.logits.values())
        diverged = shadow.logits.get(
            result.worker, float("inf")) > shadow_best
        sh_worker = shadow.worker if diverged else result.worker
        sh_overlap = aug.get(sh_worker, 0)
        actual_prefill = max(
            n_tokens - result.overlap_blocks * self.block_size, 0)
        shadow_prefill = max(
            n_tokens - sh_overlap * self.block_size, 0)
        saved = max(actual_prefill - shadow_prefill, 0)

        hot_key = None
        best_run = max(max(aug.values(), default=0), best_device)
        if seq_hashes and best_run > 0:
            hot_key = seq_hashes[min(best_run, len(seq_hashes)) - 1]

        rec = {
            "seq": seq,
            "request_id": request_id,
            "mode": mode,
            "at": time.time(),
            "request_blocks": request_blocks,
            "n_tokens": n_tokens,
            "actual": {
                "worker": worker_label(result.worker),
                "overlap_blocks": result.overlap_blocks,
                "prefill_tokens": actual_prefill,
            },
            "shadow": {
                "worker": worker_label(sh_worker),
                "overlap_blocks": sh_overlap,
                "prefill_tokens": shadow_prefill,
                "source": shadow_source.get(sh_worker, "index"),
            },
            "augmented_overlap": {worker_label(w): v
                                  for w, v in aug.items()},
            "tokens_saved": saved,
            "diverged": diverged,
            "tier_blind": tier_blind,
        }
        with self._lock:
            self._recorded += 1
            self._ring.append(rec)
            self._shadow_tokens_saved += saved
            if diverged:
                self._divergence += 1
            if tier_blind:
                self._tier_blind += 1
            if hot_key is not None:
                slot = self._hot.get(hot_key)
                if slot is None:
                    if len(self._hot) >= 4 * self.capacity:
                        self._hot.popitem(last=False)
                    slot = self._hot[hot_key] = [
                        0, 0, min(best_run, len(seq_hashes))]
                else:
                    self._hot.move_to_end(hot_key)
                slot[0] += 1
                slot[1] += saved
        m = self.metrics
        if saved:
            m.shadow_tokens_saved.inc(saved)
        if diverged:
            m.shadow_divergence.inc()
        if tier_blind:
            m.tier_blind.inc()

    # -- duplication ---------------------------------------------------------

    def duplication(self) -> dict:
        """Redundant prefix storage right now: per depth bucket, the
        (k−1)×bytes cost of every block resident on k workers (device
        or tier; a worker holding a block in both counts once)."""
        with self._lock:
            device = {w: dict(m) for w, m in self._device.items()}
            tiers = {w: dict(m) for w, m in self._tiers.items()}
        locations: dict[int, set] = {}
        depths: dict[int, int] = {}
        nbytes: dict[int, int] = {}
        for label, blocks in device.items():
            for h, d in blocks.items():
                locations.setdefault(h, set()).add(label)
                depths[h] = d
        for label, blocks in tiers.items():
            for h, (_tier, nb) in blocks.items():
                locations.setdefault(h, set()).add(label)
                if nb:
                    nbytes[h] = nb
        by_bucket: dict[str, int] = {}
        dup_blocks = 0
        for h, labels in locations.items():
            k = len(labels)
            if k <= 1:
                continue
            nb = nbytes.get(h) or self.block_nbytes
            dup_blocks += k - 1
            bucket = depth_bucket(depths.get(h, 1))
            by_bucket[bucket] = by_bucket.get(bucket, 0) + (k - 1) * nb
        return {
            "blocks_tracked": len(locations),
            "duplicate_blocks": dup_blocks,
            "duplicate_bytes": sum(by_bucket.values()),
            "by_depth_bucket": dict(sorted(by_bucket.items())),
        }

    def refresh_gauges(self) -> None:
        """Scrape-time refresh of the duplication gauge (registered via
        `PrefixMetrics.register(..., callback=...)`)."""
        dup = self.duplication()
        for bucket, nb in dup["by_depth_bucket"].items():
            self.metrics.duplicate_bytes.set(nb, depth_bucket=bucket)

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

    def top_prefixes(self, n: int = 16) -> list[dict]:
        """Hottest fleet-matched prefixes by decision hits."""
        with self._lock:
            rows = [(h, list(v)) for h, v in self._hot.items()]
        rows.sort(key=lambda r: (-r[1][0], -r[1][1], r[0]))
        return [{"seq_hash": _hex(h), "hits": v[0],
                 "shadow_tokens_saved": v[1], "depth": v[2]}
                for h, v in rows[:max(0, n)]]

    def summary(self) -> dict:
        with self._lock:
            decisions = self._decisions
            divergence = self._divergence
            saved = self._shadow_tokens_saved
            blind = self._tier_blind
            recorded = self._recorded
            in_ring = len(self._ring)
            device_workers = len(self._device)
            tier_workers = len(self._tiers)
        dup = self.duplication()
        return {
            "decisions": decisions,
            "recorded": recorded,
            "in_ring": in_ring,
            "capacity": self.capacity,
            "shadow_tokens_saved_total": saved,
            "shadow_divergence": divergence,
            "divergence_pct": round(100.0 * divergence / decisions, 2)
            if decisions else 0.0,
            "tier_blind_total": blind,
            "duplication": dup,
            "workers": {"device": device_workers, "tier": tier_workers},
            "hottest": self.top_prefixes(8),
        }


# -- consumers ---------------------------------------------------------------


def prefix_payload(push_router, limit: int = 256) -> dict:
    """The /debug/prefixes body for one router. Accepts a KvPushRouter
    or a bare KvRouter; unarmed routers report the arming hint."""
    r = getattr(push_router, "router", push_router)
    rec = getattr(r, "prefix_heat", None)
    if rec is None:
        return {"enabled": False,
                "hint": "set DYN_PREFIX_HEAT=1 to arm the prefix "
                        "heatmap recorder"}
    rec.observe_index(r.indexer)
    return {
        "enabled": True,
        "block_size": r.config.block_size,
        "summary": rec.summary(),
        "prefixes": rec.top_prefixes(32),
        "records": rec.snapshot(limit),
    }
