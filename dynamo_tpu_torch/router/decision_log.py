"""Router decision observability: the always-on `dynamo_router_*`
metrics and the opt-in per-decision ring.

Port of the part of `dynamo_tpu/router/decision_log.py` that `KvRouter`
needs (the port keeps its own copy):

  * **RouterMetrics** (`:64-150`) — fixed `dynamo_router_*` names,
    adopted into the runtime registry like EngineMetrics: decisions by
    mode, overlap-ratio / candidate / logit-margin histograms, prefill
    tokens saved, predicted-vs-actual load error, per-stream consumer
    event/drop counters, snapshot timings, KV-event gaps, and the
    prefix-index gauges refreshed at scrape time.
  * **DecisionRecorder** — a bounded ring of per-decision records plus
    cumulative per-worker totals, armed only by `DYN_ROUTER_LOG`
    (`recorder_from_env()` returns None otherwise, and recording never
    touches the selector's RNG).

`router_payload`, the `/debug/router` body, waits with the `/debug/*`
routes (ROADMAP queue 1).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

from dynamo_tpu_torch.runtime.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

DEFAULT_RING = 2048
_TRUTHY = {"1", "true", "yes", "on"}

# prefix-hit ratio (overlap_blocks / request_blocks) in [0, 1]
_RATIO_BUCKETS = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)
_CANDIDATE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
# logit margin is in block units (the cost function's scale): sub-block
# margins are coin flips, hundreds of blocks are landslides
_MARGIN_BUCKETS = (0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0,
                   64.0, 128.0, 256.0)
# relative |predicted - actual| / max(actual, 1) active-blocks error
_ERROR_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
_SNAPSHOT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def worker_label(worker) -> str:
    """(worker_id, dp_rank) → the "wid:dp" string used everywhere a
    worker key crosses a JSON/label boundary."""
    return f"{worker[0]}:{worker[1]}"


class RouterMetrics:
    """Owned by one KvRouter; fixed names, the reference's, whether or
    not a registry ever adopts them."""

    def __init__(self) -> None:
        h, c = Histogram, Counter
        self.decisions = c(
            "dynamo_router_decisions_total",
            "routing decisions by mode (route=state-updating, "
            "query=best_worker_id probes)")
        self.prefill_tokens_saved = c(
            "dynamo_router_prefill_tokens_saved_total",
            "prompt tokens the chosen worker did NOT have to prefill "
            "(prefix-cache overlap at decision time)")
        self.overlap_ratio = h(
            "dynamo_router_overlap_ratio",
            "prefix-hit ratio per decision (overlap / request blocks)",
            _RATIO_BUCKETS)
        self.candidates = h(
            "dynamo_router_candidates",
            "candidate workers per decision", _CANDIDATE_BUCKETS)
        self.logit_margin = h(
            "dynamo_router_logit_margin_blocks",
            "second-best minus best logit per decision (how close the "
            "call was, in block units)", _MARGIN_BUCKETS)
        self.load_error = h(
            "dynamo_router_load_prediction_error",
            "relative |predicted - actual| active-blocks error, sampled "
            "when a tracked worker's ForwardPassMetrics arrive",
            _ERROR_BUCKETS)
        self.events = c(
            "dynamo_router_events_total",
            "bus events consumed by stream (kv/metrics/sync)")
        self.events_dropped = c(
            "dynamo_router_events_dropped_total",
            "malformed/unappliable bus events dropped by stream")
        self.snapshot_save = h(
            "dynamo_router_snapshot_save_seconds",
            "radix-tree snapshot persist to the runtime store",
            _SNAPSHOT_BUCKETS)
        self.snapshot_restore = h(
            "dynamo_router_snapshot_restore_seconds",
            "radix-tree snapshot restore at router start",
            _SNAPSHOT_BUCKETS)
        self.snapshot_failures = c(
            "dynamo_router_snapshot_failures_total",
            "snapshot persists that raised (consumer survives; counted "
            "here)")
        self.kv_event_gaps = c(
            "dynamo_router_kv_event_gaps_total",
            "KV events missed per worker (event_id discontinuities — the "
            "prefix index silently diverged from that worker's cache)")
        self.index_resyncs = c(
            "dynamo_router_index_resyncs_total",
            "full per-worker prefix-index rebuilds after an event gap "
            "(gap_resync: drop the worker's blocks, replay the retained "
            "event tail)")
        self.index_blocks = Gauge(
            "dynamo_router_index_blocks",
            "cached blocks in the prefix index per worker")
        self.index_workers = Gauge(
            "dynamo_router_index_workers",
            "workers with at least one block in the prefix index")

    def register(self, registry: MetricsRegistry,
                 index_stats=None) -> None:
        """Adopt into a runtime registry (idempotent; first router wins
        a name, like EngineMetrics). `index_stats` is a zero-arg
        callable returning `KvRouter.index_stats()`; when given, the
        index gauges refresh on every scrape."""
        for m in (self.decisions, self.prefill_tokens_saved,
                  self.overlap_ratio, self.candidates, self.logit_margin,
                  self.load_error, self.events, self.events_dropped,
                  self.snapshot_save, self.snapshot_restore,
                  self.snapshot_failures, self.kv_event_gaps,
                  self.index_resyncs, self.index_blocks,
                  self.index_workers):
            registry.register(m)
        if index_stats is not None:
            def update() -> None:
                stats = index_stats()
                for wkey, n in (stats.get("index_blocks") or {}).items():
                    self.index_blocks.set(n, worker=wkey)
                self.index_workers.set(stats.get("index_workers", 0))
            registry.on_scrape(update)


def router_log_enabled(env: Optional[dict] = None) -> bool:
    env = os.environ if env is None else env
    return str(env.get("DYN_ROUTER_LOG", "")).lower() in _TRUTHY


def recorder_from_env(env: Optional[dict] = None
                      ) -> Optional["DecisionRecorder"]:
    """None unless DYN_ROUTER_LOG is truthy — the router stores None and
    every hot-path touch is one `if rec is not None`."""
    env = os.environ if env is None else env
    if not router_log_enabled(env):
        return None
    try:
        cap = int(env.get("DYN_ROUTER_LOG_RING", DEFAULT_RING))
    except (TypeError, ValueError):
        cap = DEFAULT_RING
    return DecisionRecorder(capacity=cap)


class DecisionRecorder:
    """Bounded ring of routing-decision records + cumulative per-worker
    totals (exact for the whole run while the ring stays a fixed-size
    window — same contract as StepRecorder).

    Thread-safe: decisions land from the router's event loop but
    summaries are read from HTTP handlers and scrape callbacks."""

    def __init__(self, capacity: int = DEFAULT_RING) -> None:
        self.capacity = max(16, int(capacity))
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._recorded = 0
        # wkey -> [decisions, tokens_saved, overlap_blocks, total_blocks]
        self._placement: dict[str, list] = {}
        # cumulative margin stats: [sum, min, close_calls(<1 block), n]
        self._margin = [0.0, float("inf"), 0, 0]
        self._hit_ratio_sum = 0.0
        # wkey -> [n, sum_abs_err, max_abs_err, last_predicted,
        #          last_actual]
        self._load_err: dict[str, list] = {}

    # -- hot path ------------------------------------------------------------

    def record_decision(self, request_id: str, result, candidates,
                        *, mode: str, tokens_saved: int,
                        n_tokens: int) -> None:
        """One SelectionResult + its candidate set into the ring. Called
        only when the recorder is armed; must not touch any RNG."""
        wkey = worker_label(result.worker)
        hit_ratio = result.overlap_blocks / max(result.total_blocks, 1)
        cand_rows = [{
            "worker": worker_label(c.worker),
            "overlap_blocks": c.overlap_blocks,
            "potential_prefill": round(
                result.potential_prefill.get(c.worker, 0.0), 4),
            "potential_decode": round(
                result.potential_decode.get(c.worker, 0.0), 4),
            "logit": round(result.logits.get(c.worker, 0.0), 4),
        } for c in candidates]
        rec = {
            "request_id": request_id,
            "mode": mode,
            "at": time.time(),
            "worker": wkey,
            "overlap_blocks": result.overlap_blocks,
            "total_blocks": result.total_blocks,
            "prefix_hit_ratio": round(hit_ratio, 4),
            "prefill_tokens": result.prefill_tokens,
            "tokens_saved": tokens_saved,
            "n_tokens": n_tokens,
            "logit_margin": round(result.margin, 4),
            "ties": result.ties,
            "draw": result.draw,
            "candidates": cand_rows,
        }
        with self._lock:
            self._recorded += 1
            self._ring.append(rec)
            tot = self._placement.get(wkey)
            if tot is None:
                tot = self._placement[wkey] = [0, 0, 0, 0]
            tot[0] += 1
            tot[1] += tokens_saved
            tot[2] += result.overlap_blocks
            tot[3] += result.total_blocks
            self._hit_ratio_sum += hit_ratio
            m = self._margin
            m[0] += result.margin
            m[1] = min(m[1], result.margin)
            m[2] += 1 if result.margin < 1.0 else 0
            m[3] += 1

    def record_load_error(self, worker, predicted: float,
                          actual: float) -> None:
        wkey = worker_label(worker)
        err = abs(predicted - actual) / max(actual, 1.0)
        with self._lock:
            e = self._load_err.get(wkey)
            if e is None:
                e = self._load_err[wkey] = [0, 0.0, 0.0, 0.0, 0.0]
            e[0] += 1
            e[1] += err
            e[2] = max(e[2], err)
            e[3] = predicted
            e[4] = actual

    # -- views ---------------------------------------------------------------

    def snapshot(self, limit: Optional[int] = None) -> list[dict]:
        with self._lock:
            recs = list(self._ring)
        if limit is not None and limit >= 0:
            recs = recs[-limit:]
        return [dict(r) for r in recs]

    @property
    def recorded(self) -> int:
        return self._recorded

    def summary(self) -> dict:
        with self._lock:
            recs = list(self._ring)
            placement = {k: list(v) for k, v in self._placement.items()}
            recorded = self._recorded
            hit_sum = self._hit_ratio_sum
            margin = list(self._margin)
            load_err = {k: list(v) for k, v in self._load_err.items()}

        total = sum(v[0] for v in placement.values())
        place_rows = {}
        for wkey, (n, saved, overlap, blocks) in sorted(
                placement.items()):
            place_rows[wkey] = {
                "decisions": n,
                "share_pct": round(100.0 * n / total, 2) if total else 0.0,
                "tokens_saved": saved,
                "mean_overlap_blocks": round(overlap / n, 2) if n else 0.0,
            }

        # overlap distribution over the ring window
        hist = [0] * (len(_RATIO_BUCKETS) + 1)
        margins_ring = []
        for r in recs:
            ratio = r["prefix_hit_ratio"]
            for i, edge in enumerate(_RATIO_BUCKETS):
                if ratio <= edge:
                    hist[i] += 1
                    break
            else:
                hist[-1] += 1
            margins_ring.append(r["logit_margin"])
        margins_ring.sort()
        n_m = margin[3]
        err_rows = {wkey: {
            "samples": e[0],
            "mean_abs": round(e[1] / e[0], 4) if e[0] else 0.0,
            "max_abs": round(e[2], 4),
            "last_predicted": e[3],
            "last_actual": e[4],
        } for wkey, e in sorted(load_err.items())}
        return {
            "decisions": recorded,
            "in_ring": len(recs),
            "capacity": self.capacity,
            "evicted": recorded - len(recs),
            "tokens_saved": sum(v[1] for v in placement.values()),
            "placement": place_rows,
            "overlap": {
                "mean_hit_ratio": round(hit_sum / recorded, 4)
                if recorded else 0.0,
                "buckets": list(_RATIO_BUCKETS),
                "counts": hist,
            },
            "margins": {
                "mean": round(margin[0] / n_m, 4) if n_m else 0.0,
                "min": margin[1] if n_m else 0.0,
                "p50": margins_ring[len(margins_ring) // 2]
                if margins_ring else 0.0,
                "close_call_pct": round(100.0 * margin[2] / n_m, 2)
                if n_m else 0.0,
            },
            "load_error": err_rows,
        }
