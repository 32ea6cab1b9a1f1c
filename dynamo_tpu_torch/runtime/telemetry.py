"""Fleet telemetry plane: mergeable metrics snapshots on the event bus.

Port of `dynamo_tpu/runtime/telemetry.py` (the port keeps its own copy).
The snapshots, merges and summaries are pure functions over snapshot
dicts, so a port process and a JAX-package process publish and merge on
one subject. A summary of a subsystem the port has not ported (mesh,
prefix plane, tenancy, serving classes, rejections) returns None, as the
reference's does when its series are absent.

Reference analog: Dynamo's worker-published `ForwardPassMetrics`/`KvStats`
streams on NATS that the planner and frontends consume (PAPER.md §planner)
— metrics ride the message plane, not an HTTP scrape fan-in. Each
component periodically publishes a `MetricsSnapshot` of its registry
(histogram buckets + counters, all mergeable) on the ``telemetry``
subject; a `TelemetryCollector` (frontend, planner, doctor) merges the
per-component snapshots into one fleet view.

Merge math: counters/gauges sum per label set; histograms with identical
bucket edges sum per bucket, so `hist_quantile` over the merged counts
equals the quantile of the combined stream within bucket resolution —
the property tests/test_telemetry.py asserts.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Optional

from dynamo_tpu_torch.runtime.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    hist_quantile,
)

logger = logging.getLogger(__name__)

# Event-plane subject carrying MetricsSnapshot payloads.
TELEMETRY_SUBJECT = "telemetry"

# Histogram preference order for fleet latency summaries: engine-owned
# first (per-token truth at the worker), frontend HTTP view as fallback.
TTFT_HISTOGRAMS = ("dynamo_engine_ttft_seconds",
                   "dynamo_http_time_to_first_token_seconds")
ITL_HISTOGRAMS = ("dynamo_engine_itl_ms",
                  "dynamo_http_inter_token_latency_seconds")
# value scale → seconds, keyed by metric name (engine ITL is in ms)
_TO_SECONDS = {"dynamo_engine_itl_ms": 1e-3}

_warned: set[str] = set()


def _warn_once(name: str, why: str) -> None:
    if name not in _warned:
        _warned.add(name)
        logger.warning("telemetry: skipping %s during merge: %s (logged "
                       "once)", name, why)


def snapshot_metrics(registry: MetricsRegistry) -> dict[str, dict]:
    """Serialize a registry into a mergeable, JSON-able MetricsSnapshot:
    ``{name: {"type": ..., ...}}`` with histogram buckets+counts and
    per-label-set counter/gauge values."""
    out: dict[str, dict] = {}
    for name, m in registry.collect().items():
        if isinstance(m, Histogram):
            counts, total_sum, total = m.snapshot()
            out[name] = {"type": "histogram",
                         "buckets": list(m.buckets),
                         "counts": counts,
                         "sum": total_sum, "count": total}
        elif isinstance(m, Counter):
            out[name] = {"type": "counter",
                         "values": [[lbl, v] for lbl, v in m.items()]}
        elif isinstance(m, Gauge):
            out[name] = {"type": "gauge",
                         "values": [[lbl, v] for lbl, v in m.items()]}
    return out


def _merge_values(into: dict, frm: dict) -> None:
    acc: dict[tuple, list] = {}
    for lbl, v in list(into["values"]) + list(frm["values"]):
        key = tuple(sorted(dict(lbl).items()))
        if key in acc:
            acc[key][1] += v
        else:
            acc[key] = [dict(lbl), v]
    into["values"] = [[lbl, v] for lbl, v in acc.values()]


def merge_snapshots(snaps: list[dict[str, dict]]) -> dict[str, dict]:
    """Merge per-component MetricsSnapshots into one fleet snapshot.
    Counters/gauges sum per label set; histograms require identical
    bucket edges (mismatches are skipped and logged once)."""
    merged: dict[str, dict] = {}
    for snap in snaps:
        for name, m in (snap or {}).items():
            cur = merged.get(name)
            if cur is None:
                if m.get("type") == "histogram":
                    merged[name] = {"type": "histogram",
                                    "buckets": list(m["buckets"]),
                                    "counts": list(m["counts"]),
                                    "sum": m["sum"], "count": m["count"]}
                else:
                    merged[name] = {"type": m.get("type", "counter"),
                                    "values": [[dict(l), v]
                                               for l, v in m["values"]]}
                continue
            if cur["type"] != m.get("type"):
                _warn_once(name, "type mismatch")
                continue
            if cur["type"] == "histogram":
                if (list(cur["buckets"]) != list(m["buckets"])
                        or len(cur["counts"]) != len(m["counts"])):
                    _warn_once(name, "bucket-edge mismatch")
                    continue
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], m["counts"])]
                cur["sum"] += m["sum"]
                cur["count"] += m["count"]
            else:
                _merge_values(cur, m)
    return merged


def flatten(snapshot: dict[str, dict]) -> dict[str, float]:
    """MetricsSnapshot → the flat ``{name: value}`` shape that
    `parse_prom_text` produces (histograms become name_sum/name_count,
    counters/gauges sum across label sets) — so the planner's interval
    delta math is shared between HTTP scrape and event-plane sources."""
    out: dict[str, float] = {}
    for name, m in snapshot.items():
        if m.get("type") == "histogram":
            out[name + "_sum"] = float(m["sum"])
            out[name + "_count"] = float(m["count"])
        else:
            out[name] = float(sum(v for _lbl, v in m["values"]))
    return out


def latency_summary(snapshot: dict[str, dict],
                    quantiles: tuple[float, ...] = (0.5, 0.9, 0.99)
                    ) -> dict[str, dict]:
    """TTFT/ITL percentile summary (seconds) from a MetricsSnapshot,
    preferring engine histograms over the frontend HTTP view."""
    out: dict[str, dict] = {}
    for key, names in (("ttft", TTFT_HISTOGRAMS), ("itl", ITL_HISTOGRAMS)):
        for name in names:
            m = snapshot.get(name)
            if not m or m.get("type") != "histogram" or not m.get("count"):
                continue
            scale = _TO_SECONDS.get(name, 1.0)
            summary = {"source": name, "count": m["count"],
                       "mean": scale * m["sum"] / m["count"]}
            for q in quantiles:
                summary[f"p{int(q * 100)}"] = scale * hist_quantile(
                    m["buckets"], m["counts"], q)
            out[key] = summary
            break
    return out


def _counter_total(snapshot: dict[str, dict], name: str) -> float:
    m = snapshot.get(name)
    if not m or m.get("type") != "counter":
        return 0.0
    return float(sum(v for _lbl, v in m.get("values", [])))


def goodput_summary(snapshot: dict[str, dict]) -> Optional[dict]:
    """Goodput/padding attribution from the step flight recorder's
    counters (engine/profiler.py). None when the component never armed
    `DYN_STEP_PROFILE` — the fleet view stays unchanged for unprofiled
    workers."""
    good = _counter_total(snapshot, "dynamo_engine_goodput_tokens_total")
    padded = _counter_total(snapshot, "dynamo_engine_padded_tokens_total")
    if not good and not padded:
        return None
    work = good + padded
    return {"goodput_tokens": good, "padded_tokens": padded,
            "padded_pct": round(100.0 * padded / work, 3) if work else 0.0}


def router_summary(snapshot: dict[str, dict]) -> Optional[dict]:
    """KV-aware routing health from the router's always-on metrics
    (router/decision_log.py). None when the component made no routing
    decisions — workers and round-robin frontends stay unchanged."""
    decisions = _counter_total(snapshot, "dynamo_router_decisions_total")
    if not decisions:
        return None
    out = {
        "decisions": int(decisions),
        "prefill_tokens_saved": int(_counter_total(
            snapshot, "dynamo_router_prefill_tokens_saved_total")),
    }
    dropped = _counter_total(snapshot, "dynamo_router_events_dropped_total")
    if dropped:
        out["events_dropped"] = int(dropped)
    ov = snapshot.get("dynamo_router_overlap_ratio")
    if ov and ov.get("type") == "histogram" and ov.get("count"):
        out["overlap"] = {
            "mean_hit_ratio": round(ov["sum"] / ov["count"], 4),
            "p50_hit_ratio": round(hist_quantile(
                ov["buckets"], ov["counts"], 0.5), 4),
        }
    err = snapshot.get("dynamo_router_load_prediction_error")
    if err and err.get("type") == "histogram" and err.get("count"):
        out["load_error"] = {"samples": err["count"],
                             "mean": round(err["sum"] / err["count"], 4)}
    return out


def _counter_by_label(snapshot: dict[str, dict], name: str,
                      label: str) -> dict[str, float]:
    m = snapshot.get(name)
    if not m or m.get("type") != "counter":
        return {}
    out: dict[str, float] = {}
    for lbl, v in m.get("values", []):
        key = dict(lbl).get(label, "")
        out[key] = out.get(key, 0.0) + v
    return out


def kv_summary(snapshot: dict[str, dict]) -> Optional[dict]:
    """KV-cache memory-plane health from the lifecycle recorder's
    always-on counters (kvbm/lifecycle.py). None when the component
    never armed `DYN_KV_LIFECYCLE` — the fleet view stays unchanged for
    unrecorded workers."""
    events = _counter_total(snapshot, "dynamo_kv_lifecycle_events_total")
    if not events:
        return None
    out: dict[str, Any] = {
        "events": int(events),
        "tokens_saved": int(_counter_total(
            snapshot, "dynamo_kv_lifecycle_tokens_saved_total")),
    }
    ev = _counter_by_label(snapshot, "dynamo_kv_lifecycle_evictions_total",
                           "cause")
    if ev:
        out["evictions"] = {k: int(v) for k, v in sorted(ev.items())}
    prem = _counter_total(
        snapshot, "dynamo_kv_lifecycle_premature_evictions_total")
    if prem:
        out["premature_evictions"] = int(prem)
        # rate per allocation — the trajectory metric the perf ledger
        # tracks (bench/ledger.py kv_premature_pct); the raw count is
        # meaningless across components of different sizes
        allocs = _counter_by_label(
            snapshot, "dynamo_kv_lifecycle_events_total",
            "ev").get("allocate", 0.0)
        if allocs:
            out["premature_pct"] = round(100.0 * prem / allocs, 3)
    rd = snapshot.get("dynamo_kv_lifecycle_reuse_distance")
    if rd and rd.get("type") == "histogram" and rd.get("count"):
        out["reuse_distance"] = {
            "samples": rd["count"],
            "p50": hist_quantile(rd["buckets"], rd["counts"], 0.5),
        }
    tiers = snapshot.get("dynamo_kvbm_tier_blocks")
    if tiers and tiers.get("type") == "gauge":
        out["tiers"] = {dict(lbl).get("tier", "?"): int(v)
                        for lbl, v in tiers.get("values", [])}
    return out


def _gauge_by_label(snapshot: dict[str, dict], name: str,
                    label: str) -> dict[str, float]:
    m = snapshot.get(name)
    if not m or m.get("type") != "gauge":
        return {}
    out: dict[str, float] = {}
    for lbl, v in m.get("values", []):
        out[dict(lbl).get(label, "")] = v
    return out


def memory_summary(snapshot: dict[str, dict]) -> Optional[dict]:
    """HBM occupancy from the memory ledger's gauges
    (engine/memory.py). None when the component never armed
    `DYN_MEM_LEDGER` — the fleet view stays unchanged for unledgered
    workers. The unattributed residual rides along verbatim: the fleet
    plane must show the same honest number /debug/memory does."""
    classes = _gauge_by_label(snapshot, "dynamo_memory_class_bytes",
                              "class")
    if not classes:
        return None
    out: dict[str, Any] = {
        "classes": {k: int(v) for k, v in sorted(classes.items())},
        "attributed_bytes": int(sum(classes.values())),
    }
    dev = _gauge_by_label(snapshot, "dynamo_memory_device_bytes", "kind")
    if dev:
        out["device"] = {k: int(v) for k, v in sorted(dev.items())}
        limit = dev.get("limit", 0.0)
        if limit:
            out["in_use_pct"] = round(
                100.0 * dev.get("in_use", 0.0) / limit, 2)
    una = snapshot.get("dynamo_memory_unattributed_bytes")
    if una and una.get("values"):
        out["unattributed_bytes"] = int(una["values"][0][1])
    head = snapshot.get("dynamo_memory_headroom_bytes")
    if head and head.get("values"):
        out["headroom_bytes"] = int(head["values"][0][1])
    # per-device occupancy (fed by the mesh recorder's polls): on
    # multi-device workers the single device-0 view above hides the
    # exact imbalance the skew gauges exist to catch
    per_dev = _gauge_by_label(snapshot, "dynamo_mesh_device_bytes",
                              "device")
    if len(per_dev) > 1:
        out["devices"] = {k: int(v) for k, v in sorted(per_dev.items())}
    return out


def mesh_summary(snapshot: dict[str, dict]) -> Optional[dict]:
    """Communication-plane view from the collective recorder's
    always-on series (engine/collectives.py). None when the component
    never armed `DYN_MESH_RECORDER` — the fleet view stays unchanged
    for unrecorded workers. Cross-rank comparison happens here: each
    worker publishes its own per-device bytes and skew, and the merged
    fleet entry is where a straggling rank stands out."""
    by_entry = _counter_by_label(
        snapshot, "dynamo_collective_bytes_total", "entry")
    reshards = _counter_by_label(
        snapshot, "dynamo_mesh_reshard_total", "entry")
    dev = _gauge_by_label(snapshot, "dynamo_mesh_device_bytes",
                          "device")
    if not by_entry and not reshards and not dev:
        return None
    out: dict[str, Any] = {
        "collective_bytes_total": int(sum(by_entry.values())),
    }
    if by_entry:
        out["bytes_by_entry"] = {k: int(v)
                                 for k, v in sorted(by_entry.items())}
        by_op = _counter_by_label(
            snapshot, "dynamo_collective_bytes_total", "op")
        out["bytes_by_op"] = {k: int(v)
                              for k, v in sorted(by_op.items())}
        by_axis = _counter_by_label(
            snapshot, "dynamo_collective_bytes_total", "axis")
        out["bytes_by_axis"] = {k: int(v)
                                for k, v in sorted(by_axis.items())}
    if reshards:
        out["reshards"] = {k: int(v)
                           for k, v in sorted(reshards.items())}
    if dev:
        out["device_bytes"] = {k: int(v) for k, v in sorted(dev.items())}
    sk = snapshot.get("dynamo_mesh_skew_ratio")
    if sk and sk.get("type") == "histogram" and sk.get("count"):
        out["skew"] = {
            "samples": sk["count"],
            "mean": round(sk["sum"] / sk["count"], 4),
            "p99": hist_quantile(sk["buckets"], sk["counts"], 0.99),
        }
    pulls = _counter_by_label(snapshot, "dynamo_kv_pull_bytes_total",
                              "link")
    pulls = {k: int(v) for k, v in sorted(pulls.items()) if k}
    if pulls:
        out["kv_pull_bytes_by_link"] = pulls
    return out


def prefix_summary(snapshot: dict[str, dict]) -> Optional[dict]:
    """Fleet prefix-plane view from the shadow-routing recorder's
    series (router/prefix_plane.py). None when the component never
    armed `DYN_PREFIX_HEAT` — the fleet view stays unchanged. The
    counters merge across routers, so the fleet entry is the
    fleet-wide reuse opportunity the shared-index direction would
    capture."""
    saved = _counter_total(snapshot,
                           "dynamo_prefix_shadow_tokens_saved_total")
    blind = _counter_total(snapshot, "dynamo_prefix_tier_blind_total")
    diverged = _counter_total(snapshot,
                              "dynamo_prefix_shadow_divergence_total")
    dup = _gauge_by_label(snapshot, "dynamo_prefix_duplicate_bytes",
                          "depth_bucket")
    if not saved and not blind and not diverged and not dup:
        # distinguish never-armed (no series at all) from armed-but-
        # quiet: an armed recorder has registered at least one series
        if "dynamo_prefix_shadow_tokens_saved_total" not in snapshot:
            return None
    out: dict[str, Any] = {
        "shadow_tokens_saved": int(saved),
        "shadow_divergence": int(diverged),
        "tier_blind": int(blind),
    }
    if dup:
        out["duplicate_bytes"] = int(sum(dup.values()))
        out["duplicate_bytes_by_depth"] = {
            k: int(v) for k, v in sorted(dup.items())}
    return out


def tenant_summary(snapshot: dict[str, dict]) -> Optional[dict]:
    """Per-tenant fairness view from the `dynamo_tenant_*` series
    (dynamo_tpu/tenancy, docs/multitenancy.md). None when the component
    never armed `DYN_TENANCY` — untenanted fleets see no new block. The
    mergeable *_seconds_total / count counter pairs let the fleet-wide
    entry show honest mean TTFT and queue wait across components."""
    admitted = _counter_by_label(
        snapshot, "dynamo_tenant_admitted_total", "tenant")
    goodput = _counter_by_label(
        snapshot, "dynamo_tenant_goodput_tokens_total", "tenant")
    if not admitted and not goodput:
        return None
    rejected = _counter_by_label(
        snapshot, "dynamo_tenant_rejected_total", "tenant")
    streams = _gauge_by_label(snapshot, "dynamo_tenant_streams", "tenant")
    kv = _gauge_by_label(snapshot, "dynamo_tenant_kv_blocks", "tenant")
    ttft_sum = _counter_by_label(
        snapshot, "dynamo_tenant_ttft_seconds_total", "tenant")
    ttft_n = _counter_by_label(
        snapshot, "dynamo_tenant_first_tokens_total", "tenant")
    wait_sum = _counter_by_label(
        snapshot, "dynamo_tenant_queue_wait_seconds_total", "tenant")
    wait_n = _counter_by_label(
        snapshot, "dynamo_tenant_admissions_total", "tenant")
    names = (set(admitted) | set(goodput) | set(rejected) | set(streams)
             | set(kv)) - {""}
    total_goodput = sum(goodput.values()) or 0.0
    out: dict[str, Any] = {}
    for name in sorted(names):
        t: dict[str, Any] = {
            "admitted": int(admitted.get(name, 0)),
            "rejected": int(rejected.get(name, 0)),
            "goodput_tokens": int(goodput.get(name, 0)),
        }
        if total_goodput:
            t["goodput_share"] = round(
                goodput.get(name, 0.0) / total_goodput, 4)
        if name in streams:
            t["streams"] = int(streams[name])
        if name in kv:
            t["kv_blocks"] = int(kv[name])
        if ttft_n.get(name):
            t["ttft_mean_s"] = round(
                ttft_sum.get(name, 0.0) / ttft_n[name], 6)
        if wait_n.get(name):
            t["queue_wait_mean_s"] = round(
                wait_sum.get(name, 0.0) / wait_n[name], 6)
        out[name] = t
    return out or None


def class_summary(snapshot: dict[str, dict]) -> Optional[dict]:
    """Per-serving-class admission view from the `dynamo_class_*`
    series (dynamo_tpu/serving_classes, docs/robustness.md). None when
    the component never armed `DYN_CLASSES` — classless fleets see no
    new block."""
    admitted = _counter_by_label(
        snapshot, "dynamo_class_admitted_total", "class")
    shed = _counter_by_label(snapshot, "dynamo_class_shed_total", "class")
    downgraded = _counter_by_label(
        snapshot, "dynamo_class_downgraded_total", "class")
    deadline = _counter_by_label(
        snapshot, "dynamo_class_deadline_rejected_total", "class")
    if not admitted and not shed and not downgraded and not deadline:
        return None
    names = (set(admitted) | set(shed) | set(downgraded)
             | set(deadline)) - {""}
    out: dict[str, Any] = {}
    for name in sorted(names):
        c: dict[str, Any] = {"admitted": int(admitted.get(name, 0))}
        if shed.get(name):
            c["shed"] = int(shed[name])
        if downgraded.get(name):
            c["downgraded"] = int(downgraded[name])
        if deadline.get(name):
            c["deadline_rejected"] = int(deadline[name])
        out[name] = c
    return out or None


def rejection_summary(snapshot: dict[str, dict]) -> Optional[dict]:
    """429/503 rejections by {reason, class} from the frontend gates —
    shed load shown next to served load instead of an unexplained
    goodput dip. None when nothing was rejected."""
    m = snapshot.get("dynamo_http_rejections_total")
    if not m or m.get("type") != "counter":
        return None
    out: dict[str, Any] = {}
    for lbl, v in m.get("values", []):
        d = dict(lbl)
        reason = d.get("reason", "?")
        by_cls = out.setdefault(reason, {})
        key = d.get("class", "") or "unknown"
        by_cls[key] = int(by_cls.get(key, 0) + v)
    return out or None


def _publish_best_effort(bus, subject: str, payload: dict) -> None:
    """Never block, never raise: local buses take publish_nowait; remote
    buses get a fire-and-forget task (same contract as breaker events)."""
    try:
        if hasattr(bus, "publish_nowait"):
            bus.publish_nowait(subject, payload)
        else:
            asyncio.get_running_loop().create_task(
                bus.publish(subject, payload))
    except Exception:
        logger.exception("telemetry publish failed")


class TelemetryPublisher:
    """Periodically publishes this process's MetricsSnapshot on the
    telemetry subject. One per served component (worker) or frontend."""

    def __init__(self, bus, registry: MetricsRegistry, component: str,
                 instance: str, role: str = "worker",
                 interval: float = 5.0) -> None:
        self._bus = bus
        self._registry = registry
        self.component = component
        self.instance = instance
        self.role = role
        self.interval = interval
        self.published = 0
        self._task: Optional[asyncio.Task] = None

    def publish_once(self) -> dict:
        payload = {"component": self.component, "instance": self.instance,
                   "role": self.role, "at": time.time(),
                   "metrics": snapshot_metrics(self._registry)}
        _publish_best_effort(self._bus, TELEMETRY_SUBJECT, payload)
        self.published += 1
        return payload

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while True:
            try:
                self.publish_once()
            except Exception:
                logger.exception("telemetry snapshot failed")
            await asyncio.sleep(self.interval)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        # parting snapshot so the collector sees final totals
        try:
            self.publish_once()
        except Exception:
            pass


class TelemetryCollector:
    """Subscribes to the telemetry subject and keeps the latest snapshot
    per (component, instance); `fleet_status()` is the merged view served
    at /fleet/status and rendered by `doctor fleet`."""

    def __init__(self, bus, stale_after: float = 120.0) -> None:
        self._bus = bus
        self.stale_after = stale_after
        self._latest: dict[tuple[str, str], dict] = {}
        # (component, instance) -> goodput tok/s from the delta between
        # the last two snapshots (counters are cumulative)
        self._goodput_rate: dict[tuple[str, str], float] = {}
        self._sub = None
        self._task: Optional[asyncio.Task] = None
        self.received = 0

    async def start(self) -> None:
        self._sub = await self._bus.subscribe(TELEMETRY_SUBJECT,
                                              from_start=True)
        self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        async for msg in self._sub:
            self.ingest(msg.get("payload") or {})

    def ingest(self, payload: dict) -> None:
        key = (str(payload.get("component", "?")),
               str(payload.get("instance", "?")))
        prev = self._latest.get(key)
        if prev is not None:
            dt = float(payload.get("at", 0.0)) - float(prev.get("at", 0.0))
            if dt > 0:
                good_now = _counter_total(
                    payload.get("metrics") or {},
                    "dynamo_engine_goodput_tokens_total")
                good_prev = _counter_total(
                    prev.get("metrics") or {},
                    "dynamo_engine_goodput_tokens_total")
                if good_now >= good_prev:
                    self._goodput_rate[key] = (good_now - good_prev) / dt
        self._latest[key] = payload
        self.received += 1

    def live(self) -> dict[tuple[str, str], dict]:
        now = time.time()
        return {k: p for k, p in self._latest.items()
                if now - float(p.get("at", now)) <= self.stale_after}

    def merged(self) -> dict[str, dict]:
        return merge_snapshots([p.get("metrics") or {}
                                for p in self.live().values()])

    def fleet_status(self, slo=None, control=None,
                     brownout=None) -> dict[str, Any]:
        """`control` is the local ControlPlane's summary — a dict or a
        zero-arg callable returning one (or None) — surfaced verbatim as
        the `control` block so /fleet/status and doctor fleet show which
        controllers are armed and what they last did. `brownout` is the
        local BrownoutMachine's state (dict or zero-arg callable),
        surfaced the same way."""
        now = time.time()
        components = []
        fleet_tok_s = 0.0
        for (comp, inst), p in sorted(self.live().items()):
            metrics = p.get("metrics") or {}
            entry = {
                "component": comp, "instance": inst,
                "role": p.get("role", "?"),
                "age_s": round(now - float(p.get("at", now)), 3),
                "latency": latency_summary(metrics),
            }
            gp = goodput_summary(metrics)
            if gp is not None:
                rate = self._goodput_rate.get((comp, inst))
                if rate is not None:
                    gp["goodput_tok_s"] = round(rate, 2)
                    fleet_tok_s += rate
                entry["goodput"] = gp
            rs = router_summary(metrics)
            if rs is not None:
                entry["router"] = rs
            ks = kv_summary(metrics)
            if ks is not None:
                entry["kv"] = ks
            ms = memory_summary(metrics)
            if ms is not None:
                entry["memory"] = ms
            xs = mesh_summary(metrics)
            if xs is not None:
                entry["mesh"] = xs
            ps = prefix_summary(metrics)
            if ps is not None:
                entry["prefix"] = ps
            ts = tenant_summary(metrics)
            if ts is not None:
                entry["tenants"] = ts
            cs = class_summary(metrics)
            if cs is not None:
                entry["classes"] = cs
            rj = rejection_summary(metrics)
            if rj is not None:
                entry["rejections"] = rj
            components.append(entry)
        merged = self.merged()
        out: dict[str, Any] = {
            "at": now,
            "components": components,
            "fleet": {"latency": latency_summary(merged),
                      "metrics": flatten(merged)},
        }
        fleet_gp = goodput_summary(merged)
        if fleet_gp is not None:
            if fleet_tok_s:
                fleet_gp["goodput_tok_s"] = round(fleet_tok_s, 2)
            out["fleet"]["goodput"] = fleet_gp
        fleet_rs = router_summary(merged)
        if fleet_rs is not None:
            out["fleet"]["router"] = fleet_rs
        fleet_kv = kv_summary(merged)
        if fleet_kv is not None:
            out["fleet"]["kv"] = fleet_kv
        fleet_mem = memory_summary(merged)
        if fleet_mem is not None:
            out["fleet"]["memory"] = fleet_mem
        fleet_mesh = mesh_summary(merged)
        if fleet_mesh is not None:
            out["fleet"]["mesh"] = fleet_mesh
        fleet_pfx = prefix_summary(merged)
        if fleet_pfx is not None:
            out["fleet"]["prefix"] = fleet_pfx
        fleet_ten = tenant_summary(merged)
        if fleet_ten is not None:
            out["fleet"]["tenants"] = fleet_ten
        fleet_cls = class_summary(merged)
        if fleet_cls is not None:
            out["fleet"]["classes"] = fleet_cls
        fleet_rej = rejection_summary(merged)
        if fleet_rej is not None:
            out["fleet"]["rejections"] = fleet_rej
        if slo is not None:
            out["slo"] = slo.status()
        if control is not None:
            c = control() if callable(control) else control
            if c is not None:
                out["control"] = c
        if brownout is not None:
            b = brownout() if callable(brownout) else brownout
            if b is not None:
                out["brownout"] = b
        return out

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        if self._sub is not None:
            self._sub.cancel()
            self._sub = None
