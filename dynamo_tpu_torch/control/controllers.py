"""The four flight controllers (docs/flight_control.md).

Each controller is a small feedback loop: it reads evidence that the
flight recorders / always-on metrics already collect, compares a
windowed view against thresholds, and nudges exactly one family of
knobs by a bounded step — emitting an action record (knob, before,
after, reason, evidence) for every change so `doctor control` can
explain it.  Controllers never read the wall clock (the tick timestamp
is injected) and never allocate state on the serving path: all
per-engine/per-router bookkeeping lives here, keyed by a stable label.

Safety model shared by all four:

- bounded step per tick, with hard caps/floors per knob;
- windowed evidence with a minimum sample count before acting;
- rollback: when the pressure signal stays clean, knobs decay back
  toward their captured base value instead of ratcheting forever;
- a controller that sees no evidence emits no actions (never a
  "default" action).

Port of `dynamo_tpu/control/controllers.py`: the same decisions, records
and payloads, on the port's own modules (no jax, no `dynamo_tpu`
import).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from dynamo_tpu_torch.engine.bucketing import BucketLadder


def _label(obj, i: int, prefix: str) -> str:
    wid = getattr(getattr(obj, "config", None), "worker_id", None)
    return f"w{wid}" if wid is not None else f"{prefix}{i}"


def _dims(shape_label: str) -> tuple[int, ...] | None:
    try:
        return tuple(int(p) for p in str(shape_label).split("x"))
    except (TypeError, ValueError):
        return None


# ---------------------------------------------------------------------------
# (a) bucket autotuner


@dataclass
class BucketTunerConfig:
    min_count: int = 8            # dispatches before a shape is evidence
    min_padded_pct: float = 25.0  # padding share worth a new rung
    max_rungs: int = 8
    max_changes_per_tick: int = 2  # churn bound: recompiles stay amortized
    prefill_align: int = 16        # page-size-aligned rungs work everywhere


class BucketAutotuner:
    """Insert bucket rungs where the step profiler shows padding burn.

    Evidence: `StepRecorder.summary()["shapes"]` — the ring-window
    padded-token attribution per (entry, shape).  A prefill shape
    ``1xB`` whose mean goodput sits far below B earns a rung at the
    aligned mean; a decode shape ``Wx1`` likewise on the width axis.
    Actuation: `BucketLadder.propose()` — the scheduler adopts it at the
    next safe point between dispatches.  Once a rung lands, new
    dispatches use the tighter shape, the old row decays out of the
    ring, and the proposal naturally stops recurring.

    Engines running the ragged attention path (`eng.ragged_active`) are
    skipped: the flat-token entry buckets on total tokens alone, so the
    padding this ladder tunes no longer exists. The handoff is announced
    ONCE per engine as an explainable `control_events` action instead of
    silently going quiet.
    """

    name = "bucket"

    def __init__(self, engines, config: BucketTunerConfig | None = None):
        self._engines = engines        # zero-arg supplier -> iterable
        self.config = config or BucketTunerConfig()
        self._order: dict[str, list[int]] = {}   # rung FIFO per engine
        self._last: dict[str, dict] = {}         # last action per engine
        self._handoff: set[str] = set()          # ragged handoff announced

    def _proposals(self, shapes: list[dict]) -> list[tuple[float, int, dict]]:
        cfg = self.config
        out = []
        for row in shapes:
            if row.get("count", 0) < cfg.min_count:
                continue
            if row.get("padded_pct", 0.0) < cfg.min_padded_pct:
                continue
            dims = _dims(row.get("shape", ""))
            if not dims or len(dims) != 2:
                continue
            entry = str(row.get("entry", ""))
            if "decode" in entry and dims[1] == 1:
                size, align = dims[0], 1
            elif ("prefill" in entry or "mixed" in entry) and dims[0] == 1:
                size, align = dims[1], cfg.prefill_align
            else:
                continue
            mean_good = row["good_tokens"] / max(row["count"], 1)
            rung = int(math.ceil(mean_good / align)) * align
            if rung <= 0 or rung >= size:
                continue  # no tighter aligned shape exists below this bucket
            out.append((float(row.get("padded_tokens", 0)), rung, row))
        # worst padding burn first; rung breaks ties deterministically
        out.sort(key=lambda t: (-t[0], t[1]))
        return out

    def tick(self, now) -> list[dict]:
        cfg = self.config
        actions = []
        for i, eng in enumerate(self._engines() or []):
            rec = getattr(eng, "step_recorder", None)
            if rec is None:
                continue
            label = _label(eng, i, "e")
            if getattr(eng, "ragged_active", False):
                if label not in self._handoff:
                    self._handoff.add(label)
                    prev = getattr(eng, "bucket_ladder", None)
                    action = {
                        "knob": f"bucket_ladder/{label}",
                        "from": sorted(prev.rungs) if prev else [],
                        "to": "retired",
                        "reason": ("ragged attention active: the "
                                   "flat-token entry buckets on total "
                                   "tokens, deleting the padding this "
                                   "ladder tunes"),
                        "evidence": {"ragged_active": True},
                    }
                    self._last[label] = action
                    actions.append(action)
                continue
            ladder = getattr(eng, "bucket_ladder", None)
            if ladder is None:
                ladder = BucketLadder(max_rungs=cfg.max_rungs)
                eng.bucket_ladder = ladder
            proposals = self._proposals(rec.summary().get("shapes") or [])
            if not proposals:
                continue
            order = self._order.setdefault(label, list(ladder.rungs))
            added, evidence = [], []
            for padded, rung, row in proposals:
                if len(added) >= cfg.max_changes_per_tick:
                    break
                if rung in order or rung in added:
                    continue
                added.append(rung)
                evidence.append({k: row.get(k) for k in
                                 ("entry", "shape", "count", "good_tokens",
                                  "padded_tokens", "padded_pct")})
            if not added:
                continue
            before = sorted(order)
            order.extend(added)
            while len(order) > cfg.max_rungs:   # evict oldest rungs first
                order.pop(0)
            if not ladder.propose(order):
                continue
            action = {
                "knob": f"bucket_ladder/{label}",
                "from": before,
                "to": sorted(order),
                "reason": f"padded_pct >= {cfg.min_padded_pct:g} on "
                          f"{len(evidence)} shape(s): add rung(s) "
                          f"{sorted(added)}",
                "evidence": {"shapes": evidence},
            }
            self._last[label] = action
            actions.append(action)
        return actions

    def state(self) -> dict:
        out = {"engines": {}}
        for i, eng in enumerate(self._engines() or []):
            ladder = getattr(eng, "bucket_ladder", None)
            if ladder is None:
                continue
            label = _label(eng, i, "e")
            st = ladder.state()
            last = self._last.get(label)
            if last is not None:
                st["last_reason"] = last["reason"]
            out["engines"][label] = st
        return out


# ---------------------------------------------------------------------------
# (b) KVBM tuner


@dataclass
class KvbmTunerConfig:
    premature_hi_pct: float = 1.0   # premature evictions per 100 allocs
    min_window_allocs: int = 16
    clean_ticks_for_rollback: int = 3
    prefetch_max: int = 8
    queue_step: int = 8
    queue_max: int = 256
    watermark_step: float = 0.01
    watermark_min: float = 0.80


class KvbmTuner:
    """Relieve KV-cache pressure when evictions outrun reuse.

    Evidence: the lifecycle recorder's premature-eviction rate (blocks
    evicted then re-allocated within the reuse window) and reuse
    profile, windowed between ticks.  Under pressure it lowers the
    admission watermark (admit less, evict less), deepens prefetch, and
    widens the offload queue (only when the async pipeline is already
    on — it never flips a synchronous deployment to async).  After
    `clean_ticks_for_rollback` clean windows it walks each knob one
    step back toward its captured base.
    """

    name = "kvbm"

    def __init__(self, engines, config: KvbmTunerConfig | None = None):
        self._engines = engines
        self.config = config or KvbmTunerConfig()
        self._st: dict[str, dict] = {}

    def _targets(self, eng):
        """(watermark holder, kvbm config) — either may be None."""
        ecfg = getattr(eng, "config", None)
        wm = ecfg if ecfg is not None and hasattr(ecfg, "watermark") else None
        kvbm = getattr(eng, "kvbm", None)
        return wm, getattr(kvbm, "config", None)

    def tick(self, now) -> list[dict]:
        cfg = self.config
        actions = []
        for i, eng in enumerate(self._engines() or []):
            rec = getattr(eng, "kv_lifecycle", None)
            if rec is None:
                continue
            label = _label(eng, i, "e")
            s = rec.summary()
            allocs, prem = s["allocations"], s["premature_evictions"]
            st = self._st.setdefault(label, {"allocs": allocs, "prem": prem,
                                             "clean": 0, "base": {}})
            allocs_d = allocs - st["allocs"]
            prem_d = prem - st["prem"]
            st["allocs"], st["prem"] = allocs, prem
            if allocs_d < cfg.min_window_allocs:
                continue  # idle window: neither pressure nor rollback
            prem_pct = 100.0 * prem_d / allocs_d
            reuse = s.get("reuse_distance") or {}
            evidence = {"window": {
                "allocations": allocs_d, "premature": prem_d,
                "premature_pct": round(prem_pct, 3),
                "reuse_samples": reuse.get("samples", 0),
                "reuse_p90": reuse.get("p90"),
            }}
            st["window"] = evidence["window"]
            wm_cfg, kv_cfg = self._targets(eng)

            def act(knob, holder, attr, new, reason):
                cur = getattr(holder, attr)
                if new == cur:
                    return
                st["base"].setdefault(attr, cur)
                setattr(holder, attr, new)
                actions.append({"knob": f"{knob}/{label}", "from": cur,
                                "to": new, "reason": reason,
                                "evidence": evidence})

            if prem_pct > cfg.premature_hi_pct:
                st["clean"] = 0
                why = (f"premature evictions {prem_pct:.2f}% of "
                       f"{allocs_d} allocs (> {cfg.premature_hi_pct:g}%)")
                if wm_cfg is not None:
                    act("watermark", wm_cfg, "watermark",
                        round(max(cfg.watermark_min,
                                  wm_cfg.watermark - cfg.watermark_step), 4),
                        why)
                if kv_cfg is not None and reuse.get("samples", 0) > 0:
                    act("prefetch_blocks", kv_cfg, "prefetch_blocks",
                        min(cfg.prefetch_max, kv_cfg.prefetch_blocks + 1),
                        why + "; reuse present, staging deeper prefetch")
                if kv_cfg is not None and kv_cfg.offload_queue_depth > 0:
                    act("offload_queue_depth", kv_cfg, "offload_queue_depth",
                        min(cfg.queue_max,
                            kv_cfg.offload_queue_depth + cfg.queue_step),
                        why + "; widening the offload pipeline")
            elif prem_pct <= cfg.premature_hi_pct / 2:
                st["clean"] += 1
                if st["clean"] >= cfg.clean_ticks_for_rollback and st["base"]:
                    why = (f"{st['clean']} clean windows "
                           f"(premature {prem_pct:.2f}%): stepping back "
                           f"toward base")
                    if wm_cfg is not None and "watermark" in st["base"]:
                        base = st["base"]["watermark"]
                        if wm_cfg.watermark < base:
                            act("watermark", wm_cfg, "watermark",
                                round(min(base, wm_cfg.watermark
                                          + cfg.watermark_step), 4), why)
                    if kv_cfg is not None and "prefetch_blocks" in st["base"]:
                        base = st["base"]["prefetch_blocks"]
                        if kv_cfg.prefetch_blocks > base:
                            act("prefetch_blocks", kv_cfg, "prefetch_blocks",
                                max(base, kv_cfg.prefetch_blocks - 1), why)
                    st["clean"] = 0
        return actions

    def state(self) -> dict:
        out = {"engines": {}}
        for label, st in self._st.items():
            out["engines"][label] = {
                "clean_ticks": st["clean"],
                "base": dict(st["base"]),
                "window": st.get("window"),
            }
        return out


# ---------------------------------------------------------------------------
# (c) router tuner


@dataclass
class RouterTunerConfig:
    min_window_decisions: int = 16
    close_call_hi: float = 0.35   # share of margins <= 1.0 block
    close_call_lo: float = 0.10
    temp_step: float = 0.05
    temp_max: float = 1.0
    temp_floor: float = 0.01      # below this, snap back to argmax (0.0)
    load_err_hi: float = 0.5      # mean |predicted - actual| load, blocks
    load_err_lo: float = 0.1
    overlap_factor: float = 1.1
    overlap_max: float = 4.0


class RouterTuner:
    """Tune overlap weight / temperature from always-on router metrics.

    Evidence: windowed deltas of the `dynamo_router_logit_margin_blocks`
    and `dynamo_router_load_prediction_error` histograms (always on —
    no DYN_ROUTER_LOG needed).  Many close calls mean the scorer can't
    separate candidates → raise temperature so ties don't herd onto one
    worker; decisive margins decay it back to argmax.  Large load-
    prediction error means the load term is misweighted → grow
    overlap_weight (trust observed cache overlap more); small error
    decays it toward its base.  Both the selector's live config and the
    router's display config are updated; the RNG draw order is never
    touched, so seeded selections stay comparable.
    """

    name = "router"

    def __init__(self, routers, config: RouterTunerConfig | None = None):
        self._routers = routers      # zero-arg supplier -> iterable/mapping
        self.config = config or RouterTunerConfig()
        self._st: dict[str, dict] = {}

    def _iter_routers(self):
        routers = self._routers() or []
        if isinstance(routers, dict):
            routers = [(k, v) for k, v in sorted(routers.items())]
        else:
            routers = list(enumerate(routers))
        for key, obj in routers:
            r = getattr(obj, "router", obj)   # unwrap KvPushRouter
            if getattr(r, "selector", None) is None or \
                    getattr(r, "metrics", None) is None:
                continue
            yield str(key), r

    def tick(self, now) -> list[dict]:
        cfg = self.config
        actions = []
        for label, r in self._iter_routers():
            m = r.metrics
            mcounts, _, mtotal = m.logit_margin.snapshot()
            close = sum(mcounts[i] for i, ub in
                        enumerate(m.logit_margin.buckets) if ub <= 1.0)
            lcounts, lsum, ltotal = m.load_error.snapshot()
            st = self._st.setdefault(label, {
                "mtotal": mtotal, "close": close,
                "lsum": lsum, "ltotal": ltotal,
                "base_overlap": r.config.overlap_weight,
            })
            dm = mtotal - st["mtotal"]
            dclose = close - st["close"]
            dlsum = lsum - st["lsum"]
            dltotal = ltotal - st["ltotal"]
            st.update(mtotal=mtotal, close=close, lsum=lsum, ltotal=ltotal)
            if dm < cfg.min_window_decisions:
                continue
            close_share = dclose / dm
            err_mean = dlsum / dltotal if dltotal > 0 else None
            evidence = {"window": {
                "decisions": dm, "close_calls": dclose,
                "close_call_share": round(close_share, 4),
                "load_error_samples": dltotal,
                "load_error_mean": round(err_mean, 4)
                                   if err_mean is not None else None,
            }}
            st["window"] = evidence["window"]

            def act(knob, new, reason):
                cur = getattr(r.config, knob)
                if new == cur:
                    return
                # the selector decides with its own config copy; the
                # router's config is what /debug/router displays — both
                # must move together
                setattr(r.selector.config, knob, new)
                setattr(r.config, knob, new)
                actions.append({"knob": f"{knob}/{label}", "from": cur,
                                "to": new, "reason": reason,
                                "evidence": evidence})

            temp = r.config.temperature
            if close_share > cfg.close_call_hi:
                act("temperature",
                    round(min(cfg.temp_max, temp + cfg.temp_step), 4),
                    f"close-call share {close_share:.2f} > "
                    f"{cfg.close_call_hi:g}: spread near-tied placements")
            elif close_share < cfg.close_call_lo and temp > 0.0:
                new = temp / 2.0
                act("temperature",
                    0.0 if new < cfg.temp_floor else round(new, 4),
                    f"close-call share {close_share:.2f} < "
                    f"{cfg.close_call_lo:g}: decay toward argmax")

            if err_mean is not None:
                ow = r.config.overlap_weight
                if err_mean > cfg.load_err_hi:
                    act("overlap_weight",
                        round(min(cfg.overlap_max,
                                  ow * cfg.overlap_factor), 4),
                        f"load-prediction error {err_mean:.2f} blocks > "
                        f"{cfg.load_err_hi:g}: weight observed overlap "
                        f"over predicted load")
                elif err_mean < cfg.load_err_lo and \
                        ow > st["base_overlap"]:
                    act("overlap_weight",
                        round(max(st["base_overlap"], ow * 0.95), 4),
                        f"load-prediction error {err_mean:.2f} blocks < "
                        f"{cfg.load_err_lo:g}: decay toward base "
                        f"{st['base_overlap']:g}")
        return actions

    def state(self) -> dict:
        out = {"routers": {}}
        for label, r in self._iter_routers():
            st = self._st.get(label, {})
            out["routers"][label] = {
                "overlap_weight": r.config.overlap_weight,
                "temperature": r.config.temperature,
                "base_overlap": st.get("base_overlap"),
                "window": st.get("window"),
            }
        return out


# ---------------------------------------------------------------------------
# (d) scale-aware forecasting


class ScaleAwareForecast:
    """Keep self-inflicted capacity changes out of the load forecast.

    When the supervisor scales the fleet, per-interval frontend metrics
    swing (drains, warmup, re-routing) for reasons that have nothing to
    do with demand.  This controller watches the supervisor's
    scale-event log; on new events it arms a hold of
    ``hold_intervals`` planner observations during which the planner's
    ``observation_guard`` feeds the predictors the last pre-scale
    ``num_req`` instead of the transient one (ISL/OSL pass through —
    length mix is demand-shaped, not capacity-shaped).  The hold is
    counted in observations, not seconds, so it is clock-free and
    deterministic.
    """

    name = "forecast"

    def __init__(self, planner, scale_events, hold_intervals: int = 2):
        self.planner = planner
        self._events = scale_events    # zero-arg supplier -> list[dict]
        self.hold_intervals = hold_intervals
        self._cursor = 0
        self._hold_left = 0
        self._held = 0
        self._last_clean = None        # last num_req observed outside a hold
        planner.observation_guard = self._guard

    def _guard(self, m):
        if self._hold_left > 0 and self._last_clean is not None:
            self._hold_left -= 1
            self._held += 1
            return replace(m, num_req=self._last_clean)
        if not math.isnan(m.num_req):
            self._last_clean = m.num_req
        return None

    def tick(self, now) -> list[dict]:
        events = list(self._events() or [])
        new = events[self._cursor:]
        self._cursor = len(events)
        if not new:
            return []
        before, self._hold_left = self._hold_left, self.hold_intervals
        return [{
            "knob": "forecast_hold",
            "from": before,
            "to": self._hold_left,
            "reason": f"{len(new)} scale event(s): capacity change is "
                      f"self-inflicted, holding num_req forecast input for "
                      f"{self.hold_intervals} observation(s)",
            "evidence": {"scale_events": new[-8:]},
        }]

    def state(self) -> dict:
        return {
            "hold_left": self._hold_left,
            "held_observations": self._held,
            "events_seen": self._cursor,
            "last_clean_num_req": self._last_clean,
        }
