"""SLO burn-rate monitor: rolling latency windows vs. objectives.

Port of `dynamo_tpu/runtime/slo.py` (the port keeps its own copy).

SRE-style multi-window multi-burn-rate alerting (Google SRE workbook ch.
5): an objective says "target_ratio of requests must beat threshold";
the burn rate is ``bad_ratio / (1 - target_ratio)`` — 1.0 burns the
error budget exactly at the sustainable rate, 14.4 exhausts a 30-day
budget in ~2 days. Paging on ONE window is noisy (short) or slow to
clear (long), so a breach requires both the fast and the slow window
over their thresholds; the fast window alone flags an emerging burn.

The monitor is fed inline from the frontend's TTFT/ITL observation
points (seconds), evaluated periodically, and publishes state
transitions on the ``slo_events`` event-plane subject; live burn rates
export as ``dynamo_slo_burn_rate{objective,window}`` gauges.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from dynamo_tpu_torch.runtime.metrics import Counter, Gauge, MetricsRegistry

# Event-plane subject for SLO state transitions.
SLO_EVENTS_SUBJECT = "slo_events"

# state ordering for display only: ok < slow_burn < fast_burn < breach
STATES = ("ok", "slow_burn", "fast_burn", "breach")


@dataclass
class SloObjective:
    """target_ratio of samples must land at or under threshold seconds."""
    name: str                    # "ttft" / "itl"
    threshold: float             # seconds
    target_ratio: float = 0.99


@dataclass
class _Track:
    objective: SloObjective
    samples: deque = field(default_factory=deque)  # (t, value) pairs
    state: str = "ok"
    fast_burn: float = 0.0
    slow_burn: float = 0.0


class SloMonitor:
    """Bounded rolling windows per objective + burn-rate evaluation.

    `observe()` runs on the serving path, so it is O(1) append plus a
    bounded trim; all window math happens in `evaluate()`, which the
    frontend calls from a low-rate periodic task."""

    def __init__(self, objectives: list[SloObjective],
                 fast_window: float = 60.0, slow_window: float = 600.0,
                 fast_burn: float = 14.4, slow_burn: float = 6.0,
                 clock: Callable[[], float] = time.monotonic,
                 max_samples: int = 8192) -> None:
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.fast_threshold = fast_burn
        self.slow_threshold = slow_burn
        self._clock = clock
        self.max_samples = max_samples
        self._tracks = {o.name: _Track(o) for o in objectives}
        self.burn_gauge = Gauge(
            "dynamo_slo_burn_rate",
            "error-budget burn rate by objective and window")
        self.transitions_total = Counter(
            "dynamo_slo_transitions_total",
            "SLO state transitions by objective and target state")

    def register(self, registry: MetricsRegistry) -> None:
        registry.register(self.burn_gauge)
        registry.register(self.transitions_total)

    def observe(self, name: str, value: float) -> None:
        tr = self._tracks.get(name)
        if tr is None:
            return
        tr.samples.append((self._clock(), value))
        while len(tr.samples) > self.max_samples:
            tr.samples.popleft()

    def _burn(self, tr: _Track, width: float, now: float) -> float:
        cutoff = now - width
        total = bad = 0
        for t, v in tr.samples:
            if t < cutoff:
                continue
            total += 1
            if v > tr.objective.threshold:
                bad += 1
        if total == 0:
            return 0.0
        budget = 1.0 - tr.objective.target_ratio
        if budget <= 0:
            return float("inf") if bad else 0.0
        return (bad / total) / budget

    def evaluate(self) -> list[dict]:
        """Recompute burn rates, update gauges, and return one event per
        objective whose state changed since the last evaluation."""
        now = self._clock()
        events: list[dict] = []
        for name, tr in self._tracks.items():
            cutoff = now - self.slow_window
            while tr.samples and tr.samples[0][0] < cutoff:
                tr.samples.popleft()
            tr.fast_burn = self._burn(tr, self.fast_window, now)
            tr.slow_burn = self._burn(tr, self.slow_window, now)
            fast_hot = tr.fast_burn >= self.fast_threshold
            slow_hot = tr.slow_burn >= self.slow_threshold
            if fast_hot and slow_hot:
                new = "breach"
            elif fast_hot:
                new = "fast_burn"
            elif slow_hot:
                new = "slow_burn"
            else:
                new = "ok"
            self.burn_gauge.set(tr.fast_burn, objective=name, window="fast")
            self.burn_gauge.set(tr.slow_burn, objective=name, window="slow")
            if new != tr.state:
                self.transitions_total.inc(objective=name, to=new)
                events.append({"objective": name, "from": tr.state,
                               "to": new, "at": time.time(),
                               "fast_burn": round(tr.fast_burn, 4),
                               "slow_burn": round(tr.slow_burn, 4),
                               "threshold_s": tr.objective.threshold})
                tr.state = new
        return events

    def status(self) -> dict:
        """Live per-objective view for /fleet/status and doctor fleet."""
        out = {}
        for name, tr in self._tracks.items():
            values = sorted(v for _t, v in tr.samples)
            pct = {}
            for q in (0.5, 0.9, 0.99):
                pct[f"p{int(q * 100)}"] = (
                    values[min(len(values) - 1, int(q * len(values)))]
                    if values else 0.0)
            out[name] = {"state": tr.state,
                         "threshold_s": tr.objective.threshold,
                         "target_ratio": tr.objective.target_ratio,
                         "fast_burn": round(tr.fast_burn, 4),
                         "slow_burn": round(tr.slow_burn, 4),
                         "samples": len(tr.samples),
                         "window": pct}
        return out
