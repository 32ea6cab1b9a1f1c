"""Prometheus-style metrics for the serving-class plane.

Fixed ``dynamo_*`` names, per-class "class" labels — same fleet-wide
aggregation contract as `EngineMetrics`/`TenantMetrics`. One instance
per frontend process, registered into the shared `MetricsRegistry`.

Port of `dynamo_tpu/serving_classes/metrics.py`: the same decisions,
records and payloads, on the port's own modules (no jax, no `dynamo_tpu`
import).
"""

from __future__ import annotations

from dynamo_tpu_torch.runtime.metrics import Counter, Gauge

ADMITTED_COUNTER = "dynamo_class_admitted_total"
SHED_COUNTER = "dynamo_class_shed_total"
DOWNGRADED_COUNTER = "dynamo_class_downgraded_total"
DEADLINE_REJECT_COUNTER = "dynamo_class_deadline_rejected_total"
REJECTIONS_COUNTER = "dynamo_http_rejections_total"
BROWNOUT_STATE_GAUGE = "dynamo_brownout_state"
BROWNOUT_ACTIONS_COUNTER = "dynamo_brownout_actions_total"


class ClassMetrics:
    """Counters the HTTP gate and brownout machine mutate."""

    def __init__(self) -> None:
        self.admitted = Counter(
            ADMITTED_COUNTER,
            "Requests admitted past the class gate, by class")
        self.shed = Counter(
            SHED_COUNTER,
            "Requests shed by brownout or deadline admission, by class")
        self.downgraded = Counter(
            DOWNGRADED_COUNTER,
            "Requests downgraded to a cheaper class, by class (original)")
        self.deadline_rejected = Counter(
            DEADLINE_REJECT_COUNTER,
            "Requests rejected as deadline-infeasible, by class")
        # the satellite fix: 429/503 rejections visible in the fleet
        # picture next to served load, labelled {reason, class}
        self.rejections = Counter(
            REJECTIONS_COUNTER,
            "HTTP-level rejections (429/503) by reason and class")
        self.brownout_state = Gauge(
            BROWNOUT_STATE_GAUGE,
            "Current brownout stage (0=ok .. 3=shrink_spec)")
        self.brownout_actions = Counter(
            BROWNOUT_ACTIONS_COUNTER,
            "Brownout stage transitions, by target stage")

    def register(self, registry) -> None:
        for metric in (self.admitted, self.shed, self.downgraded,
                       self.deadline_rejected, self.rejections,
                       self.brownout_state, self.brownout_actions):
            registry.register(metric)

    def on_admitted(self, cls_name: str) -> None:
        self.admitted.inc(**{"class": cls_name})

    def on_shed(self, cls_name: str, reason: str) -> None:
        self.shed.inc(**{"class": cls_name})
        self.rejections.inc(reason=reason, **{"class": cls_name})

    def on_downgraded(self, cls_name: str) -> None:
        self.downgraded.inc(**{"class": cls_name})

    def on_deadline_rejected(self, cls_name: str) -> None:
        self.deadline_rejected.inc(**{"class": cls_name})
        self.rejections.inc(reason="deadline", **{"class": cls_name})

    def on_rejected(self, reason: str, cls_name: str = "") -> None:
        """Generic 429/503 accounting (e.g. the tenant quota gate)."""
        self.rejections.inc(reason=reason,
                            **{"class": cls_name or "unknown"})

    def payload(self) -> dict:
        """Live counter view for /debug/classes and the fleet status."""
        def by_class(counter) -> dict:
            return {labels.get("class", ""): int(v)
                    for labels, v in counter.items()}
        return {
            "admitted": by_class(self.admitted),
            "shed": by_class(self.shed),
            "downgraded": by_class(self.downgraded),
            "deadline_rejected": by_class(self.deadline_rejected),
            "rejections": [
                {**labels, "count": int(v)}
                for labels, v in sorted(
                    self.rejections.items(),
                    key=lambda kv: (kv[0].get("reason", ""),
                                    kv[0].get("class", "")))],
        }
