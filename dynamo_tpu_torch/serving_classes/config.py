"""Service classes: the request-priority plane (docs/robustness.md).

One fleet, three kinds of traffic: ``interactive`` (a human is watching
the tokens arrive), ``standard`` (API calls with normal latency
expectations), and ``batch`` (offline work that tolerates minutes).
A `ServiceClass` names one of these tiers and carries its latency
objectives, its fair-share weight multiplier, its implicit per-request
deadline, and its position in the brownout shed ladder.

Identity is resolved at the HTTP frontend from the ``x-dyn-class``
header, falling back to the tenant's `default_class` (TenancyConfig)
and then the config default — then rides ``Context.headers`` across
every transport hop exactly like the tenant header, so the engines'
fair scheduler and every recorder attribute by the same class name.

Off-by-default contract: `classes_from_env()` returns None unless
`DYN_CLASSES` is set (a truthy preset, a JSON file path, or inline
JSON), and every integration point guards on that None — a classless
fleet runs the legacy serving path byte-identical (pinned by
tests/test_serving_classes.py).

Port of `dynamo_tpu/serving_classes/config.py`: the same decisions,
records and payloads, on the port's own modules (no jax, no `dynamo_tpu`
import).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Mapping, Optional

# the class header: set by clients (or injected by the frontend after
# tenant-default resolution) and propagated verbatim by the transport
CLASS_HEADER = "x-dyn-class"

# class applied to traffic that presents no identity
DEFAULT_CLASS = "standard"

_TRUTHY = {"1", "true", "yes", "on", "default", "preset"}


@dataclass(frozen=True)
class ServiceClass:
    """One service tier. Zero values mean "none" for every knob so a
    class can be named purely for attribution."""

    name: str
    weight: float = 1.0           # fair-share multiplier on tenant weight
    ttft_objective_s: float = 0.0  # per-class SLO threshold; 0 = none
    itl_objective_s: float = 0.0   # per-class SLO threshold; 0 = none
    deadline_s: float = 0.0        # implicit per-request deadline; 0 = none
    # brownout shed ladder position: stage >= shed_stage sheds new
    # requests of this class; 0 = never shed
    shed_stage: int = 0
    # brownout max_tokens cap: stage >= cap_stage caps new streams of
    # this class to cap_tokens; 0 = never capped
    cap_stage: int = 0
    cap_tokens: int = 0
    # deadline-infeasible requests downgrade here instead of 503; "" =
    # reject outright
    downgrade_to: str = ""

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("service class name must be non-empty")
        if self.weight <= 0:
            raise ValueError(
                f"class {self.name!r}: weight must be > 0")
        if self.deadline_s < 0 or self.ttft_objective_s < 0 \
                or self.itl_objective_s < 0:
            raise ValueError(
                f"class {self.name!r}: negative latency value")


def default_classes() -> dict[str, ServiceClass]:
    """The built-in three-tier preset (DYN_CLASSES=1). Numbers follow
    the shed ladder in docs/robustness.md: batch sheds at stage 1,
    standard streams are token-capped at stage 2, and interactive is
    never shed — stage 3 buys it headroom by shrinking spec-decode."""
    return {
        "interactive": ServiceClass(
            "interactive", weight=4.0, ttft_objective_s=0.5,
            itl_objective_s=0.1),
        "standard": ServiceClass(
            "standard", weight=2.0, ttft_objective_s=2.0,
            cap_stage=2, cap_tokens=32, downgrade_to="batch"),
        "batch": ServiceClass(
            "batch", weight=1.0, shed_stage=1),
    }


@dataclass
class ServingClassesConfig:
    """The resolved class table plus identity-resolution rules."""

    classes: dict[str, ServiceClass] = field(default_factory=dict)
    default_class: str = DEFAULT_CLASS
    # arm the brownout state machine on this config (individual stages
    # are still driven by live SLO transitions)
    brownout: bool = True
    # brownout hysteresis (seconds): minimum hold between stage changes
    # and clean time required before walking one stage back
    brownout_hold_s: float = 5.0
    brownout_recover_s: float = 15.0
    # deadline-admission estimator quantile over the engines' live
    # queue-wait/ttft histograms (docs/robustness.md formula)
    admission_quantile: float = 0.9

    def __post_init__(self) -> None:
        if not self.classes:
            self.classes = default_classes()
        if self.default_class not in self.classes:
            raise ValueError(
                f"default_class {self.default_class!r} not in classes")

    def get(self, name: Optional[str]) -> ServiceClass:
        """Class record for a name; unknown names resolve to the default
        class (a client-invented header gets no special treatment, and
        the engines never KeyError)."""
        if name and name in self.classes:
            return self.classes[name]
        return self.classes[self.default_class]

    def resolve(self, header: Optional[str],
                tenant=None) -> ServiceClass:
        """Frontend resolution precedence: explicit header first, then
        the tenant's default_class, then the config default."""
        if header:
            return self.get(header.strip())
        tenant_default = getattr(tenant, "default_class", "")
        if tenant_default:
            return self.get(tenant_default)
        return self.classes[self.default_class]

    def class_of(self, headers: Optional[Mapping]) -> str:
        """Engine-side identity: the propagated header value (stamped by
        the frontend after resolution), or the config default."""
        name = (headers or {}).get(CLASS_HEADER)
        if name and str(name) in self.classes:
            return str(name)
        return self.default_class

    def payload(self) -> dict:
        """Config view for /debug/classes."""
        return {name: {
            "weight": c.weight,
            "ttft_objective_s": c.ttft_objective_s,
            "itl_objective_s": c.itl_objective_s,
            "deadline_s": c.deadline_s,
            "shed_stage": c.shed_stage,
            "cap_stage": c.cap_stage,
            "cap_tokens": c.cap_tokens,
            "downgrade_to": c.downgrade_to,
        } for name, c in sorted(self.classes.items())}


def parse_classes(obj: dict) -> ServingClassesConfig:
    """Parse the DYN_CLASSES document:

    {"classes": [{"name": "interactive", "weight": 4,
                  "ttft_objective_s": 0.5, "deadline_s": 2.0}, ...],
     "default_class": "standard", "brownout": true,
     "brownout_hold_s": 5, "brownout_recover_s": 15}

    An empty/missing "classes" list keeps the built-in three-tier
    preset so DYN_CLASSES='{"brownout": false}' tunes one knob without
    restating the table.
    """
    if not isinstance(obj, dict):
        raise ValueError("classes config must be a JSON object")
    raw = obj.get("classes") or []
    if not isinstance(raw, list):
        raise ValueError("'classes' must be a list")
    classes: dict[str, ServiceClass] = {}
    for entry in raw:
        if not isinstance(entry, dict) or "name" not in entry:
            raise ValueError(f"bad class entry {entry!r}")
        c = ServiceClass(
            name=str(entry["name"]),
            weight=float(entry.get("weight", 1.0)),
            ttft_objective_s=float(entry.get("ttft_objective_s", 0.0)),
            itl_objective_s=float(entry.get("itl_objective_s", 0.0)),
            deadline_s=float(entry.get("deadline_s", 0.0)),
            shed_stage=int(entry.get("shed_stage", 0)),
            cap_stage=int(entry.get("cap_stage", 0)),
            cap_tokens=int(entry.get("cap_tokens", 0)),
            downgrade_to=str(entry.get("downgrade_to", "")),
        )
        if c.name in classes:
            raise ValueError(f"duplicate class {c.name!r}")
        classes[c.name] = c
    cfg = ServingClassesConfig(
        classes=classes,
        default_class=str(obj.get("default_class", DEFAULT_CLASS)),
        brownout=bool(obj.get("brownout", True)),
        brownout_hold_s=float(obj.get("brownout_hold_s", 5.0)),
        brownout_recover_s=float(obj.get("brownout_recover_s", 15.0)),
        admission_quantile=float(obj.get("admission_quantile", 0.9)),
    )
    for c in cfg.classes.values():
        if c.downgrade_to and c.downgrade_to not in cfg.classes:
            raise ValueError(
                f"class {c.name!r} downgrades to unknown class "
                f"{c.downgrade_to!r}")
    return cfg


def classes_from_env(env: Optional[Mapping] = None
                     ) -> Optional[ServingClassesConfig]:
    """None unless DYN_CLASSES is set — the off-by-default gate every
    integration point checks once. The value is a truthy preset token
    (``1``/``default`` arms the built-in three tiers), inline JSON
    (starts with '{'), or a path to a JSON file."""
    val = (env or os.environ).get("DYN_CLASSES", "").strip()
    if not val:
        return None
    if val.lower() in _TRUTHY:
        return ServingClassesConfig()
    if val.startswith("{"):
        doc = json.loads(val)
    else:
        with open(val, encoding="utf-8") as f:
            doc = json.load(f)
    return parse_classes(doc)
