"""Serving classes: priority tiers, deadline-aware admission, brownout.

See docs/robustness.md "Serving classes & brownout". Armed via the
``DYN_CLASSES`` env knob; a classless fleet runs the legacy serving
path byte-identical.

Port of `dynamo_tpu/serving_classes/__init__.py`: the same decisions,
records and payloads, on the port's own modules (no jax, no `dynamo_tpu`
import).
"""

from dynamo_tpu_torch.serving_classes.admission import (
    AdmissionEstimator,
    estimate_ttft_s,
)
from dynamo_tpu_torch.serving_classes.brownout import (
    BROWNOUT_EVENTS_SUBJECT,
    BROWNOUT_STAGES,
    BrownoutMachine,
)
from dynamo_tpu_torch.serving_classes.config import (
    CLASS_HEADER,
    DEFAULT_CLASS,
    ServiceClass,
    ServingClassesConfig,
    classes_from_env,
    default_classes,
    parse_classes,
)
from dynamo_tpu_torch.serving_classes.metrics import ClassMetrics

__all__ = [
    "AdmissionEstimator",
    "BROWNOUT_EVENTS_SUBJECT",
    "BROWNOUT_STAGES",
    "BrownoutMachine",
    "CLASS_HEADER",
    "ClassMetrics",
    "DEFAULT_CLASS",
    "ServiceClass",
    "ServingClassesConfig",
    "classes_from_env",
    "default_classes",
    "estimate_ttft_s",
    "parse_classes",
]
