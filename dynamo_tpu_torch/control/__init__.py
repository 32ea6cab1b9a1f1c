"""Flight control: closed feedback loops over the flight recorders.

The step/router/KV-lifecycle recorders built the read path;
this package is the write path — a `ControlPlane` that hosts small,
independently gateable controllers, each reading telemetry that already
exists and tuning one knob that used to be a static env var.  Everything
is off by default (`DYN_CONTROL`) and byte-identical when unarmed.
See docs/flight_control.md.

Port of `dynamo_tpu/control/__init__.py`: the same decisions, records
and payloads, on the port's own modules (no jax, no `dynamo_tpu`
import).
"""

from dynamo_tpu_torch.control.plane import (  # noqa: F401
    CONTROL_EVENTS_SUBJECT,
    CONTROLLERS,
    ControlMetrics,
    ControlPlane,
    control_enabled,
    control_plane_from_env,
)
from dynamo_tpu_torch.control.controllers import (  # noqa: F401
    BucketAutotuner,
    KvbmTuner,
    RouterTuner,
    ScaleAwareForecast,
)
