"""The reference's environment-armed planes that the port does not serve
yet, refused by name.

The reference's engine (`dynamo_tpu/engine/engine.py:718-740`), its
mocker and its HTTP frontend (`dynamo_tpu/llm/http_service.py:139`,
`:156`) arm these planes from the environment. A deployment that sets
one and gets silently nothing (no per-tenant quotas, no class admission)
would be served wrongly, so the port's `TorchEngine`, `MockEngine` and
`HttpService` raise `PlaneUnavailable` at construction instead, naming
the plane and the ROADMAP item it waits for.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

# variable -> what it arms in the reference and what it waits for; the
# reference arms DYN_TENANCY and DYN_CLASSES on any value, and
# DYN_SERVING_CLASSES is refused as the same plane's name
UNPORTED_PLANES = {
    "DYN_TENANCY": ("the tenancy plane (dynamo_tpu/tenancy: per-tenant "
                    "quotas and fair share)",
                    "ROADMAP queue 1 item 4"),
    "DYN_CLASSES": ("the serving-class plane (dynamo_tpu/serving_classes: "
                    "class admission and brownout)",
                    "ROADMAP queue 1 item 4"),
    "DYN_SERVING_CLASSES": ("the serving-class plane "
                            "(dynamo_tpu/serving_classes)",
                            "ROADMAP queue 1 item 4"),
    "DYN_MESH_RECORDER": ("the mesh and collective recorder "
                          "(engine/collectives.py)",
                          "ROADMAP queue 1 item 6"),
}
_OFF = {"", "0", "false", "no", "off"}


class PlaneUnavailable(ValueError):
    """An environment plane the port has not ported yet."""


def refuse_unported_planes(where: str,
                           env: Optional[Mapping] = None) -> None:
    """Raise for the first unported plane `env` (default os.environ)
    arms; `where` names the refusing component."""
    e = os.environ if env is None else env
    for var, (what, waits_for) in UNPORTED_PLANES.items():
        if str(e.get(var, "")).strip().lower() not in _OFF:
            raise PlaneUnavailable(
                f"{var} ({what}) is not supported by dynamo_tpu_torch yet: "
                f"it waits for {waits_for}; {where} refuses to serve "
                f"without it")
