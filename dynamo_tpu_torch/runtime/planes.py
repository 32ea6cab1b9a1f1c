"""The reference's environment-armed planes that the port does not serve
yet, refused by name.

The reference's engine (`dynamo_tpu/engine/engine.py:709-717`) and its
mocker arm the mesh and collective recorder from `DYN_MESH_RECORDER`. A
deployment that sets it and gets silently nothing would be served
wrongly, so the port's `TorchEngine` and `MockEngine` raise
`PlaneUnavailable` at construction instead, naming the plane and the
ROADMAP item it waits for. The tenancy (`DYN_TENANCY`), serving-class
(`DYN_CLASSES`) and flight-control (`DYN_CONTROL`) planes are served
(`tenancy/`, `serving_classes/`, `control/`).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

# variable -> what it arms in the reference and what it waits for
UNPORTED_PLANES = {
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
