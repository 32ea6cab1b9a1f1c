"""Link tiers: which wire a byte crosses, and what the planners assume it
costs.

Port of what the disagg handlers and the prefix plane use from
`dynamo_tpu/runtime/topology.py`: `link_for_pull_path` (`:101`) and
`link_bandwidths` (`:53`), over the reference's tiers (`:32`):

  * **local** — the same card: the same-process pull (a gather on the
    card the two engines share) and the CUDA IPC plane between two
    processes on one card (`disagg/transfer_plane.py`);
  * **ici** — another card of the same host (NVLink on an H100 host),
    which no pull path of the port uses yet;
  * **dcn** — through the host and the network: the chunked host wire.

The reference maps its pull paths to the TPU's media ("device" over ICI,
its transfer plane and the wire over DCN); the port's paths run where the
port runs them, so the mapping differs.

`link_bandwidths` gives per-tier planning estimates in bytes/second, the
reference's defaults (not a measurement of any link of the port's
machine), so the prefix plane's pull-cost gate (`router/prefix_plane.py`)
decides as the reference's does. A deployment overrides them with
`DYN_LINK_BW_LOCAL` / `DYN_LINK_BW_ICI` / `DYN_LINK_BW_DCN`.
"""

from __future__ import annotations

import os
from typing import Optional

# planning defaults (bytes/second), the reference's
_DEFAULT_BW = {
    "local": 1.0e12,
    "ici": 9.0e10,
    "dcn": 1.25e10,
}
_ENV_KEYS = {
    "local": "DYN_LINK_BW_LOCAL",
    "ici": "DYN_LINK_BW_ICI",
    "dcn": "DYN_LINK_BW_DCN",
}


def link_bandwidths(env: Optional[dict] = None) -> dict[str, float]:
    """Per-tier bandwidth estimates (bytes/s), env-overridable."""
    e = os.environ if env is None else env
    out = {}
    for tier, default in _DEFAULT_BW.items():
        raw = e.get(_ENV_KEYS[tier])
        try:
            out[tier] = float(raw) if raw else default
        except (TypeError, ValueError):
            out[tier] = default
    return out

_PULL_PATH_LINK = {"device": "local", "plane": "local", "wire": "dcn"}


def link_for_pull_path(path: str) -> str:
    """Link tier of a disagg KV-pull path label ("?" when unknown)."""
    return _PULL_PATH_LINK.get(path, "?")
