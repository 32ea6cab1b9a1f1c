"""Link tiers: which wire a disaggregated KV pull crosses.

Port of what the disagg handlers use from `dynamo_tpu/runtime/topology.py`:
`link_for_pull_path` (`:101`), over the reference's tiers (`:32`):

  * **local** — the same card: the same-process pull (a gather on the
    card the two engines share) and the CUDA IPC plane between two
    processes on one card (`disagg/transfer_plane.py`);
  * **ici** — another card of the same host (NVLink on an H100 host),
    which no pull path of the port uses yet;
  * **dcn** — through the host and the network: the chunked host wire.

The reference maps its pull paths to the TPU's media ("device" over ICI,
its transfer plane and the wire over DCN); the port's paths run where the
port runs them, so the mapping differs.
"""

from __future__ import annotations

_PULL_PATH_LINK = {"device": "local", "plane": "local", "wire": "dcn"}


def link_for_pull_path(path: str) -> str:
    """Link tier of a disagg KV-pull path label ("?" when unknown)."""
    return _PULL_PATH_LINK.get(path, "?")
