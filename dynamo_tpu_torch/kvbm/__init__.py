"""KVBM: multi-tier KV block manager (SURVEY §2.5).

Port of `dynamo_tpu/kvbm/`: cache tiers G1 (device memory) → G2 (host
RAM) → G3 (local disk) → G4 (peer workers' tiers), offload on eviction,
onboard on prefix match. G1 is the engine's device page pool
(engine/pages.py); this package owns G2/G3 and the offload/onboard flows.
On the card an offload is the KV gather plus one device-to-host copy,
an onboard one host-to-device copy plus K3 (`TorchEngine.
_read_kv_pages_sync` / `write_kv_blocks`); tier demotion G2→G3 is host
file IO.
"""

from dynamo_tpu_torch.kvbm.distributed import (
    KVBM_PULL_ENDPOINT,
    KvbmDistributed,
)
from dynamo_tpu_torch.kvbm.manager import KvbmConfig, KvbmManager, KvbmStats
from dynamo_tpu_torch.kvbm.tiers import DiskTier, HostTier, TieredStore

__all__ = ["KvbmManager", "KvbmConfig", "KvbmStats", "TieredStore",
           "HostTier", "DiskTier", "KvbmDistributed",
           "KVBM_PULL_ENDPOINT"]
