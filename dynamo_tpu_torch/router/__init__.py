"""KV-cache-aware router: the prefix index, the load scheduler and the
router engine.

Port of `dynamo_tpu/router/` (the port keeps its own copies): RadixTree /
KvIndexer / ApproxKvIndexer (`indexer.py`), ActiveSequences and
DefaultWorkerSelector (`scheduler.py`), the router metrics
(`decision_log.py`) and KvRouter / KvPushRouter (`kv_router.py`).

Reference: `lib/llm/src/kv_router/` — indexer.rs, scheduler.rs,
sequence.rs, kv_router.rs, subscriber.rs.
"""

from dynamo_tpu_torch.router.indexer import (
    ApproxKvIndexer,
    KvIndexer,
    OverlapScores,
    RadixTree,
)
from dynamo_tpu_torch.router.kv_router import (
    KvPushRouter,
    KvRouter,
    KvRouterConfig,
)
from dynamo_tpu_torch.router.scheduler import (
    ActiveSequences,
    DefaultWorkerSelector,
    MultiWorkerSequences,
    WorkerLoad,
)

__all__ = [
    "RadixTree", "KvIndexer", "ApproxKvIndexer", "OverlapScores",
    "ActiveSequences", "MultiWorkerSequences", "DefaultWorkerSelector",
    "WorkerLoad", "KvRouter", "KvPushRouter", "KvRouterConfig",
]
