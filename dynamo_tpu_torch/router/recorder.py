"""KvRecorder: persist router KV events to JSONL and replay them.

Port of `dynamo_tpu/router/recorder.py` (the port keeps its own copy) over
the port's `runtime/recorder.py`: one row per KvCacheEvent, as the
reference writes it, so a capture made by either package replays into the
other's indexer. Replay drives any ``apply_event`` consumer (RadixTree,
CRadixTree, KvIndexer): the same math, no engines.

Reference: `lib/llm/src/kv_router/recorder.rs:8`.
"""

from __future__ import annotations

from pathlib import Path
from dynamo_tpu_torch.protocols import KvCacheEvent
from dynamo_tpu_torch.runtime.recorder import Recorder


class KvRecorder:
    def __init__(self, path: str | Path) -> None:
        self.recorder = Recorder(path)
        self.path = Path(path)

    def record(self, ev: KvCacheEvent) -> None:
        self.recorder.record(ev.to_dict())

    @property
    def event_count(self) -> int:
        return self.recorder.event_count

    async def close(self) -> None:
        await self.recorder.close()

    @staticmethod
    async def replay_into(path: str | Path, indexer) -> int:
        """Feed recorded events into anything with ``apply_event``."""
        n = 0
        for _, d in Recorder.iter_events(path):
            indexer.apply_event(KvCacheEvent.from_dict(d))
            n += 1
        return n
