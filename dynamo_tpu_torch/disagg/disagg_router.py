"""Conditional disaggregation decision.

Port of `dynamo_tpu/disagg/disagg_router.py` (after the upstream
`lib/llm/src/disagg_router.rs:135,230-240`): `prefill_remote(prefill_len,
prefix_hit_len)` is True when the *uncached* prefill work exceeds
`max_local_prefill_length`, so short (or mostly cached) prompts prefill
on the decode worker and only long cold prompts pay the remote prefill
and the KV transfer. The threshold follows a store watch on
`disagg_config_key(namespace, component)` (JSON with
`max_local_prefill_length` and `conditional`).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from dynamo_tpu_torch.runtime.store import PUT

logger = logging.getLogger(__name__)

DISAGG_PREFIX = "v1/disagg/"


def disagg_config_key(namespace: str, component: str) -> str:
    return f"{DISAGG_PREFIX}{namespace}/{component}"


class DisaggRouter:
    def __init__(self, max_local_prefill_length: int = 512,
                 conditional: bool = True) -> None:
        self.max_local_prefill_length = max_local_prefill_length
        self.conditional = conditional
        self._watch = None
        self._task: Optional[asyncio.Task] = None

    def prefill_remote(self, prefill_len: int, prefix_hit_len: int = 0
                       ) -> bool:
        if not self.conditional:
            return True
        return (prefill_len - prefix_hit_len) > self.max_local_prefill_length

    async def start_watch(self, runtime, namespace: str,
                          component: str) -> "DisaggRouter":
        """Live-update the threshold from the KV store."""
        key = disagg_config_key(namespace, component)
        kv = await runtime.store.get(key)
        if kv is not None:
            self._apply(kv.value)
        self._watch = await runtime.store.watch_prefix(key)
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def _run(self) -> None:
        async for ev in self._watch:
            if ev.kind == PUT:
                self._apply(ev.value)

    def _apply(self, raw: bytes) -> None:
        try:
            cfg = json.loads(raw)
            self.max_local_prefill_length = int(
                cfg.get("max_local_prefill_length",
                        self.max_local_prefill_length))
            self.conditional = bool(cfg.get("conditional", self.conditional))
            logger.info("disagg config updated: max_local=%d conditional=%s",
                        self.max_local_prefill_length, self.conditional)
        except Exception:
            logger.exception("bad disagg config")

    async def stop(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
        if self._task is not None:
            self._task.cancel()
