"""Built-in trivial engines for tests and pipelines without models.

Port of `dynamo_tpu/engines.py` (the port keeps its own copy).

Reference: `lib/llm/src/engines.rs:120` (make_echo_engine) — streams the
request's tokens back one at a time with a fixed inter-token delay.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from dynamo_tpu_torch.protocols import (
    FINISH_LENGTH,
    FINISH_STOP,
    EngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.context import Context


class EchoEngine:
    """Echoes prompt tokens as the completion, one per delta."""

    def __init__(self, delay_ms: float = 1.0) -> None:
        self.delay_ms = delay_ms

    async def generate(self, request: dict, context: Context
                       ) -> AsyncIterator[dict]:
        req = PreprocessedRequest.from_dict(request)
        max_tokens = req.stop.max_tokens or len(req.token_ids)
        emitted = 0
        for tok in req.token_ids:
            if context.is_cancelled():
                return
            if emitted >= max_tokens:
                break
            await asyncio.sleep(self.delay_ms / 1e3)
            emitted += 1
            last = emitted >= max_tokens or emitted >= len(req.token_ids)
            yield EngineOutput(
                token_ids=[tok],
                finish_reason=(FINISH_LENGTH if last else None),
            ).to_dict()
        if emitted == 0:
            yield EngineOutput(token_ids=[], finish_reason=FINISH_STOP).to_dict()
