"""Migration operator: replay a dying request on a surviving worker.

Port of `dynamo_tpu/llm/migration.py` (the port keeps its own copy).

Reference: `lib/llm/src/migration.rs:26-73` — wraps the network edge; when
the response stream dies (worker crash, connection loss) it retries on a
*new* worker up to `migration_limit` times, carrying the tokens generated so
far, so generation continues seamlessly mid-stream
(docs/architecture/request_migration.md).

The trigger is ConnectionError, which the transport raises for worker
death AND — with deadlines configured (`stream_idle_timeout` /
`request_deadline`, docs/robustness.md) — for a wedged-but-connected
worker whose stream went silent. Hangs become migrations.

Sits between Backend and the router: requests/responses at this hop are
PreprocessedRequest / EngineOutput dicts (token ids, not text), so replayed
requests append accumulated tokens to the prompt.
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator

from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import Operator

logger = logging.getLogger(__name__)


class Migration(Operator):
    def __init__(self, migration_limit: int = 0) -> None:
        super().__init__()
        self.migration_limit = migration_limit
        # observability: how often streams died and how many were replayed
        # vs. exhausted (surfaced beside the transport/breaker counters)
        self.stats = {"migrations": 0, "exhausted": 0}

    async def forward(self, request: dict, context: Context
                      ) -> AsyncIterator[dict]:
        assert self.inner is not None
        accumulated: list[int] = list(request.get("accumulated_tokens", ()))
        attempts_left = self.migration_limit
        while True:
            req = dict(request)
            if accumulated:
                # Replay: the new worker prefills prompt+generated and
                # continues; max_tokens shrinks by what was already produced.
                req["token_ids"] = list(request["token_ids"]) + accumulated
                stop = dict(req.get("stop") or {})
                if stop.get("max_tokens"):
                    stop["max_tokens"] = max(
                        stop["max_tokens"] - len(accumulated), 1)
                req["stop"] = stop
                req["accumulated_tokens"] = accumulated
            try:
                async for out in self.inner.generate(req, context):
                    accumulated.extend(out.get("token_ids", ()))
                    yield out
                    if out.get("finish_reason"):
                        return
                return  # clean end of stream
            except ConnectionError as e:
                # a spent request budget (Context.deadline stamped by the
                # transport) makes every replay fail instantly — surface
                # the error now instead of churning through the limit
                expired = (context.deadline is not None
                           and asyncio.get_running_loop().time()
                           >= context.deadline)
                if context.is_cancelled() or attempts_left <= 0 or expired:
                    if not context.is_cancelled():
                        self.stats["exhausted"] += 1
                    raise
                attempts_left -= 1
                self.stats["migrations"] += 1
                logger.warning(
                    "stream for request %s died (%s); migrating "
                    "(%d attempts left, %d tokens accumulated)",
                    context.request_id, e, attempts_left, len(accumulated))
                # loop retries on a fresh worker; a dead instance has
                # already left the client's instance set
