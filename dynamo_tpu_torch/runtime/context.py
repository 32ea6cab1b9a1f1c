"""Request context: id + hierarchical cancellation.

Reference: `lib/runtime/src/pipeline/context.rs` (Context<T> carries request
id and a cancellation token that propagates through every pipeline stage and
across network hops via a control frame).
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any, Optional


class Context:
    def __init__(self, request_id: Optional[str] = None,
                 parent: Optional["Context"] = None,
                 headers: Optional[dict[str, Any]] = None) -> None:
        self.request_id = request_id or uuid.uuid4().hex
        self.headers: dict[str, Any] = headers or {}
        # Absolute expiry (event-loop clock) for the WHOLE request.
        # Stamped by the transport on first use of a configured
        # `request_deadline`, then inherited by router retries and
        # Migration replays that reuse this context — one shared budget,
        # not a fresh one per attempt.
        self.deadline: Optional[float] = None
        self._cancelled = asyncio.Event()
        self._parent = parent
        self._children: list[Context] = []
        if parent is not None:
            parent._children.append(self)
            self.deadline = parent.deadline
            if parent.is_cancelled():
                self._cancelled.set()

    def child(self) -> "Context":
        return Context(self.request_id, parent=self, headers=dict(self.headers))

    def cancel(self) -> None:
        """Cancel this context and all children (never propagates upward)."""
        if not self._cancelled.is_set():
            self._cancelled.set()
            for c in self._children:
                c.cancel()

    def is_cancelled(self) -> bool:
        return self._cancelled.is_set()

    async def wait_cancelled(self) -> None:
        await self._cancelled.wait()

    def raise_if_cancelled(self) -> None:
        if self.is_cancelled():
            raise asyncio.CancelledError(f"request {self.request_id} cancelled")
