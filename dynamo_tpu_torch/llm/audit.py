"""Audit subsystem: request/response capture off the hot path.

Port of `dynamo_tpu/llm/audit.py` (the port keeps its own copy).

Reference: `lib/llm/src/audit/` — a process-wide bus (`bus.rs`: publish
never blocks, subscribers drain on their own tasks), pluggable sinks
(`sink.rs`: stderr/log JSON line; env-selected via ``DYN_AUDIT_SINKS``),
and a per-request handle that accumulates the record and emits it once
at stream end (`handle.rs`/`stream.rs`). Enabled by ``DYN_AUDIT=1``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.runtime.recorder import BackgroundDrain, Recorder

logger = logging.getLogger("dynamo_tpu_torch.audit")


@dataclass
class AuditRecord:
    """One served request, emitted at stream end."""

    request_id: str
    endpoint: str                   # chat_completions | completions | ...
    model: str = ""
    created_at: float = field(default_factory=time.time)
    finished_at: float = 0.0
    request: Optional[dict] = None  # client body (may be large)
    response_text: str = ""
    reasoning_text: str = ""
    tool_calls: list = field(default_factory=list)
    finish_reason: str = ""
    usage: Optional[dict] = None
    error: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class AuditSink:
    name = "base"

    def emit(self, rec: AuditRecord) -> None:  # pragma: no cover
        raise NotImplementedError


class LogSink(AuditSink):
    """JSON line via the logging subsystem (StderrSink analog)."""

    name = "log"

    def emit(self, rec: AuditRecord) -> None:
        logger.info("%s", json.dumps(rec.to_dict(),
                                     separators=(",", ":")))


class JsonlSink(AuditSink):
    """Durable JSONL file via the generic recorder."""

    name = "jsonl"

    def __init__(self, path: str) -> None:
        self.recorder = Recorder(path)

    def emit(self, rec: AuditRecord) -> None:
        self.recorder.record(rec.to_dict())

    async def close(self) -> None:
        await self.recorder.close()


class AuditBus:
    """Publish → shared BackgroundDrain → sinks, off the event loop
    (sinks may do blocking I/O). ``publish`` never blocks and never
    raises; a full/failed/closed drain drops (and counts)."""

    def __init__(self, sinks: Optional[list[AuditSink]] = None,
                 capacity: int = 1024) -> None:
        self.sinks = sinks if sinks is not None else [LogSink()]
        self._drain = BackgroundDrain(self._emit, max_queue=capacity,
                                      name="audit-bus")

    def _emit(self, rec: AuditRecord) -> None:
        for sink in self.sinks:
            try:
                sink.emit(rec)
            except Exception:
                logger.exception("audit sink %s failed", sink.name)

    def publish(self, rec: AuditRecord) -> None:
        self._drain.put(rec)

    @property
    def published(self) -> int:
        return self._drain.count

    @property
    def dropped(self) -> int:
        return self._drain.dropped

    async def close(self) -> None:
        await self._drain.close()
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                await close()


def audit_bus_from_env() -> Optional[AuditBus]:
    """None unless ``DYN_AUDIT`` is truthy. Sinks from ``DYN_AUDIT_SINKS``
    (comma list: log, jsonl); jsonl path from ``DYN_AUDIT_PATH``."""
    if os.environ.get("DYN_AUDIT", "").lower() not in ("1", "true", "yes"):
        return None
    sinks: list[AuditSink] = []
    for name in os.environ.get("DYN_AUDIT_SINKS", "log").split(","):
        name = name.strip().lower()
        if name in ("log", "stderr", ""):
            sinks.append(LogSink())
        elif name == "jsonl":
            sinks.append(JsonlSink(
                os.environ.get("DYN_AUDIT_PATH", "audit.jsonl")))
        else:
            logger.warning("audit: unknown sink %r ignored", name)
    return AuditBus(sinks or [LogSink()])
