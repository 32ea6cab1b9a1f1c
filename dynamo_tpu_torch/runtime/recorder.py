"""Generic JSONL event recorder, off the event loop entirely.

Port of `dynamo_tpu/runtime/recorder.py` (the port keeps its own copy):
its JSONL lines are the reference's, so either package's `iter_events`
reads the other's file.

Reference: `lib/llm/src/recorder.rs:25-40` — a channel-fed background
worker appends ``{"timestamp": ..., "event": ...}`` lines to a JSONL
file; producers never block. Here the drain runs on a REAL thread (not
an event-loop task): file writes/flushes on a slow disk must not stall
the serving loop. `BackgroundDrain` is the shared core — the audit bus
reuses it with a sink-emit consumer instead of a file writer.
"""

from __future__ import annotations

import asyncio
import json
import logging
import queue as _queue
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

logger = logging.getLogger(__name__)

_SENTINEL = object()


class BackgroundDrain:
    """Bounded queue drained by a daemon thread; put never blocks.

    A consumer that raises permanently marks the drain failed: further
    puts count as dropped (no respawn storm), and ``close()`` reports
    what was lost instead of silently discarding the queue."""

    def __init__(self, consume: Callable[[Any], None],
                 max_queue: int = 4096, name: str = "drain",
                 flush: Optional[Callable[[], None]] = None,
                 flush_interval: float = 0.5) -> None:
        self._consume = consume
        self._flush = flush
        self._flush_interval = flush_interval
        self._queue: _queue.Queue = _queue.Queue(maxsize=max_queue)
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.failed: Optional[str] = None
        self.count = 0
        self.dropped = 0

    def put(self, item: Any) -> bool:
        """Enqueue without blocking. Returns False when the item was
        dropped (queue full / drain closed or failed) so producers that
        must account for loss — the tracer's `dynamo_trace_dropped_total`
        — can count exactly the queue-bound drops."""
        if self._closed or self.failed:
            self.dropped += 1
            return False
        self._ensure_thread()
        try:
            self._queue.put_nowait(item)
            return True
        except _queue.Full:
            self.dropped += 1
            return False

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name=self._name, daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=self._flush_interval)
            except _queue.Empty:
                try:
                    if self._flush is not None:
                        self._flush()
                except Exception as e:
                    self._fail(e)
                    return
                if self._closed:
                    return
                continue
            if item is _SENTINEL:
                try:
                    if self._flush is not None:
                        self._flush()
                except Exception as e:
                    self._fail(e)
                return
            try:
                self._consume(item)
                self.count += 1
            except Exception as e:
                self._fail(e)
                return

    def _fail(self, e: Exception) -> None:
        self.failed = repr(e)
        # everything still queued is lost: account for it
        lost = self._queue.qsize()
        self.dropped += lost
        logger.error("%s: consumer failed (%s); %d queued item(s) lost, "
                     "further items dropped", self._name, self.failed, lost)

    async def close(self) -> bool:
        """Drain remaining items, stop the thread. Safe to call twice.
        Returns True when the drain thread has actually exited."""
        if self._closed:
            t = self._thread
            return t is None or not t.is_alive()
        self._closed = True
        t = self._thread
        if t is not None and t.is_alive():
            try:
                self._queue.put_nowait(_SENTINEL)
            except _queue.Full:
                pass  # consumer failed with a full queue; thread exits
            await asyncio.to_thread(t.join, 10.0)
        return t is None or not t.is_alive()


class Recorder:
    """Append-only JSONL recorder on a BackgroundDrain."""

    def __init__(self, path: str | Path, flush_interval: float = 0.5,
                 max_queue: int = 4096, max_bytes: int = 0,
                 keep: int = 3) -> None:
        self.path = Path(path)
        self._file = None
        # size-based rotation (`trace.jsonl` -> `trace.jsonl.1` ...):
        # 0 = unbounded (legacy). All rotation work happens on the drain
        # thread inside _write, never on the serving loop.
        self.max_bytes = int(max_bytes)
        self.keep = max(1, int(keep))
        self._bytes = 0
        self.rotations = 0
        self._drain = BackgroundDrain(
            self._write, max_queue=max_queue,
            name=f"recorder:{self.path.name}",
            flush=self._do_flush, flush_interval=flush_interval)

    def _open(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = self.path.open("a", encoding="utf-8")
        try:
            self._bytes = self.path.stat().st_size
        except OSError:
            self._bytes = 0

    def _rotate(self) -> None:
        self._file.close()
        self._file = None
        for i in range(self.keep - 1, 0, -1):
            src = Path(f"{self.path}.{i}")
            if src.exists():
                src.replace(Path(f"{self.path}.{i + 1}"))
        self.path.replace(Path(f"{self.path}.1"))
        self.rotations += 1

    def _write(self, item: dict) -> None:
        if self._file is None:
            self._open()
        line = json.dumps(item, separators=(",", ":")) + "\n"
        if (self.max_bytes > 0 and self._bytes > 0
                and self._bytes + len(line) > self.max_bytes):
            self._rotate()
            self._open()
        self._file.write(line)
        self._bytes += len(line)

    def _do_flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def record(self, event: Any) -> bool:
        """Non-blocking; drops (and counts) when the writer can't keep
        up or has failed — recording must never stall serving. Returns
        False when the event was dropped."""
        return self._drain.put({"timestamp": time.time(), "event": event})

    @property
    def event_count(self) -> int:
        return self._drain.count

    @property
    def dropped(self) -> int:
        return self._drain.dropped

    @property
    def failed(self) -> Optional[str]:
        return self._drain.failed

    async def close(self) -> None:
        if not await self._drain.close():
            # drain wedged on a hung disk: closing the shared handle out
            # from under the writer thread would turn a stall into data
            # loss; leak the handle instead and say so
            logger.error("recorder %s: writer still busy after close "
                         "timeout; leaving file open", self.path)
            return
        if self._file is not None:
            self._file.close()
            self._file = None

    # -- reading back --------------------------------------------------------

    @staticmethod
    def iter_events(path: str | Path) -> Iterator[tuple[float, Any]]:
        with Path(path).open(encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                    yield float(d["timestamp"]), d["event"]
                except (ValueError, KeyError):
                    logger.warning("recorder: skipping bad line")
