"""Bounded compute pool: CPU-bound work off the event loop.

Port of `dynamo_tpu/runtime/compute.py` (`ComputePool`, `compute_pool`
`:88`, `run_cpu` `:95`); the port keeps its own copy. The engine compiles
guided-decoding grammars here (`engine/engine.py` `_compile_guided`).

Reference: `lib/runtime/src/compute/mod.rs:11` — the reference bridges
its async runtime to a rayon pool so CPU-heavy work (tokenization,
hashing, table builds) cannot starve the I/O loop, with permits
bounding concurrency. asyncio's default `to_thread` executor admits up
to ~32 threads with NO queueing signal: on a small serving host a
burst of CPU-bound jobs oversubscribes the cores, and the event loop's
scheduling latency (lease keepalives, stream heartbeats) degrades
exactly when the system is busiest.

This pool is the analog: one process-wide, explicitly
bounded ThreadPoolExecutor + semaphore, with queue/active counters for
observability. DEVICE-BLOCKING work (engine burst dispatch, np.asarray
syncs, device gathers) deliberately does NOT route through it — those
threads sleep on the device, not the CPU, and capping them behind
CPU permits would serialize device traffic (engine.py keeps plain
`asyncio.to_thread` there, by design).
"""

from __future__ import annotations

import asyncio
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional


class ComputePool:
    """Bounded executor bridge (`tokio-rayon` analog)."""

    def __init__(self, workers: Optional[int] = None) -> None:
        import weakref

        if workers is None:
            workers = int(os.environ.get(
                "DYN_COMPUTE_WORKERS", str(max(1, (os.cpu_count() or 1)))))
        self._workers = workers
        self._exec = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="dyn-compute")
        # admission semaphores are PER EVENT LOOP: an asyncio.Semaphore
        # binds to the loop that first awaits it, and this process-wide
        # pool outlives any one asyncio.run() (tests, CLIs) — a shared
        # semaphore would raise 'bound to a different event loop' on
        # the second loop's first contention
        self._loop_sems: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._lock = threading.Lock()
        self._active = 0
        self._completed = 0

    def _sem(self) -> asyncio.Semaphore:
        loop = asyncio.get_running_loop()
        sem = self._loop_sems.get(loop)
        if sem is None:
            sem = self._loop_sems[loop] = asyncio.Semaphore(
                self._workers * 2)
        return sem

    async def run(self, fn: Callable[..., Any], *args: Any) -> Any:
        """Run `fn(*args)` on the pool; backpressures when more than
        2× the worker count is already queued (the caller awaits its
        permit instead of growing an invisible thread queue)."""
        async with self._sem():
            with self._lock:
                self._active += 1
            try:
                loop = asyncio.get_running_loop()
                return await loop.run_in_executor(self._exec, fn, *args)
            finally:
                with self._lock:
                    self._active -= 1
                    self._completed += 1

    def stats(self) -> dict:
        with self._lock:
            return {"workers": self._workers, "active": self._active,
                    "completed": self._completed}

    def shutdown(self) -> None:
        self._exec.shutdown(wait=False, cancel_futures=True)


_pool: Optional[ComputePool] = None


def compute_pool() -> ComputePool:
    global _pool
    if _pool is None:
        _pool = ComputePool()
    return _pool


async def run_cpu(fn: Callable[..., Any], *args: Any) -> Any:
    """CPU-bound `fn` on the shared bounded pool (module-level sugar)."""
    return await compute_pool().run(fn, *args)
