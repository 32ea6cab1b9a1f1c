"""Engine-death monitor: force-exit the worker when the engine dies.

Port of `dynamo_tpu/worker/monitor.py` (the port keeps its own copy).

Reference: `components/src/dynamo/vllm/engine_monitor.py` — a wedged or
crashed engine must take the process down so its store lease expires and
the instance vanishes from every router's watch (liveness = lease).
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


class EngineDeathMonitor:
    """Polls the engine's scheduler loop; exits the process on death.

    Works with any engine that exposes `_loop_task`/`_stopped`
    (TorchEngine); engines without a background loop (echo)
    are trivially healthy.
    """

    def __init__(self, engine, interval: float = 1.0,
                 exit_code: int = 42) -> None:
        self.engine = engine
        self.interval = interval
        self.exit_code = exit_code
        self._task: Optional[asyncio.Task] = None

    def engine_dead(self) -> bool:
        if getattr(self.engine, "_stopped", False):
            return False  # deliberate shutdown
        task = getattr(self.engine, "_loop_task", None)
        if task is None or not task.done():
            return False
        if task.cancelled():
            return False
        return task.exception() is not None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            if self.engine_dead():
                logger.error(
                    "engine loop died (%r); exiting so the lease drops",
                    getattr(self.engine, "_loop_task", None))
                # os._exit: no graceful teardown — the POINT is that the
                # lease stops being refreshed immediately
                os._exit(self.exit_code)
