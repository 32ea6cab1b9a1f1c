"""Per-instance circuit breaker for the request path.

Port of `dynamo_tpu/runtime/breaker.py` (the port keeps its own copy).

Reference analog: the busy-threshold gating in
`lib/runtime/src/pipeline/network/egress/push_router.rs:31-38` reacts to
load; this reacts to *failure*. NetKV (PAPERS.md) makes the same argument
for decode-instance selection: routing must track network health, not just
queue depth. Classic three-state breaker:

    closed     -- traffic flows; consecutive infra failures are counted
    open       -- `fail_limit` consecutive failures seen; the instance is
                  filtered out of candidate sets until `cooldown` elapses
    half_open  -- cooldown elapsed; one probe request is admitted per
                  cooldown window. Success closes, failure re-opens.

Keys are per-INSTANCE (the endpoint subject), not per-address: in tests and
single-host deploys many instances share one transport address, and one
wedged engine must not open the breaker for its healthy neighbours.

The clock is injectable so fault-injection tests can step time
deterministically (`runtime/faults.py` / `DYN_FAULTS`).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _Entry:
    __slots__ = ("state", "failures", "retry_at")

    def __init__(self) -> None:
        self.state = CLOSED
        self.failures = 0
        self.retry_at = 0.0


class CircuitBreaker:
    def __init__(self, fail_limit: int = 3, cooldown: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.fail_limit = max(1, fail_limit)
        self.cooldown = cooldown
        self.clock = clock
        self._entries: dict[str, _Entry] = {}
        # lifetime transition counters, exported via service stats/metrics
        self.transitions = {CLOSED: 0, OPEN: 0, HALF_OPEN: 0}
        # observer for state changes: fn(key, old_state, new_state).
        # Set by the runtime to publish breaker events on the event
        # plane (frontends shed load before dialing a dead worker).
        # Must not raise into the request path.
        self.on_transition: Optional[
            Callable[[str, str, str], None]] = None

    def _entry(self, key: str) -> _Entry:
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _Entry()
        return e

    def _transition(self, key: str, e: _Entry, state: str) -> None:
        if e.state != state:
            old = e.state
            e.state = state
            self.transitions[state] += 1
            if self.on_transition is not None:
                try:
                    self.on_transition(key, old, state)
                except Exception:
                    logger.exception(
                        "breaker on_transition observer failed")

    # -- routing hooks -------------------------------------------------------

    def allow(self, key: str) -> bool:
        """May this instance receive a request right now?

        An open entry past its cooldown flips to half_open and admits one
        probe; further calls are rejected until the probe resolves (or
        another cooldown passes — a probe that was routed elsewhere and
        never resolved must not wedge the instance out forever).
        """
        e = self._entries.get(key)
        if e is None or e.state == CLOSED:
            return True
        now = self.clock()
        if now >= e.retry_at:
            self._transition(key, e, HALF_OPEN)
            e.retry_at = now + self.cooldown
            return True
        return False

    def record_success(self, key: str) -> None:
        e = self._entries.get(key)
        if e is None:
            return
        e.failures = 0
        self._transition(key, e, CLOSED)

    def record_failure(self, key: str) -> None:
        e = self._entry(key)
        e.failures += 1
        if e.state == HALF_OPEN or e.failures >= self.fail_limit:
            e.retry_at = self.clock() + self.cooldown
            self._transition(key, e, OPEN)

    def reset(self, key: str) -> bool:
        """Forget an instance's entry entirely. Called when the instance
        deregisters (quarantine, scale-down, lease expiry): a respawned
        worker that comes back under the same subject must start closed
        with a zero failure count, not inherit the corpse's open breaker
        and wait out a cooldown it never earned. Also keeps the entry
        map bounded under instance churn. Returns True if an entry
        existed. Lifetime transition counters are deliberately kept."""
        return self._entries.pop(key, None) is not None

    # -- introspection -------------------------------------------------------

    def state(self, key: str) -> str:
        e = self._entries.get(key)
        return e.state if e is not None else CLOSED

    def open_count(self) -> int:
        return sum(1 for e in self._entries.values() if e.state != CLOSED)

    def snapshot(self) -> dict:
        """Scrape-friendly view (service_stats / metrics export)."""
        return {
            "transitions": dict(self.transitions),
            "instances": {
                k: {"state": e.state, "failures": e.failures}
                for k, e in self._entries.items()
            },
        }
