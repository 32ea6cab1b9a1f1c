"""ControlPlane: the shared tick that hosts the feedback controllers.

Design rules (docs/flight_control.md):

- **Off by default.** `DYN_CONTROL` unset ⇒ `control_plane_from_env`
  returns None and no controller object exists anywhere — the engines,
  router, KVBM, and planner run byte-identical to a build without this
  package.
- **Independently gateable.** `DYN_CONTROL=bucket,router` arms exactly
  those controllers; `DYN_CONTROL=1|all` arms all four.
- **Explainable.** Every knob change is an action record carrying the
  before/after values and the evidence window that justified it,
  appended to a bounded ring, published on the `control_events` subject,
  and counted in `dynamo_control_actions_total{controller}` — so
  `doctor control` can reconstruct why any knob moved.
- **Deterministic.** Controllers never read the wall clock themselves;
  the tick timestamp is injected (`tick(now=...)`), so a virtual-clock
  run (bench/perf.py, the seeded tests) replays to identical events.

Port of `dynamo_tpu/control/plane.py`: the same decisions, records and
payloads, on the port's own modules (no jax, no `dynamo_tpu` import).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from collections import deque

from dynamo_tpu_torch.runtime.metrics import Counter

logger = logging.getLogger(__name__)

CONTROL_EVENTS_SUBJECT = "control_events"

#: every controller this build knows how to host, in attach order
CONTROLLERS = ("bucket", "kvbm", "router", "forecast", "brownout")

_TRUTHY = {"1", "true", "yes", "on"}


def control_enabled(env=None) -> frozenset:
    """Parse DYN_CONTROL into the set of armed controller names.

    Unset/empty ⇒ empty set (everything off).  A truthy value or
    ``all``/``*`` arms every controller; otherwise a comma list filtered
    to known names (unknown names are ignored, not an error, so an old
    env var survives a controller rename).
    """
    env = os.environ if env is None else env
    raw = (env.get("DYN_CONTROL") or "").strip().lower()
    if not raw:
        return frozenset()
    if raw in _TRUTHY or raw in ("all", "*"):
        return frozenset(CONTROLLERS)
    names = {part.strip() for part in raw.split(",") if part.strip()}
    return frozenset(n for n in names if n in CONTROLLERS)


class ControlMetrics:
    """Fixed-name control-plane metrics (RouterMetrics pattern): built by
    the plane, adopted into a registry via register()."""

    def __init__(self) -> None:
        self.actions = Counter(
            "dynamo_control_actions_total",
            "Knob changes applied by flight-control controllers")
        self.ticks = Counter(
            "dynamo_control_ticks_total",
            "Control-plane tick executions")

    def register(self, registry) -> None:
        registry.register(self.actions)
        registry.register(self.ticks)


class ControlPlane:
    """Hosts armed controllers on one shared tick.

    Controllers are plain objects with ``name``, ``tick(now) -> list``
    of action dicts ``{knob, from, to, reason, evidence}``, and
    ``state() -> dict``.  The plane stamps actions with (at, seq,
    controller), rings them, publishes them, and counts them.  A
    controller that raises is logged and skipped for that tick — one
    sick loop must not take down the others (or the serving path).
    """

    def __init__(self, enabled, *, interval_s: float = 5.0, bus=None,
                 metrics: ControlMetrics | None = None, now=time.time,
                 ring: int = 256):
        self.enabled = frozenset(enabled)
        self.interval_s = interval_s
        self.bus = bus
        self.metrics = metrics or ControlMetrics()
        self.controllers: list = []
        self.ticks = 0
        self._now = now
        self._seq = 0
        self._ring: deque = deque(maxlen=ring)
        self._task: asyncio.Task | None = None

    def attach(self, controller) -> bool:
        """Adopt a controller iff its name is armed; False ⇒ discarded."""
        if controller.name not in self.enabled:
            return False
        self.controllers.append(controller)
        return True

    # -- the tick -----------------------------------------------------------

    def tick(self, now: float | None = None) -> list[dict]:
        now = self._now() if now is None else now
        self.ticks += 1
        self.metrics.ticks.inc()
        out: list[dict] = []
        for c in self.controllers:
            try:
                actions = c.tick(now) or []
            except Exception:
                logger.exception("control: controller %r tick failed",
                                 getattr(c, "name", c))
                continue
            for action in actions:
                self._seq += 1
                ev = {"at": round(float(now), 6), "seq": self._seq,
                      "controller": c.name}
                ev.update(action)
                self._ring.append(ev)
                out.append(ev)
                self.metrics.actions.inc(controller=c.name)
                if self.bus is not None:
                    from dynamo_tpu_torch.runtime.telemetry import \
                        _publish_best_effort
                    _publish_best_effort(self.bus, CONTROL_EVENTS_SUBJECT, ev)
        return out

    # -- live deployment loop ----------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_event_loop().create_task(self._loop())

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            self.tick()

    # -- read side ----------------------------------------------------------

    def events(self, limit: int | None = None) -> list[dict]:
        evs = list(self._ring)
        return evs[-limit:] if limit else evs

    def action_counts(self) -> dict:
        return {name: int(self.metrics.actions.get(controller=name))
                for name in CONTROLLERS if name in self.enabled}

    def summary(self) -> dict:
        """Compact per-controller view for /fleet/status and doctor fleet."""
        return {
            "enabled": sorted(self.enabled),
            "interval_s": self.interval_s,
            "ticks": self.ticks,
            "actions": self.action_counts(),
            "controllers": {c.name: c.state() for c in self.controllers},
        }

    def payload(self, limit: int = 64) -> dict:
        """Full view for GET /debug/control and doctor control."""
        out = self.summary()
        out["events"] = self.events(limit)
        return out


def control_plane_from_env(runtime=None, *, engines=None, routers=None,
                           planner=None, scale_events=None, brownout=None,
                           now=time.time) -> ControlPlane | None:
    """Build an armed ControlPlane from DYN_CONTROL, or None when unset.

    ``engines``/``routers``/``scale_events`` are zero-arg suppliers (the
    fleet they observe can grow after wiring); ``planner`` is the live
    Planner or None; ``brownout`` is the frontend's live BrownoutMachine
    (serving_classes) or None.  Controllers whose inputs are absent are
    simply not attached — arming `forecast` on a frontend with no
    planner is a no-op, not an error.
    """
    enabled = control_enabled()
    if not enabled:
        return None
    try:
        interval_s = float(os.environ.get("DYN_CONTROL_INTERVAL_S") or 5.0)
    except ValueError:
        interval_s = 5.0
    metrics = ControlMetrics()
    registry = getattr(runtime, "metrics", None)
    if registry is not None:
        metrics.register(registry)
    plane = ControlPlane(enabled, interval_s=interval_s,
                         bus=getattr(runtime, "events", None),
                         metrics=metrics, now=now)
    from dynamo_tpu_torch.control.controllers import (
        BucketAutotuner,
        KvbmTuner,
        RouterTuner,
        ScaleAwareForecast,
    )
    if engines is not None:
        plane.attach(BucketAutotuner(engines))
        plane.attach(KvbmTuner(engines))
    if routers is not None:
        plane.attach(RouterTuner(routers))
    if planner is not None:
        plane.attach(ScaleAwareForecast(planner, scale_events
                                        or (lambda: [])))
    if brownout is not None:
        # the brownout machine already satisfies the controller contract
        # (name/tick/state); attaching puts its walk-back on the shared
        # tick and its stage transitions in the control action ring
        plane.attach(brownout)
    return plane
