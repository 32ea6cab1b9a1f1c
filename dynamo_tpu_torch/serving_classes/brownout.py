"""Brownout: graceful degradation under overload (docs/robustness.md).

A state machine driven by the SLO monitor's burn-rate transitions on
the ``slo_events`` subject. Overload today means falling over; with
brownout armed, the fleet degrades in explainable stages instead:

    stage 0  ok           serve everything
    stage 1  shed_batch   new batch-class requests 503 (Retry-After)
    stage 2  cap_standard new standard streams get max_tokens capped
    stage 3  shrink_spec  spec-decode lanes fall back to plain decode
                          (frees draft-model compute + memory bandwidth
                          for interactive TTFT)

Escalation: any objective entering ``fast_burn`` or ``breach`` steps
the machine up one stage (bounded). De-escalation: after every hot
objective has returned to ok/slow_burn AND ``recover_s`` clean seconds
have passed, the machine walks back ONE stage — hysteresis in both
directions (``hold_s`` between any two transitions), so a flapping
burn rate cannot thrash the ladder.

Every transition is an explainable action record {knob, from, to,
reason, evidence} published on the ``brownout_events`` subject,
reflected in the ``dynamo_brownout_state`` gauge, and counted per
target stage. The machine is also a ControlPlane-compatible controller
(``name="brownout"``, ``tick(now)``, ``state()``) so DYN_CONTROL can
gate it onto the shared control tick; transitions then ride the
``control_events`` ring too.

Deterministic: the clock is injected; `on_slo_event`/`tick` take the
evaluation timestamps, so the fake-clock tests replay the ladder
exactly.

Port of `dynamo_tpu/serving_classes/brownout.py`: the same decisions,
records and payloads, on the port's own modules (no jax, no `dynamo_tpu`
import).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

# Event-plane subject for brownout stage transitions.
BROWNOUT_EVENTS_SUBJECT = "brownout_events"

#: stage names, index == stage number
BROWNOUT_STAGES = ("ok", "shed_batch", "cap_standard", "shrink_spec")

MAX_STAGE = len(BROWNOUT_STAGES) - 1


class BrownoutMachine:
    """The overload ladder. One per frontend process.

    ``engines`` is a zero-arg supplier of in-proc engine objects; stage
    3 actuates by flipping their ``spec_shrink`` flag (a TorchEngine
    with a draft serves plain decode bursts instead of spec bursts —
    shapes it already runs — and MockEngine carries the attribute
    inertly for state/test parity). The HTTP gate consults
    `sheds()`/`cap_for()` per request, so stages 1-2 cost armed-path
    requests one integer compare and unarmed paths nothing.
    """

    name = "brownout"

    def __init__(self, classes_cfg, *,
                 engines: Optional[Callable[[], list]] = None,
                 bus=None, metrics=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.cfg = classes_cfg
        self.hold_s = classes_cfg.brownout_hold_s
        self.recover_s = classes_cfg.brownout_recover_s
        self._engines = engines
        self.bus = bus
        self.metrics = metrics           # ClassMetrics or None
        self._clock = clock
        self.stage = 0
        self._hot: set[str] = set()      # objectives in fast_burn/breach
        self._last_change = -float("inf")
        self._clean_since: Optional[float] = None
        self.transitions = 0
        if self.metrics is not None:
            self.metrics.brownout_state.set(0)

    # -- queries the serving path makes -------------------------------------

    def sheds(self, cls) -> bool:
        """True when new requests of this ServiceClass are shed at the
        current stage."""
        return bool(cls.shed_stage) and self.stage >= cls.shed_stage

    def cap_for(self, cls) -> int:
        """max_tokens cap for new streams of this ServiceClass at the
        current stage; 0 = uncapped."""
        if cls.cap_stage and cls.cap_tokens and self.stage >= cls.cap_stage:
            return cls.cap_tokens
        return 0

    # -- transitions ---------------------------------------------------------

    def _actuate(self) -> None:
        """Apply/clear the stage-3 spec-decode shrink on live engines."""
        if self._engines is None:
            return
        shrink = self.stage >= 3
        try:
            for eng in list(self._engines() or []):
                if hasattr(eng, "spec_shrink"):
                    eng.spec_shrink = shrink
        except Exception:
            logger.exception("brownout: spec_shrink actuation failed")

    def _transition(self, new_stage: int, now: float, reason: str,
                    evidence: dict) -> dict:
        old = self.stage
        self.stage = new_stage
        self._last_change = now
        self.transitions += 1
        self._actuate()
        ev = {"knob": "brownout_stage",
              "from": BROWNOUT_STAGES[old], "to": BROWNOUT_STAGES[new_stage],
              "reason": reason, "evidence": evidence,
              "at": round(float(now), 6)}
        if self.metrics is not None:
            self.metrics.brownout_state.set(new_stage)
            self.metrics.brownout_actions.inc(
                stage=BROWNOUT_STAGES[new_stage])
        if self.bus is not None:
            from dynamo_tpu_torch.runtime.telemetry import _publish_best_effort
            _publish_best_effort(self.bus, BROWNOUT_EVENTS_SUBJECT, ev)
        return ev

    def on_slo_event(self, ev: dict, now: Optional[float] = None
                     ) -> list[dict]:
        """Feed one SloMonitor transition event. Returns the brownout
        actions it caused (empty for most events)."""
        now = self._clock() if now is None else now
        obj = str(ev.get("objective", "?"))
        to = str(ev.get("to", ""))
        hot = to in ("fast_burn", "breach")
        if hot:
            self._hot.add(obj)
            self._clean_since = None
            if (self.stage < MAX_STAGE
                    and now - self._last_change >= self.hold_s):
                return [self._transition(
                    self.stage + 1, now,
                    f"{obj} entered {to}",
                    {"objective": obj, "state": to,
                     "fast_burn": ev.get("fast_burn"),
                     "slow_burn": ev.get("slow_burn"),
                     "threshold_s": ev.get("threshold_s"),
                     "hot": sorted(self._hot)})]
        else:
            self._hot.discard(obj)
            if not self._hot and self._clean_since is None:
                self._clean_since = now
        return []

    def tick(self, now: Optional[float] = None) -> list[dict]:
        """Periodic walk-back (ControlPlane controller contract): one
        stage down per `recover_s` of clean time, `hold_s` apart."""
        now = self._clock() if now is None else now
        if self.stage == 0 or self._hot:
            return []
        if self._clean_since is None:
            self._clean_since = now
            return []
        if (now - self._clean_since >= self.recover_s
                and now - self._last_change >= self.hold_s):
            ev = self._transition(
                self.stage - 1, now,
                f"clean for {round(now - self._clean_since, 3)}s",
                {"clean_s": round(now - self._clean_since, 3),
                 "recover_s": self.recover_s})
            # the NEXT step down needs a fresh clean window
            self._clean_since = now
            return [ev]
        return []

    def state(self) -> dict:
        """Live view for /debug/classes, /fleet/status, doctor."""
        return {
            "stage": self.stage,
            "stage_name": BROWNOUT_STAGES[self.stage],
            "hot_objectives": sorted(self._hot),
            "transitions": self.transitions,
            "hold_s": self.hold_s,
            "recover_s": self.recover_s,
        }
