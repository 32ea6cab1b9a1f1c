"""Deterministic, spec-driven fault injection.

Port of `dynamo_tpu/runtime/faults.py` (the port keeps its own copy):
the spec grammar (`DYN_FAULTS`, `parse_spec`), `FaultRule` and
`FaultInjector` with its seeded rng, and the one hook the port consults
so far, `on_offload` — KVBM's offload worker (`kvbm/manager.py`) asks it
before each drained batch, which is how a slow (`offload_delay`) or stuck
(`offload_stall`) tier pipeline is reproduced. The reference's other
hooks wait for the code that would call them: the transport's
`check_connect` / `on_frame`, the engine's `on_engine_call` /
`on_dispatch` (and `FaultyEngine`), the store's `on_store_op`. Their kinds
still parse, so one spec serves both packages.

Spec grammar:

    spec  := rule (';' rule)*
    rule  := key '=' value (',' key '=' value)*

    kind=<one of _KINDS>   what fires (offload_delay / offload_stall are
                           the ones the port acts on)
    addr=<glob>            match the dialed/peer address   (default *)
    subject=<glob>         match the request subject       (default *)
    after=<n>              skip the first n matching events (default 0)
    times=<k | *>          fire at most k times, * = unlimited (default 1)
    prob=<p>               fire with probability p from the SEEDED rng
    delay_s=<seconds>      for the delay kinds (default 0.05)
    error=<msg>            message for the error kinds

Determinism: trigger counts are exact; the only randomness is `prob`,
drawn from ``random.Random(DYN_FAULTS_SEED)`` (default 0).
"""

from __future__ import annotations

import fnmatch
import logging
import os
import random
from dataclasses import dataclass, field
from typing import Any, Optional

logger = logging.getLogger(__name__)

ENV_SPEC = "DYN_FAULTS"
ENV_SEED = "DYN_FAULTS_SEED"

# the reference's kinds, all parsed; the port acts on the KVBM two
OFFLOAD_DELAY = "offload_delay"
OFFLOAD_STALL = "offload_stall"
_KINDS = {"connect_refused", "disconnect", "stall", "delay", "err",
          "engine_err", "engine_stall", OFFLOAD_DELAY, OFFLOAD_STALL,
          "dispatch_wedge", "store_outage", "oom"}


@dataclass
class FaultRule:
    kind: str
    addr: str = "*"
    subject: str = "*"
    after: int = 0
    times: Optional[int] = 1       # None = unlimited
    prob: Optional[float] = None   # None = always (once past `after`)
    delay_s: float = 0.05
    error: str = "injected error"
    seen: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def matches(self, addr: Optional[str], subject: Optional[str]) -> bool:
        if addr is not None and not fnmatch.fnmatchcase(addr, self.addr):
            return False
        if subject is not None and self.subject != "*":
            if subject is None or not fnmatch.fnmatchcase(subject,
                                                          self.subject):
                return False
        return True

    def take(self, rng: random.Random) -> bool:
        """Count one matching event; decide whether the rule fires on it."""
        if self.times is not None and self.fired >= self.times:
            return False
        self.seen += 1
        if self.seen <= self.after:
            return False
        if self.prob is not None and rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


def parse_spec(spec: str) -> list[FaultRule]:
    rules: list[FaultRule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kw: dict[str, Any] = {}
        for item in part.split(","):
            key, _, val = item.strip().partition("=")
            if not _:
                raise ValueError(f"fault rule item needs key=value: {item!r}")
            if key == "times":
                kw[key] = None if val == "*" else int(val)
            elif key == "after":
                kw[key] = int(val)
            elif key in ("prob", "delay_s"):
                kw[key] = float(val)
            elif key in ("kind", "addr", "subject", "error"):
                kw[key] = val
            else:
                raise ValueError(f"unknown fault rule key: {key!r}")
        if kw.get("kind") not in _KINDS:
            raise ValueError(
                f"fault rule needs kind= one of {sorted(_KINDS)}: {part!r}")
        rules.append(FaultRule(**kw))
    return rules


class FaultInjector:
    """Holds the rule set + seeded rng; consulted from the hooks."""

    def __init__(self, rules: list[FaultRule], seed: int = 0) -> None:
        self.rules = rules
        self.rng = random.Random(seed)
        # kind → fire count, for test assertions
        self.fired: dict[str, int] = {}

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        return cls(parse_spec(spec), seed=seed)

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        spec = os.environ.get(ENV_SPEC)
        if not spec:
            return None
        inj = cls.from_spec(spec, seed=int(os.environ.get(ENV_SEED, "0")))
        logger.warning("fault injection ACTIVE: %d rule(s) from $%s",
                       len(inj.rules), ENV_SPEC)
        return inj

    def _fire(self, kinds: tuple[str, ...], addr: Optional[str],
              subject: Optional[str]) -> Optional[FaultRule]:
        for r in self.rules:
            if r.kind in kinds and r.matches(addr, subject) \
                    and r.take(self.rng):
                self.fired[r.kind] = self.fired.get(r.kind, 0) + 1
                return r
        return None

    # -- hook points ---------------------------------------------------------

    def on_offload(self, point: str = "kvbm.offload") -> Optional[tuple]:
        """Consulted by the KVBM offload worker before each drained
        batch. ("delay", s): the worker sleeps, simulating slow tier IO;
        ("stall",): the worker parks until cancelled — a stuck pipeline,
        which the bounded staging queue must absorb by falling back to
        inline eviction copies (pins released only at close)."""
        r = self._fire((OFFLOAD_DELAY, OFFLOAD_STALL), None, point)
        if r is None:
            return None
        if r.kind == OFFLOAD_DELAY:
            return ("delay", r.delay_s)
        return ("stall",)
