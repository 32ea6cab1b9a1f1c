"""Deterministic, spec-driven fault injection.

Port of `dynamo_tpu/runtime/faults.py` (the port keeps its own copy).
Every recovery path of the runtime (deadline and migration, breaker-aware
re-routing, the disagg local-serve fallback, the store-outage snapshot)
exists because something on the wire misbehaved; real crashes alone make
those paths unreproducible. This module injects seeded faults at exact
trigger points, and every kind that parses fires at a hook of the port:

  * the transport client (`runtime/transport.py`): `check_connect` before
    each dial, `on_frame` on each response frame it receives;
  * a served engine wrapped in `FaultyEngine`: `on_engine_call`;
  * the in-process store (`runtime/store.py` MemoryStore): `on_store_op`
    before each operation, with the lease reaper paused while
    `outage_active()`;
  * KVBM's offload worker (`kvbm/manager.py`): `on_offload`;
  * the engines' schedulers (`engine/engine.py`, `mocker/engine.py`):
    `on_dispatch` once per iteration.

Spec grammar (``DYN_FAULTS`` env var, ``--faults`` on every component,
or `FaultInjector.from_spec`):

    spec  := rule (';' rule)*
    rule  := key '=' value (',' key '=' value)*

    kind=connect_refused   dial to a matching addr raises ConnectionRefusedError
    kind=disconnect        matching response frame kills the whole connection
    kind=stall             matching stream goes silent from this frame on
                           (frames are swallowed; the socket stays open)
    kind=delay             matching frame is delivered after `delay_s` seconds
    kind=err               matching frame is replaced by an error frame
    kind=engine_err        FaultyEngine raises before yielding
    kind=engine_stall      FaultyEngine hangs (until context cancel)
    kind=offload_delay     KVBM offload worker sleeps `delay_s` before a
                           drained batch's gather (slow tier pipeline)
    kind=offload_stall     KVBM offload worker parks forever (stuck
                           pipeline; the bounded staging queue then
                           backpressures evictions into the inline path)
    kind=dispatch_wedge    the engine's scheduler parks mid-dispatch with
                           work pending: the dispatch watchdog
                           (engine/watchdog.py) must detect it and
                           quarantine the worker
    kind=oom               a matching dispatch raises a synthetic
                           RESOURCE_EXHAUSTED: the memory ledger's OOM
                           forensics (engine/memory.py) dump a crash file
                           and exit rc 45 when armed
    kind=store_outage      matching control-plane store ops raise
                           ConnectionError: the coordinator is
                           unreachable; routers keep serving from their
                           last-known instances

    addr=<glob>            match the dialed/peer address   (default *)
    subject=<glob>         match the request subject       (default *)
    after=<n>              skip the first n matching events (default 0)
    times=<k | *>          fire at most k times, * = unlimited (default 1)
    prob=<p>               fire with probability p from the SEEDED rng
                           (composes with after/times; default always)
    delay_s=<seconds>      for the delay kinds (default 0.05)
    error=<msg>            message for err/engine_err (default "injected error")

Example: refuse the first two dials to one worker and stall the third
response stream of any generate endpoint:

    DYN_FAULTS="kind=connect_refused,addr=127.0.0.1:7001,times=2;\
kind=stall,subject=*.generate-*,after=2"

Determinism: trigger counts are exact; the only randomness is `prob`,
drawn from ``random.Random(DYN_FAULTS_SEED)`` (default 0), so a fixed
(spec, seed, request order) triple replays the same faults.
"""

from __future__ import annotations

import fnmatch
import logging
import os
import random
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Optional

logger = logging.getLogger(__name__)

ENV_SPEC = "DYN_FAULTS"
ENV_SEED = "DYN_FAULTS_SEED"

# frame-level fault kinds (client rx path)
CONNECT_REFUSED = "connect_refused"
DISCONNECT = "disconnect"
STALL = "stall"
DELAY = "delay"
ERR = "err"
# engine-level fault kinds (FaultyEngine)
ENGINE_ERR = "engine_err"
ENGINE_STALL = "engine_stall"
# KVBM pipeline fault kinds (kvbm/manager.py offload worker)
OFFLOAD_DELAY = "offload_delay"
OFFLOAD_STALL = "offload_stall"
# self-healing fault kinds (engine/watchdog.py, runtime/store.py)
DISPATCH_WEDGE = "dispatch_wedge"
STORE_OUTAGE = "store_outage"
# OOM forensics fault kind (engine/memory.py)
OOM = "oom"

_KINDS = {CONNECT_REFUSED, DISCONNECT, STALL, DELAY, ERR,
          ENGINE_ERR, ENGINE_STALL, OFFLOAD_DELAY, OFFLOAD_STALL,
          DISPATCH_WEDGE, STORE_OUTAGE, OOM}

# the text of the synthetic OOM an `oom` rule raises (the reference
# mocker's), which `engine/memory.py` is_resource_exhausted matches
OOM_ERROR = "[fault] RESOURCE_EXHAUSTED: out of memory (injected oom)"


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
    """Holds the rule set + seeded rng; consulted from the transport hooks.

    Frame actions returned by `on_frame` (interpreted by `_Connection`):
      None            deliver normally
      ("drop",)       swallow the frame (stalled stream)
      ("kill",)       tear the connection down (mid-stream disconnect)
      ("delay", s)    deliver after s seconds
      ("err", msg)    replace with an error frame
    """

    def __init__(self, rules: list[FaultRule], seed: int = 0) -> None:
        self.rules = rules
        self.rng = random.Random(seed)
        # kind → fire count, for test assertions
        self.fired: dict[str, int] = {}
        # streams a `stall` rule has black-holed (client request ids)
        self._stalled: set[str] = set()

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

    def check_connect(self, addr: str) -> None:
        """Called before dialing `addr`; raises to refuse the connection."""
        if self._fire((CONNECT_REFUSED,), addr, None) is not None:
            raise ConnectionRefusedError(f"[fault] connect refused: {addr}")

    def on_frame(self, addr: str, subject: Optional[str], rid: Optional[str],
                 msg: dict) -> Optional[tuple]:
        if rid is not None and rid in self._stalled:
            return ("drop",)
        r = self._fire((DISCONNECT, STALL, DELAY, ERR), addr, subject)
        if r is None:
            return None
        if r.kind == DISCONNECT:
            return ("kill",)
        if r.kind == STALL:
            if rid is not None:
                self._stalled.add(rid)
            return ("drop",)
        if r.kind == DELAY:
            return ("delay", r.delay_s)
        return ("err", r.error)

    def on_engine_call(self, subject: str) -> Optional[tuple]:
        r = self._fire((ENGINE_ERR, ENGINE_STALL), None, subject)
        if r is None:
            return None
        if r.kind == ENGINE_ERR:
            return ("err", r.error)
        return ("stall",)

    def on_dispatch(self, subject: str) -> Optional[tuple]:
        """Consulted by the engine's scheduler once per iteration
        (`subject` = "dispatch.<worker_id>"). ("wedge",): the scheduler
        parks until cancelled — a wedged device dispatch with work
        pending, what the dispatch watchdog exists to catch. ("oom",): the
        scheduler raises a synthetic RESOURCE_EXHAUSTED (`OOM_ERROR`),
        which the memory ledger's forensic path catches."""
        r = self._fire((DISPATCH_WEDGE, OOM), None, subject)
        if r is None:
            return None
        return ("oom",) if r.kind == OOM else ("wedge",)

    def on_store_op(self, op: str, key: Optional[str] = None
                    ) -> Optional[tuple]:
        """Consulted by the control-plane store before each operation
        (`subject` = "store.<op>", e.g. "store.put"). ("outage",): the
        op must raise ConnectionError — the coordinator is unreachable.
        `key` matches the rule's addr glob so a spec can target one
        keyspace (addr=v1/instances/*)."""
        r = self._fire((STORE_OUTAGE,), key, f"store.{op}")
        if r is None:
            return None
        return ("outage",)

    def outage_active(self) -> bool:
        """True while any store_outage rule can still fire — the store's
        lease reaper pauses expiry during an outage (a down coordinator
        expires nothing; keepalives simply never arrive)."""
        return any(r.kind == STORE_OUTAGE
                   and (r.times is None or r.fired < r.times)
                   for r in self.rules)

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


class FaultyEngine:
    """Wrap a served engine so the injector can fail/hang its requests —
    the handler-side analog of the wire faults (wedged-but-connected
    worker, erroring engine) for canary/deregistration tests."""

    def __init__(self, inner, injector: FaultInjector, subject: str) -> None:
        self.inner = inner
        self.injector = injector
        self.subject = subject

    async def generate(self, request: Any, context=None
                       ) -> AsyncIterator[Any]:
        import asyncio

        action = self.injector.on_engine_call(self.subject)
        if action is not None:
            if action[0] == "err":
                raise RuntimeError(f"[fault] {action[1]}")
            # silent stall: hold the stream open until the caller gives up
            # (probe timeout / deadline) and cancels us
            await asyncio.Event().wait()
        async for item in self.inner.generate(request, context):
            yield item
