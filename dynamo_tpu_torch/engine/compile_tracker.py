"""Compile attribution: first-call-per-shape tracking at the engine's
bucketed step entries. Port of `dynamo_tpu/engine/compile_tracker.py`,
with the same counters, events and `track(entry, shape)` keys.

The reference jits every step entry, and JAX compiles it once per
input-shape signature; the engine bounds that set by bucketing batch and
token widths before dispatch (`_next_bucket` / `_next_pow2`), so the FIRST
call per (entry, bucketed-shape) key is the call that pays the compile.
The port's counterpart of a jitted entry at a fixed bucket is a CUDA graph
captured at that bucket (`engine/graphs.py`): on the card, a recorded
event is that (entry, bucket)'s capture, and its seconds are the whole
first dispatch (warm-up, capture and first replay). The entries that stay
eager record the same keys, and on the CPU every entry does, so the port's
bucket family can be held against the JAX engine's.

First-seen-key is exact given the bucketing, and it is cheap: the warm
path is one set lookup. The wall time of an event is an upper bound, but
it is the quantity that hit the request that triggered it, which is what
ITL-outlier attribution needs.

Counters are fully named (`dynamo_compile_total`,
`dynamo_compile_seconds_total`) and adopted into a `MetricsRegistry` via
`register(...)`, so the engine counts captures before any runtime wiring
exists.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from dynamo_tpu_torch.runtime.metrics import Counter, MetricsRegistry


def _shape_label(shape) -> str:
    """Stable label for a shape-bucket key: '8x512' style."""
    if isinstance(shape, (tuple, list)):
        return "x".join(str(s) for s in shape)
    return str(shape)


class _Track:
    """One tracked dispatch. Usable as a context manager from any thread
    (dispatch closures run under asyncio.to_thread); `.compiled` and
    `.elapsed_s` are valid after exit."""

    __slots__ = ("_tracker", "entry", "shape", "compiled", "elapsed_s",
                 "_t0")

    def __init__(self, tracker: "CompileTracker", entry: str,
                 shape) -> None:
        self._tracker = tracker
        self.entry = entry
        self.shape = shape
        self.compiled = (entry, shape) not in tracker._seen
        self.elapsed_s = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "_Track":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.elapsed_s = time.perf_counter() - self._t0
        if self.compiled and exc is None:
            self._tracker._record(self)


class CompileTracker:
    def __init__(self, history: int = 64) -> None:
        self._seen: set[tuple] = set()
        self._lock = threading.Lock()
        self.compile_total = Counter(
            "dynamo_compile_total",
            "Step compile events (first call per entry+shape bucket; on "
            "the card, the capture of its CUDA graph)")
        self.compile_seconds = Counter(
            "dynamo_compile_seconds_total",
            "Wall seconds of first-call dispatches (capture + first "
            "replay on the card)")
        self.events: deque[dict] = deque(maxlen=history)

    def track(self, entry: str, shape) -> _Track:
        """Wrap one bucketed step dispatch:

            trk = tracker.track("decode_burst", (b, k))
            with trk:            # inside the dispatch closure is fine
                out = decode_multi_step(...)
            # trk.compiled → this call paid the (entry, shape) capture
        """
        return _Track(self, entry, tuple(shape) if isinstance(
            shape, (tuple, list)) else (shape,))

    def _record(self, trk: _Track) -> None:
        with self._lock:
            key = (trk.entry, trk.shape)
            if key in self._seen:
                return              # raced: another thread recorded it
            self._seen.add(key)
        label = _shape_label(trk.shape)
        self.compile_total.inc(entry=trk.entry, shape=label)
        self.compile_seconds.inc(trk.elapsed_s, entry=trk.entry,
                                 shape=label)
        self.events.append({"entry": trk.entry, "shape": label,
                            "seconds": trk.elapsed_s,
                            "at": time.time()})

    @property
    def total(self) -> int:
        with self._lock:
            return len(self._seen)

    def register(self, registry: MetricsRegistry) -> None:
        registry.register(self.compile_total)
        registry.register(self.compile_seconds)
