"""Runtime-resizable bucket ladders. Port of
`dynamo_tpu/engine/bucketing.py`'s `BucketLadder`.

The engine rounds ragged work up to a static shape family (`_next_bucket`
in `engine/engine.py`) so its bucketed steps stay cache-hot: in the
reference, jitted programs; here, the CUDA graph captured per bucket
(`engine/graphs.py`). A bucket autotuner wants to insert extra rungs
*between* those static buckets when a shape burns padded tokens — but a
rung change mid-step would race the scheduler, and a rung change per tick
would thrash the compile tracker (each new rung is a new capture).

`BucketLadder` is the safe-point mailbox between the two: a controller
stages a new rung set with `propose()` from its own task, and the
*consumer* (the scheduler loop, between dispatches) calls `maybe_apply()`
to swap it in. Until an engine has a ladder installed
(`engine.bucket_ladder is None`, the default), the bucketing math is
untouched — the unarmed path stays byte-identical.
"""

from __future__ import annotations

import threading


class BucketLadder:
    """A small, bounded set of extra bucket rungs, swapped at safe points."""

    def __init__(self, max_rungs: int = 8):
        self.max_rungs = max_rungs
        self.rungs: tuple[int, ...] = ()
        self.proposals = 0      # propose() calls that staged a change
        self.applied = 0        # maybe_apply() calls that swapped
        self._pending: tuple[int, ...] | None = None
        self._lock = threading.Lock()

    # -- controller side ----------------------------------------------------

    def propose(self, rungs) -> bool:
        """Stage a new rung set; the consumer swaps it in at a safe point.

        Returns True if a change was staged (normalized set differs from
        the current *and* any already-pending one).
        """
        new = tuple(sorted({int(r) for r in rungs if int(r) > 0}))
        new = new[: self.max_rungs]
        with self._lock:
            if new == self.rungs and self._pending is None:
                return False
            if self._pending == new:
                return False
            self._pending = new
            self.proposals += 1
            return True

    # -- consumer side (scheduler loop, between dispatches) -----------------

    def maybe_apply(self) -> bool:
        """Adopt a staged rung set, if any.  Call only at safe points."""
        with self._lock:
            if self._pending is None:
                return False
            self.rungs = self._pending
            self._pending = None
            self.applied += 1
            return True

    def bucket_for(self, n: int, base: int, *, lo: int = 1,
                   align: int = 1) -> int:
        """Smallest applied rung covering ``n``, else the engine's ``base``.

        A rung is usable when it covers the work (``n <= rung``), beats
        the static bucket (``rung < base``), and respects the engine's
        floor and alignment (page size for prefill buckets).
        """
        for rung in self.rungs:  # sorted ascending → first hit is smallest
            if rung < n or rung >= base or rung < lo:
                continue
            if align > 1 and rung % align:
                continue
            return rung
        return base

    def state(self) -> dict:
        with self._lock:
            return {
                "rungs": list(self.rungs),
                "pending": list(self._pending) if self._pending is not None
                           else None,
                "proposals": self.proposals,
                "applied": self.applied,
            }
