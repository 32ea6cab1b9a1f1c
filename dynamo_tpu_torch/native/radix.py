"""ctypes wrapper: C++ RadixTree with the Python RadixTree's interface.

Port of `dynamo_tpu/native/radix.py` (the port keeps its own copy).
Drop-in for `dynamo_tpu_torch.router.indexer.RadixTree` (same methods,
same semantics, differential-tested); `make_radix_tree()` picks the
native build when available, else the Python tree, and the first choice
of a process is logged once with the library's build seconds.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Iterable, Optional, Sequence

from dynamo_tpu_torch.protocols import (
    KV_CLEARED,
    KV_REMOVED,
    KV_STORED,
    KvCacheEvent,
    StoredBlock,
)
from dynamo_tpu_torch.router.indexer import OverlapScores, RadixTree, WorkerKey
from dynamo_tpu_torch.tokens import SEED_HASH

logger = logging.getLogger(__name__)

_MASK = (1 << 64) - 1


def _u64(x: int) -> int:
    return x & _MASK


def _load():
    from dynamo_tpu_torch.native import build_and_load

    lib = build_and_load("radix")
    if lib is None:
        return None
    u64, u32, p = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p
    u64p, u32p = ctypes.POINTER(u64), ctypes.POINTER(u32)
    lib.rt_new.restype = p
    lib.rt_new.argtypes = [u64]
    lib.rt_free.argtypes = [p]
    lib.rt_clear.argtypes = [p]
    lib.rt_apply_stored.argtypes = [p, u64, u32, ctypes.c_int, u64,
                                    u64p, u64p, ctypes.c_size_t]
    lib.rt_apply_removed.argtypes = [p, u64, u32, u64p, ctypes.c_size_t]
    lib.rt_apply_cleared.argtypes = [p, u64, u32]
    lib.rt_find_matches.restype = ctypes.c_size_t
    lib.rt_find_matches.argtypes = [p, u64p, ctypes.c_size_t, u64p, u32p,
                                    u32p, ctypes.c_size_t, u32p]
    lib.rt_num_workers.restype = ctypes.c_size_t
    lib.rt_num_workers.argtypes = [p]
    lib.rt_workers.restype = ctypes.c_size_t
    lib.rt_workers.argtypes = [p, u64p, u32p, ctypes.c_size_t]
    lib.rt_block_count.restype = u64
    lib.rt_block_count.argtypes = [p, u64, u32]
    lib.rt_dump.restype = ctypes.c_size_t
    lib.rt_dump.argtypes = [p, u64p, u32p, u64p, u64p, u64p,
                            ctypes.c_size_t]
    return lib


_lib = None
_lib_tried = False
_bg_build = None


def native_radix_available() -> bool:
    """True once the native lib is loaded. The first call may COMPILE
    (g++, seconds): from sync code that happens inline; from inside a
    running event loop it is pushed to a background thread and this call
    reports False — callers fall back to the Python tree now and get the
    native one on the next construction (a cold-start frontend must not
    stall every in-flight request for a compile)."""
    global _lib, _lib_tried, _bg_build
    if _lib_tried:
        return _lib is not None
    from dynamo_tpu_torch.native import native_enabled

    if not native_enabled():
        _lib_tried = True
        return False

    import asyncio
    import threading

    from dynamo_tpu_torch.native import is_built

    try:
        asyncio.get_running_loop()
        inline = is_built("radix")  # a built library loads at once
    except RuntimeError:
        inline = True               # no loop: safe to compile inline
    if inline:
        _lib = _load()
        _lib_tried = True
        return _lib is not None
    # inside a loop: compile off-thread, once
    if _bg_build is None or not _bg_build.is_alive():
        def build():
            global _lib, _lib_tried
            _lib = _load()
            _lib_tried = True

        _bg_build = threading.Thread(target=build, daemon=True,
                                     name="radix-build")
        _bg_build.start()
        _bg_build.join(timeout=0.05)  # cached .so loads instantly
    return _lib_tried and _lib is not None


class CRadixTree:
    """Same interface as indexer.RadixTree, C++ underneath."""

    kind = "native"

    def __init__(self) -> None:
        assert native_radix_available(), "native radix not built"
        self._t = _lib.rt_new(_u64(SEED_HASH))
        # reusable call buffers: ctypes array construction dominates the
        # per-query cost otherwise (the tree walk itself is ~ns-scale)
        self._qcap = 256
        self._qbuf = (ctypes.c_uint64 * self._qcap)()
        self._wcap = 256
        self._wid = (ctypes.c_uint64 * self._wcap)()
        self._dp = (ctypes.c_uint32 * self._wcap)()
        self._sc = (ctypes.c_uint32 * self._wcap)()
        self._matched = ctypes.c_uint32(0)

    def __del__(self) -> None:
        t, self._t = getattr(self, "_t", None), None
        if t and _lib is not None:
            _lib.rt_free(t)

    # -- queries -----------------------------------------------------------

    def find_matches(self, local_hashes: Sequence[int]) -> OverlapScores:
        n = len(local_hashes)
        if n > self._qcap:
            self._qcap = max(n, self._qcap * 2)
            self._qbuf = (ctypes.c_uint64 * self._qcap)()
        self._qbuf[:n] = [_u64(h) for h in local_hashes]
        while True:
            k = _lib.rt_find_matches(
                self._t, self._qbuf, n, self._wid, self._dp, self._sc,
                self._wcap, ctypes.byref(self._matched))
            if k < self._wcap:
                break
            self._wcap *= 4  # truncated: room for every worker
            self._wid = (ctypes.c_uint64 * self._wcap)()
            self._dp = (ctypes.c_uint32 * self._wcap)()
            self._sc = (ctypes.c_uint32 * self._wcap)()
        wid, dp, sc = self._wid, self._dp, self._sc
        return OverlapScores(
            scores={(wid[i], dp[i]): sc[i] for i in range(k)},
            matched_blocks=self._matched.value)

    def workers(self) -> list[WorkerKey]:
        cap = max(16, _lib.rt_num_workers(self._t))
        wid = (ctypes.c_uint64 * cap)()
        dp = (ctypes.c_uint32 * cap)()
        k = _lib.rt_workers(self._t, wid, dp, cap)
        return sorted((int(wid[i]), int(dp[i])) for i in range(k))

    def block_count(self, worker: WorkerKey) -> int:
        return int(_lib.rt_block_count(self._t, _u64(worker[0]),
                                       worker[1]))

    # -- mutation ----------------------------------------------------------

    def apply_event(self, ev: KvCacheEvent) -> None:
        wid, dp = _u64(ev.worker_id), ev.dp_rank
        if ev.kind == KV_STORED:
            n = len(ev.blocks)
            seqs = (ctypes.c_uint64 * n)(
                *[_u64(b.seq_hash) for b in ev.blocks])
            locals_ = (ctypes.c_uint64 * n)(
                *[_u64(b.local_hash) for b in ev.blocks])
            has_parent = ev.parent_seq_hash is not None
            _lib.rt_apply_stored(
                self._t, wid, dp, int(has_parent),
                _u64(ev.parent_seq_hash or 0), seqs, locals_, n)
        elif ev.kind == KV_REMOVED:
            n = len(ev.seq_hashes)
            seqs = (ctypes.c_uint64 * n)(
                *[_u64(s) for s in ev.seq_hashes])
            _lib.rt_apply_removed(self._t, wid, dp, seqs, n)
        elif ev.kind == KV_CLEARED:
            _lib.rt_apply_cleared(self._t, wid, dp)

    def remove_worker(self, worker: WorkerKey) -> None:
        _lib.rt_apply_cleared(self._t, _u64(worker[0]), worker[1])

    def clear(self) -> None:
        _lib.rt_clear(self._t)

    # -- snapshot ----------------------------------------------------------

    def dump_events(self) -> list[KvCacheEvent]:
        cap = _lib.rt_dump(self._t, None, None, None, None, None, 0)
        if cap == 0:
            return []
        wid = (ctypes.c_uint64 * cap)()
        dp = (ctypes.c_uint32 * cap)()
        pseq = (ctypes.c_uint64 * cap)()
        seq = (ctypes.c_uint64 * cap)()
        local = (ctypes.c_uint64 * cap)()
        k = _lib.rt_dump(self._t, wid, dp, pseq, seq, local, cap)
        return [KvCacheEvent(
            kind=KV_STORED, worker_id=int(wid[i]), dp_rank=int(dp[i]),
            parent_seq_hash=int(pseq[i]),
            blocks=[StoredBlock(int(seq[i]), int(local[i]))])
            for i in range(k)]

    @classmethod
    def restore(cls, events: Iterable[KvCacheEvent]) -> "CRadixTree":
        tree = cls()
        for ev in events:
            tree.apply_event(ev)
        return tree


_announced: Optional[bool] = None


def make_radix_tree():
    """Native tree when built + enabled, else the Python tree. The kind
    that serves is logged once, and again only when it changes (a tree
    made while the library built off-thread is a Python one)."""
    global _announced
    native = native_radix_available()
    if native != _announced:
        _announced = native
        from dynamo_tpu_torch.native import build_seconds, native_enabled

        if native:
            secs = build_seconds.get("radix")
            logger.info("radix index: native C++ tree (%s)",
                        f"built in {secs:.2f} s" if secs is not None
                        else "library already built")
        else:
            logger.info("radix index: Python tree (%s)",
                        "DYN_NATIVE=0" if not native_enabled()
                        else "native library unavailable or building")
    return CRadixTree() if native else RadixTree()
