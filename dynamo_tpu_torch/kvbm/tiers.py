"""KVBM storage tiers: G2 host RAM + G3 local disk.

Port of `dynamo_tpu/kvbm/tiers.py` (the port keeps its own copy). A block
is a CPU tensor of shape ``(2, layers, kv_heads, page_size, head_dim)``
([k; v]) that owns its storage — never a slice of a gathered batch,
which would keep the whole batch alive behind one block. The disk tier
writes a block's raw bytes and keeps its dtype under the numpy name
("bfloat16"), so it needs no `ml_dtypes` (`runtime/tensors.py`).

Reference: `lib/llm/src/block_manager/block_manager.rs:63-75` (CacheLevel
G1..G4) and `offload.rs:86` (offload/onboard pipeline). The TPU analog
keeps G1 in the engine's device HBM page pool; this module owns the host
side. Blocks are immutable registered KV pages keyed by their chained
sequence hash (tokens.py).

Tier flow: evicted device pages land in :class:`HostTier`; when it
overflows, LRU blocks demote to :class:`DiskTier`; disk hits promote back
to host on access. :class:`TieredStore` composes the two behind one
get/put/match interface.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Optional

import torch

from dynamo_tpu_torch.runtime.tensors import DTYPES, tensor_bytes, tensor_from

logger = logging.getLogger(__name__)


class HostTier:
    """G2: host-RAM block store with LRU eviction (offload.rs:86 analog)."""

    def __init__(self, capacity_blocks: int) -> None:
        self.capacity = capacity_blocks
        self._blocks: OrderedDict[int, torch.Tensor] = OrderedDict()

    def __len__(self) -> int:
        return len(self._blocks)

    def contains(self, seq_hash: int) -> bool:
        return seq_hash in self._blocks

    def get(self, seq_hash: int) -> Optional[torch.Tensor]:
        data = self._blocks.get(seq_hash)
        if data is not None:
            self._blocks.move_to_end(seq_hash)
        return data

    def put(self, seq_hash: int, data: torch.Tensor
            ) -> list[tuple[int, torch.Tensor]]:
        """Insert; returns LRU (seq_hash, data) pairs displaced over
        capacity (for the caller to demote to the next tier)."""
        if seq_hash in self._blocks:
            self._blocks.move_to_end(seq_hash)
            return []
        self._blocks[seq_hash] = data
        displaced = []
        while len(self._blocks) > self.capacity:
            displaced.append(self._blocks.popitem(last=False))
        return displaced

    def clear(self) -> int:
        n = len(self._blocks)
        self._blocks.clear()
        return n

    def pop(self, seq_hash: int) -> Optional[torch.Tensor]:
        return self._blocks.pop(seq_hash, None)


class DiskTier:
    """G3: local-disk block store, one file per block, LRU by access.

    Blocks are written as raw bytes; dtype (its numpy name) and shape
    ride in the in-memory index, which is fine because the LRU order
    itself is in-memory state.
    """

    def __init__(self, capacity_blocks: int,
                 directory: Optional[str] = None) -> None:
        self.capacity = capacity_blocks
        if directory is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="dynamo_kvbm_")
            directory = self._tmp.name
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        # seq_hash -> (path, dtype_name, shape)
        self._lru: OrderedDict[int, tuple[str, str, tuple]] = OrderedDict()

    def __len__(self) -> int:
        return len(self._lru)

    def _path(self, seq_hash: int) -> str:
        return os.path.join(self.directory, f"{seq_hash & (2**64-1):016x}.kv")

    def contains(self, seq_hash: int) -> bool:
        return seq_hash in self._lru

    def put(self, seq_hash: int, data: torch.Tensor) -> None:
        if seq_hash in self._lru:
            self._lru.move_to_end(seq_hash)
            return
        path = self._path(seq_hash)
        raw, shape, dtype = tensor_bytes(data)
        with open(path, "wb") as f:
            f.write(raw)
        self._lru[seq_hash] = (path, dtype, tuple(shape))
        while len(self._lru) > self.capacity:
            _, (old, _, _) = self._lru.popitem(last=False)
            try:
                os.unlink(old)
            except OSError:
                pass

    def get(self, seq_hash: int) -> Optional[torch.Tensor]:
        entry = self._lru.get(seq_hash)
        if entry is None:
            return None
        self._lru.move_to_end(seq_hash)
        path, dtype, shape = entry
        try:
            with open(path, "rb") as f:
                raw = f.read()
            return tensor_from(raw, list(shape), dtype)
        except (OSError, ValueError, RuntimeError):
            logger.warning("kvbm disk block %x unreadable; dropping",
                           seq_hash)
            self._lru.pop(seq_hash, None)
            return None

    def pop(self, seq_hash: int) -> None:
        entry = self._lru.pop(seq_hash, None)
        if entry is not None:
            try:
                os.unlink(entry[0])
            except OSError:
                pass

    def clear(self) -> int:
        n = len(self._lru)
        for h in list(self._lru):
            self.pop(h)
        return n


class TieredStore:
    """Host + disk tiers behind one interface; disk hits promote to host.

    Thread-safe: the async KVBM pipeline (kvbm/manager.py) mutates the
    store from offload/prefetch worker threads while the scheduler
    coroutine and kvbm_pull serving threads read it, so every operation
    holds one re-entrant lock (re-entrant because a disk hit's promote
    path calls `put` from inside `get`)."""

    def __init__(self, host_blocks: int = 1024, disk_blocks: int = 0,
                 disk_dir: Optional[str] = None) -> None:
        self.host = HostTier(host_blocks)
        self.disk = DiskTier(disk_blocks, disk_dir) if disk_blocks else None
        self._lock = threading.RLock()
        # KV lifecycle flight recorder (kvbm/lifecycle.py): None unless
        # armed; set by KvbmManager. `_promoting` distinguishes the
        # nested put inside `get`'s disk-hit path (a g3→g2 promote)
        # from a fresh device offload (g1→g2 demote); it is only ever
        # flipped under self._lock, so concurrent puts cannot misfile.
        self.lifecycle = None
        self._promoting = False
        # fired after ANY mutation of the held-block set (insert, LRU
        # displacement/drop, promotion) — the distributed advert
        # subscribes so it can never over-claim for long. May fire from a
        # pipeline worker thread; subscribers must be thread-safe
        # (KvbmDistributed._schedule_publish hops to its event loop).
        self.on_change = None

    def _changed(self) -> None:
        if self.on_change is not None:
            self.on_change()

    def contains(self, seq_hash: int) -> bool:
        with self._lock:
            return self.host.contains(seq_hash) or (
                self.disk is not None and self.disk.contains(seq_hash))

    def put(self, seq_hash: int, data: torch.Tensor) -> None:
        with self._lock:
            lc = self.lifecycle
            fresh = lc is not None and not self.host.contains(seq_hash)
            displaced = self.host.put(seq_hash, data)
            if fresh:
                if self._promoting:
                    lc.on_promote(seq_hash, "g3", "g2")
                else:
                    lc.on_demote(seq_hash, "g1", "g2")
            for demoted_hash, demoted in displaced:
                if self.disk is not None:
                    if lc is not None:
                        if len(self.disk) >= self.disk.capacity \
                                and not self.disk.contains(demoted_hash):
                            # the disk LRU head falls off to make room
                            lc.on_drop(next(iter(self.disk._lru)), "g3")
                        lc.on_demote(demoted_hash, "g2", "g3")
                    self.disk.put(demoted_hash, demoted)
                elif lc is not None:
                    # disk-capacity unlinks and no-disk drops both
                    # shrink the set
                    lc.on_drop(demoted_hash, "g2")
        self._changed()

    def get(self, seq_hash: int) -> Optional[torch.Tensor]:
        with self._lock:
            data = self.host.get(seq_hash)
            if data is not None:
                return data
            if self.disk is None:
                return None
            data = self.disk.get(seq_hash)
            if data is not None:
                # promote: hot again, keep it a RAM copy away — and free
                # the disk slot (a lingering entry would double-count the
                # block against disk capacity and strand its file)
                self.disk.pop(seq_hash)
                self._promoting = True
                try:
                    self.put(seq_hash, data)   # fires _changed
                finally:
                    self._promoting = False
            return data

    def match_prefix(self, seq_hashes: list[int]) -> int:
        """Longest leading chain of blocks present in any tier."""
        with self._lock:
            n = 0
            for h in seq_hashes:
                if not self.contains(h):
                    break
                n += 1
            return n

    def clear(self, level: str = "all") -> dict:
        """Manual flush (reference controller ResetPool/ResetAll):
        level "g2" (host), "g3" (disk), or "all". Returns blocks dropped
        per tier."""
        with self._lock:
            dropped = {}
            if level in ("g2", "all"):
                dropped["g2"] = self.host.clear()
            if level in ("g3", "all") and self.disk is not None:
                dropped["g3"] = self.disk.clear()
            if dropped and self.lifecycle is not None:
                self.lifecycle.on_tier_clear(dropped)
        if dropped:
            self._changed()
        return dropped

    def occupancy(self) -> dict:
        with self._lock:
            out = {"g2": {"blocks": len(self.host),
                          "capacity": self.host.capacity}}
            if self.disk is not None:
                out["g3"] = {"blocks": len(self.disk),
                             "capacity": self.disk.capacity}
            return out

    def hashes(self) -> list[int]:
        """All block hashes across tiers (the distributed advert)."""
        with self._lock:
            out = list(self.host._blocks.keys())
            if self.disk is not None:
                out += [h for h in self.disk._lru.keys()
                        if h not in self.host._blocks]
            return out

    def resident_hashes(self, tier: str = "all"
                        ) -> dict[int, tuple[str, int]]:
        """Cheap residency snapshot for the prefix plane
        (router/prefix_plane.py `observe_tiers`): seq_hash ->
        ("host" | "disk", block bytes). One lock hold, no data copies —
        host bytes come from the live tensors, disk bytes from
        the in-memory dtype/shape index. A block in both tiers reports
        the host copy. `tier` restricts to "host" or "disk"."""
        with self._lock:
            out: dict[int, tuple[str, int]] = {}
            if tier in ("host", "all"):
                for h, arr in self.host._blocks.items():
                    out[h] = ("host", int(arr.nbytes))
            if tier in ("disk", "all") and self.disk is not None:
                for h, (_p, dtype, shape) in self.disk._lru.items():
                    if h in out:
                        continue
                    nbytes = DTYPES[dtype].itemsize
                    for d in shape:
                        nbytes *= int(d)
                    out[h] = ("disk", nbytes)
            return out
