"""Simulated paged KV cache: active/inactive pools, prefix reuse, LRU evict.

Port of `dynamo_tpu/mocker/kv_manager.py` (the port keeps its own copy):
blocks move between an active pool (refcounted, in use by running
requests) and an inactive pool (reusable by sequence hash, LRU-evicted
under pressure). It emits `stored` / `removed` / `cleared`-by-removal KV
events, hashed with the same `TokenBlockSequence` as the port's page pool
(`engine/pages.py`), so the router's radix index mirrors it as it mirrors
a real worker; the mocker just holds no device memory.

Reference: `lib/llm/src/mocker/kv_manager.rs:4-44`.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.protocols import (
    KV_REMOVED,
    KV_STORED,
    KvCacheEvent,
    StoredBlock,
)
from dynamo_tpu_torch.tokens import SEED_HASH, TokenBlockSequence


@dataclass
class _Block:
    seq_hash: int
    local_hash: int
    parent_seq_hash: int
    ref_count: int = 0


class MockKvManager:
    def __init__(self, total_blocks: int, block_size: int, worker_id: int = 0,
                 dp_rank: int = 0,
                 event_sink: Optional[Callable[[KvCacheEvent], None]] = None
                 ) -> None:
        self.total_blocks = total_blocks
        self.block_size = block_size
        self.worker_id = worker_id
        self.dp_rank = dp_rank
        self.event_sink = event_sink
        self._active: dict[int, _Block] = {}           # seq_hash -> block
        self._inactive: OrderedDict[int, _Block] = OrderedDict()  # LRU
        self._event_id = 0
        # KV lifecycle flight recorder (kvbm/lifecycle.py): None unless
        # DYN_KV_LIFECYCLE armed it (set by MockEngine); every touch is
        # one `is not None` check and never changes pool behavior
        self.lifecycle = None
        self._alloc_seq = 0      # synthetic page ids for the recorder

    # -- accounting --------------------------------------------------------

    @property
    def used_blocks(self) -> int:
        return len(self._active) + len(self._inactive)

    @property
    def active_blocks(self) -> int:
        return len(self._active)

    @property
    def free_blocks(self) -> int:
        return self.total_blocks - len(self._active)  # inactive are reclaimable

    def usage(self) -> float:
        return self.used_blocks / self.total_blocks if self.total_blocks else 0.0

    # -- events ------------------------------------------------------------

    def _emit(self, kind: str, blocks: list[_Block]) -> None:
        if self.event_sink is None or not blocks:
            return
        self._event_id += 1
        if kind == KV_STORED:
            ev = KvCacheEvent(
                kind=KV_STORED, worker_id=self.worker_id, dp_rank=self.dp_rank,
                event_id=self._event_id,
                parent_seq_hash=blocks[0].parent_seq_hash,
                blocks=[StoredBlock(b.seq_hash, b.local_hash) for b in blocks],
            )
        else:
            ev = KvCacheEvent(
                kind=KV_REMOVED, worker_id=self.worker_id,
                dp_rank=self.dp_rank, event_id=self._event_id,
                seq_hashes=[b.seq_hash for b in blocks],
            )
        self.event_sink(ev)
        if self.lifecycle is not None:
            self.lifecycle.on_kv_event(kind, len(blocks))

    # -- core ops ----------------------------------------------------------

    def prefix_match_blocks(self, seq: TokenBlockSequence) -> int:
        """How many leading blocks of `seq` are already cached (either pool)."""
        n = 0
        for b in seq.blocks:
            if b.seq_hash in self._active or b.seq_hash in self._inactive:
                n += 1
            else:
                break
        return n

    def can_allocate(self, n_new_blocks: int) -> bool:
        return len(self._active) + n_new_blocks <= self.total_blocks

    def blocks_to_activate(self, seq: TokenBlockSequence) -> int:
        """Blocks of `seq` that would newly enter the *active* pool on
        allocation — counts both uncached blocks and inactive-cached blocks
        (reactivation costs an active slot too). This is the number
        admission must check against capacity."""
        return sum(1 for b in seq.blocks if b.seq_hash not in self._active)

    def allocate_sequence(self, seq: TokenBlockSequence) -> bool:
        """Pin all complete blocks of `seq` into the active pool (prefill
        admission). Reuses cached blocks; evicts LRU inactive blocks to make
        room. Returns False (no change) if capacity is insufficient."""
        needed = []
        for b in seq.blocks:
            if b.seq_hash in self._active:
                continue
            if b.seq_hash in self._inactive:
                continue
            needed.append(b)
        # capacity check: active + reactivated-inactive + new must fit
        reactivate = [b.seq_hash for b in seq.blocks
                      if b.seq_hash in self._inactive]
        if len(self._active) + len(reactivate) + len(needed) > self.total_blocks:
            return False
        # evict LRU inactive to fit new blocks if the *pool* (active+inactive)
        # would overflow
        overflow = (self.used_blocks - len(reactivate)) + len(needed) \
            - self.total_blocks
        if overflow > 0:
            self._evict_lru(overflow, protect=set(reactivate),
                            cause="admission-deficit")
        stored: list[_Block] = []
        lc = self.lifecycle
        for b in seq.blocks:
            blk = self._active.get(b.seq_hash)
            if blk is not None:
                blk.ref_count += 1
                if lc is not None:
                    lc.on_hit(b.seq_hash, self.block_size)
                continue
            blk = self._inactive.pop(b.seq_hash, None)
            if blk is not None:
                blk.ref_count = 1
                self._active[b.seq_hash] = blk
                if lc is not None:
                    lc.on_hit(b.seq_hash, self.block_size)
                continue
            blk = _Block(b.seq_hash, b.local_hash, b.parent_seq_hash, 1)
            self._active[b.seq_hash] = blk
            stored.append(blk)
            if lc is not None:
                self._alloc_seq += 1
                lc.on_allocate(self._alloc_seq)
                lc.on_register(self._alloc_seq, b.seq_hash)
        self._emit(KV_STORED, stored)
        return True

    def append_block(self, seq_hash: int, local_hash: int,
                     parent_seq_hash: int) -> bool:
        """Add one newly-completed decode block for a running request."""
        lc = self.lifecycle
        if seq_hash in self._active:
            self._active[seq_hash].ref_count += 1
            if lc is not None:
                lc.on_hit(seq_hash, self.block_size)
            return True
        blk = self._inactive.pop(seq_hash, None)
        if blk is not None:
            blk.ref_count = 1
            self._active[seq_hash] = blk
            if lc is not None:
                lc.on_hit(seq_hash, self.block_size)
            return True
        if len(self._active) + 1 > self.total_blocks:
            return False
        if self.used_blocks + 1 > self.total_blocks:
            self._evict_lru(1)
        blk = _Block(seq_hash, local_hash, parent_seq_hash, 1)
        self._active[seq_hash] = blk
        if lc is not None:
            self._alloc_seq += 1
            lc.on_allocate(self._alloc_seq)
            lc.on_register(self._alloc_seq, seq_hash)
        self._emit(KV_STORED, [blk])
        return True

    def free_sequence(self, seq_hashes: list[int]) -> None:
        """Unpin a finished/preempted request's blocks → inactive (reusable)."""
        for sh in seq_hashes:
            blk = self._active.get(sh)
            if blk is None:
                continue
            blk.ref_count -= 1
            if blk.ref_count <= 0:
                del self._active[sh]
                self._inactive[sh] = blk
                self._inactive.move_to_end(sh)

    def _evict_lru(self, n: int, protect: Optional[set[int]] = None,
                   cause: str = "capacity-pressure") -> None:
        evicted = []
        for sh in list(self._inactive):
            if len(evicted) >= n:
                break
            if protect and sh in protect:
                continue
            evicted.append(self._inactive.pop(sh))
        if self.lifecycle is not None:
            for blk in evicted:
                self.lifecycle.on_evict(blk.seq_hash, cause)
        self._emit(KV_REMOVED, evicted)

    def clear(self) -> None:
        removed = list(self._inactive.values())
        self._inactive.clear()
        if self.lifecycle is not None:
            for blk in removed:
                self.lifecycle.on_evict(blk.seq_hash, "clear")
        self._emit(KV_REMOVED, removed)
