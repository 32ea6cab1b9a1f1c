"""Host-side page allocator for the device KV cache: refcounted pages,
prefix-cache reuse by sequence hash, LRU eviction, KV event emission.

Port of `dynamo_tpu/engine/pages.py` (the port keeps its own copy), with
KVBM's seams: the offload hook (`evict_hook`), the pending-offload pins
and the lifecycle recorder (`kvbm/lifecycle.py`, None unless armed). This
class only tracks ownership — the device tensors are indexed by the page
ids it hands out.

Invariants:
- page 0 is scratch and is never allocated. Padding rows of a ragged
  round all write their K/V to page 0, offset 0; on the GPU those writes
  race (engine/kernels.py), which is harmless only because no sequence
  ever owns page 0, so no attention reads it unmasked.
- a page is *registered* once it holds a complete block and is then
  immutable and shareable (prefix reuse increments its refcount)
- refcount 0 + registered ⇒ inactive LRU, evictable; refcount 0 +
  unregistered ⇒ freed immediately
- KvCacheEvents are emitted exactly where the router's view must change:
  `stored` when a sealed page wins its seq_hash, `removed` when a
  registered page is evicted (or cleared), each stamped from one monotone
  event id per pool, so the router's index mirrors the cache and counts
  any event it missed
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

from dynamo_tpu_torch.protocols import (
    KV_REMOVED,
    KV_STORED,
    KvCacheEvent,
    StoredBlock,
)

EventSink = Callable[[KvCacheEvent], None]


class BlockStateInvalid(RuntimeError):
    """An illegal block-lifecycle transition (double release, registering
    a freed page, evicting an in-use block): each silent version would
    hand ANOTHER sequence's KV to a reader."""


PARTIAL = "partial"
COMPLETE = "complete"          # sealed, but another page owns the hash
REGISTERED = "registered"      # sealed + published in _registered


@dataclass
class _Page:
    page_id: int
    refcount: int = 0
    state: str = PARTIAL
    seq_hash: Optional[int] = None


class PagePool:
    def __init__(self, num_pages: int, page_size: int, worker_id: int = 0,
                 dp_rank: int = 0,
                 event_sink: Optional[EventSink] = None) -> None:
        self.num_pages = num_pages
        self.page_size = page_size
        self.worker_id = worker_id
        self.dp_rank = dp_rank
        self.event_sink = event_sink
        # KVBM offload hook: called with a BATCH of (page_id, seq_hash)
        # pairs just before registered pages are evicted, while their
        # device data is still intact — one call per eviction batch, so
        # the manager pays one gather, not one sync per page
        self.evict_hook: Optional[
            Callable[[list[tuple[int, int]]], None]] = None
        # KV lifecycle recorder (kvbm/lifecycle.py): None unless
        # DYN_KV_LIFECYCLE armed it; every touch is one `is not None`
        # check and never changes allocator behavior
        self.lifecycle = None
        # page 0 reserved as scratch: never in the free list
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._pages: dict[int, _Page] = {}
        self._registered: dict[int, int] = {}       # seq_hash -> page_id
        self._inactive: OrderedDict[int, None] = OrderedDict()  # LRU
        # pending-offload pins (the pipelined KVBM): the evict hook may
        # claim evicted registered pages instead of copying them inline.
        # A pinned page is out of _registered/_inactive/_free and is not
        # recycled until the offload worker's gather lands and releases
        # the pin; its device data stays intact because only allocated
        # pages are ever written.
        self._pending_offload: set[int] = set()
        self._event_ids = itertools.count(1)

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def active_pages(self) -> int:
        return self.capacity - len(self._free) - len(self._inactive)

    @property
    def used_pages(self) -> int:
        """Pages out of the free list: active plus cached (inactive)."""
        return self.capacity - len(self._free)

    @property
    def pending_offload_pages(self) -> int:
        """Pages pinned for a tier offload that has not landed. They
        count as active and used (their memory is taken) but free again
        without any sequence finishing, so the admission watermark nets
        them out."""
        return len(self._pending_offload)

    def usage(self) -> float:
        return self.active_pages / self.capacity if self.capacity else 1.0

    def match_prefix(self, seq_hashes: list[int]) -> list[int]:
        """Longest chain of registered pages covering the leading blocks."""
        out = []
        for h in seq_hashes:
            pid = self._registered.get(h)
            if pid is None:
                break
            out.append(pid)
        return out

    def acquire(self, page_id: int) -> None:
        page = self._pages.get(page_id)
        if page is None:
            raise BlockStateInvalid(
                f"acquire of freed/unknown page {page_id}")
        if page.refcount == 0:
            self._inactive.pop(page_id, None)
        page.refcount += 1

    def allocate_page(self) -> Optional[int]:
        """One fresh (writable) page; evicts the LRU inactive page if the
        free list is empty. An eviction may free nothing (the hook pinned
        the victim for a deferred offload): evict at most once and report
        exhaustion (None) rather than drain the whole LRU into pins; the
        caller retries once the offload worker recycles them."""
        if not self._free:
            if self._evict_many(1) != 1 or not self._free:
                return None
        pid = self._free.pop()
        self._pages[pid] = _Page(page_id=pid, refcount=1)
        if self.lifecycle is not None:
            self.lifecycle.on_allocate(pid)
        return pid

    def allocate_sequence(self, seq_hashes: list[int], total_len: int
                          ) -> Optional[tuple[list[int], int]]:
        """Pages for a new sequence of `total_len` tokens whose complete
        blocks hash to `seq_hashes`. Returns (page_ids, cached_len) or
        None if capacity is insufficient. Guarantees cached_len <
        total_len so at least one token is computed (its logits are
        needed)."""
        matched = self.match_prefix(seq_hashes)
        if len(matched) * self.page_size >= total_len:
            matched = matched[:(total_len - 1) // self.page_size]
        need_pages = (total_len + self.page_size - 1) // self.page_size
        fresh_needed = need_pages - len(matched)
        # acquire matched pages FIRST: they may sit in _inactive and must
        # leave the LRU before any eviction can pick them as victims
        for pid in matched:
            self.acquire(pid)
        pages = list(matched)
        if len(self._free) + len(self._inactive) < fresh_needed:
            self.release_sequence(pages)
            return None
        # pre-evict the whole deficit: one batched offload-hook call
        # instead of one device sync per page in the loop below
        deficit = fresh_needed - len(self._free)
        if deficit > 0:
            self._evict_many(deficit, cause="admission-deficit")
        for _ in range(fresh_needed):
            pid = self.allocate_page()
            # the hook pinned the victims for a deferred offload (evicted
            # but not freed): the estimate above was optimistic, and the
            # caller retries at a later step
            if pid is None:
                self.release_sequence(pages)
                return None
            pages.append(pid)
        if self.lifecycle is not None:
            for h in seq_hashes[:len(matched)]:
                self.lifecycle.on_hit(h, self.page_size)
        return pages, len(matched) * self.page_size

    def register_page(self, page_id: int, seq_hash: int, local_hash: int,
                      parent_seq_hash: int) -> None:
        """Seal a PARTIAL page (complete + immutable) and publish the
        stored event. The first writer of a seq_hash wins reuse; a page
        that loses it (the same content, prefilled beside the winner)
        publishes too, as the reference's does: the worker does hold the
        block, and the router's index applies the event idempotently."""
        page = self._pages.get(page_id)
        if page is None:
            raise BlockStateInvalid(
                f"register of freed/unknown page {page_id}")
        if page.seq_hash is not None:
            # re-registering the SAME content is legal; resealing with
            # different hashes is the corruption case
            if page.seq_hash != seq_hash:
                raise BlockStateInvalid(
                    f"page {page_id} already sealed as "
                    f"{page.seq_hash:#x}, re-register as {seq_hash:#x}")
            return
        page.seq_hash = seq_hash
        if self._registered.setdefault(seq_hash, page_id) == page_id:
            page.state = REGISTERED
        else:
            page.state = COMPLETE
        if self.lifecycle is not None:
            self.lifecycle.on_register(page_id, seq_hash)
        if self.event_sink is not None:
            self.event_sink(KvCacheEvent(
                kind=KV_STORED, worker_id=self.worker_id,
                dp_rank=self.dp_rank, event_id=next(self._event_ids),
                parent_seq_hash=parent_seq_hash,
                blocks=[StoredBlock(seq_hash, local_hash)]))
            if self.lifecycle is not None:
                self.lifecycle.on_kv_event(KV_STORED, 1)

    def release_sequence(self, page_ids: list[int]) -> None:
        for pid in page_ids:
            page = self._pages.get(pid)
            if page is None:
                continue
            if page.refcount <= 0:
                raise BlockStateInvalid(
                    f"release of page {pid} with refcount "
                    f"{page.refcount}")
            page.refcount -= 1
            if page.refcount > 0:
                continue
            if page.seq_hash is not None \
                    and self._registered.get(page.seq_hash) == pid:
                self._inactive[pid] = None       # reusable, evict-last
                self._inactive.move_to_end(pid)
            else:
                self._discard(page)

    def clear_inactive(self) -> int:
        """Drop every reusable cached page, publishing removed events so
        routers forget them too. In-flight (refcounted) pages stay. The
        KVBM offload hook does NOT fire: clearing means forgetting, not
        demoting to a slower tier."""
        return self._evict_many(len(self._inactive), fire_hook=False,
                                cause="clear")

    # -- pending-offload pins (the pipelined KVBM) --------------------------

    def pin_for_offload(self, page_ids: list[int]) -> None:
        """Claim eviction victims for a deferred tier copy. Legal ONLY
        from inside the evict hook, while the victims' device data is
        intact: pinned victims skip the free-list return at the end of
        `_evict_many` and are recycled by `release_offload_pin` once
        their gather lands."""
        for pid in page_ids:
            page = self._pages.get(pid)
            if page is None:
                raise BlockStateInvalid(
                    f"offload pin of freed/unknown page {pid}")
            if page.refcount != 0 or page.state == PARTIAL:
                raise BlockStateInvalid(
                    f"offload pin of page {pid} in state {page.state} "
                    f"refcount {page.refcount}")
            self._pending_offload.add(pid)
        if self.lifecycle is not None and page_ids:
            self.lifecycle.on_pin(len(page_ids))

    def release_offload_pin(self, page_ids: list[int]) -> None:
        """The deferred gather landed (or was abandoned): recycle the
        pinned pages. Idempotent — close paths may race the worker's own
        cleanup."""
        released = 0
        for pid in page_ids:
            if pid not in self._pending_offload:
                continue
            self._pending_offload.discard(pid)
            released += 1
            page = self._pages.get(pid)
            if page is not None:
                self._discard(page)
        if self.lifecycle is not None and released:
            self.lifecycle.on_unpin(released)

    def _discard(self, page: _Page) -> None:
        self._pages.pop(page.page_id, None)
        self._free.append(page.page_id)

    def _evict_many(self, n: int, fire_hook: bool = True,
                    cause: str = "capacity-pressure") -> int:
        """Evict up to n LRU inactive pages, with ONE offload-hook call
        for the whole batch (device data still intact when it fires).
        `fire_hook=False` for admin clears: drop, don't offload. `cause`
        only labels the lifecycle recorder's eviction (capacity-pressure
        = allocate_page, admission-deficit = allocate_sequence's
        pre-evict, clear = clear_inactive); it never changes the
        victims."""
        victims: list[_Page] = []
        while len(victims) < n and self._inactive:
            pid, _ = self._inactive.popitem(last=False)   # LRU
            victim = self._pages[pid]
            if victim.refcount != 0 or victim.state == PARTIAL:
                raise BlockStateInvalid(
                    f"evicting page {pid} in state {victim.state} "
                    f"refcount {victim.refcount}")
            victims.append(victim)
        registered = [p for p in victims if p.seq_hash is not None]
        if registered and fire_hook and self.evict_hook is not None:
            self.evict_hook([(p.page_id, p.seq_hash) for p in registered])
        for page in registered:
            self._registered.pop(page.seq_hash, None)
            if self.lifecycle is not None:
                self.lifecycle.on_evict(page.seq_hash, cause)
            if self.event_sink is not None:
                self.event_sink(KvCacheEvent(
                    kind=KV_REMOVED, worker_id=self.worker_id,
                    dp_rank=self.dp_rank, event_id=next(self._event_ids),
                    seq_hashes=[page.seq_hash]))
                if self.lifecycle is not None:
                    self.lifecycle.on_kv_event(KV_REMOVED, 1)
        for page in victims:
            # a hook that pinned the page owns its recycling
            if page.page_id in self._pending_offload:
                continue
            self._discard(page)
        return len(victims)
