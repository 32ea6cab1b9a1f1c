"""Global prefix index: which worker holds which KV blocks.

Port of `dynamo_tpu/router/indexer.py` (the port keeps its own copy): the
pure-Python `RadixTree`, `KvIndexer` with its event-id gap count, and
`ApproxKvIndexer`. `KvIndexer` takes the native C++ tree
(`native/radix.cpp` through `native/radix.py` make_radix_tree) by default,
as the reference does; where it cannot be built, or with `DYN_NATIVE=0`,
the Python tree serves with the same results. Each tree names its
`kind` ("native" or "python"), which the router's index stats report.

Reference: `lib/llm/src/kv_router/indexer.rs` — `RadixTree` (:222) over
(worker × block-hash) with `find_matches` (:274) returning per-worker overlap
scores, `apply_event` (:331) ingesting stored/removed KV events, and
dump/restore as an event list (:491); `KvIndexer` (:786) is the event-driven
task owning the tree; `ApproxKvIndexer` (approx.rs:165) predicts cache
contents from routing decisions with a TTL when engines emit no events.

A worker is identified by ``(worker_id, dp_rank)`` — the reference's
`WorkerWithDpRank` (protocols.rs) — so each data-parallel rank is scored and
addressed individually.

The tree is keyed structurally by *local* (content) hashes along root→leaf
paths, while each node also records its *chained sequence hash* so removal
events (which carry sequence hashes) are O(1) via a lookup table.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from dynamo_tpu_torch.protocols import (
    KV_CLEARED,
    KV_REMOVED,
    KV_STORED,
    KvCacheEvent,
    StoredBlock,
)
from dynamo_tpu_torch.tokens import (
    SEED_HASH,
    compute_block_hashes,
    compute_seq_hashes,
)

WorkerKey = tuple[int, int]  # (worker_id, dp_rank)


@dataclass
class OverlapScores:
    """Per-worker count of consecutive prompt-prefix blocks already cached."""

    scores: dict[WorkerKey, int] = field(default_factory=dict)
    # Blocks of the query that matched *some* worker (depth of deepest match).
    matched_blocks: int = 0

    def best(self) -> tuple[Optional[WorkerKey], int]:
        if not self.scores:
            return None, 0
        w = max(self.scores, key=lambda k: self.scores[k])
        return w, self.scores[w]


class _Node:
    __slots__ = ("local_hash", "seq_hash", "parent", "children", "workers")

    def __init__(self, local_hash: int, seq_hash: int,
                 parent: Optional["_Node"]) -> None:
        self.local_hash = local_hash
        self.seq_hash = seq_hash
        self.parent = parent
        self.children: dict[int, _Node] = {}   # local_hash -> node
        self.workers: set[WorkerKey] = set()


class RadixTree:
    """Prefix tree over KV blocks across all workers (indexer.rs:222)."""

    kind = "python"

    def __init__(self) -> None:
        self.root = _Node(0, SEED_HASH, None)
        # (worker, seq_hash) -> node; a seq_hash can only denote one chain
        # position, but different workers may have applied divergent events,
        # so the node set per seq_hash is shared while membership is per-worker.
        self._by_seq: dict[int, _Node] = {SEED_HASH: self.root}
        self._worker_blocks: dict[WorkerKey, set[int]] = {}

    # -- queries -----------------------------------------------------------

    def find_matches(self, local_hashes: Sequence[int]) -> OverlapScores:
        """Walk the query's block hashes from the root; each node visited
        credits one block of overlap to every worker on that node
        (indexer.rs:274). Scores are *consecutive-prefix* depths because a
        worker absent from node i cannot be credited at node i+1 — its score
        simply stops growing (matches reference semantics where scores[w] is
        the last depth at which w appeared)."""
        scores: dict[WorkerKey, int] = {}
        node = self.root
        depth = 0
        for lh in local_hashes:
            child = node.children.get(lh)
            if child is None:
                break
            depth += 1
            for w in child.workers:
                # Only extend workers that matched every block so far.
                if scores.get(w, 0) == depth - 1:
                    scores[w] = depth
            node = child
        return OverlapScores(scores=scores, matched_blocks=depth)

    def workers(self) -> list[WorkerKey]:
        return sorted(self._worker_blocks)

    def block_count(self, worker: WorkerKey) -> int:
        return len(self._worker_blocks.get(worker, ()))

    # -- mutation ----------------------------------------------------------

    def apply_event(self, ev: KvCacheEvent) -> None:
        w: WorkerKey = (ev.worker_id, ev.dp_rank)
        if ev.kind == KV_STORED:
            parent = self._by_seq.get(
                ev.parent_seq_hash if ev.parent_seq_hash is not None
                else SEED_HASH)
            if parent is None:
                # Orphan chain: parent unknown (e.g. replayed after prune).
                # Reference logs + drops; we drop too.
                return
            node = parent
            for b in ev.blocks:
                child = node.children.get(b.local_hash)
                if child is None:
                    child = _Node(b.local_hash, b.seq_hash, node)
                    node.children[b.local_hash] = child
                    self._by_seq[b.seq_hash] = child
                child.workers.add(w)
                self._worker_blocks.setdefault(w, set()).add(b.seq_hash)
                node = child
        elif ev.kind == KV_REMOVED:
            for sh in ev.seq_hashes:
                self._remove(w, sh)
        elif ev.kind == KV_CLEARED:
            for sh in list(self._worker_blocks.get(w, ())):
                self._remove(w, sh)
            self._worker_blocks.pop(w, None)

    def _remove(self, w: WorkerKey, seq_hash: int) -> None:
        node = self._by_seq.get(seq_hash)
        if node is None:
            return
        node.workers.discard(w)
        blocks = self._worker_blocks.get(w)
        if blocks is not None:
            blocks.discard(seq_hash)
        self._prune(node)

    def _prune(self, node: _Node) -> None:
        while (node is not self.root and not node.workers
               and not node.children):
            parent = node.parent
            assert parent is not None
            parent.children.pop(node.local_hash, None)
            self._by_seq.pop(node.seq_hash, None)
            node = parent

    def remove_worker(self, worker: WorkerKey) -> None:
        """Drop every block of a dead worker (instance watch DELETE)."""
        self.apply_event(KvCacheEvent(
            kind=KV_CLEARED, worker_id=worker[0], dp_rank=worker[1]))

    def clear(self) -> None:
        self.root = _Node(0, SEED_HASH, None)
        self._by_seq = {SEED_HASH: self.root}
        self._worker_blocks = {}

    # -- snapshot (indexer.rs:491 dump/restore as events) -------------------

    def dump_events(self) -> list[KvCacheEvent]:
        out: list[KvCacheEvent] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                for w in child.workers:
                    out.append(KvCacheEvent(
                        kind=KV_STORED, worker_id=w[0], dp_rank=w[1],
                        parent_seq_hash=node.seq_hash,
                        blocks=[StoredBlock(child.seq_hash, child.local_hash)],
                    ))
                stack.append(child)
        return out

    @classmethod
    def restore(cls, events: Iterable[KvCacheEvent]) -> "RadixTree":
        tree = cls()
        for ev in events:
            tree.apply_event(ev)
        return tree


class KvIndexer:
    """Owns a RadixTree, fed by KV events; queried with raw token ids.

    Reference: indexer.rs:786 (channel-driven task). Here the event pump is
    a plain method — the router wires an event-bus subscription to it
    (kv_router.py) — so the hot query path has no task hops.
    """

    def __init__(self, block_size: int,
                 use_native: Optional[bool] = None) -> None:
        from dynamo_tpu_torch.native.radix import make_radix_tree

        self.block_size = block_size
        # native C++ tree when built (DYN_NATIVE=0 disables); identical
        # semantics enforced by the differential tests
        self.tree = RadixTree() if use_native is False \
            else make_radix_tree()
        self.events_applied = 0
        # per-worker event_id continuity: engines stamp stored/removed
        # events from a monotone counter, so a jump means the bus
        # dropped one and the index silently diverged from the worker's
        # real cache — placement overlap is skewed until the blocks
        # churn out. Events with id 0 (snapshot dumps, approx events)
        # carry no sequencing and are skipped.
        self._last_event_id: dict[WorkerKey, int] = {}
        self.gaps: dict[WorkerKey, int] = {}     # worker -> missed events
        self.on_gap = None       # callable(worker, missed) | None

    def apply_event(self, ev: KvCacheEvent) -> None:
        eid = getattr(ev, "event_id", 0) or 0
        if eid > 0:
            w: WorkerKey = (ev.worker_id, ev.dp_rank)
            last = self._last_event_id.get(w)
            if last is not None and eid > last + 1:
                missed = eid - last - 1
                self.gaps[w] = self.gaps.get(w, 0) + missed
                if self.on_gap is not None:
                    self.on_gap(w, missed)
            # eid <= last means the worker restarted (counter reset) or
            # a snapshot replayed — resync, no gap
            self._last_event_id[w] = eid
        self.tree.apply_event(ev)
        self.events_applied += 1

    def find_matches_for_tokens(self, tokens: Sequence[int]) -> OverlapScores:
        return self.tree.find_matches(
            compute_block_hashes(tokens, self.block_size))

    def remove_worker(self, worker: WorkerKey) -> None:
        # Purge the per-worker event cursor and gap counter along with
        # the blocks: a resynced or respawned worker restarts its
        # event_id sequence, and a stale cursor would mis-count the
        # reset as a gap (and keep dead workers in event_gaps forever).
        self.tree.remove_worker(worker)
        self._last_event_id.pop(worker, None)
        self.gaps.pop(worker, None)


class ApproxKvIndexer:
    """Predicted cache index for engines that publish no KV events.

    On each routing decision the router calls `process_routing_decision` and
    the chosen worker is *assumed* to hold the prompt's blocks for `ttl_secs`
    (reference approx.rs:165, default 120s TTL).
    """

    def __init__(self, block_size: int, ttl_secs: float = 120.0,
                 clock=time.monotonic) -> None:
        self.block_size = block_size
        self.ttl_secs = ttl_secs
        self._clock = clock
        self.tree = RadixTree()
        self._expiry: list[tuple[float, WorkerKey, int]] = []  # (t, w, seq_hash)
        # Latest deadline per (worker, seq_hash): re-routing the same prefix
        # refreshes the TTL, so a stale heap entry must not evict the block.
        self._deadline: dict[tuple[WorkerKey, int], float] = {}

    def find_matches_for_tokens(self, tokens: Sequence[int]) -> OverlapScores:
        self._expire()
        return self.tree.find_matches(
            compute_block_hashes(tokens, self.block_size))

    def process_routing_decision(self, worker: WorkerKey,
                                 tokens: Sequence[int]) -> None:
        self._expire()
        local = compute_block_hashes(tokens, self.block_size)
        seq = compute_seq_hashes(tokens, self.block_size)
        now = self._clock()
        parent = SEED_HASH
        for lh, sh in zip(local, seq):
            self.tree.apply_event(KvCacheEvent(
                kind=KV_STORED, worker_id=worker[0], dp_rank=worker[1],
                parent_seq_hash=parent, blocks=[StoredBlock(sh, lh)]))
            deadline = now + self.ttl_secs
            self._deadline[(worker, sh)] = deadline
            heapq.heappush(self._expiry, (deadline, worker, sh))
            parent = sh

    def remove_worker(self, worker: WorkerKey) -> None:
        self.tree.remove_worker(worker)
        for key in [k for k in self._deadline if k[0] == worker]:
            del self._deadline[key]

    def clear(self) -> None:
        self.tree.clear()
        self._expiry.clear()
        self._deadline.clear()

    def _expire(self) -> None:
        now = self._clock()
        while self._expiry and self._expiry[0][0] <= now:
            t, w, sh = heapq.heappop(self._expiry)
            latest = self._deadline.get((w, sh))
            if latest is None or latest > t:
                continue  # refreshed by a later routing decision, or gone
            del self._deadline[(w, sh)]
            self.tree.apply_event(KvCacheEvent(
                kind=KV_REMOVED, worker_id=w[0], dp_rank=w[1],
                seq_hashes=[sh]))
