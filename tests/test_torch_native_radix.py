"""The port's native radix index (`dynamo_tpu_torch/native/radix.cpp`
through `native/radix.py`): host C++, its own copy of the JAX package's,
behaviour unchanged.

- The JAX package's own cases (`tests/test_native_radix.py`: store, find,
  remove, clear, orphan parents, dump/restore, a randomized differential,
  the indexer's default, duplicate seq hashes with divergent parents), as
  written and on the port (`port_copy`).
- Three trees fed the same seeded event streams: the port's `CRadixTree`,
  the port's Python `RadixTree` and the reference's `CRadixTree` give the
  same workers, block counts, scores and matched blocks after every
  event, and a dump of any of them restores into each of them alike.
- `KvIndexer` takes the native tree by default; with `DYN_NATIVE=0` a
  process serves the Python tree, and says which in `kind`.
- The library builds with g++ under `_build/dynamo_tpu_torch/<source
  hash>/libradix.so` at the root of the checkout, through a temporary
  file renamed into place.
"""

import random

import pytest

from dynamo_tpu.native import radix as ref_radix
from dynamo_tpu_torch import native as t_native
from dynamo_tpu_torch.native import radix as t_radix
from dynamo_tpu_torch.protocols import (
    KV_CLEARED,
    KV_REMOVED,
    KV_STORED,
    KvCacheEvent,
    StoredBlock,
)
from dynamo_tpu_torch.router.indexer import KvIndexer, RadixTree
from dynamo_tpu_torch.tokens import SEED_HASH, chain_hash
from tests.test_torch_faults import port_copy, run_case

REF_CASES = ["test_basic_store_find_remove", "test_clear_and_remove_worker",
             "test_orphan_parent_dropped", "test_dump_restore_roundtrip",
             "test_randomized_differential",
             "test_indexer_uses_native_by_default",
             "test_duplicate_seq_hash_divergent_parents"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", REF_CASES)
def test_reference_native_case(case, pkg, request):
    import tests.test_native_radix as ref_cases

    run_case(ref_cases if pkg == "ref" else port_copy("test_native_radix"),
             case, request)


def _trees():
    """(port native, port Python, reference native)."""
    assert t_radix.native_radix_available()
    assert ref_radix.native_radix_available()
    return t_radix.CRadixTree(), RadixTree(), ref_radix.CRadixTree()


def _ref_event(ev: KvCacheEvent):
    from dynamo_tpu.protocols import KvCacheEvent as RefEvent

    return RefEvent.from_dict(ev.to_dict())


def _apply(trees, ev) -> None:
    for t in trees[:2]:
        t.apply_event(ev)
    trees[2].apply_event(_ref_event(ev))


def _views(t, queries) -> tuple:
    return (t.workers(), [t.block_count(w) for w in t.workers()],
            [(dict(t.find_matches(q).scores), t.find_matches(q).matched_blocks)
             for q in queries])


def _stream(seed: int, n: int = 400):
    """Seeded stored (fresh chains, extensions of live chains, orphans
    under unknown parents), removed (live tails and unknown hashes) and
    cleared events over 6 workers x 2 dp ranks; and queries over the
    chains stored."""
    rng = random.Random(seed)
    chains: list = []          # (locals, tail seq hash)
    events = []
    for _ in range(n):
        op = rng.random()
        w, dp = rng.randint(1, 6), rng.randint(0, 1)
        if op < 0.55 or not chains:
            locals_ = [rng.randint(1, 50) for _ in range(rng.randint(1, 5))]
            parent, base = None, []
            r = rng.random()
            if chains and r < 0.4:
                base, parent = rng.choice(chains)
            elif r < 0.5:
                parent = rng.getrandbits(63)        # an orphan chain
            seq = parent if parent is not None else SEED_HASH
            blocks = []
            for lh in locals_:
                seq = chain_hash(seq, lh)
                blocks.append(StoredBlock(seq, lh))
            chains.append((base + locals_, seq))
            events.append(KvCacheEvent(
                kind=KV_STORED, worker_id=w, dp_rank=dp,
                parent_seq_hash=parent, blocks=blocks))
        elif op < 0.85:
            events.append(KvCacheEvent(
                kind=KV_REMOVED, worker_id=w, dp_rank=dp,
                seq_hashes=[rng.choice(chains)[1], rng.getrandbits(63)]))
        else:
            events.append(KvCacheEvent(kind=KV_CLEARED, worker_id=w,
                                       dp_rank=dp))
    queries = [c[0] for c in chains[-40:]] + [
        [rng.randint(1, 50) for _ in range(6)] for _ in range(10)]
    return events, queries


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_three_trees_agree_on_seeded_streams(seed):
    trees = _trees()
    events, queries = _stream(seed)
    for i, ev in enumerate(events):
        _apply(trees, ev)
        if i % 20 == 0 or i == len(events) - 1:
            want = _views(trees[1], queries)
            assert _views(trees[0], queries) == want, i
            assert _views(trees[2], queries) == want, i


@pytest.mark.parametrize("seed", [11, 12])
def test_dump_restores_into_every_tree(seed):
    """A dump of any of the three trees restores into each of them with
    the same views (a dump keeps what a restore can rebuild in order, so
    the views are compared among restores, not with the live trees)."""
    trees = _trees()
    events, queries = _stream(seed, 200)
    for ev in events:
        _apply(trees, ev)
    views = []
    for src in trees:
        dump = [KvCacheEvent.from_dict(e.to_dict())
                for e in src.dump_events()]
        for t in (t_radix.CRadixTree.restore(dump), RadixTree.restore(dump),
                  ref_radix.CRadixTree.restore(
                      [_ref_event(e) for e in dump])):
            views.append(_views(t, queries))
    assert all(v == views[0] for v in views)
    assert views[0][0]                           # workers survived


def test_orphans_and_divergent_parents_across_packages():
    """An orphan chain (its parent never stored) indexes nothing; one seq
    hash stored under two parents by two workers, then removed, leaves
    the three trees alike."""
    trees = _trees()
    s = 999_999
    for ev in (
            KvCacheEvent(kind=KV_STORED, worker_id=1, parent_seq_hash=424242,
                         blocks=[StoredBlock(5, 7)]),
            KvCacheEvent(kind=KV_STORED, worker_id=1,
                         blocks=[StoredBlock(s, 10)]),
            KvCacheEvent(kind=KV_STORED, worker_id=1,
                         blocks=[StoredBlock(111, 20)]),
            KvCacheEvent(kind=KV_STORED, worker_id=2, parent_seq_hash=111,
                         blocks=[StoredBlock(s, 30)]),
            KvCacheEvent(kind=KV_REMOVED, worker_id=2, seq_hashes=[s])):
        _apply(trees, ev)
        want = _views(trees[1], [[7], [10], [20, 30], [20], [30]])
        assert _views(trees[0], [[7], [10], [20, 30], [20], [30]]) == want
        assert _views(trees[2], [[7], [10], [20, 30], [20], [30]]) == want
    assert trees[0].find_matches([7]).scores == {}


def test_indexer_native_by_default_and_off_with_dyn_native(monkeypatch):
    idx = KvIndexer(4)
    assert isinstance(idx.tree, t_radix.CRadixTree)
    assert idx.tree.kind == "native"
    assert KvIndexer(4, use_native=False).tree.kind == "python"
    # a fresh process with DYN_NATIVE=0: the library is never loaded
    monkeypatch.setattr(t_radix, "_lib", None)
    monkeypatch.setattr(t_radix, "_lib_tried", False)
    monkeypatch.setenv("DYN_NATIVE", "0")
    off = KvIndexer(4)
    assert type(off.tree) is RadixTree and off.tree.kind == "python"


def test_library_builds_under_build_dir(monkeypatch, tmp_path):
    """Keyed by the source's hash under `_build/dynamo_tpu_torch/`, beside
    the CUDA kernels; a cold build in an empty root writes through a
    temporary file, records its seconds and loads."""
    path = t_native.library_path("radix")
    root = t_native.BUILD_ROOT
    assert root.parts[-2:] == ("_build", "dynamo_tpu_torch")
    assert root.parent.parent == t_native._DIR.parents[1]
    assert path.parent.parent == root and path.name == "libradix.so"
    assert len(path.parent.name) == 16
    monkeypatch.setattr(t_native, "BUILD_ROOT", tmp_path / "b")
    monkeypatch.setattr(t_native, "_lib_cache", {})
    monkeypatch.setattr(t_native, "build_seconds", {})
    lib = t_native.build_and_load("radix")
    assert lib is not None and t_native.build_seconds["radix"] > 0
    built = t_native.library_path("radix")
    assert built.exists() and built.parent.parent == tmp_path / "b"
    assert [p.name for p in built.parent.iterdir()] == ["libradix.so"]
    assert built.parent.name == path.parent.name
