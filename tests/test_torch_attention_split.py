"""The bf16 paged-attention core's work split, on the CPU.

`dynamo_tpu_torch/engine/paged_core.py` mirrors the integer arithmetic the
kernel (`csrc/paged_attention.cuh`) does on the device: tiles of one
lane's rows, items (tile, KV head) weighted by their visible pages, CTA c
of m = min(n, W) owning the window [c·W/m, (c+1)·W/m) and running the
pieces of B = ceil(W/m) pages that start in it, partial slots and ticket
counts. These tests pin that every visible page of every (tile, KV head)
is covered exactly once, that no CTA runs more than its window and one
piece, that the partial slots of split items never collide and
their tickets count their pieces, and that identical lanes are cut alike
(so their outputs are bit-identical).
"""

import random

import pytest

from dynamo_tpu_torch.engine import paged_core


def _check_split(tile_pages, kvh, n_ctas):
    segs = paged_core.work_split(tile_pages, kvh, n_ctas)
    total = kvh * sum(tile_pages)
    working = min(n_ctas, total)
    b = window = -(-total // working) if total else 0
    covered, slots = {}, {}
    for c, cta in enumerate(segs):
        # its window's units, plus what its last piece runs past the window
        assert sum(p1 - p0 for _, _, p0, p1, _ in cta) <= window + b
        for ti, g, p0, p1, slot in cta:
            assert 0 <= p0 < p1 <= tile_pages[ti] and p1 - p0 <= b
            assert p0 % b == 0                    # cut from the item's start
            for p in range(p0, p1):
                assert (ti, g, p) not in covered, "a page covered twice"
                covered[(ti, g, p)] = c
            if slot >= 0:
                assert slot not in slots
                assert slot < 2 * n_ctas
                slots[slot] = (ti, g, p0)
    want = {(ti, g, p) for ti, n in enumerate(tile_pages)
            for g in range(kvh) for p in range(n)}
    assert set(covered) == want
    assert not any(segs[working:])
    # an item's ticket counts its pieces: ceil(pages / B), in any CTAs
    pieces = {}
    for cta in segs:
        for ti, g, _, _, _ in cta:
            pieces[(ti, g)] = pieces.get((ti, g), 0) + 1
    assert pieces == {(ti, g): -(-n // b) for ti, n in enumerate(tile_pages)
                      for g in range(kvh) if n}
    return segs


@pytest.mark.parametrize("lengths,kvh,n_ctas", [
    ([4096] + [1] * 7, 8, 264),          # one long lane beside 1-token lanes
    ([44, 73, 133, 233, 383, 653, 853, 1033], 8, 264),   # the burst shape
    ([1], 1, 264),                       # more CTAs than work
    ([2, 3, 1], 2, 264),
    ([16, 15, 17, 32, 0, 33, 0, 1], 8, 7),   # page edges, empty lanes
    ([300, 5, 1000], 2, 3),
])
def test_decode_split_covers_every_page_once(lengths, kvh, n_ctas):
    p, max_pages = 16, 512
    tl = paged_core.tiles([n - 1 for n in lengths], None, 16, p, max_pages)
    assert [t[0] for t in tl] == list(range(len(lengths)))
    assert [t[3] for t in tl] == [-(-n // p) for n in lengths]
    _check_split([t[3] for t in tl], kvh, n_ctas)


def test_all_lanes_empty_give_no_work():
    tl = paged_core.tiles([-1] * 8, None, 16, 16, 64)
    segs = paged_core.work_split([t[3] for t in tl], 8, 264)
    assert all(not s for s in segs)


def test_mixed_round_tiles_and_split():
    """The ragged path's mixed round: a 512-row chunk at positions
    512..1023, 8 decode rows, 248 padding rows; at G = 4 a tile holds
    TILE_MMA_ROWS / 4 chunk rows."""
    ctx = [41, 70, 130, 230, 380, 650, 850, 1030]
    qpos = list(range(512, 1024)) + [c - 1 for c in ctx] + [-1] * 248
    lanes = [0] * 512 + list(range(8, 16)) + [0] * 248
    rows = paged_core.tile_rows(32, 8)
    assert rows == paged_core.TILE_MMA_ROWS // 4
    n = 512 // rows
    tl = paged_core.tiles(qpos, lanes, rows, 16, 512)
    assert [t[1] for t in tl[:n]] == [rows] * n
    assert [t[3] for t in tl[:n]] == [(512 + rows * (j + 1) - 1) // 16 + 1
                                      for j in range(n)]
    assert [(t[1], t[3]) for t in tl[n:n + 8]] == \
        [(1, -(-c // 16)) for c in ctx]
    assert all(t[3] == 0 for t in tl[n + 8:])
    assert sum(t[1] for t in tl) == len(qpos)
    _check_split([t[3] for t in tl], 8, 264)


@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_tiles_stay_inside_aligned_blocks(group):
    """Chunks that straddle the aligned row blocks, lanes interleaved, and
    non-monotone positions: a tile never crosses a block or a lane change,
    and its pages are those of its deepest row."""
    rng = random.Random(group)
    rows = paged_core.tile_rows(group * 4, 4)
    qpos, lanes = [], []
    for lane in range(6):
        n = rng.randrange(1, 3 * rows)
        start = rng.randrange(0, 200)
        qpos += [start + i for i in range(n)]
        lanes += [lane] * n
    qpos[3] = -1
    qpos[5], qpos[6] = qpos[6], qpos[5]
    tl = paged_core.tiles(qpos, lanes, rows, 4, 40)
    t = 0
    for s, nr, lane, pages in tl:
        assert s == t and 1 <= nr <= rows
        assert s // rows == (s + nr - 1) // rows
        assert all(lanes[i] == lane for i in range(s, s + nr))
        deepest = max(qpos[s:s + nr])
        assert pages == (0 if deepest < 0 else min(deepest // 4 + 1, 40))
        t += nr
    assert t == len(qpos)


def test_identical_lanes_are_cut_alike():
    """Two lanes with the same context, anywhere in the batch, get the same
    pieces relative to their own start: the kernel then reduces them in
    the same order, and identical requests stay token-identical."""
    lengths = [1033, 44, 73, 1033, 133, 653, 1033, 853]
    tl = paged_core.tiles([n - 1 for n in lengths], None, 16, 16, 512)
    segs = _check_split([t[3] for t in tl], 8, 264)
    cuts = {}
    for cta in segs:
        for ti, g, p0, p1, _ in cta:
            cuts.setdefault((ti, g), []).append((p0, p1))
    same = [ti for ti, n in enumerate(lengths) if n == 1033]
    for g in range(8):
        assert len({tuple(sorted(cuts[(ti, g)])) for ti in same}) == 1


@pytest.mark.parametrize("seed", range(6))
def test_random_splits(seed):
    rng = random.Random(seed)
    pages = [rng.choice([0, 1, 2, 5, 17, 64, 300]) for _ in
             range(rng.randrange(1, 40))]
    if not sum(pages):
        pages[0] = 3
    _check_split(pages, rng.choice([1, 2, 8]), rng.choice([1, 5, 132, 264]))


def test_core_gate():
    ok = paged_core.core_supported
    assert ok(32, 8, 16, 128)
    assert ok(12, 4, 16, 96) and ok(8, 1, 64, 128) and ok(4, 4, 1, 16)
    assert not ok(64, 4, 16, 128)        # 16 heads per KV head
    assert not ok(32, 8, 12, 128)        # page not a power of two
    assert not ok(32, 8, 128, 128)       # page over 64 keys
    assert not ok(32, 8, 16, 80)         # head_dim not built
    assert not ok(6, 4, 16, 128)         # partial GQA group
