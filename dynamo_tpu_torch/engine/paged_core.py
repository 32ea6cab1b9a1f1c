"""What K1 and K4 share: the bf16 paged-attention core's geometry gate,
grid, persistent scratch and a plain mirror of its work split; the fp32
paths' split count; the card's SM count.

The bf16 core (`csrc/paged_attention.cuh`) divides the visible work of a
call among a grid fixed by shapes alone: items are (tile, KV head) in row
order, a tile being a run of up to 64/G consecutive rows of one lane
inside an aligned block of 64/G rows (K4: one row per lane), and an item's
work is the pages its deepest row can see. Of the W work units, CTA c <
m = min(n, W) owns the window [c·W/m, (c+1)·W/m); every item is cut into
pieces of B = ceil(W/m) pages from its own start and a CTA runs the
pieces that start in its window, so identical lanes are reduced
identically.
`tiles` and `work_split` below do the kernel's integer arithmetic in
Python, so the CPU tests can pin that every visible page is covered
exactly once, that no CTA runs more than its window and a piece, and
that the partial slots never collide.
"""

from __future__ import annotations

import functools

import torch

TILE_MMA_ROWS = 64          # kTileMmaRows: (row, head) pairs per tile
MAX_GROUP = 8               # kMaxGroup: query heads per KV head
HEAD_DIMS = (16, 32, 64, 96, 128)   # head_dim instances built
MAX_PAGE_SIZE = 64
CTAS_PER_SM = 2             # the core's grid: two CTAs per SM fit
# fp32 paths: split-KV when (rows x KV heads) is small — aim for this many
# CTAs per SM, with at least MIN_PAGES_PER_SPLIT pages of the table each
FP32_CTAS_PER_SM = 4
MIN_PAGES_PER_SPLIT = 2
MAX_SPLITS = 32


@functools.cache
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def num_splits(rows: int, n_kv_heads: int, max_pages: int,
               n_sms: int) -> int:
    """fp32 paths: splits per (row, KV head), 1 when the grid already fills
    the card, else enough for FP32_CTAS_PER_SM CTAs per SM. Rows divide
    their own visible pages among the splits."""
    base = max(rows * n_kv_heads, 1)
    want = FP32_CTAS_PER_SM * n_sms
    if base >= want:
        return 1
    return max(1, min(-(-want // base), max_pages // MIN_PAGES_PER_SPLIT,
                      MAX_SPLITS))


def core_supported(n_heads: int, n_kv_heads: int, page_size: int,
                   head_dim: int) -> bool:
    """Geometry the bf16 core takes: whole GQA groups of at most 8 heads,
    a built head_dim (rows of D bf16 in 16-byte copies), a
    power-of-two page of at most 64 keys."""
    if n_kv_heads <= 0 or n_heads % n_kv_heads:
        return False
    g = n_heads // n_kv_heads
    return (1 <= g <= MAX_GROUP and head_dim in HEAD_DIMS
            and 0 < page_size <= MAX_PAGE_SIZE
            and page_size & (page_size - 1) == 0)


def grid_ctas(device: torch.device) -> int:
    return CTAS_PER_SM * sm_count(device)


_SCRATCH: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
# scratch buffers a larger shape superseded: a CUDA graph captured before
# the growth still points at them, so none is ever freed
_RETIRED: list[torch.Tensor] = []


def grow_scratch(device: torch.device, old: torch.Tensor | None, make,
                 what: str) -> torch.Tensor:
    """`make()`, a larger scratch buffer to use in place of `old`, which
    is kept alive. Raises while the current stream is capturing a CUDA
    graph: the new buffer would belong to the graph's pool, so make one
    eager call at the shape before capturing it."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what}: scratch asked to grow while a CUDA "
                           f"graph is being captured; make one eager call "
                           f"at this shape first")
    if old is not None:
        _RETIRED.append(old)
    return make()


def core_scratch(device: torch.device, n_ctas: int, head_dim: int,
                 n_counters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(partials, counters) kept per device across calls: two partial
    slots of TILE_MMA_ROWS·(D+2) floats per CTA and one ticket counter per
    (tile, KV head). Counters start at 0 and every launch leaves them 0, so
    a call allocates nothing unless a shape outgrows the buffers (make the
    first call before capturing a CUDA graph; `grow_scratch`)."""
    need = 2 * n_ctas * TILE_MMA_ROWS * (head_dim + 2)
    part, counters = _SCRATCH.get(device, (None, None))
    if part is None or part.numel() < need:
        part = grow_scratch(device, part, lambda: torch.empty(
            need, dtype=torch.float32, device=device), "paged_core")
    if counters is None or counters.numel() < n_counters:
        counters = grow_scratch(device, counters, lambda: torch.zeros(
            max(n_counters, 1), dtype=torch.int32, device=device),
            "paged_core")
    _SCRATCH[device] = (part, counters)
    return part, counters


# --- plain mirror of the device-side work split ------------------------------

def tile_rows(n_heads: int, n_kv_heads: int) -> int:
    return TILE_MMA_ROWS // (n_heads // n_kv_heads)


def tiles(qpos: list[int], lanes: list[int] | None, rows_per_tile: int,
          page_size: int, max_pages: int) -> list[tuple[int, int, int, int]]:
    """The core's tiles: (first row, rows, lane, visible pages) in row
    order. `lanes` None is K4 (row b is lane b, its own tile). A tile
    starts at row t when t % rows_per_tile == 0 or the lane changes."""
    out, t, n = [], 0, len(qpos)
    while t < n:
        lane = t if lanes is None else lanes[t]
        nr, maxq = 1, qpos[t]
        if lanes is not None:
            while (nr < rows_per_tile and t + nr < n
                   and (t + nr) % rows_per_tile and lanes[t + nr] == lane):
                maxq = max(maxq, qpos[t + nr])
                nr += 1
        pages = 0 if maxq < 0 else min(maxq // page_size + 1, max_pages)
        out.append((t, nr, lane, pages))
        t += nr
    return out


def cta_of(unit: int, total: int, n_ctas: int) -> int:
    """The CTA whose window [c·W/n, (c+1)·W/n) holds `unit` (n <= W)."""
    return ((unit + 1) * n_ctas + total - 1) // total - 1


def work_split(tile_pages: list[int], n_kv_heads: int, n_ctas: int
               ) -> list[list[tuple[int, int, int, int, int]]]:
    """Per CTA, its pieces in order: (tile, kvh, first page, end page,
    partial slot or -1 when the piece is its whole item). Items are (tile,
    kvh) with kvh inside a tile, cut into pieces of B = ceil(W / m)
    pages; a piece of a split item starting at unit u writes slot
    2·floor(u/B) (the item's last piece) or that + 1."""
    total = n_kv_heads * sum(tile_pages)
    out = [[] for _ in range(n_ctas)]
    if not total:
        return out
    working = min(n_ctas, total)
    b = -(-total // working)
    u = 0
    for ti, pages in enumerate(tile_pages):
        for g in range(n_kv_heads):
            n_pieces = -(-pages // b)
            for j in range(n_pieces):
                start = u + j * b
                p0, p1 = j * b, min((j + 1) * b, pages)
                slot = -1 if n_pieces == 1 else \
                    2 * (start // b) + (0 if j == n_pieces - 1 else 1)
                out[cta_of(start, total, working)].append(
                    (ti, g, p0, p1, slot))
            u += pages
    return out
