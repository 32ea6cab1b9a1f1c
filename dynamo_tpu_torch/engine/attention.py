"""Paged attention: the phase path's entries and the ragged step's.

Port of `dynamo_tpu/engine/attention.py`: its `_NEG_INF` mask convention
(`:27`), `prefill_attention` (`:117`) and `mixed_attention` (`:147`) —
XLA in the reference; here `prefill_attention_ref` is the plain version,
and `prefill_attention` runs K1's kernel on CUDA tensors (the chunk rows
flattened into K1's flat rows, `chunk_rows`) — and the two kernel entries:
- K4 `paged_attention_decode` (`:178`): one query token per lane, the
  decode burst's hot loop. CUDA tensors launch the hand-written kernel
  `csrc/paged_attention_decode.cu` (bf16: the paged-attention core shared
  with K1, `csrc/paged_attention.cuh`, at one row per lane; fp32: a CTA
  per (lane, KV head, split) and a merge launch); CPU tensors run
  `paged_attention_decode_ref`, the port of the reference's plain version
  `_xla_decode` (`:197`).
- K1 `ragged_attention` (`:236`), the ragged step's entry
  (engine/ragged.py).

The reference picks between its Pallas kernels and XLA by backend and
geometry, and counts fallbacks; the port has no fallback: a CUDA tensor
goes through the hand-written kernel or raises, a CPU tensor runs the
plain version.

K4 computes `_xla_decode`'s function, scores scaled by 1/sqrt(D). The
reference's TPU path does not: the upstream Pallas `paged_attention`
kernel applies no scale and `_pallas_decode` passes q unscaled, so on a
TPU the reference's decode attention is unscaled while its prefill,
ragged and plain decode attention are scaled. The port does not copy
that.

Cache layout: K/V pages per layer are (num_kv_heads, num_pages,
page_size, head_dim).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from dynamo_tpu_torch.engine.cuda_build import CudaKernel
from dynamo_tpu_torch.engine.paged_core import (
    core_scratch,
    core_supported,
    grid_ctas,
    num_splits,
    sm_count,
)

# finite "minus infinity" for masked scores: exp(_NEG_INF - m) is exactly
# 0 in fp32, and a fully masked row never produces inf - inf
_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

_c = ctypes
_DECODE_KERNEL = CudaKernel("paged_attention_decode", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # q k_pages v_pages
    _c.c_void_p, _c.c_void_p,                            # lengths tables
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # out part ml ctrs
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B H KVH N P
    _c.c_int, _c.c_int, _c.c_int,                        # D max_pages n
    _c.c_float, _c.c_int, _c.c_void_p])                  # scale dtype stream
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 227 * 1024
DECODE_STEP_KEYS = 32       # kStepKeys in the source (fp32 path)


def visible_pages(lengths: torch.Tensor, page_size: int,
                  max_pages: int) -> int:
    """Pages the longest lane can see (at least 1): the plain versions
    gather only these — keys past every lane's length are masked, and
    exp(_NEG_INF - max) is exactly 0 in fp32, so the result is unchanged
    while the gather stays small."""
    longest = int(lengths.max()) if lengths.numel() else 0
    return min(max(1, -(-longest // page_size)), max_pages)


def _gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(KVH, N, P, D) pages at tables (B, n) -> (B, KVH, n*P, D)."""
    kvh, _, _, d = pages.shape
    b = tables.shape[0]
    return pages[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(
        b, kvh, -1, d)


def prefill_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_tables: torch.Tensor,
                          q_positions: torch.Tensor, seq_lens: torch.Tensor,
                          kv_pages: Optional[int] = None) -> torch.Tensor:
    """Plain version of `prefill_attention`: causal attention of a batch
    of prefill chunks, reading K/V from pages (the reference's
    per-sequence function, vmapped over Bp).

    q: (Bp, T, H, D); page_tables: (Bp, max_pages); q_positions: (Bp, T)
    absolute positions; seq_lens: (Bp,) valid lengths. Returns (Bp, T, H,
    D) in q's dtype. Row t of sequence i attends keys s <= q_positions[i,
    t] and s < seq_lens[i]; fp32 scores / sqrt(D), softmax, weighted sum
    of V. The query heads of a KV head are grouped instead of repeating
    K/V, and only the pages the longest sequence can see are gathered —
    `kv_pages` of them when the caller knows the count (one host read per
    forward instead of one per layer), else counted from seq_lens. A
    padding row (position >= seq_len) averages V over the valid keys, as
    the reference's does."""
    bp, t, h, d = q.shape
    kvh, _, p, _ = k_pages.shape
    groups = h // kvh
    n = kv_pages or visible_pages(seq_lens, p, page_tables.shape[1])
    k = _gather_pages(k_pages, page_tables[:, :n]).float()   # (Bp,KVH,S,D)
    v = _gather_pages(v_pages, page_tables[:, :n]).float()
    qg = q.float().reshape(bp, t, kvh, groups, d)
    scores = torch.einsum("btgjd,bgsd->bgjts", qg, k) / math.sqrt(d)
    s_pos = torch.arange(k.shape[2], device=q.device)
    mask = (s_pos[None, None, :] <= q_positions[:, :, None]) \
        & (s_pos[None, None, :] < seq_lens[:, None, None])  # (Bp, T, S)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgjts,bgsd->btgjd", probs, v)
    return out.reshape(bp, t, h, d).to(q.dtype)


def chunk_rows(q_positions: torch.Tensor, seq_lens: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's row tags for a batch of chunks flattened to Bp·T rows:
    (token_qpos, token_lanes), (Bp·T,) int32 each — a row's position, or
    -1 past its sequence's length (a padding row), and its sequence's
    index into the page tables. Computed once per step and handed to
    every layer's `prefill_attention`."""
    bp, t = q_positions.shape
    qpos = torch.where(q_positions < seq_lens[:, None], q_positions,
                       torch.full_like(q_positions, -1))
    lanes = torch.arange(bp, dtype=torch.int32,
                         device=q_positions.device).repeat_interleave(t)
    return qpos.reshape(bp * t).to(torch.int32), lanes


def prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_tables: torch.Tensor,
                      q_positions: torch.Tensor, seq_lens: torch.Tensor,
                      kv_pages: Optional[int] = None,
                      row_tags: Optional[tuple] = None) -> torch.Tensor:
    """Signature of `prefill_attention_ref`. CPU: the plain version.
    CUDA: K1's kernel (`ragged.ragged_paged_attention`) on the chunk rows
    viewed as Bp·T flat rows of a (Bp·T, H, D) query, each tagged by
    `chunk_rows` (`row_tags`, when the caller computed them once per step)
    and reading its sequence's row of `page_tables`: a chunk's rows are
    consecutive rows of one lane, the tiles K1's core is built for. No
    host read: the kernel finds each row's visible pages on the card, so
    the step can be captured in a CUDA graph.

    Padding rows differ by design: K1 gives a row past its sequence's
    length exact zeros, the plain version an average over the valid keys.
    Rows are independent outside attention and attention reads only keys
    below seq_len, so valid rows, the last-token logits and the cache
    rows below seq_len are the same either way (the padding rows' own
    K/V, written to page 0 or past seq_len in a partly filled page, are
    masked until decode overwrites them)."""
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k_pages, v_pages, page_tables,
                                     q_positions, seq_lens, kv_pages)
    from dynamo_tpu_torch.engine import ragged

    bp, t, h, d = q.shape
    qpos, lanes = (row_tags if row_tags is not None
                   else chunk_rows(q_positions, seq_lens))
    out = ragged.ragged_paged_attention(
        q.reshape(bp * t, h, d).contiguous(), k_pages, v_pages, qpos, lanes,
        page_tables)
    return out.view(bp, t, h, d)


def mixed_attention(q_dec: torch.Tensor, q_chunk: torch.Tensor,
                    k_pages: torch.Tensor, v_pages: torch.Tensor,
                    dec_lengths: torch.Tensor, dec_tables: torch.Tensor,
                    chunk_tables: torch.Tensor,
                    chunk_positions: torch.Tensor,
                    chunk_seq_lens: torch.Tensor,
                    chunk_kv_pages: Optional[int] = None,
                    chunk_row_tags: Optional[tuple] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One attention entry for a mixed prefill+decode step: the decode
    sub-batch through K4 `paged_attention_decode`, the chunk sub-batch
    through `prefill_attention` (K1 on CUDA tensors), against the same
    caches. The sub-batches are different sequences with disjoint page
    tables, so each side's numerics are exactly the stand-alone
    function's. Returns (dec_out (B, H, D), chunk_out (Bp, T, H, D))."""
    dec_out = paged_attention_decode(q_dec, k_pages, v_pages, dec_lengths,
                                     dec_tables)
    chunk_out = prefill_attention(q_chunk, k_pages, v_pages, chunk_tables,
                                  chunk_positions, chunk_seq_lens,
                                  chunk_kv_pages, chunk_row_tags)
    return dec_out, chunk_out


def paged_attention_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, lengths: torch.Tensor,
                               page_tables: torch.Tensor) -> torch.Tensor:
    """Plain version of K4, the reference's `_xla_decode`. q: (B, H, D);
    k_pages/v_pages: (KVH, N, P, D); lengths: (B,) valid lengths (0 = a
    padding lane); page_tables: (B, max_pages). Returns (B, H, D) in q's
    dtype: fp32 scores / sqrt(D) over keys s < lengths[b], softmax,
    weighted sum of V. Padding lanes are exact zeros (the reference's give
    a uniform-softmax row, which its engine ignores)."""
    b, h, d = q.shape
    kvh, _, p, _ = k_pages.shape
    groups = h // kvh
    n = visible_pages(lengths, p, page_tables.shape[1])
    k = _gather_pages(k_pages, page_tables[:, :n]).float()   # (B, KVH, S, D)
    v = _gather_pages(v_pages, page_tables[:, :n]).float()
    qg = q.float().reshape(b, kvh, groups, d)
    scores = torch.einsum("bgjd,bgsd->bgjs", qg, k) / math.sqrt(d)
    s_pos = torch.arange(k.shape[2], device=q.device)
    mask = (s_pos[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgjs,bgsd->bgjd", probs, v).reshape(b, h, d)
    out = torch.where((lengths > 0)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def decode_supported(n_heads: int, n_kv_heads: int, page_size: int,
                     head_dim: int, dtype: torch.dtype) -> bool:
    """Geometry the K4 kernel takes (it replaces the TPU gate `head_dim %
    128 == 0`, `attention.py:190`): whole GQA groups; bf16 — the core's
    gate (`paged_core.core_supported`: at most 8 query heads per KV head,
    a built head_dim, a power-of-two page of at most 64 keys); fp32 —
    head_dim a multiple of 8 (16-byte vectors) and shared memory for the
    group's queries and one step of K/V that fits a CTA."""
    if dtype not in _DTYPE_CODES or n_kv_heads <= 0 or page_size <= 0 \
            or n_heads % n_kv_heads or head_dim % 8:
        return False
    if dtype == torch.bfloat16:
        return core_supported(n_heads, n_kv_heads, page_size, head_dim)
    g = n_heads // n_kv_heads
    keys = max(1, DECODE_STEP_KEYS // page_size) * page_size
    smem = 4 * (2 * g * head_dim + 2 * keys * (head_dim + 1) + g * keys
                + 3 * g)
    return smem <= MAX_SMEM_BYTES


def paged_attention_decode(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, lengths: torch.Tensor,
                           page_tables: torch.Tensor) -> torch.Tensor:
    """Signature of `paged_attention_decode_ref`. CUDA: the K4 kernel, on
    the current stream, into a fresh output tensor; CPU: the plain
    version."""
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, k_pages, v_pages, lengths,
                                          page_tables)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_attention_decode: unsupported device {q.device}")
    kvh, n_pages, p, d = k_pages.shape
    b, h, qd = q.shape
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("lengths", lengths), ("page_tables", page_tables)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"paged_attention_decode: {name} must be a "
                             f"contiguous tensor on {q.device}")
    if qd != d or v_pages.shape != k_pages.shape \
            or lengths.shape != (b,) or page_tables.dim() != 2 \
            or page_tables.shape[0] != b:
        raise ValueError("paged_attention_decode: shape mismatch")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError("paged_attention_decode: q and pages must share a "
                         "dtype")
    if lengths.dtype != torch.int32 or page_tables.dtype != torch.int32:
        raise ValueError("paged_attention_decode: lengths and page_tables "
                         "must be int32")
    if not decode_supported(h, kvh, p, d, q.dtype):
        raise ValueError(
            f"paged_attention_decode: unsupported geometry H={h} KVH={kvh} "
            f"P={p} D={d} dtype={q.dtype}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention_decode: k_pages and v_pages must "
                         "be 16-byte aligned")
    out = torch.empty_like(q)
    max_pages = page_tables.shape[1]
    if q.dtype == torch.bfloat16:
        # the core: a fixed grid, persistent partial slots and counters
        blocks = grid_ctas(q.device)
        part, counters = core_scratch(q.device, blocks, d, b * kvh)
        ptrs = (part.data_ptr(), 0, counters.data_ptr())
    else:
        blocks = num_splits(b, kvh, max_pages, sm_count(q.device))
        # split-KV scratch: per split (m, l) and un-normalised acc, fp32
        part_acc = torch.empty((b * blocks * h * d) if blocks > 1 else 0,
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b * blocks * h * 2) if blocks > 1 else 0,
                              dtype=torch.float32, device=q.device)
        ptrs = (part_acc.data_ptr(), part_ml.data_ptr(), 0)
    _DECODE_KERNEL(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   lengths.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
                   *ptrs, b, h, kvh, n_pages, p, d, max_pages, blocks,
                   1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream)
    return out


def ragged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, token_qpos: torch.Tensor,
                     token_lanes: torch.Tensor, lane_tables: torch.Tensor,
                     page_size: int) -> torch.Tensor:
    """Flat-token ragged paged attention — THE attention entry of the
    ragged step (decode lanes, prefill chunk tokens and mixed rounds all
    ride it as rows of one (T, H, D) tensor). q: (T, H, D); token_qpos:
    (T,) absolute position each row attends up to, -1 for padding rows;
    token_lanes: (T,) row into lane_tables (L, max_pages)."""
    from dynamo_tpu_torch.engine import ragged

    if k_pages.shape[2] != page_size:
        raise ValueError(f"ragged_attention: cache page size "
                         f"{k_pages.shape[2]} != {page_size}")
    return ragged.ragged_paged_attention(q, k_pages, v_pages, token_qpos,
                                         token_lanes, lane_tables)
