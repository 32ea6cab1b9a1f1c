"""K1 `ragged_paged_attention`: flat query rows over the paged KV cache.

Port of `dynamo_tpu/engine/ragged.py:80` (a Pallas TPU kernel). Every
query — a decode lane's one token or any token of a prefill chunk — is one
row of a flat (T, H, D) array, tagged with the absolute position it
attends up to (`token_qpos`) and the lane whose page table it reads
(`token_lanes`).

Mask convention: a row with `qpos` attends KV positions `s <= qpos`
(inclusive — the engine writes a token's own K/V before attention).
Padding rows carry `qpos = -1` and output exactly zero.

On CUDA tensors `ragged_paged_attention` launches the hand-written kernel
`csrc/ragged_paged_attention.cu` (bf16: the paged-attention core shared
with K4, `csrc/paged_attention.cuh` — tiles of up to 64/G rows of one lane
on tensor cores, pages by cp.async through an mbarrier ring, the visible
work split evenly over a fixed grid on the device and merged in the same
launch; fp32: one CTA per (row, KV head, split) and a merge launch; both
with an fp32 online softmax over only the pages a row can see; see the
sources); on CPU
tensors it runs `ragged_attention_ref`, the plain version — a port of
`dynamo_tpu/engine/ragged.py:53` `ragged_attention_xla`, i.e. the decode
reference `_xla_decode` (`dynamo_tpu/engine/attention.py:197`) applied per
flat row. Any other device, or a geometry the kernel does not take,
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dynamo_tpu_torch.engine.attention import _NEG_INF
from dynamo_tpu_torch.engine.cuda_build import CudaKernel
from dynamo_tpu_torch.engine.paged_core import (
    core_scratch,
    core_supported,
    grid_ctas,
    num_splits,
    sm_count,
)

_c = ctypes
_KERNEL = CudaKernel("ragged_paged_attention", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # q k_pages v_pages
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # qpos lanes tables
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # out part ml ctrs
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # T H KVH N P
    _c.c_int, _c.c_int, _c.c_int,                        # D max_pages n
    _c.c_float, _c.c_int, _c.c_void_p])                  # scale dtype stream

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 227 * 1024
PAGES_PER_STEP = 2          # kPagesPerStep in the source (fp32 path)


def ragged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, token_qpos: torch.Tensor,
                         token_lanes: torch.Tensor,
                         lane_tables: torch.Tensor) -> torch.Tensor:
    """Plain version. q: (T, H, D); k_pages/v_pages: (KVH, N, P, D);
    token_qpos: (T,) (-1 ⇒ padding row); token_lanes: (T,) row into
    lane_tables (L, max_pages). Returns (T, H, D) in q's dtype; padding
    rows exactly zero.

    Per row: gather the lane's pages, fp32 scores / sqrt(D), mask
    s < qpos + 1 with the finite _NEG_INF, softmax, weighted sum of V.
    The page table is cut to the pages the deepest row can see: the cut
    keys were masked, and exp(_NEG_INF - max) is exactly 0 in fp32, so the
    result is unchanged while the gather stays small."""
    kvh, _, p, d = k_pages.shape
    t, h, _ = q.shape
    groups = h // kvh
    lengths = torch.clamp(token_qpos.long() + 1, min=0)
    n_pages = max(1, -(-int(lengths.max()) // p)) if t else 1
    tables = lane_tables.long()[token_lanes.long()][:, :n_pages]  # (T, n)
    # (KVH, T, n, P, D) -> (T, KVH, S, D)
    k = k_pages[:, tables].permute(1, 0, 2, 3, 4).reshape(t, kvh, -1, d)
    v = v_pages[:, tables].permute(1, 0, 2, 3, 4).reshape(t, kvh, -1, d)
    qg = q.float().reshape(t, kvh, groups, d)
    scores = torch.einsum("tgjd,tgsd->tgjs", qg, k.float()) / math.sqrt(d)
    s_pos = torch.arange(k.shape[2], device=q.device)
    mask = (s_pos[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("tgjs,tgsd->tgjd", probs, v.float())
    out = out.reshape(t, h, d)
    out = torch.where((token_qpos >= 0)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def ragged_supported(n_heads: int, n_kv_heads: int, page_size: int,
                     head_dim: int, dtype: torch.dtype) -> bool:
    """Geometry the CUDA kernel takes (replaces the TPU tiling gate
    `dynamo_tpu/engine/ragged.py:47`): whole GQA groups; bf16 — the
    core's gate (`paged_core.core_supported`: at most 8 query heads per
    KV head, a built head_dim, a power-of-two page of at most 64 keys);
    fp32 — a head_dim that is a multiple of the 16-byte vector width and
    shared memory that fits one CTA."""
    if dtype not in _DTYPE_CODES or n_kv_heads <= 0 \
            or n_heads % n_kv_heads:
        return False
    g = n_heads // n_kv_heads
    if dtype == torch.bfloat16:
        return core_supported(n_heads, n_kv_heads, page_size, head_dim)
    keys = PAGES_PER_STEP * page_size
    smem = 4 * (2 * g * head_dim + 2 * keys * (head_dim + 1)
                + g * keys + 3 * g)
    return head_dim % 4 == 0 and smem <= MAX_SMEM_BYTES


def ragged_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, token_qpos: torch.Tensor,
                           token_lanes: torch.Tensor,
                           lane_tables: torch.Tensor) -> torch.Tensor:
    """Signature of `ragged_attention_ref`. CUDA: the kernel, on the
    current stream, into a fresh output tensor; CPU: the plain version."""
    if q.device.type == "cpu":
        return ragged_attention_ref(q, k_pages, v_pages, token_qpos,
                                    token_lanes, lane_tables)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention: unsupported device {q.device}")
    kvh, n_pages, p, d = k_pages.shape
    t, h, qd = q.shape
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("token_qpos", token_qpos),
                    ("token_lanes", token_lanes),
                    ("lane_tables", lane_tables)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"ragged_paged_attention: {name} must be a "
                             f"contiguous tensor on {q.device}")
    if qd != d or v_pages.shape != k_pages.shape \
            or token_qpos.shape != (t,) or token_lanes.shape != (t,) \
            or lane_tables.dim() != 2:
        raise ValueError("ragged_paged_attention: shape mismatch")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError("ragged_paged_attention: q and pages must share "
                         "a dtype")
    for name, x in (("token_qpos", token_qpos),
                    ("token_lanes", token_lanes),
                    ("lane_tables", lane_tables)):
        if x.dtype != torch.int32:
            raise ValueError(f"ragged_paged_attention: {name} must be "
                             f"int32")
    if not ragged_supported(h, kvh, p, d, q.dtype):
        raise ValueError(
            f"ragged_paged_attention: unsupported geometry H={h} KVH={kvh} "
            f"P={p} D={d} dtype={q.dtype}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("ragged_paged_attention: k_pages and v_pages must "
                         "be 16-byte aligned")
    out = torch.empty_like(q)
    max_pages = lane_tables.shape[1]
    if q.dtype == torch.bfloat16:
        # the core: a fixed grid, persistent partial slots and counters
        blocks = grid_ctas(q.device)
        part, counters = core_scratch(q.device, blocks, d, t * kvh)
        ptrs = (part.data_ptr(), 0, counters.data_ptr())
    else:
        blocks = num_splits(t, kvh, max_pages, sm_count(q.device))
        # split-KV scratch: per split (m, l) and un-normalised acc, fp32
        part_acc = torch.empty((t * blocks * h * d) if blocks > 1 else 0,
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((t * blocks * h * 2) if blocks > 1 else 0,
                              dtype=torch.float32, device=q.device)
        ptrs = (part_acc.data_ptr(), part_ml.data_ptr(), 0)
    _KERNEL(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            token_qpos.data_ptr(), token_lanes.data_ptr(),
            lane_tables.data_ptr(), out.data_ptr(), *ptrs, t, h, kvh,
            n_pages, p, d, max_pages, blocks, 1.0 / math.sqrt(d),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    return out

