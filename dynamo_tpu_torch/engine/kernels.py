"""The paged KV cache writes: K2 `paged_kv_write` and K3
`paged_kv_write_pages`.

K2 is the port of `dynamo_tpu/engine/kernels.py:32` `paged_kv_write` (a
Pallas TPU kernel): one K/V row per token into its page slot. On CUDA
tensors the wrapper launches the hand-written kernel `csrc/paged_kv_write.cu`
(a flat list of 16-byte chunks in one wave, in place — see the source for
its design and bound); on CPU tensors it runs `paged_kv_write_ref`, the
plain version, which is the scatter branch of
`dynamo_tpu/models/llama.py:195-203` `_write_kv`.

K3 is the port of `dynamo_tpu/engine/kernels.py:78` `paged_kv_write_pages`
(a Pallas TPU kernel): whole pages of rows, for page-aligned prefill
chunks, stored without reading the destination back. CUDA tensors launch
`csrc/paged_kv_write_pages.cu` (a TMA box in, a bulk copy out, per slot
and head); CPU tensors run `paged_kv_write_pages_ref`.

`paged_kv_gather` is no TPU kernel: it copies a sequence's pages out of
every layer's caches into one (2, L, KVH, n, P, D) tensor for the
disaggregated KV transfer, the function the reference computes in XLA as
`_gather_kv_jit` (`dynamo_tpu/engine/engine.py:72`). CUDA tensors launch
`csrc/paged_kv_gather.cu` (one launch for all 2L caches, a flat list of
16-byte chunks); CPU tensors run `paged_kv_gather_ref`, a stack of
per-layer `index_select`s. It is a copy, so the two are bit-identical.

K2 and K3 read K and V as the caller hands them: any strides on the
leading dimensions (a step passes its projections' output, and K3 a
permuted view of the chunk's token-major K/V), stride 1 on D, every row
start 16-byte aligned. The caches are contiguous. Any other device, or a
geometry or layout a kernel does not take, raises. Both write in place
into the caller's cache tensors. Padding rows and slots target scratch
page 0, which `engine/pages.py` never hands out.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.engine.cuda_build import CudaKernel

_c = ctypes
_KERNEL = CudaKernel("paged_kv_write", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,   # kc vc k v
    _c.c_void_p, _c.c_void_p,                             # page_ids offsets
    *[_c.c_longlong] * 4,                                 # k, v byte strides
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,     # B KVH N P bytes
    _c.c_void_p])                                         # stream
_PAGES_KERNEL = CudaKernel("paged_kv_write_pages", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,   # kc vc kb vb
    _c.c_void_p,                                          # page_ids
    *[_c.c_longlong] * 6,                                 # kb, vb strides
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,     # M KVH N P bytes
    _c.c_void_p])                                         # stream

_GATHER_KERNEL = CudaKernel("paged_kv_gather", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # caches ids out
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # 2L KVH N n bytes
    _c.c_void_p])                                        # stream


# K3 stages a slot's K and V pages in one CTA's shared memory
# (csrc/paged_kv_write_pages.cu kMaxSmem)
K3_MAX_SMEM = 227 * 1024 - 1024


def _check_cuda_args(name: str, ref: torch.Tensor, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous tensor on "
                             f"{ref.device}")


def _row_strides(name: str, arg: str, t: torch.Tensor, ref: torch.Tensor
                 ) -> list[int]:
    """Byte strides of `t`'s leading dimensions for a kernel that reads
    16-byte chunks of its rows: `t` lies on `ref`'s device, its last
    dimension has stride 1, and its data pointer and every leading stride
    (of a dimension longer than 1) are multiples of 16 bytes."""
    if t.device != ref.device:
        raise ValueError(f"{name}: {arg} must lie on {ref.device}")
    es = t.element_size()
    strides = [s * es if n > 1 else 0
               for s, n in zip(t.stride()[:-1], t.shape[:-1])]
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: {arg}'s last dimension must have stride "
                         f"1, not {t.stride(-1)}")
    if t.data_ptr() % 16 or any(s % 16 for s in strides):
        raise ValueError(f"{name}: {arg}'s rows must start on 16-byte "
                         f"boundaries (data_ptr {t.data_ptr()}, strides "
                         f"{t.stride()} x {es} B)")
    return strides


def paged_kv_write_ref(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, page_ids: torch.Tensor,
                       offsets: torch.Tensor) -> None:
    """Plain version: kc/vc (KVH, N, P, D); k/v (B, KVH, D);
    page_ids/offsets (B,). Writes k[b]/v[b] at (page_ids[b], offsets[b])
    in place. Duplicate targets (padding rows on scratch page 0) keep one
    of their rows, unspecified which — as the reference's scatter."""
    pages, offs = page_ids.long(), offsets.long()
    kc[:, pages, offs, :] = k.transpose(0, 1).to(kc.dtype)
    vc[:, pages, offs, :] = v.transpose(0, 1).to(vc.dtype)


def paged_kv_write(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, page_ids: torch.Tensor,
                   offsets: torch.Tensor) -> None:
    """kc/vc: (KVH, N, P, D); k/v: (B, KVH, D), any strides on B and KVH;
    page_ids/offsets: (B,) int32, invalid rows already redirected to page
    0 offset 0 by the caller (`models/llama.py` `_kv_targets`). In place.
    CUDA: the kernel, on the current stream; CPU: the plain version."""
    if kc.device.type == "cpu":
        paged_kv_write_ref(kc, vc, k, v, page_ids, offsets)
        return
    if kc.device.type != "cuda":
        raise ValueError(f"paged_kv_write: unsupported device {kc.device}")
    kvh, n_pages, p, d = kc.shape
    b = k.shape[0]
    _check_cuda_args("paged_kv_write", kc, kc=kc, vc=vc, page_ids=page_ids,
                     offsets=offsets)
    if not (vc.shape == kc.shape and k.shape == (b, kvh, d)
            and v.shape == k.shape and page_ids.shape == (b,)
            and offsets.shape == (b,)):
        raise ValueError(
            f"paged_kv_write: shape mismatch kc {tuple(kc.shape)} "
            f"k {tuple(k.shape)} page_ids {tuple(page_ids.shape)}")
    if not (kc.dtype == vc.dtype == k.dtype == v.dtype):
        raise ValueError("paged_kv_write: caches and rows must share a "
                         "dtype")
    if page_ids.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError("paged_kv_write: page_ids/offsets must be int32")
    row_bytes = d * kc.element_size()
    if row_bytes % 16:
        raise ValueError(f"paged_kv_write: head_dim {d} x "
                         f"{kc.element_size()} B is not a multiple of the "
                         f"16-byte vector width")
    strides = [*_row_strides("paged_kv_write", "k", k, kc),
               *_row_strides("paged_kv_write", "v", v, kc)]
    if b == 0:
        return
    _KERNEL(kc.data_ptr(), vc.data_ptr(), k.data_ptr(), v.data_ptr(),
            page_ids.data_ptr(), offsets.data_ptr(), *strides, b, kvh,
            n_pages, p, row_bytes,
            torch.cuda.current_stream(kc.device).cuda_stream)


def paged_kv_write_pages_ref(kc: torch.Tensor, vc: torch.Tensor,
                             k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                             page_ids: torch.Tensor) -> None:
    """Plain version: kc/vc (KVH, N, P, D); k_blocks/v_blocks (M, KVH, P,
    D), one complete page of rows per slot; page_ids (M,). Stores block m
    as page page_ids[m] in place. Padding slots share scratch page 0,
    which keeps one of them, unspecified which — as the reference's grid
    keeps the last."""
    pages = page_ids.long()
    kc[:, pages] = k_blocks.transpose(0, 1).to(kc.dtype)
    vc[:, pages] = v_blocks.transpose(0, 1).to(vc.dtype)


def paged_kv_write_pages(kc: torch.Tensor, vc: torch.Tensor,
                         k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                         page_ids: torch.Tensor) -> None:
    """kc/vc: (KVH, N, P, D); k_blocks/v_blocks: (M, KVH, P, D), any
    strides on M, KVH and P (the caller's token-major chunk K/V, permuted);
    page_ids: (M,) int32, padding slots already aimed at page 0 by the
    caller. In place. CUDA: the kernel, on the current stream; CPU: the
    plain version."""
    if kc.device.type == "cpu":
        paged_kv_write_pages_ref(kc, vc, k_blocks, v_blocks, page_ids)
        return
    if kc.device.type != "cuda":
        raise ValueError(
            f"paged_kv_write_pages: unsupported device {kc.device}")
    kvh, n_pages, p, d = kc.shape
    m = k_blocks.shape[0]
    _check_cuda_args("paged_kv_write_pages", kc, kc=kc, vc=vc,
                     page_ids=page_ids)
    if not (vc.shape == kc.shape and k_blocks.shape == (m, kvh, p, d)
            and v_blocks.shape == k_blocks.shape
            and page_ids.shape == (m,)):
        raise ValueError(
            f"paged_kv_write_pages: shape mismatch kc {tuple(kc.shape)} "
            f"k_blocks {tuple(k_blocks.shape)} page_ids "
            f"{tuple(page_ids.shape)}")
    if not (kc.dtype == vc.dtype == k_blocks.dtype == v_blocks.dtype):
        raise ValueError("paged_kv_write_pages: caches and blocks must "
                         "share a dtype")
    if page_ids.dtype != torch.int32:
        raise ValueError("paged_kv_write_pages: page_ids must be int32")
    row_bytes = d * kc.element_size()
    if row_bytes % 16 or row_bytes > 512 or p > 256 \
            or 2 * p * row_bytes > K3_MAX_SMEM:
        raise ValueError(f"paged_kv_write_pages: a page of {p} rows of "
                         f"{d} x {kc.element_size()} B is not a TMA box the "
                         f"kernel takes (rows a multiple of 16 B and at most "
                         f"512, at most 256 rows, K and V pages within "
                         f"{K3_MAX_SMEM} B)")
    strides = [*_row_strides("paged_kv_write_pages", "k_blocks", k_blocks,
                             kc),
               *_row_strides("paged_kv_write_pages", "v_blocks", v_blocks,
                             kc)]
    if m == 0:
        return
    _PAGES_KERNEL(kc.data_ptr(), vc.data_ptr(), k_blocks.data_ptr(),
                  v_blocks.data_ptr(), page_ids.data_ptr(), *strides, m, kvh,
                  n_pages, p, row_bytes,
                  torch.cuda.current_stream(kc.device).cuda_stream)


def paged_kv_gather_ref(k_cache: list, v_cache: list,
                        page_ids: torch.Tensor) -> torch.Tensor:
    """Plain version: k_cache/v_cache, L per-layer (KVH, N, P, D) caches
    each; page_ids (n,). Returns (2, L, KVH, n, P, D), the K pages of
    every layer then the V pages — `_gather_kv_jit`'s layout."""
    ids = page_ids.long()
    return torch.stack([torch.stack([c.index_select(1, ids) for c in caches])
                        for caches in (k_cache, v_cache)])


def cache_pointers(k_cache: list, v_cache: list) -> torch.Tensor:
    """(2L,) int64 device array of the caches' base pointers, K caches
    first: what `paged_kv_gather` reads. The engine builds it once (its
    caches are updated in place and never move)."""
    ptrs = [c.data_ptr() for c in (*k_cache, *v_cache)]
    return torch.tensor(ptrs, dtype=torch.int64).to(k_cache[0].device)


def paged_kv_gather(k_cache: list, v_cache: list, page_ids: torch.Tensor,
                    pointers: torch.Tensor | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Signature of `paged_kv_gather_ref`, returning a new tensor, or
    `out` (2, L, KVH, n, P, D) contiguous when given. `pointers`: the
    caches' `cache_pointers`, built here when not given (a host-to-device
    copy). CUDA: the kernel, on the current stream; CPU: the plain
    version."""
    kc0 = k_cache[0]
    if kc0.device.type == "cpu":
        got = paged_kv_gather_ref(k_cache, v_cache, page_ids)
        if out is None:
            return got
        out.copy_(got)
        return out
    if kc0.device.type != "cuda":
        raise ValueError(f"paged_kv_gather: unsupported device {kc0.device}")
    kvh, n_pages, p, d = kc0.shape
    n = page_ids.shape[0]
    layers = len(k_cache)
    if len(v_cache) != layers:
        raise ValueError("paged_kv_gather: as many V caches as K caches")
    for i, c in enumerate((*k_cache, *v_cache)):
        if c.shape != kc0.shape or c.dtype != kc0.dtype \
                or c.device != kc0.device or not c.is_contiguous() \
                or c.data_ptr() % 16:
            raise ValueError(f"paged_kv_gather: cache {i} must be a "
                             f"contiguous, 16-byte aligned {tuple(kc0.shape)} "
                             f"{kc0.dtype} tensor on {kc0.device}")
    _check_cuda_args("paged_kv_gather", kc0, page_ids=page_ids)
    if page_ids.dtype != torch.int32 or page_ids.dim() != 1:
        raise ValueError("paged_kv_gather: page_ids must be (n,) int32")
    page_bytes = p * d * kc0.element_size()
    if page_bytes % 16:
        raise ValueError(f"paged_kv_gather: a page of {p} x {d} x "
                         f"{kc0.element_size()} B is not a multiple of the "
                         f"16-byte vector width")
    if pointers is None:
        pointers = cache_pointers(k_cache, v_cache)
    if pointers.shape != (2 * layers,) or pointers.dtype != torch.int64 \
            or pointers.device != kc0.device:
        raise ValueError(f"paged_kv_gather: pointers must be ({2 * layers},) "
                         f"int64 on {kc0.device}")
    shape = (2, layers, kvh, n, p, d)
    if out is None:
        out = torch.empty(shape, dtype=kc0.dtype, device=kc0.device)
    elif tuple(out.shape) != shape or out.dtype != kc0.dtype \
            or out.device != kc0.device or not out.is_contiguous() \
            or out.data_ptr() % 16:
        raise ValueError(f"paged_kv_gather: out must be a contiguous, "
                         f"16-byte aligned {shape} {kc0.dtype} tensor on "
                         f"{kc0.device}")
    if n == 0:
        return out
    _GATHER_KERNEL(pointers.data_ptr(), page_ids.data_ptr(), out.data_ptr(),
                   2 * layers, kvh, n_pages, n, page_bytes,
                   torch.cuda.current_stream(kc0.device).cuda_stream)
    return out
