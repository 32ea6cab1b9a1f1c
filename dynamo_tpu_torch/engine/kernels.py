"""The paged KV cache writes: K2 `paged_kv_write` and K3
`paged_kv_write_pages`.

K2 is the port of `dynamo_tpu/engine/kernels.py:32` `paged_kv_write` (a
Pallas TPU kernel): one K/V row per token into its page slot. On CUDA
tensors the wrapper launches the hand-written kernel `csrc/paged_kv_write.cu`
(one CTA per row, 16-byte vector stores, in place — see the source for its
design and bound); on CPU tensors it runs `paged_kv_write_ref`, the plain
version, which is the scatter branch of `dynamo_tpu/models/llama.py:195-203`
`_write_kv`.

K3 is the port of `dynamo_tpu/engine/kernels.py:78` `paged_kv_write_pages`
(a Pallas TPU kernel): whole pages of rows, for page-aligned prefill
chunks, stored without reading the destination back. CUDA tensors launch
`csrc/paged_kv_write_pages.cu`; CPU tensors run `paged_kv_write_pages_ref`.

Any other device, or a geometry a kernel does not take, raises. Both
write in place into the caller's cache tensors. Padding rows and slots
target scratch page 0, which `engine/pages.py` never hands out.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.engine.cuda_build import CudaKernel

_c = ctypes
_KERNEL = CudaKernel("paged_kv_write", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,   # kc vc k v
    _c.c_void_p, _c.c_void_p,                             # page_ids offsets
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,     # B KVH N P bytes
    _c.c_void_p])                                         # stream
_PAGES_KERNEL = CudaKernel("paged_kv_write_pages", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,   # kc vc kb vb
    _c.c_void_p,                                          # page_ids
    _c.c_int, _c.c_int, _c.c_int, _c.c_int,               # M KVH N bytes
    _c.c_void_p])                                         # stream


def _check_cuda_args(name: str, ref: torch.Tensor, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous tensor on "
                             f"{ref.device}")


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
    """kc/vc: (KVH, N, P, D); k/v: (B, KVH, D); page_ids/offsets: (B,)
    int32, invalid rows already redirected to page 0 offset 0 by the
    caller. In place. CUDA: the kernel, on the current stream; CPU: the
    plain version."""
    if kc.device.type == "cpu":
        paged_kv_write_ref(kc, vc, k, v, page_ids, offsets)
        return
    if kc.device.type != "cuda":
        raise ValueError(f"paged_kv_write: unsupported device {kc.device}")
    kvh, n_pages, p, d = kc.shape
    b = k.shape[0]
    _check_cuda_args("paged_kv_write", kc, kc=kc, vc=vc, k=k, v=v,
                     page_ids=page_ids, offsets=offsets)
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
    _KERNEL(kc.data_ptr(), vc.data_ptr(), k.data_ptr(), v.data_ptr(),
            page_ids.data_ptr(), offsets.data_ptr(), b, kvh, n_pages, p,
            row_bytes, torch.cuda.current_stream(kc.device).cuda_stream)


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
    """kc/vc: (KVH, N, P, D); k_blocks/v_blocks: (M, KVH, P, D); page_ids:
    (M,) int32, padding slots already aimed at page 0 by the caller. In
    place. CUDA: the kernel, on the current stream; CPU: the plain
    version."""
    if kc.device.type == "cpu":
        paged_kv_write_pages_ref(kc, vc, k_blocks, v_blocks, page_ids)
        return
    if kc.device.type != "cuda":
        raise ValueError(
            f"paged_kv_write_pages: unsupported device {kc.device}")
    kvh, n_pages, p, d = kc.shape
    m = k_blocks.shape[0]
    _check_cuda_args("paged_kv_write_pages", kc, kc=kc, vc=vc,
                     k_blocks=k_blocks, v_blocks=v_blocks, page_ids=page_ids)
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
    page_bytes = p * d * kc.element_size()
    if page_bytes % 16:
        raise ValueError(f"paged_kv_write_pages: a page of {p} x {d} x "
                         f"{kc.element_size()} B is not a multiple of the "
                         f"16-byte vector width")
    _PAGES_KERNEL(kc.data_ptr(), vc.data_ptr(), k_blocks.data_ptr(),
                  v_blocks.data_ptr(), page_ids.data_ptr(), m, kvh, n_pages,
                  page_bytes, torch.cuda.current_stream(kc.device).cuda_stream)
