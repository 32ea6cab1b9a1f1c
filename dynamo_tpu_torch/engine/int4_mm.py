"""The A8 quantized GEMMs: K5 `w8a8_matmul` and K6 `int4_matmul`.

K5 is the port of `dynamo_tpu/engine/int4_mm.py:107` `w8a8_matmul` (Pallas
kernel `_w8a8_kernel`, `:92`), K6 of `:168` `int4_matmul` (`_kernel`,
`:50`). Both compute the reference's TPU function exactly:

    sx = max(absmax(x_row), 1e-12) · f32(1/127)  per row, fp32
    xq = round_half_even(x / sx)                 int8 (the `_a8_prologue`)
    y  = xq @ w                                  exact int32
    out = ((float(y) · sx) · s).to(x.dtype)

with w the int8 weight (K5) or the unpacked nibbles of `quant.pack4` (K6).
`/ 127` is written as a division in the reference, which XLA compiles as
the product with fp32 1/127 (and `x / sx` as a true division); the port
computes what the reference runs.
The reference pads M to 32 and picks Mosaic blocks; both are TPU tiling
and are not carried over.

On CUDA tensors each wrapper makes ONE call into its C launcher, which
launches the shared row-quantize kernel (xq, sx) and then the int8
tensor-core GEMM with the epilogue fused, K split across CTAs where the
output tiles alone would leave SMs idle (`csrc/a8_gemm.cuh`,
`csrc/w8a8_matmul.cu`, `csrc/int4_matmul.cu`); that call is one counted
launch. On CPU tensors they run the plain versions `w8a8_matmul_ref` /
`int4_matmul_ref`, whose integer product is taken in float64 — exact
below 2^53, where fp32 is not (|y| reaches 127·127·14336 > 2^24). Any
other device, or a shape the kernels do not take, raises.

Weights are K-major (engine/quant.py): q (N, K) int8, p (N/2, K) packed,
s (1, N) fp32; x (M, K) fp32 or bf16, contiguous; the output has x's
dtype. The kernels take K % 128 == 0 and N % 128 == 0 (int8) or N/2 % 128
== 0 (int4) — the reference's gate — and any M >= 1.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dynamo_tpu_torch.engine.cuda_build import CudaKernel

_c = ctypes
_ARGS = [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # x w s out
         _c.c_void_p, _c.c_longlong,                          # ws ws_bytes
         _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # M K N dtype
         _c.c_void_p]                                         # stream
_W8A8_KERNEL = CudaKernel("w8a8_matmul", list(_ARGS))
_INT4_KERNEL = CudaKernel("int4_matmul", list(_ARGS))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def recip32(n: int) -> float:
    """fp32 1/n. The reference divides by constants (`absmax / 127.0`
    here, `amax / qmax` in its quantize) inside jitted functions, and XLA
    compiles a division by a constant as a product with its fp32
    reciprocal: the reference serves `a * f32(1/n)`, which differs from
    the quotient in the last bit of some scales. The port computes that
    product."""
    return float(np.float32(1) / np.float32(n))


def a8_prologue_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain per-row int8 activation quantization (the reference's
    `_a8_prologue` without its padding): (xq (M, K) int8, sx (M, 1) fp32)."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) * recip32(127)
    return torch.round(xf / sx).to(torch.int8), sx


def _epilogue(acc: torch.Tensor, sx: torch.Tensor, s: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """float64 integer sums → fp32 (round to nearest even, as the int32 →
    fp32 conversion) → (y·sx)·s → the activation dtype."""
    return ((acc.float() * sx) * s).to(dtype)


def w8a8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """Plain K5: x (M, K), q (N, K) int8 K-major, s (1, N)."""
    xq, sx = a8_prologue_ref(x)
    return _epilogue(xq.double() @ q.double().T, sx, s, x.dtype)


def int4_matmul_ref(x: torch.Tensor, p: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """Plain K6: x (M, K), p (N/2, K) nibble-packed K-major, s (1, N)."""
    from dynamo_tpu_torch.engine.quant import _unpack4

    xq, sx = a8_prologue_ref(x)
    return _epilogue(xq.double() @ _unpack4(p.T).double(), sx, s, x.dtype)


def _launch(kernel: CudaKernel, x: torch.Tensor, w: torch.Tensor,
            s: torch.Tensor, n: int) -> torch.Tensor:
    name = kernel.name
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: x and w must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    for arg, t in (("x", x), ("w", w), ("s", s)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous tensor on "
                             f"{x.device}")
    if x.dtype not in _DTYPES or w.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise ValueError(f"{name}: needs x fp32/bf16, w int8, s fp32; got "
                         f"{x.dtype}, {w.dtype}, {s.dtype}")
    if w.shape[1] != k or tuple(s.shape) != (1, n):
        raise ValueError(f"{name}: shape mismatch x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} s {tuple(s.shape)}")
    if k % 128 or w.shape[0] % 128:
        raise ValueError(f"{name}: K={k} and the weight's {w.shape[0]} rows "
                         f"must be multiples of 128 (the kernel's gate)")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    # scratch: xq (M, K) int8, sx (M,) fp32 and, for up to 64 rows (where
    # the launcher may split K), the split sums (M, N) int32 and one counter
    # per output tile (at most one per 16 x 64)
    nbytes = m * k + 4 * m
    if m <= 64:
        nbytes += 4 * (m * n + (m + 15) // 16 * (n // 64))
    ws = torch.empty(nbytes, dtype=torch.int8, device=x.device)
    kernel(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
           ws.data_ptr(), nbytes, m, k, n, _DTYPES[x.dtype],
           torch.cuda.current_stream(x.device).cuda_stream)
    return out


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """K5. x (M, K) fp32/bf16, q (N, K) int8 K-major, s (1, N) fp32 →
    (M, N) in x's dtype. CUDA: the kernel; CPU: the plain version."""
    if x.device.type == "cpu":
        return w8a8_matmul_ref(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {x.device}")
    return _launch(_W8A8_KERNEL, x, q, s, q.shape[0])


def int4_matmul(x: torch.Tensor, p: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """K6. x (M, K) fp32/bf16, p (N/2, K) nibble-packed K-major, s (1, N)
    fp32 → (M, N) in x's dtype. CUDA: the kernel; CPU: the plain
    version."""
    if x.device.type == "cpu":
        return int4_matmul_ref(x, p, s)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    return _launch(_INT4_KERNEL, x, p, s, 2 * p.shape[0])
