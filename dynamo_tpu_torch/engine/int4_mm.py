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
launches the shared row-quantize kernel (xq, sx) and then, behind it by
programmatic dependent launch, the GEMM chosen by M (`csrc/a8_gemm.cuh`,
`csrc/w8a8_matmul.cu`, `csrc/int4_matmul.cu`): at M <= 16 a
weight-streaming swap-AB kernel on a fixed grid that cuts the (32-row x
512-byte) units of the weights evenly over the SMs (`stream_split` below
mirrors that split), above it a wgmma + TMA kernel over 128-row output
tiles (`wide_cols` mirrors their width); that call is one counted launch.
`w8a8_matmul_group` / `int4_matmul_group` multiply one x by up to three
weights in one such call (q/k/v, gate/up: one quantize, one GEMM). On CPU
tensors they run the plain versions `w8a8_matmul_ref` / `int4_matmul_ref`,
whose integer product is taken in float64 — exact below 2^53, where fp32
is not (|y| reaches 127·127·14336 > 2^24). Any other device, or a shape
the kernels do not take, raises.

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
_ARGS = [_c.c_void_p,                                        # x
         _c.c_void_p, _c.c_longlong,                          # ws ws_bytes
         _c.c_void_p, _c.c_longlong,                          # part, ints
         _c.c_void_p, _c.c_longlong,                          # tickets, n
         _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # M K dtype n
         _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # w s out N
         _c.c_void_p]                                         # stream
MAX_GROUP = 3           # weights one call multiplies the same x by
_W8A8_KERNEL = CudaKernel("w8a8_matmul", list(_ARGS))
_INT4_KERNEL = CudaKernel("int4_matmul", list(_ARGS))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the GEMM designs by M (csrc/a8_gemm.cuh `matmul`): the stream GEMM up to
# STREAM_MAX_M activation rows, in 8·NB-row activation tiles; above, the
# wide GEMM's 128 x 128 output tiles
STREAM_MAX_M = 16
STREAM_ROWS = 32        # weight rows per stream tile
STREAM_CHUNK = 512      # bytes of K per stream unit
STREAM_WARPS = 2        # consumer warps, one ticket each per tile
STREAM_CTAS_PER_SM = 2  # the stream GEMM's fixed grid
# partial-slot ints per CTA: 2 slots x 2 consumer warps x 32 lanes x the
# widest accumulator (NB 2, two nibble halves: 16 ints)
PART_INTS_PER_CTA = 2 * 2 * 32 * 16


def design(m: int) -> tuple[str, int]:
    """The GEMM that runs M activation rows: ("stream", NB) or ("wide",
    0)."""
    if m > STREAM_MAX_M:
        return "wide", 0
    return "stream", 1 if m <= 8 else 2


def wide_cols(int4: bool, m: int, cols: int, n_sms: int) -> int:
    """Logical columns per tile of the wide GEMM for M activation rows and
    `cols` logical columns in all (a grouped call's weights together): K5
    128; K6 256 where those tiles alone fill the card's SMs, else 128
    (twice the tiles)."""
    if int4 and -(-m // 128) * (cols // 256) >= n_sms:
        return 256
    return 128


def cta_of(unit: int, total: int, n_ctas: int) -> int:
    """The CTA whose window [c·U/G, (c+1)·U/G) holds `unit` (G <= U)."""
    return ((unit + 1) * n_ctas + total - 1) // total - 1


def stream_split(rows: int, k: int, n_ctas: int
                 ) -> list[list[tuple[int, int, int, int]]]:
    """Plain mirror of the stream GEMM's work split: units (tile of
    STREAM_ROWS weight rows, STREAM_CHUNK bytes of K) in tile-major order,
    G = min(n_ctas, U) CTAs, CTA c owning units [c·U/G, (c+1)·U/G). Per
    CTA, its pieces in order: (tile, first chunk, end chunk, partial slot
    or -1 when the piece is the whole tile). A piece of a cut tile parks
    its sums in slot 2c (the CTA's first tile) or 2c + 1 (its last)."""
    kc = -(-k // STREAM_CHUNK)
    total = rows // STREAM_ROWS * kc
    g = min(n_ctas, total)
    out = []
    for c in range(g):
        u0, u1 = total * c // g, total * (c + 1) // g
        first, pieces, u = u0 // kc, [], u0
        while u < u1:
            tile = u // kc
            end = min(u1, (tile + 1) * kc)
            whole = u == tile * kc and end == (tile + 1) * kc
            pieces.append((tile, u - tile * kc, end - tile * kc,
                           -1 if whole else 2 * c + (tile != first)))
            u = end
        out.append(pieces)
    return out


_SCRATCH: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def stream_scratch(device: torch.device, rows: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(partial slots, tickets) kept per device across calls: 2 slots per
    CTA and one ticket per consumer warp of each stream tile. Tickets start at 0 and every launch
    leaves them 0, so a call allocates nothing unless a shape outgrows the
    buffers (make the first call before capturing a CUDA graph)."""
    from dynamo_tpu_torch.engine.paged_core import sm_count

    part, tickets = _SCRATCH.get(device, (None, None))
    need = PART_INTS_PER_CTA * STREAM_CTAS_PER_SM * sm_count(device)
    if part is None or part.numel() < need:
        part = torch.empty(need, dtype=torch.int32, device=device)
    need_t = STREAM_WARPS * rows // STREAM_ROWS
    if tickets is None or tickets.numel() < need_t:
        tickets = torch.zeros(need_t, dtype=torch.int32, device=device)
    _SCRATCH[device] = (part, tickets)
    return part, tickets


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


def _launch(kernel: CudaKernel, x: torch.Tensor,
            weights: list[tuple[torch.Tensor, torch.Tensor]],
            int4: bool) -> list[torch.Tensor]:
    name = kernel.name
    if not 1 <= len(weights) <= MAX_GROUP:
        raise ValueError(f"{name}: takes 1..{MAX_GROUP} weights, got "
                         f"{len(weights)}")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be 2-D, got {tuple(x.shape)}")
    m, k = x.shape
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{name}: needs x fp32/bf16 and contiguous; got "
                         f"{x.dtype}")
    if k % 128:
        raise ValueError(f"{name}: K={k} must be a multiple of 128 (the "
                         f"kernel's gate)")
    outs, rows = [], 0
    for w, s in weights:
        n = 2 * w.shape[0] if int4 else w.shape[0]
        if w.dim() != 2:
            raise ValueError(f"{name}: w must be 2-D, got {tuple(w.shape)}")
        for arg, t in (("w", w), ("s", s)):
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"{name}: {arg} must be a contiguous "
                                 f"tensor on {x.device}")
        if w.dtype != torch.int8 or s.dtype != torch.float32:
            raise ValueError(f"{name}: needs w int8, s fp32; got {w.dtype}, "
                             f"{s.dtype}")
        if w.shape[1] != k or tuple(s.shape) != (1, n):
            raise ValueError(f"{name}: shape mismatch x {tuple(x.shape)} w "
                             f"{tuple(w.shape)} s {tuple(s.shape)}")
        if w.shape[0] % 128:
            raise ValueError(f"{name}: the weight's {w.shape[0]} rows must "
                             f"be a multiple of 128 (the kernel's gate)")
        outs.append(torch.empty((m, n), dtype=x.dtype, device=x.device))
        rows += w.shape[0]
    if m == 0:
        return outs
    # scratch: xq (M, K) int8 and sx (M,) fp32 for this call; the stream
    # GEMM's partial slots and tickets persist per device
    nbytes = m * k + 4 * m
    ws = torch.empty(nbytes, dtype=torch.int8, device=x.device)
    part, tickets = stream_scratch(x.device, rows)
    g = len(weights)
    kernel(x.data_ptr(), ws.data_ptr(), nbytes, part.data_ptr(),
           part.numel(), tickets.data_ptr(), tickets.numel(), m, k,
           _DTYPES[x.dtype], g,
           (_c.c_void_p * g)(*(w.data_ptr() for w, _ in weights)),
           (_c.c_void_p * g)(*(s.data_ptr() for _, s in weights)),
           (_c.c_void_p * g)(*(o.data_ptr() for o in outs)),
           (_c.c_int * g)(*(o.shape[1] for o in outs)),
           torch.cuda.current_stream(x.device).cuda_stream)
    return outs


def _device_ok(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """K5. x (M, K) fp32/bf16, q (N, K) int8 K-major, s (1, N) fp32 →
    (M, N) in x's dtype. CUDA: the kernel; CPU: the plain version."""
    return w8a8_matmul_group(x, [(q, s)])[0]


def int4_matmul(x: torch.Tensor, p: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """K6. x (M, K) fp32/bf16, p (N/2, K) nibble-packed K-major, s (1, N)
    fp32 → (M, N) in x's dtype. CUDA: the kernel; CPU: the plain
    version."""
    return int4_matmul_group(x, [(p, s)])[0]


def w8a8_matmul_group(x: torch.Tensor,
                      weights: list[tuple[torch.Tensor, torch.Tensor]]
                      ) -> list[torch.Tensor]:
    """K5 of x by 1..MAX_GROUP weights (q, s) at once — the projections
    that read the same activations (q/k/v, gate/up): one row quantize and
    one GEMM over all their tiles, one counted launch. Equal, bit for bit,
    to one `w8a8_matmul` per weight (the same xq and sx, exact int32
    sums)."""
    if not _device_ok("w8a8_matmul", x):
        return [w8a8_matmul_ref(x, q, s) for q, s in weights]
    return _launch(_W8A8_KERNEL, x, weights, int4=False)


def int4_matmul_group(x: torch.Tensor,
                      weights: list[tuple[torch.Tensor, torch.Tensor]]
                      ) -> list[torch.Tensor]:
    """K6 of x by 1..MAX_GROUP packed weights (p, s) at once, as
    `w8a8_matmul_group`."""
    if not _device_ok("int4_matmul", x):
        return [int4_matmul_ref(x, p, s) for p, s in weights]
    return _launch(_INT4_KERNEL, x, weights, int4=True)
