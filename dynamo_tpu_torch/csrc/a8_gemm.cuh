// The A8 quantized GEMM shared by K5 (w8a8_matmul.cu) and K6
// (int4_matmul.cu): per-row int8 activation quantization, an exact int32
// product on the tensor cores, the epilogue (y·sx)·s.
//
// Replaces the Pallas TPU kernels of dynamo_tpu/engine/int4_mm.py:
// `_a8_prologue` (:76, an XLA prologue there), `_w8a8_kernel` (:92) and
// the int4 `_kernel` (:50) with its XLA epilogue. The function is the
// TPU's, bit for bit:
//   sx = max(absmax(x_row), 1e-12) · (1/127)  fp32 product: XLA compiles
//                                             the reference's `/ 127.0`
//                                             as a product with the fp32
//                                             reciprocal
//   xq = rint(x / sx)                         int8, IEEE division
//   y  = xq · w                               int32, exact (any order)
//   out = (float_rn(y) · sx) · s              two IEEE products, one
//                                             rounding to the output type
// The TPU's int4 kernel recovers the nibble products with two int8 dots
// and an algebraic epilogue because Mosaic could not shift i8 vectors;
// here the nibbles are unpacked in registers (and/or/sub/xor, exact): the
// low nibbles of 16 packed weight rows are one int8 MMA row block (the
// even logical columns), the high nibbles another (the odd ones).
//
// Operand layout: xq (M, K) row-major and the weights K-major — (N, K)
// int8, or (N/2, K) packed bytes whose low nibble is logical column 2j
// (stored +8) and whose high nibble is column 2j+1 — so both operands
// hold consecutive k, as the s8 MMAs want. Both designs below are
// swap-AB: the weight rows are the MMA's A operand (M side) and the
// activation rows its B operand (N side), so no A row is padding and the
// int4 rows unpack into A fragments in registers.
//
// One call multiplies x by 1..3 weights that read it (q/k/v, gate/up):
// one row quantize, one GEMM over all their tiles. Two launches, both on
// the caller's stream:
// 1. quantize_rows_kernel: one CTA per row; 16-byte loads kept in
//    registers, block absmax, then xq (M, K) int8 and sx (M,) fp32 into
//    the caller's scratch. It lets the GEMM launch at once (programmatic
//    dependent launch): the GEMM streams its first weight stages while x
//    is quantized and waits (griddepcontrol.wait) only before its first
//    read of xq / sx. It asks for the GEMM's shared-memory carveout, so
//    the GEMM's CTAs start beside it.
// 2. the GEMM, by M:
//    - M <= 16, "stream" (decode): bound by the weight bytes (58.7 MB
//      int8, 29.4 MB int4 for an 8B gate/up projection). A fixed grid of
//      two CTAs per SM walks units of (32 weight rows x 512 bytes of K) in
//      tile-major order, CTA c owning units [c·U/G, (c+1)·U/G): every
//      projection, grouped or not, fills the card within one unit. One
//      producer thread feeds a 4-stage ring per CTA (8 per SM) with TMA
//      boxes of (32 rows, 128 bytes), 128-byte swizzled, completing on
//      mbarriers: per stage 32 weight rows x 512 bytes (the same bytes for
//      K5 and K6: K6's stage covers twice the logical columns) and the
//      stage's 8·NB rows of xq (rows past M land as zeros). Two consumer
//      warps run mma.sync.m16n8k32 (16 weight rows x 8·NB activation
//      rows) from ldmatrix. A tile cut between CTAs is folded without
//      atomics on the sums: each piece writes its int32 partials to its
//      CTA's slot, takes a ticket, and the last piece adds the others
//      (exact in any order) and runs the epilogue; it resets the ticket,
//      so the persistent tickets stay 0 between calls.
//    - M >= 17, "wide" (prefill): bound by int8 operations. A persistent
//      CTA (one per SM) walks 128-row x 128- or 256-column output tiles; a
//      producer thread loads 128-byte-swizzled TMA tiles (xq 128 rows,
//      weights 128 or 64 rows, 128 bytes of K per stage) into a 5-6 stage
//      ring; two consumer warpgroups (setmaxnreg) run wgmma: K5 SS
//      m64n128k32 (each warpgroup 64 weight rows x the 128 activation
//      rows); K6 RS with the unpacked nibbles as register A: 128 packed
//      rows per tile, each warpgroup 64 of them x the 128 activation rows
//      (m64n128k32, two row blocks: low and high nibbles) where those
//      tiles alone fill the card, else 64 packed rows per tile, each
//      warpgroup 64 activation rows (m64n64k32). The epilogue scales in
//      registers, transposes through shared memory and stores 16-byte
//      rows.
//
// Shapes taken: K % 128 == 0, N % 128 == 0 (int8) or N % 256 == 0 (int4),
// any M >= 0; x fp32 or bf16, out of x's type.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace a8 {

constexpr int kQuantThreads = 1024;
constexpr int kQuantRegs = 4;

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a 2-D box of a tensor map at (c0 innermost, c1) -> shared
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// programmatic dependent launch: let the next kernel on the stream start /
// wait for the previous kernel's completion and its memory
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a · b for one m16n8k32 tile: a row-major 16x32, b column-major
// 32x8 (4 consecutive k per register), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four packed bytes → four int8 of their low nibbles minus 8. Each byte
// is lifted to [0x80, 0x8f] before subtracting, so no byte borrows from
// its neighbour.
__device__ __forceinline__ uint32_t nib_lo(uint32_t w) {
  return (((w & 0x0f0f0f0fu) | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}
// ... → four int8 of their high nibbles, sign-extended (b >> 4).
__device__ __forceinline__ uint32_t nib_hi(uint32_t w) {
  const uint32_t t = ((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u;
  return ((t | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

__device__ __forceinline__ float scale(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// ---------------------------------------------------------------------------
// prologue
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// 16 bytes of x → V floats
__device__ __forceinline__ void to_f32(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void to_f32(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 pair: low half first
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bytes(const int (&q)[4]) {
  return (uint32_t)(q[0] & 0xff) | ((uint32_t)(q[1] & 0xff) << 8) |
         ((uint32_t)(q[2] & 0xff) << 16) | ((uint32_t)(q[3] & 0xff) << 24);
}

// One CTA per row, of quant_threads(K) threads (two 16-byte loads each,
// at most kQuantThreads), each keeping up to kQuantRegs loads in
// registers between the absmax and the quantize (longer rows are read
// again). The
// GEMM behind it may start at once: it reads xq / sx only after
// griddepcontrol.wait, i.e. after this grid has completed.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ sx, int K) {
  constexpr int V = 16 / sizeof(T);          // elements per 16-byte load
  __shared__ float red[kQuantThreads / 32];
  griddep_launch_dependents();
  const size_t row = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + row * K);
  const int nv = K / V;
  uint4 keep[kQuantRegs];
  float amax = 0.f;
  auto absmax = [&](const uint4& u) {
    float v[V];
    to_f32(u, v);
#pragma unroll
    for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(v[j]));
  };
#pragma unroll
  for (int r = 0; r < kQuantRegs; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i < nv) {
      keep[r] = src[i];
      absmax(keep[r]);
    }
  }
  for (int i = threadIdx.x + kQuantRegs * blockDim.x; i < nv;
       i += blockDim.x)
    absmax(src[i]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    float m = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    m = warp_max(m);
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const float scale = __fmul_rn(fmaxf(red[0], 1e-12f), 1.0f / 127.0f);
  int8_t* dst = xq + row * K;
  auto quantize = [&](int i, const uint4& u) {
    float v[V];
    to_f32(u, v);
    int q[V];
#pragma unroll
    for (int j = 0; j < V; ++j) q[j] = __float2int_rn(__fdiv_rn(v[j], scale));
    if constexpr (V == 4) {
      reinterpret_cast<uint32_t*>(dst)[i] = pack_bytes(q);
    } else {
      const int lo[4] = {q[0], q[1], q[2], q[3]};
      const int hi[4] = {q[4], q[5], q[6], q[7]};
      reinterpret_cast<uint2*>(dst)[i] = make_uint2(pack_bytes(lo),
                                                    pack_bytes(hi));
    }
  };
#pragma unroll
  for (int r = 0; r < kQuantRegs; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i < nv) quantize(i, keep[r]);
  }
  for (int i = threadIdx.x + kQuantRegs * blockDim.x; i < nv;
       i += blockDim.x)
    quantize(i, src[i]);
  if (threadIdx.x == 0) sx[row] = scale;
}

// one output value / a pair of adjacent ones, fp32 or bf16
__device__ __forceinline__ void store1(void* out, size_t i, float a,
                                       int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(a);
  else
    static_cast<float*>(out)[i] = a;
}
__device__ __forceinline__ void store2(void* out, size_t i, float a, float b,
                                       int bf16) {
  if (bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       i) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2(a, b);
}

// ---------------------------------------------------------------------------
// segments: one call multiplies the same x by up to kMaxSegs weights (q/k/v,
// gate/up) — one row quantize, one GEMM over their tiles in order
// ---------------------------------------------------------------------------

constexpr int kMaxSegs = 3;

struct Seg {
  const float* s;    // (N,)
  void* out;         // (M, N), fp32 or bf16
  int N;             // logical columns
  int tiles;         // this weight's tiles in the GEMM's walk
};

// the segment of global tile `tile`, which becomes the segment's own index
__device__ __forceinline__ Seg seg_of(const Seg (&seg)[kMaxSegs], int n_seg,
                                      int& tile, int& si) {
  si = 0;
  if (n_seg > 1 && tile >= seg[0].tiles) {
    tile -= seg[0].tiles;
    si = 1;
    if (n_seg > 2 && tile >= seg[1].tiles) {
      tile -= seg[1].tiles;
      si = 2;
    }
  }
  return si == 0 ? seg[0] : si == 1 ? seg[1] : seg[2];
}

__device__ __forceinline__ const CUtensorMap* map_of(
    int si, const CUtensorMap* t0, const CUtensorMap* t1,
    const CUtensorMap* t2) {
  return si == 0 ? t0 : si == 1 ? t1 : t2;
}

// ---------------------------------------------------------------------------
// stream GEMM (M <= 16)
// ---------------------------------------------------------------------------

struct StreamArgs {
  const float* sx;   // (M,)
  Seg seg[kMaxSegs];
  int n_seg;
  int M, K;
  int rows;          // weight rows of all segments: N (int8) or N/2 (int4)
  int out_bf16;
  int* part;         // partial slots: 2 per CTA
  int* counters;     // tickets: 2 per tile (one per consumer warp), all 0
};

constexpr int kStreamCtasPerSm = 2;

// NB: n8 activation tiles per MMA row block (M <= 8·NB; 1 or 2)
template <bool kInt4, int NB>
struct Stream {
  static constexpr int kRows = 32;            // weight rows per tile
  static constexpr int kChunk = 512;          // bytes of K per unit
  static constexpr int kXRows = 8 * NB;
  static constexpr int kWBytes = kRows * kChunk;
  static constexpr int kStageBytes = (kRows + kXRows) * kChunk;
  static constexpr int kStages = 4;           // per CTA, 2 CTAs per SM
  static constexpr int kWarps = 2;            // consumer warps
  static constexpr int kThreads = 32 * (kWarps + 1);
  static constexpr int kHalves = kInt4 ? 2 : 1;
  static constexpr int kAcc = 4 * NB * kHalves;            // per thread
  static constexpr int kSlotInts = kWarps * 32 * kAcc;     // per slot
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                                  2 * kStages * sizeof(uint64_t);
};

// Byte (row r, k byte kb) of a stage operand: `rows` x 512 bytes landed by
// four TMA boxes of (rows, 128 bytes), each 128-byte swizzled — 16-byte
// column c of row r sits at column c ^ (r % 8), so ldmatrix's 8 rows hit 8
// different bank groups.
template <int kRowsOp>
__device__ __forceinline__ int sw_off(int r, int kb) {
  return (kb >> 7) * (kRowsOp * 128) + r * 128 +
         ((((kb >> 4) & 7) ^ (r & 7)) << 4);
}

// the CTA whose window [c·U/G, (c+1)·U/G) holds unit u
__device__ __forceinline__ int cta_of(long long u, long long U, int G) {
  return (int)(((u + 1) * G + U - 1) / U) - 1;
}

template <bool kInt4, int NB>
__device__ __forceinline__ void stream_body(const CUtensorMap* tx,
                                            const CUtensorMap* tw0,
                                            const CUtensorMap* tw1,
                                            const CUtensorMap* tw2,
                                            const StreamArgs& g) {
  using S = Stream<kInt4, NB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)S::kStages * S::kStageBytes);
  uint64_t* empty = full + S::kStages;
  const int KC = (g.K + S::kChunk - 1) / S::kChunk;
  const long long U = (long long)(g.rows / S::kRows) * KC;
  const int G = gridDim.x, c = blockIdx.x;
  const long long u0 = U * c / G, u1 = U * (c + 1) / G;
  const int n = (int)(u1 - u0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], S::kWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == S::kWarps) {
    // producer, one thread: per unit four TMA boxes of (32 weight rows,
    // 128 bytes) and four of (8·NB activation rows, 128 bytes); K past its
    // end and activation rows past M land as zeros
    if (lane != 0) return;
    auto load_w = [&](int i) {
      const long long u = u0 + i;
      int lt = (int)(u / KC), si;
      seg_of(g.seg, g.n_seg, lt, si);
      const CUtensorMap* tw = map_of(si, tw0, tw1, tw2);
      const int row0 = lt * S::kRows;
      const int k0 = (int)(u % KC) * S::kChunk;
      const int slot = i % S::kStages;
      uint8_t* st = smem + (size_t)slot * S::kStageBytes;
      mbar_expect_tx(&full[slot], S::kStageBytes);
#pragma unroll
      for (int j = 0; j < S::kChunk / 128; ++j)
        tma_load_2d(st + j * S::kRows * 128, tw, k0 + 128 * j, row0,
                    &full[slot]);
    };
    auto load_x = [&](int i) {
      const int k0 = (int)((u0 + i) % KC) * S::kChunk;
      const int slot = i % S::kStages;
      uint8_t* xs = smem + (size_t)slot * S::kStageBytes + S::kWBytes;
#pragma unroll
      for (int j = 0; j < S::kChunk / 128; ++j)
        tma_load_2d(xs + j * S::kXRows * 128, tx, k0 + 128 * j, 0,
                    &full[slot]);
    };
    // the ring's first pass streams weights before x is quantized
    const int pre = min(n, S::kStages);
    for (int i = 0; i < pre; ++i) load_w(i);
    griddep_wait();
    for (int i = 0; i < pre; ++i) load_x(i);
    for (int i = pre; i < n; ++i) {
      mbar_wait(&empty[i % S::kStages], ((i / S::kStages) & 1) ^ 1);
      load_w(i);
      load_x(i);
    }
    return;
  }

  // consumers: warp `warp` owns weight rows 16·warp .. +15 of each tile
  griddep_wait();
  const int gid = lane >> 2, tig = lane & 3;
  // the epilogue's operands are loaded ahead, so that a tile's end waits on
  // no load: sx of this thread's activation rows 8j + 2·tig + e, and the
  // weight scales of its two rows (K6: their two columns each) per tile
  float xsr[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * tig + e;
      xsr[j][e] = m < g.M ? g.sx[m] : 0.f;
    }
  Seg sg{};
  int lt = 0;
  float wsr[2][S::kHalves];
  int acc[S::kHalves][NB][4];
  auto zero = [&]() {
#pragma unroll
    for (int h = 0; h < S::kHalves; ++h)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0;
  };
  zero();
  // ldmatrix rows of this lane: A row 16·warp + lane % 16 (k half lane /
  // 16); B row lane % 8 (k half lane / 8 % 2) of n8 tile pairs
  const int ar = 16 * warp + (lane & 15), ak = (lane >> 4) * 16;
  const int br = ((lane >> 4) << 3) + (lane & 7), bk = ((lane >> 3) & 1) * 16;
  for (int i = 0; i < n; ++i) {
    const long long u = u0 + i;
    const int tile = (int)(u / KC), kc = (int)(u % KC);
    const int slot = i % S::kStages;
    if (i == 0 || kc == 0) {
      lt = tile;
      int si;
      sg = seg_of(g.seg, g.n_seg, lt, si);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = lt * S::kRows + warp * 16 + gid + 8 * hr;
#pragma unroll
        for (int h = 0; h < S::kHalves; ++h)
          wsr[hr][h] = kInt4 ? sg.s[2 * r + h] : sg.s[r];
      }
    }
    mbar_wait(&full[slot], (i / S::kStages) & 1);
    const uint8_t* ws = smem + (size_t)slot * S::kStageBytes;
    const uint8_t* xs = ws + S::kWBytes;
#pragma unroll 4
    for (int kk = 0; kk < S::kChunk / 32; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ws + sw_off<S::kRows>(ar, kk * 32 + ak));
      uint32_t b[NB][2];
      if constexpr (NB == 1) {
        ldsm_x2(b[0], xs + sw_off<S::kXRows>(lane & 7, kk * 32 + bk));
      } else {
#pragma unroll
        for (int p = 0; p < NB / 2; ++p) {
          uint32_t r[4];
          ldsm_x4(r, xs + sw_off<S::kXRows>(p * 16 + br, kk * 32 + bk));
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
      }
      if constexpr (!kInt4) {
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_s8(acc[0][j], a, b[j][0], b[j][1]);
      } else {
        const uint32_t lo[4] = {nib_lo(a[0]), nib_lo(a[1]), nib_lo(a[2]),
                                nib_lo(a[3])};
        const uint32_t hi[4] = {nib_hi(a[0]), nib_hi(a[1]), nib_hi(a[2]),
                                nib_hi(a[3])};
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          mma_s8(acc[0][j], lo, b[j][0], b[j][1]);
          mma_s8(acc[1][j], hi, b[j][0], b[j][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (kc != KC - 1 && i != n - 1) continue;

    // this CTA's piece of `tile` ends here
    const long long t0 = (long long)tile * KC, t1 = t0 + KC;
    if (t0 < u0 || t1 > u1) {
      // a tile cut between CTAs: park the partial sums in this CTA's slot
      // (its first tile's piece in slot 2c, its last tile's in 2c + 1),
      // take a ticket; the last piece adds the others' slots
      auto slot_of = [&](int cc) {
        const int ft = (int)(U * cc / G / KC);
        return g.part + ((size_t)(2 * cc + (tile == ft ? 0 : 1)) * S::kWarps +
                         warp) *
                            32 * S::kAcc;
      };
      int* mine = slot_of(c);
#pragma unroll
      for (int h = 0; h < S::kHalves; ++h)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mine[((h * NB + j) * 4 + e) * 32 + lane] = acc[h][j][e];
      __threadfence();
      __syncwarp();
      const int c_lo = cta_of(t0, U, G), c_hi = cta_of(t1 - 1, U, G);
      int last = 0;
      if (lane == 0) {
        int* ticket = g.counters + S::kWarps * tile + warp;
        last = atomicAdd(ticket, 1) == c_hi - c_lo;
        if (last) *ticket = 0;
      }
      last = __shfl_sync(0xffffffffu, last, 0);
      if (!last) {
        zero();
        continue;
      }
      __threadfence();
      for (int cc = c_lo; cc <= c_hi; ++cc) {
        if (cc == c) continue;
        const int* other = slot_of(cc);
#pragma unroll
        for (int h = 0; h < S::kHalves; ++h)
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[h][j][e] += __ldcg(other + ((h * NB + j) * 4 + e) * 32 +
                                     lane);
      }
    }

    // epilogue: accumulator (h, j, e) is weight row 16·warp + gid + 8·(e/2)
    // of the tile and activation row 8j + 2·tig + e%2; K6's two halves are
    // the logical columns 2r and 2r + 1 of packed row r
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * j + 2 * tig + (e & 1);
        if (m >= g.M) continue;
        const int r = lt * S::kRows + warp * 16 + gid + 8 * (e >> 1);
        const float xs_m = xsr[j][e & 1];
        if constexpr (!kInt4) {
          store1(sg.out, (size_t)m * sg.N + r,
                 scale(acc[0][j][e], xs_m, wsr[e >> 1][0]), g.out_bf16);
        } else {
          store2(sg.out, (size_t)m * sg.N + 2 * r,
                 scale(acc[0][j][e], xs_m, wsr[e >> 1][0]),
                 scale(acc[1][j][e], xs_m, wsr[e >> 1][1]), g.out_bf16);
        }
      }
    zero();
  }
}

// ---------------------------------------------------------------------------
// wide GEMM (M >= 17): wgmma + TMA
// ---------------------------------------------------------------------------

struct WideArgs {
  const float* sx;   // (M,)
  Seg seg[kMaxSegs];
  int n_seg;
  int n_tiles;       // weight tiles of all segments
  int M, K;
  int out_bf16;
};

// kWideW (K6 only): 128 packed rows (256 columns) per tile, each consumer
// warpgroup 64 of them x all 128 activation rows (wgmma n128); otherwise
// 64 packed rows, each warpgroup all 64 x 64 of the activation rows (n64),
// twice the tiles for shapes that would leave SMs idle
template <bool kInt4, bool kWideW>
struct Wide {
  static constexpr int kBX = 128;                  // activation rows / tile
  static constexpr int kBW = kInt4 && !kWideW ? 64 : 128;  // weight rows
  static constexpr int kCols = kInt4 ? 2 * kBW : kBW;      // logical columns
  static constexpr int kN = kInt4 && !kWideW ? 64 : 128;   // wgmma n
  static constexpr int kBlocks = kInt4 ? 2 : 1;    // A row blocks (nibbles)
  static constexpr int kAcc = kBlocks * kN / 2;    // accumulators / thread
  static constexpr int kXBytes = kBX * 128;        // 128 bytes of K
  static constexpr int kWBytes = kBW * 128;
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kStages = kStageBytes == 32768 ? 5 : 6;
  static constexpr int kThreads = 384;             // producer + 2 consumers
  static constexpr int kEpiBytes = 32768;          // per consumer warpgroup
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                                  2 * kEpiBytes +
                                  2 * kStages * sizeof(uint64_t);
};

// shared-memory matrix descriptor: K-major rows of 128 bytes, 128-byte
// swizzle (as TMA wrote them), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep a register's value where it is across the asynchronous wgmma
__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void wgmma_ss_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(int (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// named barrier over one consumer warpgroup
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <bool kInt4, bool kWideW>
__device__ __forceinline__ void wide_body(const CUtensorMap* tx,
                                          const CUtensorMap* tw0,
                                          const CUtensorMap* tw1,
                                          const CUtensorMap* tw2,
                                          const WideArgs& g) {
  using W = Wide<kInt4, kWideW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* epi = smem + (size_t)W::kStages * W::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * W::kEpiBytes);
  uint64_t* empty = full + W::kStages;
  const int m_tiles = (g.M + W::kBX - 1) / W::kBX;
  const int tiles = m_tiles * g.n_tiles;
  const int KT = g.K / 128;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int i = 0; i < W::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);          // the consumers' 8 warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    // tiles t = blockIdx.x + j·gridDim.x, activation tile fastest (the CTAs
    // running together share weight tiles in L2)
    const int n_it = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * KT;
    auto at = [&](int it, int& xrow, int& wrow, int& k, int& si) {
      const int t = blockIdx.x + (it / KT) * gridDim.x;
      int nt = t / m_tiles;
      seg_of(g.seg, g.n_seg, nt, si);
      xrow = (t % m_tiles) * W::kBX;
      wrow = nt * W::kBW;
      k = (it % KT) * 128;
    };
    auto load_w = [&](int it) {
      int xrow, wrow, k, si;
      at(it, xrow, wrow, k, si);
      const int slot = it % W::kStages;
      mbar_expect_tx(&full[slot], W::kStageBytes);
      tma_load_2d(smem + (size_t)slot * W::kStageBytes + W::kXBytes,
                  map_of(si, tw0, tw1, tw2), k, wrow, &full[slot]);
    };
    auto load_x = [&](int it) {
      int xrow, wrow, k, si;
      at(it, xrow, wrow, k, si);
      const int slot = it % W::kStages;
      tma_load_2d(smem + (size_t)slot * W::kStageBytes, tx, k, xrow,
                  &full[slot]);
    };
    const int pre = min(n_it, W::kStages);
    for (int it = 0; it < pre; ++it) load_w(it);
    griddep_wait();
    for (int it = 0; it < pre; ++it) load_x(it);
    for (int it = pre; it < n_it; ++it) {
      mbar_wait(&empty[it % W::kStages], ((it / W::kStages) & 1) ^ 1);
      load_w(it);
      load_x(it);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  griddep_wait();
  const int cw = wg - 1;                      // consumer warpgroup
  const int t = threadIdx.x - 128 * wg;
  const int warp = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int esize = g.out_bf16 ? 2 : 4;
  uint8_t* buf = epi + cw * W::kEpiBytes;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x0 = (tile % m_tiles) * W::kBX;
    int nt = tile / m_tiles, si;
    const Seg sg = seg_of(g.seg, g.n_seg, nt, si);
    const int w0 = nt * W::kBW;
    int acc[W::kAcc];
#pragma unroll
    for (int i = 0; i < W::kAcc; ++i) acc[i] = 0;
    for (int kb = 0; kb < KT; ++kb, ++it) {
      const int slot = it % W::kStages;
      mbar_wait(&full[slot], (it / W::kStages) & 1);
      const uint8_t* xs = smem + (size_t)slot * W::kStageBytes;
      const uint8_t* ws = xs + W::kXBytes;
#pragma unroll
      for (int i = 0; i < W::kAcc; ++i) reg_fence(acc[i]);
      if constexpr (!kInt4) {
        // A: this warpgroup's 64 weight rows; B: the 128 activation rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128(acc, sw128_desc(ws + cw * 64 * 128 + kk * 32),
                        sw128_desc(xs + kk * 32));
        wgmma_commit();
        wgmma_wait0();
      } else {
        // A: 64 packed rows (kWideW: this warpgroup's half of the tile's
        // 128), unpacked in registers into two row blocks (low nibbles: even
        // columns, high: odd); B: kN activation rows (kWideW: all 128,
        // else this warpgroup's 64)
        uint32_t lo[4][4], hi[4][4];
        const int r = (kWideW ? 64 * cw : 0) + 16 * warp + (lane & 15);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, ws + r * 128 + (((2 * kk + (lane >> 4)) ^ (r & 7)) << 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[kk][i] = nib_lo(a[i]);
            hi[kk][i] = nib_hi(a[i]);
          }
        }
        constexpr int kHalf = W::kAcc / 2;
        int (&acc_lo)[kHalf] = *reinterpret_cast<int(*)[kHalf]>(&acc[0]);
        int (&acc_hi)[kHalf] = *reinterpret_cast<int(*)[kHalf]>(&acc[kHalf]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db =
              sw128_desc(xs + (kWideW ? 0 : cw * 64 * 128) + kk * 32);
          if constexpr (kWideW) {
            wgmma_rs_n128(acc_lo, lo[kk], db);
            wgmma_rs_n128(acc_hi, hi[kk], db);
          } else {
            wgmma_rs_n64(acc_lo, lo[kk], db);
            wgmma_rs_n64(acc_hi, hi[kk], db);
          }
        }
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            reg_fence(lo[kk][i]);
            reg_fence(hi[kk][i]);
          }
      }
#pragma unroll
      for (int i = 0; i < W::kAcc; ++i) reg_fence(acc[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

    // epilogue: scale in registers, transpose into this warpgroup's buffer
    // (rows = activation rows, in the output type), 16-byte row stores.
    // acc[4j + e] (K6: its low-nibble block; acc[kAcc/2 + 4j + e] the high)
    // is weight row wr0 + 16·warp + gid + 8·(e/2) and activation row xr0 +
    // 8j + 2·tig + e%2. This warpgroup's columns: K5 64 (its weight rows),
    // K6 128 (64 packed rows, two columns each); a wide K6 tile goes out in
    // two passes of 64 activation rows so the buffer stays 32 KB.
    constexpr int kPasses = kInt4 && kWideW ? 2 : 1;
    constexpr int kRowsOut = W::kN / kPasses;
    constexpr int kColsOut = kInt4 ? 128 : 64;
    constexpr int kJ = W::kN / 8 / kPasses;     // n8 blocks per pass
    const int wr0 = kInt4 && !kWideW ? 0 : 64 * cw;   // tile-local rows
    const int xr0 = kInt4 && !kWideW ? 64 * cw : 0;
    const int cbase = kInt4 ? 2 * (w0 + wr0) : w0 + wr0;
    const int vpr = kColsOut * esize / 16;      // 16-byte vectors per row
    // the scales first, into registers: the stores into the buffer would
    // otherwise order every later global load behind them
    float wsc[2][kInt4 ? 2 : 1];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rl = 16 * warp + gid + 8 * hr;
#pragma unroll
      for (int h = 0; h < (kInt4 ? 2 : 1); ++h)
        wsc[hr][h] = __ldg(sg.s + (kInt4 ? cbase + 2 * rl + h : cbase + rl));
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      float xsc[kJ][2];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int m = x0 + xr0 + 8 * (kJ * p + jj) + 2 * tig + e1;
          xsc[jj][e1] = m < g.M ? __ldg(g.sx + m) : 0.f;
        }
      wg_sync(1 + cw);                // the buffer's last stores are done
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kJ * p + jj;
          const int xr = 8 * j + 2 * tig + (e & 1);   // of this warpgroup
          const int rl = 16 * warp + gid + 8 * (e >> 1);
          if (x0 + xr0 + xr >= g.M) continue;
          const float xs_m = xsc[jj][e & 1];
          const size_t at = (size_t)(xr - kRowsOut * p) * kColsOut;
          if constexpr (!kInt4) {
            store1(buf, at + rl, scale(acc[4 * j + e], xs_m, wsc[e >> 1][0]),
                   g.out_bf16);
          } else {
            store2(buf, at + 2 * rl,
                   scale(acc[4 * j + e], xs_m, wsc[e >> 1][0]),
                   scale(acc[W::kAcc / 2 + 4 * j + e], xs_m, wsc[e >> 1][1]),
                   g.out_bf16);
          }
        }
      wg_sync(1 + cw);
      const int xbase = x0 + xr0 + kRowsOut * p;
      for (int v = t; v < kRowsOut * vpr; v += 128) {
        const int row = v / vpr, cv = v % vpr;
        if (xbase + row >= g.M) continue;
        *reinterpret_cast<uint4*>(static_cast<uint8_t*>(sg.out) +
                                  ((size_t)(xbase + row) * sg.N + cbase) *
                                      esize +
                                  cv * 16) =
            *reinterpret_cast<const uint4*>(
                buf + (size_t)row * kColsOut * esize + cv * 16);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// the dynamic shared memory of each kernel is raised once per process
inline int set_smem(const void* fn, size_t smem) {
  static const void* done[32];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == fn) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_done < 32) done[n_done++] = fn;
  return 0;
}

// launch behind the previous kernel on the stream with programmatic
// dependent launch (the kernel calls griddepcontrol.wait before it reads
// what that kernel wrote)
template <typename... KArgs, typename... Args>
int launch_pdl(void (*kernel)(KArgs...), int grid, int threads, size_t smem,
               cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// a (rows, K) int8 row-major tensor as 128-byte-swizzled boxes of
// (box_rows, 128 bytes); rows past the end read as zeros
inline int tensor_map(CUtensorMap* map, const void* base, int K, int rows,
                      int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// threads of the row quantize for rows of nv 16-byte loads: two loads each,
// whole warps, 128 .. kQuantThreads
inline int quant_threads(int nv) {
  const int t = ((nv + 1) / 2 + 31) / 32 * 32;
  return t < 128 ? 128 : t > kQuantThreads ? kQuantThreads : t;
}

// activation rows up to which the stream GEMM runs (the wide GEMM above)
constexpr int kStreamMaxM = 16;

// tickets the stream GEMM needs for `rows` weight rows: one per consumer
// warp of each tile
inline long long tickets_needed(int rows) {
  return (long long)Stream<false, 1>::kWarps * rows / Stream<false, 1>::kRows;
}

// the caller's persistent stream scratch: partial slots and tickets
struct Scratch {
  int* part;
  long long part_ints;
  int* counters;
  long long n_counters;
};

// one weight of a call: K-major rows, its scales, its output
struct HostSeg {
  const void* w;
  const float* s;
  void* out;
  int N;             // logical columns
};

template <class Ker, int NB>
int run_stream(const int8_t* xq, const float* sx, const HostSeg* segs,
               int n_seg, const Scratch& sc, int M, int K, int out_bf16,
               cudaStream_t stream) {
  using S = Stream<Ker::kInt4, NB>;
  StreamArgs g{sx, {}, n_seg, M, K, 0, out_bf16, sc.part, sc.counters};
  CUtensorMap tx, tw[kMaxSegs];
  int e = tensor_map(&tx, xq, K, M, S::kXRows);
  for (int i = 0; i < n_seg && e == 0; ++i) {
    const int rows = Ker::kInt4 ? segs[i].N / 2 : segs[i].N;
    g.seg[i] = Seg{segs[i].s, segs[i].out, segs[i].N, rows / S::kRows};
    g.rows += rows;
    e = tensor_map(&tw[i], segs[i].w, K, rows, S::kRows);
  }
  if (e != 0) return e;
  for (int i = n_seg; i < kMaxSegs; ++i) tw[i] = tw[0];
  const long long U =
      (long long)(g.rows / S::kRows) * ((K + S::kChunk - 1) / S::kChunk);
  const int G = (int)(U < kStreamCtasPerSm * sm_count()
                          ? U : kStreamCtasPerSm * sm_count());
  if ((long long)G * 2 * S::kSlotInts > sc.part_ints ||
      tickets_needed(g.rows) > sc.n_counters)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = Ker::template stream<NB>();
  e = set_smem(reinterpret_cast<const void*>(kernel), S::kSmem);
  if (e != 0) return e;
  return launch_pdl(kernel, G, S::kThreads, S::kSmem, stream, tx, tw[0],
                    tw[1], tw[2], g);
}

template <class Ker, bool kWideW>
int run_wide(const int8_t* xq, const float* sx, const HostSeg* segs,
             int n_seg, int M, int K, int out_bf16, cudaStream_t stream) {
  using W = Wide<Ker::kInt4, kWideW>;
  WideArgs g{sx, {}, n_seg, 0, M, K, out_bf16};
  CUtensorMap tx, tw[kMaxSegs];
  int e = tensor_map(&tx, xq, K, M, W::kBX);
  for (int i = 0; i < n_seg && e == 0; ++i) {
    const int rows = Ker::kInt4 ? segs[i].N / 2 : segs[i].N;
    g.seg[i] = Seg{segs[i].s, segs[i].out, segs[i].N, segs[i].N / W::kCols};
    g.n_tiles += g.seg[i].tiles;
    e = tensor_map(&tw[i], segs[i].w, K, rows, W::kBW);
  }
  if (e != 0) return e;
  for (int i = n_seg; i < kMaxSegs; ++i) tw[i] = tw[0];
  const int tiles = (M + W::kBX - 1) / W::kBX * g.n_tiles;
  const int G = tiles < sm_count() ? tiles : sm_count();
  auto kernel = Ker::template wide<kWideW>();
  e = set_smem(reinterpret_cast<const void*>(kernel), W::kSmem);
  if (e != 0) return e;
  return launch_pdl(kernel, G, W::kThreads, W::kSmem, stream, tx, tw[0],
                    tw[1], tw[2], g);
}

// The whole matmul of x by 1..kMaxSegs weights: one row quantize into `ws`
// (xq (M, K) int8, then sx (M,) fp32), then one GEMM, chosen by M, over
// every weight's tiles. `Ker` names the file's kernels: kInt4, stream<NB>()
// and wide().
template <class Ker>
int matmul(const void* x, const HostSeg* segs, int n_seg, void* ws,
           long long ws_bytes, const Scratch& sc, int M, int K, int dtype,
           cudaStream_t stream) {
  bool ok = n_seg >= 1 && n_seg <= kMaxSegs && M >= 0 && K > 0 &&
            K % 128 == 0 && (dtype == 0 || dtype == 1) &&
            (long long)M * K + 4LL * M <= ws_bytes;
  for (int i = 0; ok && i < n_seg; ++i)
    ok = segs[i].N > 0 && segs[i].N % (Ker::kInt4 ? 256 : 128) == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  int8_t* xq = static_cast<int8_t*>(ws);
  float* sx = reinterpret_cast<float*>(xq + (size_t)M * K);
  const int qt = quant_threads(K / (dtype == 0 ? 4 : 8));
  // the row quantize takes the SM's shared-memory carveout the GEMM behind
  // it wants, so the GEMM's CTAs can start beside it
  static bool carved = false;
  if (!carved) {
    for (const void* fn : {reinterpret_cast<const void*>(
                               &quantize_rows_kernel<float>),
                           reinterpret_cast<const void*>(
                               &quantize_rows_kernel<__nv_bfloat16>)}) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    carved = true;
  }
  if (dtype == 0)
    quantize_rows_kernel<float><<<M, qt, 0, stream>>>(
        static_cast<const float*>(x), xq, sx, K);
  else
    quantize_rows_kernel<__nv_bfloat16><<<M, qt, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), xq, sx, K);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bf = dtype == 1;
  if (M <= kStreamMaxM)
    return M <= 8 ? run_stream<Ker, 1>(xq, sx, segs, n_seg, sc, M, K, bf, stream)
                  : run_stream<Ker, 2>(xq, sx, segs, n_seg, sc, M, K, bf, stream);
  if (Ker::kInt4) {
    // K6 takes its 256-column tiles where they alone fill the card
    long long cols = 0;
    for (int i = 0; i < n_seg; ++i) cols += segs[i].N;
    if ((M + 127) / 128 * (cols / 256) >= sm_count())
      return run_wide<Ker, true>(xq, sx, segs, n_seg, M, K, bf, stream);
  }
  return run_wide<Ker, false>(xq, sx, segs, n_seg, M, K, bf, stream);
}

}  // namespace a8
