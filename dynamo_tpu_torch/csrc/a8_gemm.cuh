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
// here the nibbles are unpacked in registers (and/or/sub/xor, exact), so
// K6 is K5 with a different B-fragment load.
//
// Two launches per matmul, both on the caller's stream:
// 1. quantize_rows_kernel: one CTA per row; 16-byte loads, block absmax,
//    then xq (M, K) int8 and sx (M,) fp32 into the caller's scratch (and
//    zeros for the split-K sums, when the GEMM splits).
// 2. the GEMM: one CTA per (BM x BN) output tile and K split;
//    mma.sync.m16n8k32 s8·s8→s32 fed by ldmatrix from shared rows padded
//    by 16 bytes (conflict-free), cp.async multi-stage pipeline over K;
//    the epilogue scales and stores straight from the accumulators.
//    blockIdx.x runs over M tiles, so the CTAs that share a weight tile
//    are launched together and read it from L2. Where the output tiles
//    would give fewer than two CTAs per SM (decode on every 8B projection:
//    N = 14336 is 224 tiles, 4096 64, 1024 16), K is split over
//    gridDim.z: each split adds its int32 sums into scratch with atomics
//    (exact in any order) and the last CTA of a tile, counted by an
//    atomic ticket, runs the epilogue on the totals.
// Operand layout: xq (M, K) row-major and the weights K-major — (N, K)
// int8, or (N/2, K) packed bytes whose low nibble is logical column 2j
// (stored +8) and whose high nibble is column 2j+1 — so every fragment
// register holds 4 consecutive k, as the s8 MMA wants. An int4 B load of
// 8 packed rows gives two n8 tiles: the low nibbles are the even logical
// columns, the high nibbles the odd ones; the epilogue interleaves them.
//
// Bound: at decode (M <= 16) bytes — the weights are streamed once
// (58.7 MB int8, 29.4 MB int4 for an 8B gate/up projection); at prefill
// (M ~ 512) int8 operations. Tiles by M: <= 16 rows: 16x64 tiles, 4 warps
// (224 tiles at N = 14336, split in 2 for two CTAs per SM); <= 64: 64x64,
// 4 warps; else 128x128, 8 warps. Left for later: wgmma/TMA, one prologue
// shared by the projections that read the same activations (q/k/v,
// gate/up), a persistent schedule.
//
// Shapes taken: K % 128 == 0, N % 128 == 0 (int8) or N % 256 == 0 (int4),
// any M >= 0; x fp32 or bf16, out of x's type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace a8 {

constexpr int kQuantThreads = 256;

struct GemmArgs {
  const int8_t* a;   // xq (M, K)
  const float* sx;   // (M,)
  const int8_t* b;   // weights, K-major rows
  const float* s;    // (N,)
  void* out;         // (M, N), fp32 or bf16
  int M, K, N;       // N: logical columns
  int out_bf16;
  int splits;        // K split across gridDim.z CTAs per output tile
  int* acc;          // splits > 1: (M, N) int32 sums, zeroed by the prologue
  int* counters;     // splits > 1: one per output tile, zeroed likewise
};

// (BM, BN logical, warps along M, warps along N, BK bytes, stages)
template <int BM_, int BN_, int WM_, int WN_, int BK_, int ST_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, kWarpsM = WM_, kWarpsN = WN_;
  static constexpr int BK = BK_, kStages = ST_;
  static constexpr int kThreads = 32 * WM_ * WN_;
};
using CfgDecode = Cfg<16, 64, 1, 4, 128, 4>;
using CfgMid = Cfg<64, 64, 2, 2, 128, 3>;
using CfgWide = Cfg<128, 128, 2, 4, 64, 4>;

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

// One CTA per row; the CTAs also zero `n_zero` ints of split-K scratch.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ sx, int K,
                         int* __restrict__ zero, int n_zero) {
  constexpr int V = 16 / sizeof(T);          // elements per 16-byte load
  __shared__ float red[kQuantThreads / 32];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_zero;
       i += gridDim.x * blockDim.x)
    zero[i] = 0;
  const size_t row = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + row * K);
  const int nv = K / V;
  float amax = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    float v[V];
    to_f32(src[i], v);
#pragma unroll
    for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    float m = lane < kQuantThreads / 32 ? red[lane] : 0.f;
    m = warp_max(m);
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const float scale = __fmul_rn(fmaxf(red[0], 1e-12f), 1.0f / 127.0f);
  int8_t* dst = xq + row * K;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    float v[V];
    to_f32(src[i], v);
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
  }
  if (threadIdx.x == 0) sx[row] = scale;
}

// ---------------------------------------------------------------------------
// GEMM
// ---------------------------------------------------------------------------

// 16 bytes global -> shared without registers; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
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

__device__ __forceinline__ void store2(void* out, size_t i, float a, float b,
                                       int bf16) {
  if (bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       i) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2(a, b);
}

__device__ __forceinline__ void store4(void* out, size_t i, float a, float b,
                                       float c, float d, int bf16) {
  if (bf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) =
        make_float4(a, b, c, d);
  }
}

// Fragment ownership (PTX m16n8k32): lane = 4·gid + tig holds A rows gid
// and gid+8 at k = 4·tig.. (+16), B column gid at k = 4·tig.. (+16), and
// accumulator rows gid / gid+8, columns 2·tig, 2·tig+1 of its n8 tile.
template <bool kInt4, class C>
__device__ __forceinline__ void gemm_tile(const GemmArgs& g) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, ST = C::kStages;
  constexpr int WM = BM / C::kWarpsM;        // warp tile rows
  constexpr int WN = BN / C::kWarpsN;        // warp tile logical columns
  constexpr int MT = WM / 16;                // m16 tiles per warp
  constexpr int NT = WN / 8;                 // n8 tiles per warp
  constexpr int BR = kInt4 ? BN / 2 : BN;    // weight rows per CTA tile
  constexpr int LDS = BK + 16;               // padded smem row, bytes
  constexpr int CH = BK / 16;                // 16-byte chunks per row
  static_assert(MT >= 1 && NT % 2 == 0 && BK % 32 == 0, "tile shape");
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* a_s = smem;                        // ST x BM x LDS
  int8_t* b_s = smem + ST * BM * LDS;        // ST x BR x LDS

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int row0 = kInt4 ? n0 / 2 : n0;      // first weight row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int gid = lane >> 2, tig = lane & 3;
  const int KT = g.K / BK / g.splits;        // k tiles of this CTA's split
  const int kt0 = blockIdx.z * KT;

  auto load = [&](int kt, int slot) {
    const int k0 = (kt0 + kt) * BK;
    int8_t* as = a_s + slot * BM * LDS;
    int8_t* bs = b_s + slot * BR * LDS;
#pragma unroll
    for (int i = threadIdx.x; i < BM * CH; i += C::kThreads) {
      const int r = i / CH, c = i % CH;
      const bool ok = m0 + r < g.M;          // rows past M read as zeros
      cp_async16(as + r * LDS + c * 16,
                 g.a + (ok ? (size_t)(m0 + r) * g.K + k0 + c * 16 : 0),
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = threadIdx.x; i < BR * CH; i += C::kThreads) {
      const int r = i / CH, c = i % CH;
      cp_async16(bs + r * LDS + c * 16,
                 g.b + (size_t)(row0 + r) * g.K + k0 + c * 16, 16);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < KT) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();   // stage kt landed; stage kt-1 fully consumed
    if (kt + ST - 1 < KT) load(kt + ST - 1, (kt + ST - 1) % ST);
    cp_async_commit();
    const int8_t* as = a_s + (kt % ST) * BM * LDS + wm * WM * LDS;
    const int8_t* bs =
        b_s + (kt % ST) * BR * LDS + (kInt4 ? wn * WN / 2 : wn * WN) * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldsm_x4(af[mi],
                as + (mi * 16 + (lane & 15)) * LDS + kk * 32 + (lane >> 4) * 16);
      uint32_t bf[NT][2];
      if constexpr (!kInt4) {
        // 16 weight rows (two n8 tiles) x 32 k per ldmatrix.x4
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[4];
          ldsm_x4(r, bs + (p * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDS +
                         kk * 32 + ((lane >> 3) & 1) * 16);
          bf[2 * p][0] = r[0];
          bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2];
          bf[2 * p + 1][1] = r[3];
        }
      } else {
        // 8 packed rows (16 logical columns) x 32 k per ldmatrix.x2: low
        // nibbles = the even columns' tile, high nibbles = the odd ones'
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[2];
          ldsm_x2(r, bs + (p * 8 + (lane & 7)) * LDS + kk * 32 +
                         ((lane >> 3) & 1) * 16);
          bf[2 * p][0] = nib_lo(r[0]);
          bf[2 * p][1] = nib_lo(r[1]);
          bf[2 * p + 1][0] = nib_hi(r[0]);
          bf[2 * p + 1][1] = nib_hi(r[1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();

  const int rbase = m0 + wm * WM;
  const int cbase = n0 + wn * WN;
  if (g.splits > 1) {
    // split-K: add this split's int32 sums into the tile's scratch (exact,
    // in any order); the CTA that arrives last reads the totals back and
    // runs the epilogue
    __shared__ int last;
    auto each = [&](auto&& f) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = rbase + mi * 16 + gid + 8 * half;
          if (row >= g.M) continue;
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // logical column of accumulator (ni, e): see the epilogue
              const int col = kInt4 ? cbase + (ni >> 1) * 16 + 4 * tig +
                                          2 * e + (ni & 1)
                                    : cbase + ni * 8 + 2 * tig + e;
              f(acc[mi][ni][2 * half + e], g.acc + (size_t)row * g.N + col);
            }
        }
    };
    each([](int v, int* p) { atomicAdd(p, v); });
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(g.counters + blockIdx.y * gridDim.x + blockIdx.x, 1) ==
             g.splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    each([](int& v, int* p) { v = __ldcg(p); });
  }

  // epilogue: (float(acc) · sx[row]) · s[col], rounded once on store
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rbase + mi * 16 + gid + 8 * half;
      if (row >= g.M) continue;
      const float xs = g.sx[row];
      const size_t o = (size_t)row * g.N;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        // tiles 2p ("even") and 2p+1 ("odd"); this thread's two values of
        // each at this row
        const int e0 = acc[mi][2 * p][2 * half];
        const int e1 = acc[mi][2 * p][2 * half + 1];
        const int o0 = acc[mi][2 * p + 1][2 * half];
        const int o1 = acc[mi][2 * p + 1][2 * half + 1];
        if constexpr (!kInt4) {
          const int c0 = cbase + p * 16 + 2 * tig;       // tile 2p
          const int c1 = c0 + 8;                         // tile 2p+1
          store2(g.out, o + c0, scale(e0, xs, g.s[c0]),
                 scale(e1, xs, g.s[c0 + 1]), g.out_bf16);
          store2(g.out, o + c1, scale(o0, xs, g.s[c1]),
                 scale(o1, xs, g.s[c1 + 1]), g.out_bf16);
        } else {
          // packed rows p·8 + 2·tig and p·8 + 2·tig + 1 hold logical
          // columns c, c+1 and c+2, c+3 (low nibble even, high odd)
          const int c = cbase + p * 16 + 4 * tig;
          store4(g.out, o + c, scale(e0, xs, g.s[c]),
                 scale(o0, xs, g.s[c + 1]), scale(e1, xs, g.s[c + 2]),
                 scale(o1, xs, g.s[c + 3]), g.out_bf16);
        }
      }
    }
  }
}

template <bool kInt4, class C>
int launch_gemm(void (*kernel)(GemmArgs), const GemmArgs& g,
                cudaStream_t stream) {
  constexpr int BR = kInt4 ? C::BN / 2 : C::BN;
  const size_t smem = (size_t)C::kStages * (C::BM + BR) * (C::BK + 16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((g.M + C::BM - 1) / C::BM, g.N / C::BN, g.splits);
  kernel<<<grid, C::kThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

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

// K splits for a grid of `tiles` output tiles over KT k tiles: enough CTAs
// for two per SM, each split at least 4 k tiles long, dividing KT.
inline int pick_splits(int tiles, int KT) {
  const int want = (2 * sm_count() + tiles - 1) / tiles;
  for (int s = want < KT / 4 ? want : KT / 4; s > 1; --s)
    if (KT % s == 0) return s;
  return 1;
}

// The whole matmul: prologue launch, then the GEMM for M's tile config.
// `pick(Cfg{})` returns the file's __global__ GEMM kernel for that config.
// Scratch `ws` (ws_bytes): xq (M·K int8), sx (M fp32), then, where there is
// room, split-K sums (M·N int32) and tile counters.
template <bool kInt4, class C, class Pick>
int run(const void* x, const void* w, const float* s, void* out, void* ws,
        long long ws_bytes, int M, int K, int N, int dtype,
        cudaStream_t stream, Pick pick) {
  char* base = static_cast<char*>(ws);
  int8_t* a = reinterpret_cast<int8_t*>(base);
  float* sx = reinterpret_cast<float*>(base + (size_t)M * K);
  const size_t fixed = (size_t)M * K + 4 * (size_t)M;
  const int m_tiles = (M + C::BM - 1) / C::BM, n_tiles = N / C::BN;
  int splits = pick_splits(m_tiles * n_tiles, K / C::BK);
  const size_t need = 4 * ((size_t)M * N + (size_t)m_tiles * n_tiles);
  if (splits > 1 && (long long)(fixed + need) > ws_bytes) splits = 1;
  int* acc = reinterpret_cast<int*>(base + fixed);
  const int n_zero =
      splits > 1 ? (int)((size_t)M * N + (size_t)m_tiles * n_tiles) : 0;
  if (dtype == 0)
    quantize_rows_kernel<float><<<M, kQuantThreads, 0, stream>>>(
        static_cast<const float*>(x), a, sx, K, acc, n_zero);
  else
    quantize_rows_kernel<__nv_bfloat16><<<M, kQuantThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), a, sx, K, acc, n_zero);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const GemmArgs g{a, sx, static_cast<const int8_t*>(w), s, out, M, K, N,
                   dtype == 1, splits, acc, acc + (size_t)M * N};
  return launch_gemm<kInt4, C>(pick(C{}), g, stream);
}

template <bool kInt4, class Pick>
int matmul(const void* x, const void* w, const float* s, void* out, void* ws,
           long long ws_bytes, int M, int K, int N, int dtype,
           cudaStream_t stream, Pick pick) {
  if (M < 0 || K <= 0 || K % 128 != 0 || N <= 0 ||
      N % (kInt4 ? 256 : 128) != 0 || (dtype != 0 && dtype != 1) ||
      (long long)M * K + 4LL * M > ws_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  if (M <= CfgDecode::BM)
    return run<kInt4, CfgDecode>(x, w, s, out, ws, ws_bytes, M, K, N, dtype,
                                 stream, pick);
  if (M <= CfgMid::BM)
    return run<kInt4, CfgMid>(x, w, s, out, ws, ws_bytes, M, K, N, dtype,
                              stream, pick);
  return run<kInt4, CfgWide>(x, w, s, out, ws, ws_bytes, M, K, N, dtype,
                             stream, pick);
}

}  // namespace a8
