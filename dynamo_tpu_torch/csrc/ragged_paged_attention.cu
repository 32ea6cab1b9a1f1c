// Ragged paged attention (K1): flat query rows over a paged KV cache.
//
// Replaces the Pallas TPU kernel dynamo_tpu/engine/ragged.py
// `ragged_paged_attention`, and computes what it computes: row t (a decode
// lane's token or any token of a prefill chunk) attends the KV positions
// s <= token_qpos[t] of lane token_lanes[t], whose pages are found by the
// double indirection lane_tables[token_lanes[t], j]; GQA (H/KVH query
// heads share one KV head); fp32 online softmax; rows with qpos = -1
// (padding) output exactly 0.
//
// Both paths walk only the pages a row can see, where the TPU grid visits
// every max_pages/ppcb block (masked blocks contribute exactly zero there,
// so the result is the same). The TPU's sequential grid carries the
// softmax state across blocks; here a loop inside the CTA does.
//
// bf16 (the serving path): the shared core csrc/paged_attention.cuh. A
// tile is a run of up to 64/G consecutive rows of one lane (a prefill
// chunk's rows share their lane's pages) and its rows x G query heads are
// the MMA rows, so a decode row is G live rows and a 16-row chunk tile at
// G = 4 fills four m16 tiles; pages arrive by cp.async into an 8-stage
// mbarrier ring fed by a producer warp and stay bf16 in shared memory; the
// CTAs
// split the visible (tile, KV head, page) work evenly on the device, in
// decode and mixed rounds alike, and the last CTA of a split item merges
// its pieces in the same launch. One launch per call, no host read of
// token_qpos or token_lanes.
// fp32 (the tests' exact path; no tensor-core type keeps fp32 precision):
// - one CTA per (row t, KV head g, split), 128 threads; the G query heads
//   in shared memory as fp32 pre-scaled by 1/sqrt(D); kPagesPerStep pages
//   per step staged as fp32 rows padded to D+1 floats, one thread per
//   (head, key) score, one warp per head for the softmax, one thread per
//   (head, d) accumulator; split-KV when the grid cannot fill the card
//   (each split writes (m, l, acc) to scratch and a second launch merges
//   them; with S = 1 the first launch writes the output).
// Padding rows (qpos < 0) write exact zeros and read no page.
//
// Bound: bytes at decode (each visible K/V element is read once per (row,
// KV head) and used for 4 flops per query head); at prefill the tile
// shares each page across its rows, and the bf16 path moves the flops to
// tensor cores.
//
// Geometry the launcher takes: bf16 as the core (G <= 8, D in {16, 32,
// 64, 96, 128}, P a power of two <= 64); fp32: D a multiple of 4 and
// dynamic shared memory (2·G·D + 2·KEYS·(D+1) + G·KEYS + 3·G floats, KEYS
// = kPagesPerStep·P) up to the card's 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPagesPerStep = 2;
constexpr int kCombineThreads = 128;

__device__ __forceinline__ void store_f32(float* dst, float x) { *dst = x; }

// rows x cols contiguous floats (cols a multiple of 4, 16-byte aligned)
// from global memory into shared rows of `stride` floats, times `scale`.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           float* __restrict__ dst, int rows,
                                           int cols, int stride,
                                           float scale) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const int chunks_per_row = cols / 4;
  for (int i = threadIdx.x; i < rows * chunks_per_row; i += blockDim.x) {
    const float4 e = src4[i];
    const int r = i / chunks_per_row;
    float* d = dst + r * stride + (i - r * chunks_per_row) * 4;
    d[0] = e.x * scale;
    d[1] = e.y * scale;
    d[2] = e.z * scale;
    d[3] = e.w * scale;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
    ragged_fp32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pages,
                       const float* __restrict__ v_pages,
                       const int* __restrict__ token_qpos,
                       const int* __restrict__ token_lanes,
                       const int* __restrict__ lane_tables,
                       float* __restrict__ out, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int n_heads,
                       int n_kv_heads, int n_pages, int page_size,
                       int head_dim, int max_pages, float scale) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int G = n_heads / n_kv_heads;
  const int P = page_size;
  const int D = head_dim;
  const int DP = D + 1;                 // padded row: conflict-free columns
  const int KEYS = kPagesPerStep * P;
  float* q_s = smem;                    // G*D      scaled queries
  float* acc_s = q_s + G * D;           // G*D      un-normalised outputs
  float* k_s = acc_s + G * D;           // KEYS*DP  staged K rows
  float* v_s = k_s + KEYS * DP;         // KEYS*DP  staged V rows
  float* p_s = v_s + KEYS * DP;         // G*KEYS   scores, then probs
  float* m_s = p_s + G * KEYS;          // G        running max
  float* l_s = m_s + G;                 // G        running denominator
  float* a_s = l_s + G;                 // G        rescale of this step

  const size_t head0 = (size_t)t * n_heads + (size_t)g * G;
  const int qpos = token_qpos[t];
  if (qpos < 0) {  // padding row: exact zeros (the combine pass writes them)
    if (n_splits == 1)
      for (int i = threadIdx.x; i < G * D; i += blockDim.x)
        store_f32(out + head0 * D + i, 0.f);
    return;
  }
  const int visible = min(qpos / P + 1, max_pages);   // ceil((qpos+1)/P)
  const int per_split = (visible + n_splits - 1) / n_splits;
  const int page_begin = split * per_split;
  const int page_end = min(visible, page_begin + per_split);

  stage_rows(q + head0 * D, q_s, G, D, D, scale);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) acc_s[i] = 0.f;
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }

  const int* table = lane_tables + (size_t)token_lanes[t] * max_pages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int j0 = page_begin; j0 < page_end; j0 += kPagesPerStep) {
    const int n_step = min(kPagesPerStep, page_end - j0);
    const int keys = n_step * P;
    const int n_valid = min(keys, qpos - j0 * P + 1);   // kvpos <= qpos
    __syncthreads();  // previous step fully consumed (and q staged)
    for (int pi = 0; pi < n_step; ++pi) {
      const size_t base = ((size_t)g * n_pages + table[j0 + pi]) * P * D;
      stage_rows(k_pages + base, k_s + pi * P * DP, P, D, DP, 1.f);
      stage_rows(v_pages + base, v_s + pi * P * DP, P, D, DP, 1.f);
    }
    __syncthreads();
    // scores: one thread per (head, key), four independent partial sums
    for (int hk = threadIdx.x; hk < G * keys; hk += blockDim.x) {
      const int h = hk / keys;
      const int key = hk - h * keys;
      const float* qh = q_s + h * D;
      const float* kr = k_s + key * DP;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int d = 0; d < D; d += 4) {
        s0 += qh[d] * kr[d];
        s1 += qh[d + 1] * kr[d + 1];
        s2 += qh[d + 2] * kr[d + 2];
        s3 += qh[d + 3] * kr[d + 3];
      }
      p_s[h * KEYS + key] = (s0 + s1) + (s2 + s3);
    }
    __syncthreads();
    // online softmax update, one warp per query head
    for (int h = warp; h < G; h += n_warps) {
      float* ph = p_s + h * KEYS;
      float mx = -INFINITY;
      for (int key = lane; key < n_valid; key += 32) mx = fmaxf(mx, ph[key]);
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int key = lane; key < keys; key += 32) {
        const float e = key < n_valid ? expf(ph[key] - m_new) : 0.f;
        ph[key] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);   // m_prev = -inf -> 0
        m_s[h] = m_new;
        l_s[h] = alpha * l_s[h] + sum;
        a_s[h] = alpha;
      }
    }
    __syncthreads();
    // acc[h][d] = alpha_h * acc[h][d] + sum_key prob[h][key] * v[key][d]
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
      const int h = i / D;
      const int d = i - h * D;
      const float* ph = p_s + h * KEYS;
      float a = acc_s[i] * a_s[h];
      for (int key = 0; key < keys; ++key) a += ph[key] * v_s[key * DP + d];
      acc_s[i] = a;
    }
  }
  __syncthreads();
  if (n_splits == 1) {
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
      const float l = l_s[i / D];
      store_f32(out + head0 * D + i, l > 0.f ? acc_s[i] / l : 0.f);
    }
    return;
  }
  // partials of this split: acc (T, S, H, D), (m, l) (T, S, H, 2)
  const size_t part0 = ((size_t)t * n_splits + split) * n_heads + g * G;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    part_acc[part0 * D + i] = acc_s[i];
  if (threadIdx.x < G) {
    part_ml[(part0 + threadIdx.x) * 2] = m_s[threadIdx.x];
    part_ml[(part0 + threadIdx.x) * 2 + 1] = l_s[threadIdx.x];
  }
}

// Merge the splits of one (row, head): out = sum_s w_s acc_s / sum_s w_s
// l_s with w_s = exp(m_s - max_s m_s); empty splits carry m = -inf (w 0).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    combine_splits_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ token_qpos,
                          T* __restrict__ out, int n_heads, int head_dim,
                          int n_splits) {
  extern __shared__ float w_s[];        // n_splits weights
  __shared__ float denom;
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  T* o = out + ((size_t)t * n_heads + h) * head_dim;
  if (token_qpos[t] < 0) {
    for (int d = threadIdx.x; d < head_dim; d += blockDim.x)
      store_f32(o + d, 0.f);
    return;
  }
  const float* ml = part_ml + ((size_t)t * n_splits * n_heads + h) * 2;
  const size_t s_stride = (size_t)n_heads * 2;
  if (threadIdx.x == 0) {
    float m_max = -INFINITY;
    for (int s = 0; s < n_splits; ++s) m_max = fmaxf(m_max, ml[s * s_stride]);
    float l = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float m = ml[s * s_stride];
      const float w = m == -INFINITY ? 0.f : expf(m - m_max);
      w_s[s] = w;
      l += w * ml[s * s_stride + 1];
    }
    denom = l;
  }
  __syncthreads();
  const float* acc = part_acc + ((size_t)t * n_splits * n_heads + h) * head_dim;
  const size_t a_stride = (size_t)n_heads * head_dim;
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) a += w_s[s] * acc[s * a_stride + d];
    store_f32(o + d, denom > 0.f ? a / denom : 0.f);
  }
}

int launch_fp32(const void* q, const void* k, const void* v, const int* qpos,
                const int* lanes, const int* tables, void* out,
                float* part_acc, float* part_ml, int rows, int n_heads,
                int n_kv_heads, int n_pages, int page_size, int head_dim,
                int max_pages, int n_splits, float scale,
                cudaStream_t stream) {
  const int G = n_heads / n_kv_heads;
  const size_t keys = (size_t)kPagesPerStep * page_size;
  const size_t smem =
      sizeof(float) * (2 * (size_t)G * head_dim + 2 * keys * (head_dim + 1) +
                       (size_t)G * keys + 3 * (size_t)G);
  auto kernel = ragged_fp32_kernel;
  // the card's whole 227 KB, once per kernel instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows, n_kv_heads, n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qpos, lanes, tables,
      static_cast<float*>(out),
      part_acc, part_ml, n_heads, n_kv_heads, n_pages, page_size, head_dim,
      max_pages, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  combine_splits_kernel<float>
      <<<dim3(rows, n_heads), kCombineThreads, sizeof(float) * n_splits,
         stream>>>(part_acc, part_ml, qpos, static_cast<float*>(out), n_heads,
                   head_dim, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k/v pages and out share it).
// fp32: n_blocks is the split count S; S > 1 needs part (rows*S*n_heads*
// head_dim floats) and part_ml (rows*S*n_heads*2 floats) of scratch.
// bf16: n_blocks is the grid's CTA count n; part holds 2n partial slots of
// 64*(head_dim+2) floats and counters rows*n_kv_heads ints, all 0 (the
// kernel leaves them 0); part_ml is unused.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* token_qpos, const int* token_lanes, const int* lane_tables,
    void* out, float* part, float* part_ml, int* counters, int rows,
    int n_heads, int n_kv_heads, int n_pages, int page_size, int head_dim,
    int max_pages, int n_blocks, float scale, int dtype,
    cudaStream_t stream) {
  if (rows == 0) return 0;
  if (dtype == 1) {
    pa::Args a{};
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k_pages);
    a.v = static_cast<const __nv_bfloat16*>(v_pages);
    a.qpos = token_qpos;
    a.lanes = token_lanes;
    a.tables = lane_tables;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.part = part;
    a.counters = counters;
    a.rows = rows;
    a.n_heads = n_heads;
    a.n_kv_heads = n_kv_heads;
    a.n_pages = n_pages;
    a.page_size = page_size;
    a.max_pages = max_pages;
    return pa::launch<false>(a, head_dim, scale, n_blocks, stream);
  }
  if (dtype != 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_blocks < 1 || n_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fp32(q, k_pages, v_pages, token_qpos, token_lanes,
                     lane_tables, out, part, part_ml, rows, n_heads,
                     n_kv_heads, n_pages, page_size, head_dim, max_pages,
                     n_blocks, scale, stream);
}
