// Paged decode attention (K4): one query token per lane over the lane's
// page table, in the decode burst's hot loop.
//
// Replaces the TPU path dynamo_tpu/engine/attention.py `_pallas_decode`,
// which calls the upstream Pallas `paged_attention` kernel. It computes the
// function of that file's plain version `_xla_decode`: lane b's H query
// heads attend its KV positions s < lengths[b], whose pages are
// page_tables[b, s / P]; GQA (the G = H/KVH query heads of a KV head share
// its pages); scores scaled by 1/sqrt(D); fp32 softmax. The upstream TPU
// kernel omits the 1/sqrt(D) scale and `_pallas_decode` passes q unscaled,
// so on a TPU the reference's decode attention is unscaled; this kernel
// keeps the scale, as `_xla_decode`, `prefill_attention` and the ragged
// kernel do. A lane with lengths[b] <= 0 (a padding lane) writes exact
// zeros and reads no page (`_xla_decode` gives a uniform-softmax row there).
//
// Two paths in one source:
// - bf16 (the serving path): the shared core csrc/paged_attention.cuh at one
//   row per lane (qpos = lengths[b] - 1, so a length-0 lane is a zero row):
//   the G query heads of a KV head are the MMA rows of one tile, pages
//   arrive by cp.async into an 8-stage mbarrier ring fed by a producer warp,
//   the CTAs split the visible (lane, KV head, page) work evenly on the
//   device and the last CTA of a split (lane, KV head) merges the pieces in
//   the same launch. P·V from P's bf16 head and tail, as in K1.
// - fp32 (the tests' exact path; no tensor-core type keeps fp32): one CTA
//   per (lane b, KV head g, split), 128 threads; the G query heads in
//   shared memory as fp32 pre-scaled by 1/sqrt(D); the CTA walks only the
//   ceil(len/P) pages the lane can see (the TPU grid visits every
//   pages_per_compute_block block of the table), a few pages per step as
//   fp32 rows padded to D+1 floats, one thread per (head, key) score, one
//   warp per head for the online softmax, one thread per (head, d)
//   accumulator; each lane's pages divided evenly among S splits whose
//   (m, l, acc) a second launch merges (S = 1: the first writes the output).
//
// Bound: bytes. Every visible K/V element is read once per (lane, KV head)
// and used for 4 flops per query head, far below the card's flop/byte
// ratio.
//
// Geometry the launcher takes: bf16 as the core (G <= 8, D in {16, 32, 64,
// 96, 128}, P a power of two <= 64); fp32: D a multiple of 8 and dynamic
// shared memory (2·G·D + 2·KEYS·(D+1) + G·KEYS + 3·G floats, KEYS =
// P·max(1, 32/P)) up to the card's 227 KB. The wrapper checks both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCombineThreads = 128;
constexpr int kStepKeys = 32;        // keys staged per step (at least a page)

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }

// one 16-byte vector of T as fp32 values times `scale`
__device__ __forceinline__ void widen(uint4 e, float* d, float scale,
                                      const float*) {
  d[0] = __uint_as_float(e.x) * scale;
  d[1] = __uint_as_float(e.y) * scale;
  d[2] = __uint_as_float(e.z) * scale;
  d[3] = __uint_as_float(e.w) * scale;
}

// rows x cols contiguous T (a row a multiple of 16 bytes, 16-byte aligned)
// from global memory into shared fp32 rows of `stride` floats, times scale.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* __restrict__ dst, int rows,
                                           int cols, int stride,
                                           float scale) {
  constexpr int kPer = 16 / sizeof(T);
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  const int chunks_per_row = cols / kPer;
  for (int i = threadIdx.x; i < rows * chunks_per_row; i += blockDim.x) {
    const int r = i / chunks_per_row;
    widen(src4[i], dst + r * stride + (i - r * chunks_per_row) * kPer, scale,
          static_cast<const T*>(nullptr));
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ lengths,
                        const int* __restrict__ page_tables,
                        T* __restrict__ out, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int n_heads,
                        int n_kv_heads, int n_pages, int page_size,
                        int head_dim, int max_pages, int pages_per_step,
                        float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int G = n_heads / n_kv_heads;
  const int P = page_size;
  const int D = head_dim;
  const int DP = D + 1;                 // padded row: conflict-free columns
  const int KEYS = pages_per_step * P;
  float* q_s = smem;                    // G*D      scaled queries
  float* acc_s = q_s + G * D;           // G*D      un-normalised outputs
  float* k_s = acc_s + G * D;           // KEYS*DP  staged K rows
  float* v_s = k_s + KEYS * DP;         // KEYS*DP  staged V rows
  float* p_s = v_s + KEYS * DP;         // G*KEYS   scores, then probs
  float* m_s = p_s + G * KEYS;          // G        running max
  float* l_s = m_s + G;                 // G        running denominator
  float* a_s = l_s + G;                 // G        rescale of this step

  const size_t head0 = (size_t)b * n_heads + (size_t)g * G;
  const int len = lengths[b];
  if (len <= 0) {  // padding lane: exact zeros (the combine pass writes them)
    if (n_splits == 1)
      for (int i = threadIdx.x; i < G * D; i += blockDim.x)
        store_out(out + head0 * D + i, 0.f);
    return;
  }
  const int visible = min((len + P - 1) / P, max_pages);
  const int per_split = (visible + n_splits - 1) / n_splits;
  const int page_begin = min(visible, split * per_split);
  const int page_end = min(visible, page_begin + per_split);

  stage_rows(q + head0 * D, q_s, G, D, D, scale);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) acc_s[i] = 0.f;
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }

  const int* table = page_tables + (size_t)b * max_pages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int j0 = page_begin; j0 < page_end; j0 += pages_per_step) {
    const int n_step = min(pages_per_step, page_end - j0);
    const int keys = n_step * P;
    const int n_valid = min(keys, len - j0 * P);      // kvpos < len
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
      store_out(out + head0 * D + i, l > 0.f ? acc_s[i] / l : 0.f);
    }
    return;
  }
  // partials of this split: acc (B, S, H, D), (m, l) (B, S, H, 2); an empty
  // split writes m = -inf, l = 0
  const size_t part0 = ((size_t)b * n_splits + split) * n_heads + g * G;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    part_acc[part0 * D + i] = acc_s[i];
  if (threadIdx.x < G) {
    part_ml[(part0 + threadIdx.x) * 2] = m_s[threadIdx.x];
    part_ml[(part0 + threadIdx.x) * 2 + 1] = l_s[threadIdx.x];
  }
}

// Merge the splits of one (lane, head): out = sum_s w_s acc_s / sum_s w_s
// l_s with w_s = exp(m_s - max_s m_s); empty splits carry m = -inf (w 0).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_splits_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ lengths, T* __restrict__ out,
                          int n_heads, int head_dim, int n_splits) {
  extern __shared__ float w_s[];        // n_splits weights
  __shared__ float denom;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  T* o = out + ((size_t)b * n_heads + h) * head_dim;
  if (lengths[b] <= 0) {
    for (int d = threadIdx.x; d < head_dim; d += blockDim.x)
      store_out(o + d, 0.f);
    return;
  }
  const float* ml = part_ml + ((size_t)b * n_splits * n_heads + h) * 2;
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
  const float* acc =
      part_acc + ((size_t)b * n_splits * n_heads + h) * head_dim;
  const size_t a_stride = (size_t)n_heads * head_dim;
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) a += w_s[s] * acc[s * a_stride + d];
    store_out(o + d, denom > 0.f ? a / denom : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           const int* tables, void* out, float* part_acc, float* part_ml,
           int batch, int n_heads, int n_kv_heads, int n_pages, int page_size,
           int head_dim, int max_pages, int n_splits, float scale,
           cudaStream_t stream) {
  const int G = n_heads / n_kv_heads;
  const int pages_per_step = page_size >= kStepKeys ? 1
                                                    : kStepKeys / page_size;
  const size_t keys = (size_t)pages_per_step * page_size;
  const size_t smem =
      sizeof(float) * (2 * (size_t)G * head_dim + 2 * keys * (head_dim + 1) +
                       (size_t)G * keys + 3 * (size_t)G);
  auto kernel = paged_decode_kernel<T>;
  // the card's whole 227 KB, once per kernel instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(batch, n_kv_heads, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, tables, static_cast<T*>(out),
      part_acc, part_ml, n_heads, n_kv_heads, n_pages, page_size, head_dim,
      max_pages, pages_per_step, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  decode_combine_splits_kernel<T>
      <<<dim3(batch, n_heads), kCombineThreads, sizeof(float) * n_splits,
         stream>>>(part_acc, part_ml, lengths, static_cast<T*>(out), n_heads,
                   head_dim, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k/v pages and out share it).
// fp32: n_blocks is the split count S; S > 1 needs part (batch*S*n_heads*
// head_dim floats) and part_ml (batch*S*n_heads*2 floats) of scratch.
// bf16: n_blocks is the grid's CTA count n; part holds 2n partial slots of
// 64*(head_dim+2) floats and counters batch*n_kv_heads ints, all 0 (the
// kernel leaves them 0); part_ml is unused.
extern "C" int paged_attention_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* lengths, const int* page_tables, void* out, float* part,
    float* part_ml, int* counters, int batch, int n_heads, int n_kv_heads,
    int n_pages, int page_size, int head_dim, int max_pages, int n_blocks,
    float scale, int dtype, cudaStream_t stream) {
  if (batch == 0) return 0;
  if (dtype == 1) {
    pa::Args a{};
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k_pages);
    a.v = static_cast<const __nv_bfloat16*>(v_pages);
    a.lengths = lengths;
    a.tables = page_tables;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.part = part;
    a.counters = counters;
    a.rows = batch;
    a.n_heads = n_heads;
    a.n_kv_heads = n_kv_heads;
    a.n_pages = n_pages;
    a.page_size = page_size;
    a.max_pages = max_pages;
    return pa::launch<true>(a, head_dim, scale, n_blocks, stream);
  }
  if (dtype != 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_blocks < 1 || n_blocks > 65535 || n_kv_heads > 65535 ||
      page_size <= 0 || head_dim % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(q, k_pages, v_pages, lengths, page_tables, out, part,
                       part_ml, batch, n_heads, n_kv_heads, n_pages,
                       page_size, head_dim, max_pages, n_blocks, scale,
                       stream);
}
