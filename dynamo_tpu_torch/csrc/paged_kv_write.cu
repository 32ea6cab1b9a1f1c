// Paged KV write (K2): scatter one K row and one V row per token and KV
// head into the paged caches, in place, reading K and V where the
// projections and RoPE left them.
//
// Replaces the Pallas TPU kernel dynamo_tpu/engine/kernels.py
// `paged_kv_write`, which DMAs the touched page block in, blends one row
// and DMAs it out (the TPU's sequential grid makes that safe). Here every
// row is stored directly: no read-back, no blend.
//
// Layout: caches kc/vc (KVH, N, P, D), contiguous; rows k/v (B, KVH, D)
// with any strides on B and KVH (in 16-byte units, from the wrapper) and
// stride 1 on D, so a step hands over the projection's output as it lies;
// page_ids/offsets (B,) int32, already redirected once per step by the
// caller (models/llama.py `_kv_targets`): invalid rows target scratch page
// 0, offset 0. Those padding rows race on the GPU, which is harmless
// because page 0 is never allocated to a sequence (engine/pages.py), so
// attention never reads it unmasked. The caller guarantees page_ids < N
// and offsets < P.
//
// Bound: bytes. The kernel is a copy: every byte of K and V is read once
// and written once into its page, and nothing is computed. At the main
// path's sizes (8 to 768 rows) it sits near the launch floor, so what
// counts is how many 16-byte chunks are in flight at once, how short each
// thread's chain from its index to its load is, and that the step
// launches nothing around it. The work is a flat list of 16-byte chunks,
// one per thread (a grid-stride loop past what fits on the card), ordered
// (row, head, K|V, chunk of D): at bf16 D 128 a warp moves one (row,
// head), K on lanes 0-15 and V on lanes 16-31; the 768-row mixed round is
// one pass of 768 CTAs on 132 SMs, the 8-row decode round 8 CTAs. The
// index divides by multiply-high (FastDiv), a few instructions on the way
// to the first load, and each thread's row load is issued before its
// dependent page-id load is needed. (Two or four chunks per thread, with
// fewer CTAs, measured no faster on an H100: PERF.md.)
//
// It must run on the caller's stream before attention reads the cache in
// the same layer (the inclusive mask kvpos <= qpos includes the token's
// own K/V): the wrapper launches it on torch's current stream.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;   // 2048 resident threads per SM

// n / d for 0 <= n < 2^31 as (umulhi(n, m) + n) >> s (Granlund and
// Montgomery; d = 2^k gives m = 1, s = k)
struct FastDiv {
  unsigned d, m, s;

  FastDiv() = default;
  explicit FastDiv(unsigned divisor) : d(divisor), s(0) {
    while ((1ull << s) < d) ++s;
    m = (unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }

  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

struct PagedKvWriteMap {
  uint4* kc;
  uint4* vc;
  const uint4* k;
  const uint4* v;
  const int* page_ids;
  const int* offsets;
  long long k_sb, k_sh, v_sb, v_sh;   // source strides, 16-byte chunks
  unsigned n_pages, page_size;
  FastDiv chunks, kvh;                // 16-byte chunks per row; KV heads

  // chunk j = ((b * kvh + h) * 2 + kv) * chunks + c
  __device__ __forceinline__ void split(unsigned j, unsigned& b, unsigned& h,
                                        unsigned& kv, unsigned& c) const {
    const unsigned r = chunks.div(j), hb = r >> 1;
    c = j - r * chunks.d;
    kv = r & 1;
    b = kvh.div(hb);
    h = hb - b * kvh.d;
  }

  __device__ __forceinline__ const uint4* src(unsigned j) const {
    unsigned b, h, kv, c;
    split(j, b, h, kv, c);
    return kv ? v + b * v_sb + h * v_sh + c : k + b * k_sb + h * k_sh + c;
  }

  __device__ __forceinline__ uint4* dst(unsigned j) const {
    unsigned b, h, kv, c;
    split(j, b, h, kv, c);
    const size_t at =
        (((size_t)h * n_pages + (unsigned)page_ids[b]) * page_size +
         (unsigned)offsets[b]) * chunks.d + c;
    return (kv ? vc : kc) + at;
  }
};

__global__ void __launch_bounds__(kThreads)
    paged_kv_write_kernel(PagedKvWriteMap map, unsigned total) {
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned j = blockIdx.x * kThreads + threadIdx.x; j < total;
       j += stride) {
    const uint4 val = __ldg(map.src(j));
    *map.dst(j) = val;
  }
}

int sm_count() {
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

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// row_bytes = D * sizeof(element), a multiple of 16; k_sb .. v_sh are the
// sources' B and KVH strides in bytes, multiples of 16; k and v 16-byte
// aligned.
extern "C" int paged_kv_write_launch(
    void* kc, void* vc, const void* k, const void* v, const int* page_ids,
    const int* offsets, long long k_sb, long long k_sh, long long v_sb,
    long long v_sh, int batch, int kvh, int n_pages, int page_size,
    int row_bytes, cudaStream_t stream) {
  if (batch == 0) return 0;
  if (row_bytes % 16 != 0 || (k_sb | k_sh | v_sb | v_sh) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = row_bytes / 16;
  const long long total = (long long)batch * kvh * 2 * chunks;
  // every chunk index below 2^31, as FastDiv takes it
  if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const PagedKvWriteMap map{static_cast<uint4*>(kc),
                            static_cast<uint4*>(vc),
                            static_cast<const uint4*>(k),
                            static_cast<const uint4*>(v),
                            page_ids,
                            offsets,
                            k_sb / 16,
                            k_sh / 16,
                            v_sb / 16,
                            v_sh / 16,
                            (unsigned)n_pages,
                            (unsigned)page_size,
                            FastDiv(chunks),
                            FastDiv(kvh)};
  const long long need = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)kCtasPerSm * sm_count();
  paged_kv_write_kernel<<<(int)(need < cap ? need : cap), kThreads, 0,
                          stream>>>(map, (unsigned)total);
  return static_cast<int>(cudaGetLastError());
}
