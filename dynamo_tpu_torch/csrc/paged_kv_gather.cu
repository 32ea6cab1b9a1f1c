// Paged KV gather: copy a sequence's pages out of every layer's K and V
// cache into one contiguous (2, L, KVH, n, P, D) tensor, in one launch.
//
// Not a TPU kernel: the reference computes the same gather in XLA,
// `_gather_kv_jit` (dynamo_tpu/engine/engine.py:72), one jitted program in
// place of 2L per-layer gathers and the stacks, because per-op dispatch
// dominated its transfer measurements. This is its counterpart for the
// disaggregated KV transfer (engine/engine.py `read_kv_pages*`): the
// prefill worker gathers the pages it pinned and ships them to the decode
// worker, over the host wire or through a CUDA IPC staging buffer.
//
// Layout: 2L caches, each (KVH, N, P, D) contiguous, found through a
// device array of 2L base pointers (K caches first, then V), built once
// per engine; page_ids (n,) int32 below N; out (2, L, KVH, n, P, D)
// contiguous. A page of one head is P*D contiguous elements in its cache
// and in the output, so the copy is a flat list of 16-byte chunks: chunk
// j = ((cache * KVH + h) * n + i) * page_chunks + c.
//
// Bound: bytes. Every byte of the n pages is read once and written once;
// nothing is computed. The work is the flat chunk list in a grid-stride
// loop over a grid of up to 8 CTAs per SM; each thread issues four
// independent 16-byte loads before its four stores, so enough loads are in
// flight to keep the card's memory busy. The divisions go by multiply-high
// (FastDiv), as in paged_kv_write.cu.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr int kUnroll = 4;

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

struct GatherMap {
  const uint4* const* caches;   // 2L base pointers
  const int* page_ids;
  uint4* out;
  unsigned n_pages;             // N, pages per cache
  FastDiv page_chunks, n, kvh;

  __device__ __forceinline__ const uint4* src(unsigned j) const {
    const unsigned r = page_chunks.div(j);        // (cache, h, i)
    const unsigned c = j - r * page_chunks.d;
    const unsigned q = n.div(r);                  // (cache, h)
    const unsigned i = r - q * n.d;
    const unsigned cache = kvh.div(q);
    const unsigned h = q - cache * kvh.d;
    const size_t at =
        ((size_t)h * n_pages + (unsigned)__ldg(page_ids + i)) *
            page_chunks.d + c;
    return caches[cache] + at;
  }
};

__global__ void __launch_bounds__(kThreads)
    paged_kv_gather_kernel(GatherMap map, unsigned total) {
  const unsigned stride = gridDim.x * kThreads;
  unsigned j = blockIdx.x * kThreads + threadIdx.x;
  for (; j + (kUnroll - 1) * stride < total; j += kUnroll * stride) {
    uint4 val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) val[u] = __ldg(map.src(j + u * stride));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) map.out[j + u * stride] = val[u];
  }
  for (; j < total; j += stride) map.out[j] = __ldg(map.src(j));
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

// caches: device array of n_caches (= 2L) pointers, each 16-byte aligned;
// page_bytes = P * D * sizeof(element), a multiple of 16.
extern "C" int paged_kv_gather_launch(const void* caches, const int* page_ids,
                                      void* out, int n_caches, int kvh,
                                      int n_pages, int n, int page_bytes,
                                      cudaStream_t stream) {
  if (n == 0 || n_caches == 0) return 0;
  if (page_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int page_chunks = page_bytes / 16;
  const long long total = (long long)n_caches * kvh * n * page_chunks;
  // every chunk index (and j + (kUnroll - 1) * stride) below 2^32, and the
  // FastDiv inputs below 2^31
  if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const GatherMap map{static_cast<const uint4* const*>(caches),
                      page_ids,
                      static_cast<uint4*>(out),
                      (unsigned)n_pages,
                      FastDiv(page_chunks),
                      FastDiv(n),
                      FastDiv(kvh)};
  const long long need = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)kCtasPerSm * sm_count();
  paged_kv_gather_kernel<<<(int)(need < cap ? need : cap), kThreads, 0,
                           stream>>>(map, (unsigned)total);
  return static_cast<int>(cudaGetLastError());
}
