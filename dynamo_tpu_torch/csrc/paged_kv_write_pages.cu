// Whole-page KV store (K3): copy complete pages of K and V rows into the
// paged caches, in place, for page-aligned prefill chunks.
//
// Replaces the Pallas TPU kernel dynamo_tpu/engine/kernels.py
// `paged_kv_write_pages`, one program per page slot that stores the slot's
// block without reading the destination page back. Here one CTA copies one
// KV head of one page slot, so a 512-token chunk at Llama-3-8B geometry
// (32 slots x 8 KV heads) is 256 CTAs and fills the card; a CTA per slot
// alone would be 32.
//
// Layout: caches kc/vc (KVH, N, P, D); blocks kb/vb (M, KVH, P, D), one
// complete page of rows per slot; page_ids (M,) int32, chosen by the caller
// (models/llama.py `paged_forward`): a slot whose first row lies past the
// sequence's length targets scratch page 0. Several padding slots then race
// on page 0 -- harmless because page 0 is never allocated to a sequence
// (engine/pages.py), so attention never reads it unmasked. A partly filled
// last page also receives the padding tokens' rows in its tail, as on the
// TPU: attention masks them by length and decode overwrites them later. The
// caller guarantees page_ids < N.
//
// Bound: bytes. 2·M·KVH·P·D elements are read once and written once and
// nothing is computed, so it is a copy: 16-byte vector loads and stores,
// a CTA's threads on consecutive chunks of one contiguous (P, D) page. The
// kernel copies bytes, so it takes any dtype; the wrapper requires
// P·D·sizeof(T) to be a multiple of 16.
//
// It runs on the caller's stream before attention reads the cache in the
// same layer: the wrapper launches it on torch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
    paged_kv_write_pages_kernel(uint4* __restrict__ kc, uint4* __restrict__ vc,
                                const uint4* __restrict__ kb,
                                const uint4* __restrict__ vb,
                                const int* __restrict__ page_ids,
                                int n_pages, int chunks_per_page) {
  const int m = blockIdx.x;
  const int h = blockIdx.y;
  const int kvh = gridDim.y;
  const size_t src = ((size_t)m * kvh + h) * chunks_per_page;
  const size_t dst = ((size_t)h * n_pages + page_ids[m]) * chunks_per_page;
  for (int i = threadIdx.x; i < chunks_per_page; i += blockDim.x) {
    kc[dst + i] = kb[src + i];
    vc[dst + i] = vb[src + i];
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// page_bytes = P * D * sizeof(element); must be a multiple of 16.
extern "C" int paged_kv_write_pages_launch(void* kc, void* vc, const void* kb,
                                           const void* vb, const int* page_ids,
                                           int n_slots, int kvh, int n_pages,
                                           int page_bytes,
                                           cudaStream_t stream) {
  if (n_slots == 0) return 0;
  if (page_bytes % 16 != 0 || kvh <= 0 || kvh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = page_bytes / 16;
  const int threads =
      chunks < kMaxThreads ? ((chunks + 31) / 32) * 32 : kMaxThreads;
  paged_kv_write_pages_kernel<<<dim3(n_slots, kvh), threads, 0, stream>>>(
      static_cast<uint4*>(kc), static_cast<uint4*>(vc),
      static_cast<const uint4*>(kb), static_cast<const uint4*>(vb), page_ids,
      n_pages, chunks);
  return static_cast<int>(cudaGetLastError());
}
