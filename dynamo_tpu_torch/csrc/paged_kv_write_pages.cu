// Whole-page KV store (K3): copy complete pages of K and V rows into the
// paged caches, in place, for page-aligned prefill chunks, reading K and V
// where the projections and RoPE left them.
//
// Replaces the Pallas TPU kernel dynamo_tpu/engine/kernels.py
// `paged_kv_write_pages`, one program per page slot that stores the slot's
// block without reading the destination page back.
//
// Layout: caches kc/vc (KVH, N, P, D), contiguous; blocks kb/vb (M, KVH,
// P, D), one complete page of rows per slot, with any strides on M, KVH
// and P (bytes, multiples of 16, from the wrapper) and stride 1 on D. The
// chunk's token-major (Bp, T, KVH, D) K is such a view, (T/P pages, P,
// KVH, D) permuted to (M, KVH, P, D) with strides (P·KVH·D, D, KVH·D, 1),
// so models/llama.py `_chunk_kv_writer` hands it over without a copy.
// page_ids (M,) int32, chosen by the caller: a slot whose first row lies
// past the sequence's length targets scratch page 0. Several padding slots
// then race on page 0 -- harmless because page 0 is never allocated to a
// sequence (engine/pages.py), so attention never reads it unmasked. A
// partly filled last page also receives the padding tokens' rows in its
// tail, as on the TPU: attention masks them by length and decode
// overwrites them later. The caller guarantees page_ids < N.
//
// Bound: bytes. A copy: 2·M·KVH·P·D elements read once and written once.
// One CTA per (slot, KV head): one thread asks the TMA for the head's K
// page and V page, each a box of P rows x D gathered at the source's row
// stride (a 4-D tensor map over the blocks, built on the host per call and
// passed as a __grid_constant__ parameter, so a CUDA graph captures it),
// into shared memory behind one mbarrier; then stores each as one
// contiguous bulk copy (cp.async.bulk) into its cache page. No register
// holds a byte of the page and no thread computes an address per chunk. A
// 512-token chunk at Llama-3-8B geometry is 32 x 8 CTAs of 8 KB. Measured
// on an H100 against 16-byte vector loads of the same views, one chunk per
// thread: 0.0044 against 0.0045 ms per launch in a 32-layer run (PERF.md).
//
// Shapes taken: D·sizeof(T) a multiple of 16 and at most 512 bytes, P at
// most 256, K and V pages together within a CTA's shared memory; the
// wrapper checks them.
//
// It runs on the caller's stream before attention reads the cache in the
// same layer: the wrapper launches it on torch's current stream.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRowBytes = 512;     // a box row: 256 16-bit words
constexpr int kMaxPage = 256;         // a box's rows
constexpr int kMaxSmem = 227 * 1024 - 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one warp per (slot, head); its first thread issues the four copies
__global__ void __launch_bounds__(32) paged_kv_write_pages_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, char* kc, char* vc,
    const int* page_ids, int n_pages, int page_bytes, int k_head_dim,
    int v_head_dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const int m = blockIdx.x, h = blockIdx.y;
  const uint32_t b = smem_u32(&bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b),
               "r"(2 * page_bytes)
               : "memory");
  // box {D, 1 head, P rows} at (0, h, 0, m) of dims {D, KVH, P, M}, or
  // {D, P rows, 1 head} at (0, 0, h, m) of dims {D, P, KVH, M}
  const int kh1 = k_head_dim == 1 ? h : 0, kh2 = k_head_dim == 1 ? 0 : h;
  const int vh1 = v_head_dim == 1 ? h : 0, vh2 = v_head_dim == 1 ? 0 : h;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(&kmap)), "r"(b), "r"(0), "r"(kh1),
      "r"(kh2), "r"(m)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(smem + page_bytes)),
      "l"(reinterpret_cast<uint64_t>(&vmap)), "r"(b), "r"(0), "r"(vh1),
      "r"(vh2), "r"(m)
      : "memory");
  const size_t dst = ((size_t)h * n_pages + page_ids[m]) * page_bytes;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(b)
      : "memory");
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          kc + dst),
      "r"(smem_u32(smem)), "r"(page_bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          vc + dst),
      "r"(smem_u32(smem + page_bytes)), "r"(page_bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// blocks (M, KVH, P, D) with byte strides s_m, s_h, s_r as dims
// {D, KVH, P, M} of 16-bit words (*head_dim = 1), or {D, P, KVH, M}
// (*head_dim = 2) where the head stride is the larger
int block_map(CUtensorMap* map, int* head_dim, const void* base,
              long long s_m, long long s_h, long long s_r, int m, int kvh,
              int p, int row_bytes) {
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
  // size-1 dimensions carry stride 0 from the wrapper: give them any
  // legal stride
  if (s_h == 0) s_h = row_bytes;
  if (s_r == 0) s_r = row_bytes;
  if (s_m == 0) s_m = row_bytes;
  *head_dim = s_h <= s_r ? 1 : 2;
  const bool hf = *head_dim == 1;
  const cuuint64_t dims[4] = {(cuuint64_t)(row_bytes / 2),
                              (cuuint64_t)(hf ? kvh : p),
                              (cuuint64_t)(hf ? p : kvh), (cuuint64_t)m};
  const cuuint64_t strides[3] = {(cuuint64_t)(hf ? s_h : s_r),
                                 (cuuint64_t)(hf ? s_r : s_h),
                                 (cuuint64_t)s_m};
  const cuuint32_t box[4] = {(cuuint32_t)(row_bytes / 2),
                             (cuuint32_t)(hf ? 1 : p),
                             (cuuint32_t)(hf ? p : 1), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// row_bytes = D * sizeof(element); the block strides on M, KVH and P in
// bytes; kb and vb 16-byte aligned.
extern "C" int paged_kv_write_pages_launch(
    void* kc, void* vc, const void* kb, const void* vb, const int* page_ids,
    long long k_sm, long long k_sh, long long k_sr, long long v_sm,
    long long v_sh, long long v_sr, int n_slots, int kvh, int n_pages,
    int page_size, int row_bytes, cudaStream_t stream) {
  if (n_slots == 0) return 0;
  if (row_bytes % 16 != 0 || row_bytes > kMaxRowBytes ||
      page_size > kMaxPage ||
      2 * page_size * row_bytes > kMaxSmem ||
      (k_sm | k_sh | k_sr | v_sm | v_sh | v_sr) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(kb) | reinterpret_cast<uintptr_t>(vb)) %
          16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap kmap, vmap;
  int k_hd = 1, v_hd = 1;
  int e = block_map(&kmap, &k_hd, kb, k_sm, k_sh, k_sr, n_slots, kvh,
                    page_size, row_bytes);
  if (e == 0)
    e = block_map(&vmap, &v_hd, vb, v_sm, v_sh, v_sr, n_slots, kvh,
                  page_size, row_bytes);
  if (e != 0) return e;
  const int page_bytes = page_size * row_bytes;
  const int smem = 2 * page_bytes;
  static bool smem_allowed = false;
  if (!smem_allowed) {
    const cudaError_t a = cudaFuncSetAttribute(
        paged_kv_write_pages_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (a != cudaSuccess) return static_cast<int>(a);
    smem_allowed = true;
  }
  paged_kv_write_pages_kernel<<<dim3(n_slots, kvh), 32, smem, stream>>>(
      kmap, vmap, static_cast<char*>(kc), static_cast<char*>(vc), page_ids,
      n_pages, page_bytes, k_hd, v_hd);
  return static_cast<int>(cudaGetLastError());
}
