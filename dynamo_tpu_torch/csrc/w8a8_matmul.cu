// W8A8 GEMM (K5): y = ((xq · q) · sx) · s with per-row int8 activations.
//
// Replaces the Pallas TPU kernel dynamo_tpu/engine/int4_mm.py
// `w8a8_matmul` (`_w8a8_kernel`, :92; `pallas_call` :133) together with
// its XLA prologue `_a8_prologue` (:76) and epilogue. The design, the
// bound and the shapes taken are in a8_gemm.cuh, shared with K6.
//
// Weights: q (N, K) int8, K-major (the transpose of the reference's q);
// s (N,) fp32. x (M, K) fp32 or bf16; out (M, N) of x's type. The caller
// provides scratch `ws` (a8_gemm.cuh `run`).

#include "a8_gemm.cuh"

namespace {

template <class C>
__global__ void __launch_bounds__(C::kThreads)
    w8a8_gemm_kernel(a8::GemmArgs g) {
  a8::gemm_tile<false, C>(g);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (x and out share it).
extern "C" int w8a8_matmul_launch(const void* x, const void* w,
                                  const float* s, void* out, void* ws,
                                  long long ws_bytes, int M, int K, int N,
                                  int dtype, cudaStream_t stream) {
  auto pick = [](auto cfg) { return &w8a8_gemm_kernel<decltype(cfg)>; };
  return a8::matmul<false>(x, w, s, out, ws, ws_bytes, M, K, N, dtype,
                           stream, pick);
}
