// W4A8 GEMM (K6): y = ((xq · unpack4(p)) · sx) · s over nibble-packed
// weights, with per-row int8 activations.
//
// Replaces the Pallas TPU kernel dynamo_tpu/engine/int4_mm.py
// `int4_matmul` (`_kernel`, :50; `pallas_call` :197) together with its
// XLA prologue `_a8_prologue` (:76) and its nibble-recovering epilogue.
// The weights are read from device memory as packed bytes and unpacked in
// registers on their way into the tensor cores; no unpacked or bf16 copy
// exists anywhere. The design, the bound and the shapes taken are in
// a8_gemm.cuh, shared with K5.
//
// Weights: p (N/2, K) int8, K-major; byte (j, k) holds logical column 2j
// in its low nibble (stored +8) and column 2j+1 in its high nibble
// (two's complement) — engine/quant.py `pack4`. s (N,) fp32. x (M, K)
// fp32 or bf16; out (M, N) of x's type. The caller provides
// scratch `ws` for xq, sx and split-K sums (a8_gemm.cuh `run`).

#include "a8_gemm.cuh"

namespace {

template <class C>
__global__ void __launch_bounds__(C::kThreads)
    int4_gemm_kernel(a8::GemmArgs g) {
  a8::gemm_tile<true, C>(g);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// N is the LOGICAL column count (twice p's rows). dtype: 0 = float32,
// 1 = bfloat16 (x and out share it).
extern "C" int int4_matmul_launch(const void* x, const void* w,
                                  const float* s, void* out, void* ws,
                                  long long ws_bytes, int M, int K, int N,
                                  int dtype, cudaStream_t stream) {
  auto pick = [](auto cfg) { return &int4_gemm_kernel<decltype(cfg)>; };
  return a8::matmul<true>(x, w, s, out, ws, ws_bytes, M, K, N, dtype,
                           stream, pick);
}
