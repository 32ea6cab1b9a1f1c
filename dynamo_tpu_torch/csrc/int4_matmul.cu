// W4A8 GEMM (K6): y = ((xq · unpack4(p)) · sx) · s over nibble-packed
// weights, with per-row int8 activations.
//
// Replaces the Pallas TPU kernel dynamo_tpu/engine/int4_mm.py
// `int4_matmul` (`_kernel`, :50; `pallas_call` :197) together with its
// XLA prologue `_a8_prologue` (:76) and its nibble-recovering epilogue.
// The weights are read from device memory as packed bytes and unpacked in
// registers on their way into the tensor cores (the MMA's A operand); no
// unpacked or bf16 copy exists anywhere. The design, the bound and the
// shapes taken are in a8_gemm.cuh, shared with K5.
//
// Weights: p (N/2, K) int8, K-major; byte (j, k) holds logical column 2j
// in its low nibble (stored +8) and column 2j+1 in its high nibble
// (two's complement) — engine/quant.py `pack4`. s (N,) fp32. x (M, K)
// fp32 or bf16; out (M, N) of x's type. The caller provides scratch `ws`
// for xq and sx, and the persistent partial slots and tickets of the
// stream GEMM (a8_gemm.cuh `matmul`).

#include "a8_gemm.cuh"

namespace {

template <int NB>
__global__ void __launch_bounds__(a8::Stream<true, NB>::kThreads,
                             a8::kStreamCtasPerSm)
    int4_gemm_stream(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw0,
                     const __grid_constant__ CUtensorMap tw1,
                     const __grid_constant__ CUtensorMap tw2,
                     a8::StreamArgs g) {
  a8::stream_body<true, NB>(&tx, &tw0, &tw1, &tw2, g);
}

template <bool kWideW>
__global__ void __launch_bounds__(a8::Wide<true, kWideW>::kThreads, 1)
    int4_gemm_wide(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw0,
                   const __grid_constant__ CUtensorMap tw1,
                   const __grid_constant__ CUtensorMap tw2, a8::WideArgs g) {
  a8::wide_body<true, kWideW>(&tx, &tw0, &tw1, &tw2, g);
}

struct Kernels {
  static constexpr bool kInt4 = true;
  template <int NB>
  static auto stream() { return &int4_gemm_stream<NB>; }
  template <bool kWideW>
  static auto wide() { return &int4_gemm_wide<kWideW>; }
};

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) times n_seg (1..3) weights that share it: weights w[i], scales
// s[i] (N[i],), output out[i] (M, N[i]); N[i] is the LOGICAL column count
// (twice p's rows, multiple of 256). One row quantize, one GEMM. dtype: 0 = float32,
// 1 = bfloat16 (x and the outputs share it).
extern "C" int int4_matmul_launch(const void* x, void* ws, long long ws_bytes,
                                  int* part, long long part_ints,
                                  int* counters, long long n_counters, int M,
                                  int K, int dtype, int n_seg,
                                  const void* const* w, const float* const* s,
                                  void* const* out, const int* N,
                                  cudaStream_t stream) {
  if (n_seg < 1 || n_seg > a8::kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  a8::HostSeg segs[a8::kMaxSegs];
  for (int i = 0; i < n_seg; ++i) segs[i] = a8::HostSeg{w[i], s[i], out[i], N[i]};
  const a8::Scratch sc{part, part_ints, counters, n_counters};
  return a8::matmul<Kernels>(x, segs, n_seg, ws, ws_bytes, sc, M, K, dtype,
                             stream);
}
