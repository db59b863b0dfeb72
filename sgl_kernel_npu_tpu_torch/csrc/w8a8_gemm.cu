// Kernels A and K1: W8A8 GEMM out of a stacked int8 weight bank at layer li.
//
// A  replaces sgl_kernel_npu_tpu/ops/matmul.py::grouped_matmul_int8_pallas
//    (_gmm_int8_kernel) as reached through quant_matmul_int8_stacked's 3-D
//    bank branch (matmul.py:243-260), and quant_matmul_int8_pallas
//    (matmul.py:71, a plain [K, N] weight = a one-layer bank): bank
//    [L, K, N].
// K1 replaces sgl_kernel_npu_tpu/ops/matmul.py::
//    quant_matmul_int8_stacked_tiled (_w8a8_tiled_kernel, matmul.py:161), the
//    4-D branch of quant_matmul_int8_stacked: bank pretiled to
//    [L, N/bn, K, bn] (pretile_weight_bank), panel j of layer li one
//    contiguous [K, bn] block.
//
//   out[m, n] = bf16|f32( float(sum_k x[m, k] * w[li, k, n]) * x_scale[m] * w_scale[li, n] )
//
// Bound on an H100: at decode (M = 8 to 128) the call moves K*N weight bytes
// and does 2*M*K*N int8 operations, below the 1,979 TOP/s line (the ridge is
// near M = 295), so 3.35 TB/s of device memory bounds it; at prefill widths
// the int8 tensor-core rate comes close. Both kernels are the shared
// w8a8_core.cuh loop: a panel with rows of bn bytes is read exactly as the
// plain bank with rows of N bytes, the layer index is an argument (no copy of
// the layer), and K is split over blocks when the output has too few tiles
// for 132 SMs. Exact: equal to the plain version bit for bit.

#include "w8a8_core.cuh"

using skt_w8a8::Gemm;

static Gemm gemm_args(const void* x, const void* w, const void* xs, const void* ws,
                      void* out, void* workspace, int M, int N, int K, int li, int bn,
                      int out_f32) {
  Gemm p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.out = out;
  p.accum = static_cast<int32_t*>(workspace);
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldx = K;
  p.li = li;
  p.bn = bn;
  p.out_f32 = out_f32;
  return p;
}

// A: x [M, K] int8, w [L, K, N] int8, xs [M] f32, ws [L, N] f32, out [M, N] bf16
// (f32 when out_f32).
// splits > 1 needs workspace: M*N int32, zeroed here on the stream.
// Needs K % 64 == 0, N % 16 == 0 and 16-byte aligned x and w.
extern "C" int skt_w8a8_gemm(const void* x, const void* w, const void* xs,
                             const void* ws, void* out, void* workspace, int M,
                             int N, int K, int li, int splits, int out_f32, void* stream) {
  return (int)skt_w8a8::launch<skt_w8a8::X_INT8>(
      gemm_args(x, w, xs, ws, out, workspace, M, N, K, li, N, out_f32), splits,
      static_cast<cudaStream_t>(stream));
}

// K1: as A over w [L, N/bn, K, bn] int8; needs bn % 128 == 0.
extern "C" int skt_w8a8_gemm_tiled(const void* x, const void* w, const void* xs,
                                   const void* ws, void* out, void* workspace, int M,
                                   int N, int K, int li, int bn, int splits,
                                   int out_f32, void* stream) {
  if (bn <= 0 || bn % skt_w8a8::BN != 0 || N % bn != 0) return (int)cudaErrorInvalidValue;
  return (int)skt_w8a8::launch<skt_w8a8::X_INT8>(
      gemm_args(x, w, xs, ws, out, workspace, M, N, K, li, bn, out_f32), splits,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* skt_w8a8_gemm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
