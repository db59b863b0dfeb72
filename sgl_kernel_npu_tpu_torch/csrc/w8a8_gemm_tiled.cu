// Kernels K1 and A: W8A8 GEMM over a weight bank at layer li, K1 on a bank
// pretiled to panels, A on a plain one.
//
// K1 replaces sgl_kernel_npu_tpu/ops/matmul.py::quant_matmul_int8_stacked_tiled
//    (_w8a8_tiled_kernel, matmul.py:141-161), the 4-D branch of
//    quant_matmul_int8_stacked: the bank pretiled to [L, N/bn, K, bn]
//    (pretile_weight_bank), panel j of layer li one contiguous [K, bn] block.
// A  replaces sgl_kernel_npu_tpu/ops/matmul.py::grouped_matmul_int8_pallas
//    (_gmm_int8_kernel) with its constant map, as quant_matmul_int8_stacked's
//    3-D bank branch reaches it (matmul.py:243-260), and
//    quant_matmul_int8_pallas (matmul.py:71, a plain [K, N] weight = a
//    one-layer bank): a bank [L, K, N], which is the pretiled layout with
//    one panel, bn = N.
//
//   out[m, n] = bf16|f32( (float(sum_k x[m, k] * w[li, k, n]) * x_scale[m]) * w_scale[li, n] )
//
// Bound on an H100: at decode (M = 8 to 128) the call moves K*N weight bytes
// and does 2*M*K*N int8 operations, below the 1,979 TOP/s line (the ridge
// is near M = 295), so 3.35 TB/s of device memory bounds it (Llama-3-8B's
// wo + w2 + lm_head at M 128: 0.19 ms); at prefill widths the int8 rate
// comes close. Both kernels are the int8 stage of w8a8_wgmma.cuh, the one
// that K2 runs after its row pass, fed straight from x and x_scale, with the
// epilogue in their order (EpiTiled, EpiBank): int8 wgmma on 128-row tiles
// for M > 32 (M 128 is one row tile, so each weight byte leaves device
// memory once), int8 mma.sync on 16-row tiles for M <= 32, K split over
// blocks where the output has too few tiles for the card (wo and w2 at M 128:
// 16 tiles, 4 splits) and merged by the last split through an integer
// arrival counter. Exact: equal to the plain version bit for bit.

#include "w8a8_wgmma.cuh"

// x [M, K] int8, w [L, N/bn, K, bn] int8, xs [M] f32, ws [L, N] f32, out [M,
// N] bf16 (f32 when out_f32). The plan (ops/matmul.py::gemm_plan): row tiles
// of bm (16 for M <= 32, else 128), K split `splits` ways; with splits > 1,
// partials holds tiles * splits * bm * 256 int32 and arrivals one int per
// tile, zero before the first call (the kernel leaves them zero). Needs K %
// 64 == 0, N % 16 == 0, bn % 128 == 0 with N % bn == 0 (bn % 16 at M <= 32),
// and 16-byte aligned x and w.
template <class Epi>
static int gemm(const void* x, const void* w, const void* xs, const void* ws, void* out,
                void* partials, void* arrivals, int M, int N, int K, int li, int bn, int bm,
                int splits, int out_f32, void* stream) {
  if (!plan_ok(M, N, K, bn, bm, splits, partials, arrivals) || li < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Args a{};
  a.xq = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w) + (size_t)li * N * K;
  a.wsc = static_cast<const float*>(ws) + (size_t)li * N;
  a.bias = nullptr;
  a.xs = static_cast<const float*>(xs);
  a.out = out;
  a.part = static_cast<int4*>(partials);
  a.arrivals = static_cast<int*>(arrivals);
  a.M = M;
  a.N = N;
  a.K = K;
  a.bn = bn;
  a.splits = splits;
  a.out_f32 = out_f32;
  return (int)launch_gemm<Epi>(a, bm, static_cast<cudaStream_t>(stream));
}

extern "C" int skt_w8a8_gemm_tiled(const void* x, const void* w, const void* xs,
                                   const void* ws, void* out, void* partials, void* arrivals,
                                   int M, int N, int K, int li, int bn, int bm, int splits,
                                   int out_f32, void* stream) {
  return gemm<EpiTiled>(x, w, xs, ws, out, partials, arrivals, M, N, K, li, bn, bm, splits,
                        out_f32, stream);
}

// A: the same with w [L, K, N] int8, one panel of bn = N columns (any N %
// 16 == 0: the TMA boxes past N come as zeros, and no column past N is
// written).
extern "C" int skt_w8a8_gemm(const void* x, const void* w, const void* xs, const void* ws,
                             void* out, void* partials, void* arrivals, int M, int N, int K,
                             int li, int bm, int splits, int out_f32, void* stream) {
  return gemm<EpiBank>(x, w, xs, ws, out, partials, arrivals, M, N, K, li, N, bm, splits,
                       out_f32, stream);
}

extern "C" const char* skt_w8a8_gemm_tiled_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
