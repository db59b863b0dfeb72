// Kernel K8: grouped W8A8 GEMM out of a stacked int8 expert bank, each row
// tile at its own expert. (A and K1, the GEMM at one layer of a plain or
// pretiled bank, are w8a8_gemm_tiled.cu, on the int8 stage of
// w8a8_wgmma.cuh.)
//
// K8 replaces sgl_kernel_npu_tpu/ops/matmul.py::grouped_matmul_int8_pallas
//    (matmul.py:496) with its per-m-tile expert map, as
//    models/qwen_next.py::_moe_mlp_q calls it: row tile i of block_m rows
//    reads expert eid[i] of a [G, K, N] or pretiled [G, N/bn, K, bn] bank.
//
//   out[m, n] = bf16|f32( float(sum_k x[m, k] * w[e, k, n]) * x_scale[m] * w_scale[e, n] )
//
// Bound on an H100: the bytes of the experts its live tiles read (at the
// Qwen bench shape every expert of the layer, 2 MB each for w13), x and out;
// 32-row tiles read an expert once per tile, so the grid's weight reads
// exceed those bytes only where an expert holds more than 32 rows, and L2
// takes repeats. Its operations are below the int8 tensor-core line at
// decode widths. It runs the w8a8_core.cuh loop: a panel with rows of bn
// bytes is read exactly as the plain bank with rows of N bytes, the expert
// index comes from the map (no copy of the expert), and K is split over
// blocks when the output has too few tiles for 132 SMs. Exact: equal to
// the plain version bit for bit.

#include "w8a8_core.cuh"

using skt_w8a8::Gemm;

static Gemm gemm_args(const void* x, const void* w, const void* xs, const void* ws,
                      void* out, void* workspace, int M, int N, int K, int li, int bn,
                      int out_f32) {
  Gemm p{};
  p.x = static_cast<const int8_t*>(x);
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

// K8: x [M, K] int8, w [G, K, N] (bn = N) or [G, N/bn, K, bn] int8, xs [M] f32
// (0 on padding rows), ws [G, N] f32, eid [M / block_m] int32, out [M, N].
// Needs M % block_m == 0 and block_m % 32 == 0; eid is clamped to [0, G).
extern "C" int skt_w8a8_gemm_grouped(const void* x, const void* w, const void* xs,
                                     const void* ws, void* out, void* workspace,
                                     const void* eid, int M, int N, int K, int G, int bn,
                                     int block_m, int splits, int out_f32, void* stream) {
  if (bn <= 0 || N % bn != 0 || (bn != N && bn % skt_w8a8::BN != 0) || block_m <= 0
      || block_m % 32 != 0 || M % block_m != 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  Gemm p = gemm_args(x, w, xs, ws, out, workspace, M, N, K, 0, bn, out_f32);
  p.eid = static_cast<const int32_t*>(eid);
  p.block_m = block_m;
  p.groups = G;
  return (int)skt_w8a8::launch(p, splits, static_cast<cudaStream_t>(stream));
}

extern "C" const char* skt_w8a8_gemm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
