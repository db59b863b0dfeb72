// Kernel K8: grouped W8A8 GEMM out of a stacked int8 expert bank, each row
// tile at its own expert. (A and K1, the GEMM at one layer of a plain or
// pretiled bank, are w8a8_gemm_tiled.cu, on the same int8 stage.)
//
// K8 replaces sgl_kernel_npu_tpu/ops/matmul.py::grouped_matmul_int8_pallas
//    (matmul.py:496) with its per-m-tile expert map, as
//    models/qwen_next.py::_moe_mlp_q and parallel/fused_moe.py's aligned
//    compaction call it: row tile i of block_m rows reads expert eid[i] of
//    a [G, K, N] or pretiled [G, N/bn, K, bn] bank.
//
//   out[m, n] = bf16|f32( (float(sum_k x[m, k] * w[e, k, n]) * x_scale[m]) * w_scale[e, n] )
//
// Bound on an H100: the bytes of the experts its live tiles read (at the
// Qwen bench shape every expert of the layer, 2 MB each for w13; at the EP
// MoE layer 8 experts of 29.4 MB for GMM1, 14.7 MB for GMM2), x and out;
// its operations are below the int8 tensor-core line at these widths, so
// 3.35 TB/s bounds it. It runs the int8 stage of w8a8_wgmma.cuh with the
// epilogue order EpiGrouped (K1's, a type of its own so that a profile
// tells K8's launches from K1's), the expert of each row tile found on the
// card: block_m a multiple of 128 (the MoE layer's aligned compaction) takes
// 128-row wgmma tiles, so each weight byte of an expert leaves device
// memory once per 128 rows, its expert a panel coordinate of a weight map
// over the whole bank; any other block_m (Qwen's 32) takes 16-row mma.sync
// tiles, each offsetting its cp.async source by its expert's block. The
// grid runs the row tiles fastest, so the row tiles of one expert read its
// weights together (the repeats from L2). A row tile of padding (every
// x_scale 0) writes zeros without streaming weights. K splits only where the
// plan (ops/matmul.py::gemm_plan, from the shape alone) says so, merged by
// the last split through an integer arrival counter: one launch, no memset,
// no atomic on the output. Exact: equal to the plain version bit for bit.

#include "w8a8_wgmma.cuh"

// K8: x [M, K] int8, w [G, K, N] (bn = N) or [G, N/bn, K, bn] int8, xs [M] f32
// (0 on padding rows), ws [G, N] f32, eid [M / block_m] int32, out [M, N]
// bf16 (f32 when out_f32). The plan (ops/matmul.py::gemm_plan with
// block_m): row tiles of bm (128 where block_m % 128 == 0, else 16), K
// split `splits` ways; with splits > 1, partials holds tiles * splits * bm
// * 256 int32 and arrivals one int per tile, zero before the first call
// (the kernel leaves them zero). Needs M % block_m == 0, block_m % 32 == 0
// and a multiple of bm, K % 64 == 0, N % 16 == 0, bn % 128 == 0 or bn == N,
// and 16-byte aligned x and w; eid is clamped to [0, G).
extern "C" int skt_w8a8_gemm_grouped(const void* x, const void* w, const void* xs,
                                     const void* ws, void* out, void* partials, void* arrivals,
                                     const void* eid, int M, int N, int K, int G, int bn,
                                     int block_m, int bm, int splits, int out_f32,
                                     void* stream) {
  if (!plan_ok(M, N, K, bn, bm, splits, partials, arrivals, true) || G <= 0 ||
      block_m <= 0 || block_m % 32 != 0 || block_m % bm != 0 || M % block_m != 0 ||
      (bm == W_BM) != (block_m % W_BM == 0))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Args a{};
  a.xq = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.wsc = static_cast<const float*>(ws);
  a.bias = nullptr;
  a.xs = static_cast<const float*>(xs);
  a.out = out;
  a.part = static_cast<int4*>(partials);
  a.arrivals = static_cast<int*>(arrivals);
  a.eid = static_cast<const int32_t*>(eid);
  a.M = M;
  a.N = N;
  a.K = K;
  a.bn = bn;
  a.splits = splits;
  a.out_f32 = out_f32;
  a.block_m = block_m;
  a.groups = G;
  return (int)launch_gemm<EpiGrouped>(a, bm, static_cast<cudaStream_t>(stream));
}

extern "C" const char* skt_w8a8_gemm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
