// Kernel K2: fused RMSNorm -> int8 quant -> W8A8 GEMM (+ int32 bias) -> dequant.
//
// Replaces sgl_kernel_npu_tpu/ops/rmsq_gemm.py::rmsnorm_quant_gemm
// (_rmsq_kernel, rmsq_gemm.py:148) in both of its modes, with the row
// statistics of rmsq_gemm.py::_row_stats:
//
//   rstd[m]  = rsqrt(mean_k x[m, k]^2 + eps)          (1 without the norm)
//   xn       = x * rstd * gamma + beta
//   per_token:  qdiv[m] = max(max_k |xn|, 1e-7) * f32(1/127), qoff = 0,
//               x_scale[m] = qdiv[m], no bias
//   per_tensor: qdiv[m] = quant_scale, qoff = quant_offset, x_scale[m] = 1,
//               an optional int32 bias [L, N]
//   v        = xn / qdiv + qoff                      (divided, not multiplied)
//   xq       = clamp(rint(fp16_cast ? float(half(v)) : v), -128, 127)
//   out[m,n] = (float(sum_k xq[m, k] * w[li, k, n] + bias[li, n]) * w_scale[li, n])
//              * x_scale[m]
//
// x is bf16 or f32, with rows ldx elements apart: the MLA path's second stage
// feeds a column slice of the first stage's f32 output without a copy.
//
// Bound on an H100: at decode (M = 8 to 128) the call moves the K*N weight
// bytes of its bank panel and some 2*M*K bytes of activations, below the int8
// tensor-core line, so 3.35 TB/s bounds it (wqkv + w13 of Llama-3-8B at M 128:
// 143 MB, 0.046 ms). Two launches:
//   * a row pass, one block per row, quantises each row ONCE into xq [M, K]
//     int8 (0.5 MB at M 128, read back from L2) and writes x_scale [M]. Its
//     sum of squares runs in float64: every bf16 or f32 square is exact there
//     and the sum of K of them is exact or within 2^-53, so the f32 mean does
//     not depend on the order of the sum; 1/sqrt is taken in float64 and
//     rounded once. Every later step rounds on its own (__fmul_rn, __fdiv_rn,
//     __fadd_rn: no FMA contraction), and fp16_cast rounds through
//     __float2half_rn, as the plain version's cast to float16. The plain
//     version (ops/rmsq_gemm.py::_quant_rows) computes the same, bit for bit;
//   * the GEMM is the int8 stage of w8a8_wgmma.cuh, which K1 shares: the
//     weights stream through cp.async rings of 256-column tiles and are
//     byte-transposed on chip for int8 wgmma (M > 32, 128-row tiles) or
//     mma.sync (M <= 32, 16-row tiles), with exact int32 sums (w13 at M 128: 112 reads of
//     the 0.5 MB xq, from L2); when the output has too few tiles for the
//     card (wqkv: 24), K is split over blocks (ops/matmul.py::gemm_plan) and
//     the last split of a tile merges the others through an integer arrival
//     counter that it resets. int8 mma.sync at M 128 measured slower
//     (PERF.md: this kernel's first loop);
//   * its epilogue (EpiRmsq) adds the bias and multiplies in the plain
//     version's order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "w8a8_wgmma.cuh"

namespace {

constexpr int ROW_THREADS = 256;
constexpr float INV_INT8_MAX = (float)(1.0 / 127.0);

// ------------------------------------------------------------- row pass

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// eight consecutive elements of a row as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ float normed(float x, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x, rstd), g), b);
}

// One quantised activation. fp16_cast rounds to fp16 (nearest even, with
// fp16's subnormals and overflow to inf) before rint, as the plain version's
// cast to float16 does.
__device__ __forceinline__ int quant_one(float xn, float qdiv, float qoff, int fp16_cast) {
  float v = __fadd_rn(__fdiv_rn(xn, qdiv), qoff);
  if (fp16_cast) v = __half2float(__float2half_rn(v));
  const int q = __float2int_rn(v);      // round half to even; saturates out of range
  return max(-128, min(127, q));
}

// xq [M, K] int8 and xs [M] (the epilogue's row scale) of each row of x. A
// thread keeps up to CACHE groups of 8 columns of its row, gamma and beta in
// registers, all loaded at once (K <= 8,192 in one read); columns past
// those are read again in each step.
constexpr int CACHE = 4;

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
rmsq_rows(const T* __restrict__ x, int ldx, const float* __restrict__ gamma,
          const float* __restrict__ beta, const float* __restrict__ quant_scale,
          const float* __restrict__ quant_offset, int8_t* __restrict__ xq,
          float* __restrict__ xs, int M, int K, float eps, int apply_norm, int per_tensor,
          int fp16_cast) {
  __shared__ double dsum[ROW_THREADS / 32];
  __shared__ float fmax_[ROW_THREADS / 32];
  __shared__ float rs_s, qd_s;
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (size_t)m * ldx;
  const int ng = K / 8;
  float v[CACHE][8], gv[CACHE][8], bv[CACHE][8];
#pragma unroll
  for (int c = 0; c < CACHE; ++c) {
    const int gi = tid + c * ROW_THREADS;
    if (gi < ng) {
      load8(xr + 8 * gi, v[c]);
      load8(gamma + 8 * gi, gv[c]);
      load8(beta + 8 * gi, bv[c]);
    }
  }
  const int rest = tid + CACHE * ROW_THREADS;      // the first group not cached

  float rs = 1.f;
  if (apply_norm) {
    double s = 0.0;
#pragma unroll
    for (int c = 0; c < CACHE; ++c)
      if (tid + c * ROW_THREADS < ng)
#pragma unroll
        for (int i = 0; i < 8; ++i) s += (double)v[c][i] * (double)v[c][i];
    for (int gi = rest; gi < ng; gi += ROW_THREADS) {
      float u[8];
      load8(xr + 8 * gi, u);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += (double)u[i] * (double)u[i];
    }
    s = warp_sum(s);
    if (lane == 0) dsum[warp] = s;
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int i = 0; i < ROW_THREADS / 32; ++i) t += dsum[i];
      const float f = __fadd_rn(__fdiv_rn((float)t, (float)K), eps);
      rs_s = (float)(1.0 / sqrt((double)f));      // correctly rounded, unlike rsqrtf
    }
    __syncthreads();
    rs = rs_s;
  }
  float qdiv, qoff = 0.f;
  if (per_tensor) {
    qdiv = *quant_scale;
    if (quant_offset != nullptr) qoff = *quant_offset;
    if (tid == 0) xs[m] = 1.f;
  } else {
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < CACHE; ++c)
      if (tid + c * ROW_THREADS < ng)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          amax = fmaxf(amax, fabsf(normed(v[c][i], rs, gv[c][i], bv[c][i])));
    for (int gi = rest; gi < ng; gi += ROW_THREADS) {
      float u[8], ug[8], ub[8];
      load8(xr + 8 * gi, u);
      load8(gamma + 8 * gi, ug);
      load8(beta + 8 * gi, ub);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(normed(u[i], rs, ug[i], ub[i])));
    }
    amax = warp_max(amax);
    if (lane == 0) fmax_[warp] = amax;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int i = 0; i < ROW_THREADS / 32; ++i) t = fmaxf(t, fmax_[i]);
      qd_s = __fmul_rn(fmaxf(t, 1e-7f), INV_INT8_MAX);
      xs[m] = qd_s;
    }
    __syncthreads();
    qdiv = qd_s;
  }
  int8_t* qr = xq + (size_t)m * K;
  auto emit = [&](int gi, const float (&u)[8], const float (&ug)[8], const float (&ub)[8]) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = quant_one(normed(u[i], rs, ug[i], ub[i]), qdiv, qoff, fp16_cast);
      packed[i >> 2] |= (uint32_t)(uint8_t)(int8_t)q << ((i & 3) * 8);
    }
    *reinterpret_cast<uint2*>(qr + 8 * gi) = make_uint2(packed[0], packed[1]);
  };
#pragma unroll
  for (int c = 0; c < CACHE; ++c)
    if (tid + c * ROW_THREADS < ng) emit(tid + c * ROW_THREADS, v[c], gv[c], bv[c]);
  for (int gi = rest; gi < ng; gi += ROW_THREADS) {
    float u[8], ug[8], ub[8];
    load8(xr + 8 * gi, u);
    load8(gamma + 8 * gi, ug);
    load8(beta + 8 * gi, ub);
    emit(gi, u, ug, ub);
  }
}

}  // namespace

// x [M, ldx] bf16 (x_f32 = 0) or f32 (x_f32 = 1), its first K columns used;
// gamma, beta [K] f32; w [L, N/bn, K, bn] int8 (bn = N: a plain [K, N] weight
// with L = 1); ws [L, N] f32; bias [L, N] int32 or null; quant_scale and
// quant_offset one f32 each (per_tensor; quant_offset may be null); xq [M, K]
// int8 and xs [M] f32 written here; out [M, N] bf16 or f32 (out_f32). The
// plan (ops/matmul.py::gemm_plan): row tiles of bm (16 for M <= 32, else
// 128), 256-column tiles, K split `splits` ways (<= 16, and at most one split
// per K stage: 64 bytes at bm 16, 128 above); with
// splits > 1, partials holds tiles * splits * bm * 256 int32 and arrivals
// tiles ints, zero before the first call. Needs K % 64 == 0, N % 16 == 0,
// bn == N or bn % 16 == 0 with N % bn == 0, and rows of x 16-byte aligned.
extern "C" int skt_rmsq_gemm(const void* x, const void* gamma, const void* beta,
                             const void* w, const void* ws, const void* bias,
                             const void* quant_scale, const void* quant_offset, void* xq,
                             void* xs, void* out, void* partials, void* arrivals, int M, int N,
                             int K, int ldx, int li, int bn, int bm, int splits, float eps,
                             int apply_norm, int per_tensor, int x_f32, int fp16_cast,
                             int out_f32, void* stream) {
  if (!plan_ok(M, N, K, bn, bm, splits, partials, arrivals) || ldx < K || li < 0 ||
      (per_tensor && quant_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* qs = static_cast<const float*>(quant_scale);
  const float* qo = static_cast<const float*>(quant_offset);
  int8_t* q8 = static_cast<int8_t*>(xq);
  float* xsv = static_cast<float*>(xs);
  if (x_f32)
    rmsq_rows<float><<<M, ROW_THREADS, 0, st>>>(static_cast<const float*>(x), ldx, g, b, qs, qo,
                                                q8, xsv, M, K, eps, apply_norm, per_tensor,
                                                fp16_cast);
  else
    rmsq_rows<__nv_bfloat16><<<M, ROW_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, g, b, qs, qo, q8, xsv, M, K, eps,
        apply_norm, per_tensor, fp16_cast);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Args a{};
  a.xq = q8;
  a.w = static_cast<const int8_t*>(w) + (size_t)li * N * K;
  a.wsc = static_cast<const float*>(ws) + (size_t)li * N;
  a.bias = bias != nullptr ? static_cast<const int32_t*>(bias) + (size_t)li * N : nullptr;
  a.xs = xsv;
  a.out = out;
  a.part = static_cast<int4*>(partials);
  a.arrivals = static_cast<int*>(arrivals);
  a.M = M;
  a.N = N;
  a.K = K;
  a.bn = bn;
  a.splits = splits;
  a.out_f32 = out_f32;
  return (int)launch_gemm<EpiRmsq>(a, bm, st);
}

extern "C" const char* skt_rmsq_gemm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
