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
// tensor-core line, so 3.35 TB/s bounds it. The TPU design keeps the int8
// activation out of device memory by quantising each x block in the GEMM's
// prologue; so does this one:
//   * a row pass, one block per row, writes rstd, qdiv and x_scale ([M] f32
//     each). Its sum of squares runs in float64: every bf16 or f32 square is
//     exact there and the sum of K of them is exact or within 2^-53, so the
//     f32 mean does not depend on the order of the sum; and 1/sqrt is taken
//     in float64 and rounded once. The plain version computes both the same
//     way, so the two agree bit for bit;
//   * the GEMM block (w8a8_core.cuh) loads x per K stage, normalises, divides,
//     adds the offset, rounds to fp16 where asked (__float2half_rn, as the
//     plain version's cast) and half to even into int8 rows in shared memory,
//     and runs the int8 mma.sync loop of kernel A over the pretiled
//     [L, N/bn, K, bn] bank (or a plain [K, N] weight, bn = N);
//   * the epilogue adds the bias and multiplies in the plain version's order.
// Every x block is quantised again by each 128-column block that needs it
// (x is small next to the weight panel and comes from L2). That work, with
// its IEEE divides, is what bounds the kernel at M = 128, far above the
// bytes; a thread keeps its rows' rstd and divisor, and per stage its
// columns' gamma and beta, in registers. A wider 16 x 512 tile, which
// quantises 4x less, measured slower: each of its row blocks streams and
// transposes the whole panel for one m16 tile.

#include "w8a8_core.cuh"

namespace {

constexpr int ROW_THREADS = 256;
constexpr float INV_INT8_MAX = (float)(1.0 / 127.0);

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

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// stats [3, M]: rstd, the quant divisor, the epilogue row scale
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
rmsq_rows(const T* __restrict__ x, int ldx, const float* __restrict__ gamma,
          const float* __restrict__ beta, const float* __restrict__ quant_scale,
          float* __restrict__ stats, int M, int K, float eps, int apply_norm,
          int per_tensor) {
  __shared__ double dsum[ROW_THREADS / 32];
  __shared__ float fmax_[ROW_THREADS / 32];
  __shared__ float rs_s;
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (size_t)m * ldx;

  float rs = 1.f;
  if (apply_norm) {
    double s = 0.0;
    for (int k = tid; k < K; k += ROW_THREADS) {
      const double v = (double)to_float(xr[k]);
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) dsum[warp] = s;
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int i = 0; i < ROW_THREADS / 32; ++i) t += dsum[i];
      const float v = __fadd_rn(__fdiv_rn((float)t, (float)K), eps);
      rs_s = (float)(1.0 / sqrt((double)v));      // correctly rounded, unlike rsqrtf
    }
    __syncthreads();
    rs = rs_s;
  }
  if (per_tensor) {
    if (tid == 0) {
      stats[m] = rs;
      stats[M + m] = *quant_scale;
      stats[2 * M + m] = 1.f;
    }
    return;
  }
  float amax = 0.f;
  for (int k = tid; k < K; k += ROW_THREADS) {
    const float xn = __fadd_rn(__fmul_rn(__fmul_rn(to_float(xr[k]), rs), gamma[k]), beta[k]);
    amax = fmaxf(amax, fabsf(xn));
  }
  amax = warp_max(amax);
  if (lane == 0) fmax_[warp] = amax;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int i = 0; i < ROW_THREADS / 32; ++i) t = fmaxf(t, fmax_[i]);
    const float scale = __fmul_rn(fmaxf(t, 1e-7f), INV_INT8_MAX);
    stats[m] = rs;
    stats[M + m] = scale;
    stats[2 * M + m] = scale;
  }
}

}  // namespace

// x [M, ldx] bf16 (x_f32 = 0) or f32 (x_f32 = 1), its first K columns used;
// gamma, beta [K] f32; w [L, N/bn, K, bn] int8 (bn = N: a plain [K, N] weight
// with L = 1); ws [L, N] f32; bias [L, N] int32 or null; quant_scale and
// quant_offset one f32 each (per_tensor; quant_offset may be null); stats
// [3, M] f32 written here; out [M, N] bf16 or f32 (out_f32); splits > 1 needs
// workspace M*N int32. Needs K % 64 == 0, N % 16 == 0, bn == N or
// bn % 128 == 0, and rows of x 16-byte aligned.
extern "C" int skt_rmsq_gemm(const void* x, const void* gamma, const void* beta,
                             const void* w, const void* ws, const void* bias,
                             const void* quant_scale, const void* quant_offset, void* stats,
                             void* out, void* workspace, int M, int N, int K, int ldx,
                             int li, int bn, int splits, float eps, int apply_norm,
                             int per_tensor, int x_f32, int fp16_cast, int out_f32,
                             void* stream) {
  if (bn <= 0 || N % bn != 0 || (bn != N && bn % skt_w8a8::BN != 0) || ldx < K ||
      (per_tensor && quant_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  float* sv = static_cast<float*>(stats);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* qs = static_cast<const float*>(quant_scale);
  if (x_f32)
    rmsq_rows<float><<<M, ROW_THREADS, 0, st>>>(static_cast<const float*>(x), ldx, g, b,
                                                qs, sv, M, K, eps, apply_norm, per_tensor);
  else
    rmsq_rows<__nv_bfloat16><<<M, ROW_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, g, b, qs, sv, M, K, eps, apply_norm,
        per_tensor);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  skt_w8a8::Gemm p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.rstd = sv;
  p.qdiv = sv + M;
  p.xs = sv + 2 * M;
  p.qoff = per_tensor ? static_cast<const float*>(quant_offset) : nullptr;
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const int32_t*>(bias);
  p.out = out;
  p.accum = static_cast<int32_t*>(workspace);
  p.gamma = g;
  p.beta = b;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldx = ldx;
  p.li = li;
  p.bn = bn;
  p.out_f32 = out_f32;
  p.fp16_cast = fp16_cast;
  return x_f32 ? (int)skt_w8a8::launch<skt_w8a8::X_F32>(p, splits, st)
               : (int)skt_w8a8::launch<skt_w8a8::X_BF16>(p, splits, st);
}

extern "C" const char* skt_rmsq_gemm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
