// Kernel K20: residual add + RMSNorm + bias + static int8 quantisation, with
// the residual sum stored.
//
// Replaces sgl_kernel_npu_tpu/ops/norm.py::_add_rmsnorm_quant_pallas
// (_add_rmsnorm_quant_kernel, norm.py:59-95), the quant path of the
// reference's add_rmsnorm_bias. For row r of x, residual [N, d] (bf16 or f32,
// one dtype) and per-column f32 vectors weight, bias, quant_scale,
// quant_offset [d]:
//   h     = x + residual in x's dtype (the f32 sum rounded once)  -> h [N, d]
//   mean  = sum_k h^2 / d: the sum in float64 (every bf16 square is exact
//           there), rounded to f32 once, divided in f32
//   rstd  = 1 / sqrt(mean + eps) in float64, rounded to f32 once (rsqrtf
//           approximates)
//   y     = h * rstd * weight + bias, q = y * quant_scale + quant_offset,
//           each step one f32 operation rounded on its own (no FMA)
//   out   = clamp(rint(q), -128, 127), round half to even  -> int8 [N, d]
// The plain version (ops/norm.py::add_rmsnorm_bias_ref) takes the same
// steps, so the two agree bit for bit on the card.
//
// Bound on an H100: bytes (x and residual read, h and the int8 written: 7
// bytes per element from bf16); a few operations per element. Design: one
// block of 256 threads per row; a thread holds its 8-element chunks of h in
// registers (d <= 8192: at most 4 chunks a thread), so the row is read once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXC = 4;                // 8-element chunks per thread

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// h = x + residual rounded to the storage type, stored, and returned as f32
__device__ __forceinline__ void add_store8(const float (&x)[8], const float (&r)[8],
                                           __nv_bfloat16* p, float (&h)[8]) {
  __align__(16) __nv_bfloat16 o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[i] = __float2bfloat16_rn(__fadd_rn(x[i], r[i]));
    h[i] = __bfloat162float(o[i]);
  }
  *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(o);
}
__device__ __forceinline__ void add_store8(const float (&x)[8], const float (&r)[8], float* p,
                                           float (&h)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __fadd_rn(x[i], r[i]);
  reinterpret_cast<float4*>(p)[0] = make_float4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(h[4], h[5], h[6], h[7]);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
add_rmsnorm_quant_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         const float* __restrict__ w, const float* __restrict__ b,
                         const float* __restrict__ qs, const float* __restrict__ qo,
                         int8_t* __restrict__ q, T* __restrict__ hout, int d, float eps) {
  __shared__ double part[THREADS / 32];
  __shared__ float rstd_s;
  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * d;
  const int chunks = d / 8;
  float h[MAXC][8];
  double ss = 0.0;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int ch = tid + c * THREADS;
    if (ch < chunks) {
      float xv[8], rv[8];
      load8(x + row + ch * 8, xv);
      load8(res + row + ch * 8, rv);
      add_store8(xv, rv, hout + row + ch * 8, h[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += (double)h[c][i] * (double)h[c][i];
    }
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) part[tid >> 5] = ss;
  __syncthreads();
  if (tid == 0) {
    double t = 0.0;
    for (int i = 0; i < THREADS / 32; ++i) t += part[i];
    const float v = __fadd_rn(__fdiv_rn((float)t, (float)d), eps);
    rstd_s = (float)(1.0 / sqrt((double)v));
  }
  __syncthreads();
  const float rs = rstd_s;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int ch = tid + c * THREADS;
    if (ch < chunks) {
      const int k0 = ch * 8;
      float wv[8], bv[8], sv[8], ov[8];
      load8(w + k0, wv);
      load8(b + k0, bv);
      load8(qs + k0, sv);
      load8(qo + k0, ov);
      __align__(8) int8_t out[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(h[c][i], rs), wv[i]), bv[i]);
        const float z = __fadd_rn(__fmul_rn(y, sv[i]), ov[i]);
        out[i] = (int8_t)fminf(fmaxf(rintf(z), -128.f), 127.f);
      }
      *reinterpret_cast<int2*>(q + row + k0) = *reinterpret_cast<const int2*>(out);
    }
  }
}

}  // namespace

// x, residual [N, d] bf16 (x_f32 = 0) or f32; weight, bias, quant_scale,
// quant_offset [d] f32; q [N, d] int8; h [N, d] in x's dtype. d % 8 == 0,
// d <= 8192.
extern "C" int skt_add_rmsnorm_quant(const void* x, const void* res, const void* w,
                                     const void* b, const void* qs, const void* qo, void* q,
                                     void* h, int N, int d, int x_f32, float eps, void* stream) {
  if (N <= 0 || d <= 0 || d % 8 || d > 8 * THREADS * MAXC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* sf = static_cast<const float*>(qs);
  const float* of = static_cast<const float*>(qo);
  int8_t* qo8 = static_cast<int8_t*>(q);
  if (x_f32)
    add_rmsnorm_quant_kernel<float><<<N, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(res), wf, bf, sf, of, qo8,
        static_cast<float*>(h), d, eps);
  else
    add_rmsnorm_quant_kernel<__nv_bfloat16><<<N, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(res), wf, bf,
        sf, of, qo8, static_cast<__nv_bfloat16*>(h), d, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_add_rmsnorm_quant_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
