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
// bytes per element from bf16); a few operations per element.
//
// Design: a block a row, in one of two forms chosen by the row count.
//   * Decode rows (N no more than the SMs): the four per-column vectors (16
//     bytes a column, more than a bf16 row's own 7) are loaded before the
//     norm, not after it, so their latency is no longer paid after the
//     reduction; their 64 KB a row of 4096 still take the SM some 0.45 us
//     to take in, wherever they are issued. A thread holds one or two
//     8-column chunks (d <= 4096: one; the block d / 8 threads, at most
//     512).
//   * More rows (a prefill): 256 threads a row, up to four chunks each; the
//     vectors are read after the row's norm, as the other blocks on the SM
//     keep its loads in flight, and the block holds few registers, so that
//     many fit on an SM.
// In both, every warp finds rstd itself: the warps' float64 partial sums go
// to shared memory, one barrier, then each warp sums them in the same xor
// tree (every lane the same bits) and takes the float64 root and reciprocal
// (IEEE, as 1.0 / sqrt), so no second barrier waits on one thread. The
// clamp and rint take no conversion instruction (those run at a quarter of
// the FMA rate): the value is clamped to [-128, 127] first (the bounds are
// integers, so clamping commutes with rounding; NaN goes to -128 as before)
// and 1.5 * 2^23 added, which rounds it to the nearest integer, ties to
// even, in the low byte of the sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_once.cuh"

namespace {

constexpr int MAX_D = 8192;
constexpr int STREAM_THREADS = 256;    // a prefill row's block
constexpr int STREAM_CPT = MAX_D / 8 / STREAM_THREADS;
constexpr int DECODE_THREADS = 512;    // the most a decode row's block takes

// 8 elements of a row as they lie in memory: one 16-byte vector of bf16, two
// of f32
template <typename T>
struct Raw {
  int4 v[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load_raw(const T* p, Raw<T>& r) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    r.v[i] = __ldg(reinterpret_cast<const int4*>(p) + i);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void to_f32(const Raw<__nv_bfloat16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void to_f32(const Raw<float>& r, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(&r.v[0]);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = f[i];
}

// h = x + residual, the f32 sum rounded once to the storage type
__device__ __forceinline__ void add_round(const Raw<__nv_bfloat16>& x,
                                          const Raw<__nv_bfloat16>& r,
                                          Raw<__nv_bfloat16>& h) {
  float a[8], c[8];
  to_f32(x, a);
  to_f32(r, c);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&h.v[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __floats2bfloat162_rn(__fadd_rn(a[2 * i], c[2 * i]),
                                 __fadd_rn(a[2 * i + 1], c[2 * i + 1]));
}
__device__ __forceinline__ void add_round(const Raw<float>& x, const Raw<float>& r,
                                          Raw<float>& h) {
  const float* a = reinterpret_cast<const float*>(&x.v[0]);
  const float* c = reinterpret_cast<const float*>(&r.v[0]);
  float* o = reinterpret_cast<float*>(&h.v[0]);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __fadd_rn(a[i], c[i]);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rstd of the row from the block's nw warp partials (after the barrier that
// wrote them): the same xor tree in every warp and lane
__device__ __forceinline__ float row_rstd(const double* part, int nw, int lane, int d,
                                          float eps) {
  const double t = warp_sum(lane < nw ? part[lane] : 0.0);
  const float v = __fadd_rn(__fdiv_rn((float)t, (float)d), eps);
  return (float)__drcp_rn(__dsqrt_rn((double)v));
}

// the int8 of 8 columns: y = h * rstd * w + b, z = y * qs + qo, each step
// rounded; clamp(rint(z), -128, 127) from the low byte of clamp(z) + 1.5 * 2^23
__device__ __forceinline__ int2 quant8(const float (&h)[8], float rs, const float (&w)[8],
                                       const float (&b)[8], const float (&qs)[8],
                                       const float (&qo)[8]) {
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(h[j], rs), w[j]), b[j]);
    const float z = __fadd_rn(__fmul_rn(y, qs[j]), qo[j]);
    v[j] = __float_as_uint(__fadd_rn(fminf(fmaxf(z, -128.f), 127.f), 12582912.f));
  }
  const uint32_t lo = __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040),
                                  0x5410);
  const uint32_t hi = __byte_perm(__byte_perm(v[4], v[5], 0x0040), __byte_perm(v[6], v[7], 0x0040),
                                  0x5410);
  return make_int2((int)lo, (int)hi);
}

// A block a row; CPT chunks of 8 columns a thread (chunk tid + c * threads);
// EARLY: the vectors loaded before the row's norm (decode rows), else after
// it
template <typename T, int CPT, bool EARLY>
__global__ void __launch_bounds__(EARLY ? DECODE_THREADS : STREAM_THREADS)
add_rmsnorm_quant_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         const float* __restrict__ w, const float* __restrict__ b,
                         const float* __restrict__ qs, const float* __restrict__ qo,
                         int8_t* __restrict__ q, T* __restrict__ hout, int d, float eps) {
  __shared__ double part[32];
  const int tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  const size_t row = (size_t)blockIdx.x * d;
  const int chunks = d / 8;
  Raw<T> xr[CPT], rr[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = tid + c * nt;
    if (ch < chunks) {
      load_raw(x + row + ch * 8, xr[c]);
      load_raw(res + row + ch * 8, rr[c]);
    }
  }
  // h in the storage type (stored as it is), its squares summed in float64
  Raw<T> hr[CPT];
  double ss = 0.0;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = tid + c * nt;
    if (ch < chunks) {
      add_round(xr[c], rr[c], hr[c]);
      int4* dst = reinterpret_cast<int4*>(hout + row + ch * 8);
#pragma unroll
      for (int j = 0; j < (int)(sizeof(T) / 2); ++j) dst[j] = hr[c].v[j];
      float hf[8];
      to_f32(hr[c], hf);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += (double)hf[j] * (double)hf[j];
    }
  }
  // EARLY: the vectors, issued after the row's loads and before the
  // barrier, so that they arrive while the block reduces
  float wv[EARLY ? CPT : 1][8], bv[EARLY ? CPT : 1][8], sv[EARLY ? CPT : 1][8],
      ov[EARLY ? CPT : 1][8];
  if constexpr (EARLY) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int ch = tid + c * nt;
      if (ch < chunks) {
        load8(w + ch * 8, wv[c]);
        load8(b + ch * 8, bv[c]);
        load8(qs + ch * 8, sv[c]);
        load8(qo + ch * 8, ov[c]);
      }
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) part[tid >> 5] = ss;
  __syncthreads();
  const float rs = row_rstd(part, nt >> 5, lane, d, eps);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = tid + c * nt;
    if (ch < chunks) {
      float hf[8];
      to_f32(hr[c], hf);
      int2 out;
      if constexpr (EARLY) {
        out = quant8(hf, rs, wv[c], bv[c], sv[c], ov[c]);
      } else {
        float w8[8], b8[8], s8[8], o8[8];
        load8(w + ch * 8, w8);
        load8(b + ch * 8, b8);
        load8(qs + ch * 8, s8);
        load8(qo + ch * 8, o8);
        out = quant8(hf, rs, w8, b8, s8, o8);
      }
      *reinterpret_cast<int2*>(q + row + ch * 8) = out;
    }
  }
}

template <typename T, int CPT, bool EARLY>
cudaError_t launch_rows(const void* x, const void* res, const float* w, const float* b,
                        const float* qs, const float* qo, int8_t* q, void* h, int N, int d,
                        int threads, float eps, cudaStream_t st) {
  add_rmsnorm_quant_kernel<T, CPT, EARLY><<<N, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), w, b, qs, qo, q, static_cast<T*>(h),
      d, eps);
  return cudaGetLastError();
}

// the decode form while every row has an SM of its own, else the prefill form
template <typename T>
cudaError_t launch(const void* x, const void* res, const float* w, const float* b,
                   const float* qs, const float* qo, int8_t* q, void* h, int N, int d, float eps,
                   cudaStream_t st) {
  int sms = 0;
  const cudaError_t e = skt::sm_count(sms);
  if (e != cudaSuccess) return e;
  const int chunks = d / 8;
  if (N <= sms) {
    const int cpt = chunks <= DECODE_THREADS ? 1 : 2;
    const int threads = ((chunks + cpt - 1) / cpt + 31) / 32 * 32;
    return cpt == 1
               ? launch_rows<T, 1, true>(x, res, w, b, qs, qo, q, h, N, d, threads, eps, st)
               : launch_rows<T, 2, true>(x, res, w, b, qs, qo, q, h, N, d, threads, eps, st);
  }
  const int threads = chunks < STREAM_THREADS ? (chunks + 31) / 32 * 32 : STREAM_THREADS;
  return launch_rows<T, STREAM_CPT, false>(x, res, w, b, qs, qo, q, h, N, d, threads, eps, st);
}

}  // namespace

// x, residual [N, d] bf16 (x_f32 = 0) or f32; weight, bias, quant_scale,
// quant_offset [d] f32; q [N, d] int8; h [N, d] in x's dtype. d % 8 == 0,
// d <= 8192.
extern "C" int skt_add_rmsnorm_quant(const void* x, const void* res, const void* w,
                                     const void* b, const void* qs, const void* qo, void* q,
                                     void* h, int N, int d, int x_f32, float eps, void* stream) {
  if (N <= 0 || d <= 0 || d % 8 || d > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* sf = static_cast<const float*>(qs);
  const float* of = static_cast<const float*>(qo);
  int8_t* q8 = static_cast<int8_t*>(q);
  const cudaError_t e =
      x_f32 ? launch<float>(x, res, wf, bf, sf, of, q8, h, N, d, eps, st)
            : launch<__nv_bfloat16>(x, res, wf, bf, sf, of, q8, h, N, d, eps, st);
  return (int)e;
}

extern "C" const char* skt_add_rmsnorm_quant_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
