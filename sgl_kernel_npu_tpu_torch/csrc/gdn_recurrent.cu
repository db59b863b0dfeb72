// Kernel K9: one gated-delta-rule decode step on a bf16 or f32 state pool, in
// place.
//
// Replaces sgl_kernel_npu_tpu/ops/gdn/recurrent_pallas.py::
// fused_sigmoid_gating_delta_rule_update_pallas (_kernel, recurrent_pallas.py:
// 38-133), the recurrence of every GDN layer of the Qwen3-Next decode steps.
// The gating (g, beta from A_log, a, dt_bias, b) stays in PyTorch, as it
// stays in XLA there. Like the TPU kernel, which keeps its scratch in the
// pool's dtype, it takes a bf16 pool (decode_step_q's) or an f32 one (the
// f32 decode_step's, and the JAX init_state's default), at K = V = D in
// {32, 64, 128}: one instantiation per (pool type, D).
//
// Per sequence b and value head hv (query/key head h = hv / (HV / H)), all f32:
//   q, k <- q * rstd(q), k * rstd(k)     (l2norm: rstd = 1/sqrt(sum x^2 + 1e-6))
//   q    <- q * scale
//   s     = float(pool[row, hv]) * exp(g)              [D, D]
//   kv[j] = sum_i k[i] s[i, j];  delta[j] = (v[j] - kv[j]) * beta
//   s    += k[i] delta[j];       o[j] = sum_i q[i] s[i, j]
//   pool[row, hv] = s, rounded to bf16 (to nearest even) on a bf16 pool and
//   stored as it is on an f32 one; o comes from the f32 s
// with row = clamp(idx[b], 0, pool_rows - 1); a sequence with idx[b] < 0 reads
// that row and writes nothing. The sum of squares of the l2norm is taken in
// float64 and rounded to f32, and 1/sqrt(that + 1e-6) in float64 and rounded
// once, as the plain version takes it, since rsqrtf approximates.
//
// Bound on an H100: the state, read once and written once (2 * D * D * the
// pool's element bytes per (sequence, head): 67 MB at the Qwen bench shape,
// bf16, 0.020 ms at 3.35 TB/s; 268 MB at Qwen3-Next-80B-A3B's 32 v-heads,
// f32, 0.080 ms); 4 * D * D operations per (sequence, head) are far below
// the f32 rate. Design: one block per (head, sequence), one thread per value
// column j. The thread that owns column j runs the whole recurrence down it
// with its D state values in registers (no cross-thread reduction); q and k
// sit in shared memory and are read as broadcasts. A warp reads 64 (bf16) or
// 128 (f32) contiguous bytes of each state row. Simple first: no vector
// loads, no cp.async.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }

template <int WARPS>
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                      // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// 1/sqrt(f32(sum) + 1e-6), from a float64 sum, rounded once
__device__ __forceinline__ float inv_norm(double sum) {
  const float s = __fadd_rn((float)sum, 1e-6f);
  return (float)(1.0 / sqrt((double)s));
}

// KD = VD = D: D threads a block, one value column each
template <typename T, int D>
__global__ void __launch_bounds__(D)
gdn_recurrent_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ beta, T* __restrict__ pool,
                     const int* __restrict__ idx, float* __restrict__ out, int H, int HV,
                     int pool_rows, float scale, int l2norm) {
  constexpr int KD = D, VD = D, WARPS = D / 32;
  __shared__ float qs[KD], ks[KD];
  __shared__ double red[WARPS];
  const int hv = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int h = hv / (HV / H);
  float qj = q[((size_t)b * H + h) * KD + j];
  float kj = k[((size_t)b * H + h) * KD + j];
  if (l2norm) {
    const float rq = inv_norm(block_sum<WARPS>((double)qj * qj, red));
    const float rk = inv_norm(block_sum<WARPS>((double)kj * kj, red));
    qj = __fmul_rn(qj, rq);
    kj = __fmul_rn(kj, rk);
  }
  qs[j] = __fmul_rn(qj, scale);
  ks[j] = kj;
  __syncthreads();

  const int raw = idx[b];
  const int row = min(max(raw, 0), pool_rows - 1);
  T* st = pool + ((size_t)row * HV + hv) * (size_t)(KD * VD) + j;
  const size_t bh = (size_t)b * HV + hv;
  const float alpha = expf(g[bh]);
  const float bt = beta[bh];

  float s[KD];
  float kv = 0.f;
#pragma unroll
  for (int i = 0; i < KD; ++i) {
    s[i] = __fmul_rn(to_f32(st[(size_t)i * VD]), alpha);
    kv += ks[i] * s[i];
  }
  const float delta = __fmul_rn(__fsub_rn(v[bh * VD + j], kv), bt);
  float o = 0.f;
#pragma unroll
  for (int i = 0; i < KD; ++i) {
    s[i] += ks[i] * delta;
    o += qs[i] * s[i];
  }
  out[bh * VD + j] = o;
  if (raw >= 0) {
#pragma unroll
    for (int i = 0; i < KD; ++i) from_f32(st + (size_t)i * VD, s[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* g, const void* beta,
           void* pool, const void* idx, void* out, int B, int H, int HV, int pool_rows,
           float scale, int l2norm, cudaStream_t stream) {
  gdn_recurrent_kernel<T, D><<<dim3(HV, B), D, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<T*>(pool), static_cast<const int*>(idx),
      static_cast<float*>(out), H, HV, pool_rows, scale, l2norm);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k [B, H, D] f32; v [B, HV, D] f32; g, beta [B, HV] f32; pool
// [pool_rows, HV, D, D] bf16 (pool_f32 == 0) or f32 (pool_f32 != 0), updated
// in place; idx [B] int32; out [B, HV, D] f32; D = kd = vd in {32, 64, 128}.
// HV a multiple of H. Rows that a sequence with idx < 0 reads must not be
// written by another sequence of the same call.
extern "C" int skt_gdn_recurrent(const void* q, const void* k, const void* v, const void* g,
                                 const void* beta, void* pool, const void* idx, void* out,
                                 int B, int H, int HV, int kd, int vd, int pool_rows,
                                 float scale, int l2norm, int pool_f32, void* stream) {
  if (kd != vd || H <= 0 || HV % H != 0 || pool_rows <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SKT_GDN_CASE(D)                                                                      \
  case D:                                                                                   \
    return pool_f32 ? launch<float, D>(q, k, v, g, beta, pool, idx, out, B, H, HV,          \
                                       pool_rows, scale, l2norm, st)                        \
                    : launch<__nv_bfloat16, D>(q, k, v, g, beta, pool, idx, out, B, H, HV,  \
                                               pool_rows, scale, l2norm, st);
  switch (kd) {
    SKT_GDN_CASE(32)
    SKT_GDN_CASE(64)
    SKT_GDN_CASE(128)
    default:
      break;
  }
#undef SKT_GDN_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* skt_gdn_recurrent_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
