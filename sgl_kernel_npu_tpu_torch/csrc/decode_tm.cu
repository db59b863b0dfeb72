// Kernel C: paged GQA decode over the read-only int8 token-major cache, with
// the current token folded in (deferred write).
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/decode_v9.py::
// decode_gqa_pallas_v9_int8_defer (_kernel_v9_int8) and its finalization
// decode_v6.py::_finalize_rows.
//
// Cache: k/v int8 [L, P, ps*hkv, D], row r = t*hkv + h; scales f32
// [L, P, 1, ps*hkv] with the same row order. One block per (kv head, sequence)
// serves the G = hq/hkv query heads of its group, so every cached k/v row is
// read from device memory once per layer.
//
// Bound on an H100: the bytes of the cached rows it must read,
// cached*hkv*D*2 + cached*hkv*8 per sequence per layer, over 3.35 TB/s (its
// operations are a few per byte, far below the tensor-core line). Design:
// a tile of D cached tokens per step, one thread per token for the scores
// (16-byte row loads, q of the group held in shared memory), an f32 online
// softmax per head (one warp per head), then one thread per output column for
// P.V. It follows the TPU kernel's rounding: k scales multiply the scores,
// v scales multiply the probabilities, and that product is rounded to bf16
// before it meets V, as the MXU dot there takes bf16 operands. Only rows
// t < cached are ever read, so no stale slot can put 0*NaN into the sum (the
// TPU kernel masks its stale VMEM lanes for that, decode_v9.py:113-116).
// Simple first: no split over the context, no tensor cores yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head dim (the tm layout's lane width)
constexpr int TILE = D;         // cached tokens per step = threads per block
constexpr int MAXG = 8;         // query heads per kv head

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(TILE)
decode_tm_kernel(const __nv_bfloat16* __restrict__ q,     // [B, hq, D]
                 const __nv_bfloat16* __restrict__ kn,    // [B, hkv, D]
                 const __nv_bfloat16* __restrict__ vn,    // [B, hkv, D]
                 const int8_t* __restrict__ kc,           // [L, P, ps*hkv, D]
                 const int8_t* __restrict__ vc,
                 const float* __restrict__ ksc,           // [L, P, 1, ps*hkv]
                 const float* __restrict__ vsc,
                 const int* __restrict__ cached,          // [B]
                 const int* __restrict__ bt,              // [B, MP]
                 __nv_bfloat16* __restrict__ out,         // [B, hq, D]
                 int hkv, int G, int P, int ps, int MP, int li, float sm_scale) {
  __shared__ float qs[MAXG][D];
  __shared__ float sc[MAXG][TILE];      // scores, then bf16(p * v_scale)
  __shared__ float vscale[TILE];
  __shared__ long long vrow[TILE];      // element offset of each token's v row
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG], pcur_s[MAXG];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = TILE / 32;
  const int hq = hkv * G;
  // a block table maps at most MP*ps tokens: never read past it
  const int clen = min(max(cached[b], 0), MP * ps);
  const long long rows = (long long)ps * hkv;

  for (int g = 0; g < G; ++g)
    qs[g][tid] = __bfloat162float(q[((size_t)b * hq + h * G + g) * D + tid]);
  if (tid < G) {
    m_s[tid] = -CUDART_INF_F;
    l_s[tid] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < clen; t0 += TILE) {
    // scores: thread tid owns cached token t0 + tid
    const int tok = t0 + tid;
    if (tok < clen) {
      const int page = bt[(size_t)b * MP + tok / ps];
      const long long row = ((long long)li * P + page) * rows
                            + (long long)(tok % ps) * hkv + h;
      const int8_t* kp = kc + row * D;
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 16) {
        const int4 kv = *reinterpret_cast<const int4*>(kp + d);
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&kv);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kf = (float)k8[e];
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) dot[g] += qs[g][d + e] * kf;
        }
      }
      const float ks = ksc[row];
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) sc[g][tid] = dot[g] * ks * sm_scale;
      vscale[tid] = vsc[row];
      vrow[tid] = row * D;
    } else {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) sc[g][tid] = -CUDART_INF_F;
      vscale[tid] = 0.f;
      vrow[tid] = 0;
    }
    __syncthreads();

    // online softmax: one warp per query head (the tile holds >= 1 valid token)
    for (int g = warp; g < G; g += nwarps) {
      float mt = -CUDART_INF_F;
      for (int c = lane; c < TILE; c += 32) mt = fmaxf(mt, sc[g][c]);
      mt = warp_max(mt);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);
      const float alpha = expf(m_old - m_new);
      float psum = 0.f;
      for (int c = lane; c < TILE; c += 32) {
        const float p = expf(sc[g][c] - m_new);
        psum += p;
        sc[g][c] = bf16_round(p * vscale[c]);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + psum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // P.V: thread tid owns output column tid
    const int nvalid = min(TILE, clen - t0);
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] *= alpha_s[g];
    for (int c = 0; c < nvalid; ++c) {
      const float v = (float)vc[vrow[c] + tid];
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] += sc[g][c] * v;
    }
    __syncthreads();
  }

  // fold the current token in (decode_v6.py::_finalize_rows)
  const size_t cur = ((size_t)b * hkv + h) * D;
  for (int g = warp; g < G; g += nwarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += qs[g][d] * __bfloat162float(kn[cur + d]);
    s = warp_sum(s) * sm_scale;
    if (lane == 0) {
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, s);
      const float alpha = expf(m_old - m_new);
      const float p = expf(s - m_new);
      l_s[g] = l_s[g] * alpha + p;
      alpha_s[g] = alpha;
      pcur_s[g] = bf16_round(p);
    }
  }
  __syncthreads();
  const float vcur = __bfloat162float(vn[cur + tid]);
  for (int g = 0; g < G; ++g) {
    const float o = acc[g] * alpha_s[g] + pcur_s[g] * vcur;
    out[((size_t)b * hq + h * G + g) * D + tid] =
        __float2bfloat16_rn(o / fmaxf(l_s[g], 1e-37f));
  }
}

}  // namespace

extern "C" int skt_decode_tm(const void* q, const void* kn, const void* vn,
                             const void* kc, const void* vc, const void* ksc,
                             const void* vsc, const void* cached, const void* bt,
                             void* out, int B, int hkv, int G, int P, int ps, int MP,
                             int li, float sm_scale, void* stream) {
  if (G > MAXG) return (int)cudaErrorInvalidValue;
  const dim3 grid(hkv, B);
  decode_tm_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kn),
      static_cast<const __nv_bfloat16*>(vn), static_cast<const int8_t*>(kc),
      static_cast<const int8_t*>(vc), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(cached),
      static_cast<const int*>(bt), static_cast<__nv_bfloat16*>(out), hkv, G, P, ps,
      MP, li, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_decode_tm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
