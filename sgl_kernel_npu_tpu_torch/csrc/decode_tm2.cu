// Kernel K3: paged GQA decode over the read-only int8 head-major-page ("tm2")
// cache, with the current token folded in (deferred write).
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_v13.py::
// decode_gqa_pallas_v13_int8_defer (_kernel_v13_int8) and decode_v11.py::
// decode_gqa_pallas_v11_int8_defer (_kernel_v11_int8), which share one
// contract and take one page per online-softmax step, and their finalization
// decode_v6.py::_finalize_rows.
//
// Cache: k/v int8 [L, P, hkv, ps, D], head h's tokens of a page one contiguous
// [ps, D] block; scales f32 [L, P, hkv, ps]. One block per (kv head, sequence)
// serves the G query heads of its group, so every cached row is read from
// device memory once per layer.
//
// Bound on an H100: the bytes of the cached rows it must read,
// cached*hkv*(2*D + 8) per sequence and layer, over 3.35 TB/s; its operations
// are a few per byte, far below the tensor-core line. Design: per page, warps
// read 4 tokens' 128-byte k rows at a time (8 lanes per row, 16 bytes each)
// and write all the page's scores to shared memory (G x ps f32); then one warp
// per query head takes the page maximum, rescales, and stores p * v_scale
// rounded to bf16 (as the TPU kernels round it before their bf16 MXU dot);
// then each thread accumulates 16 columns of P.V over every 16th token. So
// it rounds where v11/v13 round. Columns past the cached length are dead:
// their score is -1e30 and their v scale 0, and no P.V term reads them, so a
// stale row can never put 0*NaN into the sum. cached = 0 (only the current
// token) and any number of pages per sequence are handled.
// Simple first: CUDA cores, no split over the context, no tensor cores yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_once.cuh"

namespace {

constexpr int D = 128;          // head dim
constexpr int THREADS = 128;    // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;       // bytes (= int8 columns) per lane of a row
constexpr int LPR = D / CHUNK;  // lanes per row: 8
constexpr int RPW = 32 / LPR;   // rows per warp step: 4
constexpr float NEG = -1e30f;

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

template <int G>
__global__ void __launch_bounds__(THREADS)
decode_tm2_kernel(const __nv_bfloat16* __restrict__ q,     // [B, hq, D]
                  const __nv_bfloat16* __restrict__ kn,    // [B, hkv, D]
                  const __nv_bfloat16* __restrict__ vn,    // [B, hkv, D]
                  const int8_t* __restrict__ kc,           // [L, P, hkv, ps, D]
                  const int8_t* __restrict__ vc,
                  const float* __restrict__ ksc,           // [L, P, hkv, ps]
                  const float* __restrict__ vsc,
                  const int* __restrict__ cached,          // [B]
                  const int* __restrict__ bt,              // [B, MP]
                  __nv_bfloat16* __restrict__ out,         // [B, hq, D]
                  int hkv, int P, int ps, int MP, int li, float sm_scale) {
  extern __shared__ float smem[];
  float* sc = smem;                    // [G][ps] scores, then bf16(p * v_scale)
  float* vscale = smem + G * ps;       // [ps]
  __shared__ float qs[G][D];
  __shared__ float red[WARPS][G][D];
  __shared__ float m_s[G], l_s[G], alpha_s[G], pcur_s[G];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * G;
  const int sub = lane / LPR, col0 = (lane % LPR) * CHUNK;
  // a block table maps at most MP*ps tokens: never read past it
  const int clen = min(max(cached[b], 0), MP * ps);
  const int npages = (clen + ps - 1) / ps;

  for (int g = 0; g < G; ++g)
    qs[g][tid] = __bfloat162float(q[((size_t)b * hq + h * G + g) * D + tid]);
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  float qr[G][CHUNK];                  // this lane's columns of q
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) qr[g][e] = qs[g][col0 + e];

  float acc[G][CHUNK];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) acc[g][e] = 0.f;

  for (int c = 0; c < npages; ++c) {
    const int page = bt[(size_t)b * MP + c];
    const size_t head = (((size_t)li * P + page) * hkv + h) * (size_t)ps;  // row index
    const int8_t* kp = kc + head * D;
    const int8_t* vp = vc + head * D;
    const int n = min(ps, clen - c * ps);              // live tokens of the page

    // scores of the page: warp w, step s covers tokens (s*WARPS + w)*RPW + sub;
    // the steps stop at the live tokens (the rest of the page is never read)
    for (int t0 = warp * RPW; t0 < n; t0 += WARPS * RPW) {
      const int t = t0 + sub;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      if (t < n) {
        const int4 kv = *reinterpret_cast<const int4*>(kp + (size_t)t * D + col0);
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&kv);
#pragma unroll
        for (int e = 0; e < CHUNK; ++e) {
          const float kf = (float)k8[e];
#pragma unroll
          for (int g = 0; g < G; ++g) dot[g] += qr[g][e] * kf;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      }
      if (lane % LPR == 0 && t < ps) {
        const bool live = t < n;
        const float ks = live ? ksc[head + t] : 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g * ps + t] = live ? dot[g] * ks * sm_scale : NEG;
        vscale[t] = live ? vsc[head + t] : 0.f;
      }
    }
    __syncthreads();

    // online softmax, one page per step: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float mt = NEG;
      for (int t = lane; t < n; t += 32) mt = fmaxf(mt, sc[g * ps + t]);
      mt = warp_max(mt);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);
      const float alpha = expf(m_old - m_new);
      float psum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(sc[g * ps + t] - m_new);
        psum += p;
        sc[g * ps + t] = bf16_round(p * vscale[t]);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + psum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // P.V: this thread's 16 columns over tokens warp*RPW + sub + 16*i
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int e = 0; e < CHUNK; ++e) acc[g][e] *= a;
    }
    for (int t = warp * RPW + sub; t < n; t += WARPS * RPW) {
      const int4 vv = *reinterpret_cast<const int4*>(vp + (size_t)t * D + col0);
      const int8_t* v8 = reinterpret_cast<const int8_t*>(&vv);
      float pv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pv[g] = sc[g * ps + t];
#pragma unroll
      for (int e = 0; e < CHUNK; ++e) {
        const float vf = (float)v8[e];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][e] += pv[g] * vf;
      }
    }
    __syncthreads();                 // sc and vscale are rewritten next page
  }

  // sum the partial P.V of the 4 token lanes of a warp, then of the warps
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) {
      float v = acc[g][e];
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[g][e] = v;
    }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < CHUNK; ++e) red[warp][g][col0 + e] = acc[g][e];
  }

  // fold the current token in (decode_v6.py::_finalize_rows)
  const size_t cur = ((size_t)b * hkv + h) * D;
  for (int g = warp; g < G; g += WARPS) {
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
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += red[w][g][tid];
    o = o * alpha_s[g] + pcur_s[g] * vcur;
    out[((size_t)b * hq + h * G + g) * D + tid] =
        __float2bfloat16_rn(o / fmaxf(l_s[g], 1e-37f));
  }
}

template <int G>
cudaError_t launch(const void* q, const void* kn, const void* vn, const void* kc,
                   const void* vc, const void* ksc, const void* vsc, const void* cached,
                   const void* bt, void* out, int B, int hkv, int P, int ps, int MP,
                   int li, float sm_scale, cudaStream_t st) {
  // scores and v scales of one page; raise the kernel's dynamic shared-memory
  // limit on this device the first time a larger page needs it
  const size_t smem = (size_t)(G + 1) * ps * sizeof(float);
  const cudaError_t e = skt::ensure_smem(decode_tm2_kernel<G>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(hkv, B);
  decode_tm2_kernel<G><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kn),
      static_cast<const __nv_bfloat16*>(vn), static_cast<const int8_t*>(kc),
      static_cast<const int8_t*>(vc), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(cached),
      static_cast<const int*>(bt), static_cast<__nv_bfloat16*>(out), hkv, P, ps, MP, li,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// G = hq / hkv in {1, 2, 4, 8}; D = 128.
extern "C" int skt_decode_tm2(const void* q, const void* kn, const void* vn,
                              const void* kc, const void* vc, const void* ksc,
                              const void* vsc, const void* cached, const void* bt,
                              void* out, int B, int hkv, int G, int P, int ps, int MP,
                              int li, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  switch (G) {
    case 1: return (int)launch<1>(q, kn, vn, kc, vc, ksc, vsc, cached, bt, out, B, hkv,
                                  P, ps, MP, li, sm_scale, st);
    case 2: return (int)launch<2>(q, kn, vn, kc, vc, ksc, vsc, cached, bt, out, B, hkv,
                                  P, ps, MP, li, sm_scale, st);
    case 4: return (int)launch<4>(q, kn, vn, kc, vc, ksc, vsc, cached, bt, out, B, hkv,
                                  P, ps, MP, li, sm_scale, st);
    case 8: return (int)launch<8>(q, kn, vn, kc, vc, ksc, vsc, cached, bt, out, B, hkv,
                                  P, ps, MP, li, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* skt_decode_tm2_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
