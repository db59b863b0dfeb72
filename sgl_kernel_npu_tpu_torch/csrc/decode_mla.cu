// Kernel K7: paged MLA decode over split latent caches, all in f32.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode.py::decode_mla_pallas
// (_mla_decode_kernel, decode.py:192-283), the serving engine's attention.
//
// q [B, H, lkv + lrope] bf16; ckv [P, ps, lkv] and krope [P, ps, lrope] bf16
// (one layer's caches, one latent head); seq_lens [B] INCLUDING the current
// token, which is already in the cache; block table [B, MP]; out [B, H, lkv]
// bf16.
//
// Rounding, as _mla_decode_kernel takes it: one page per online-softmax step;
// the score is (q[:lkv] . ckv) + (q[lkv:] . krope), each an f32 sum of f32
// products, times sm_scale; columns past seq_len score -1e30; exp, the row
// sums and P.V stay in f32 (no bf16 rounding of p); the result is divided by
// max(l, 1e-37).
//
// Bound on an H100: the bytes of the cached rows, seq_len * (lkv + lrope) * 2
// per sequence and layer, over 3.35 TB/s. MLA is MQA at the latent level, so
// one block serves G heads of a sequence from one read of each row (the
// engine's batch is small: B * H / G blocks). Per page:
//   * scores: a warp per token, lanes over the columns (bf16 pairs, 128
//     contiguous bytes per warp), q's columns of the G heads in registers,
//     warp sums; into shared memory ([G, ps] f32);
//   * softmax: a warp per head;
//   * P.V: a thread per output column pair accumulates over the page's
//     tokens in f32, rows read as bf16 pairs.
// CUDA cores in f32, as the TPU kernel's f32 dots; no tensor cores, no split
// of the context yet. One instantiation, DeepSeek's widths: lkv 512, lrope
// even and <= 64, G = 4 heads per block (H % 4 == 0).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_once.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr int G = 4;                                // heads per block
constexpr int LKV = 512;
constexpr int NJ = LKV / 64;

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

__device__ __forceinline__ float2 bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// lane's columns: ckv pairs 2*lane + 64*j (j < NJ), krope pair 2*lane
// (masked at lrope)
__global__ void __launch_bounds__(THREADS)
decode_mla_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ckv,
                  const __nv_bfloat16* __restrict__ krope, const int* __restrict__ seq_lens,
                  const int* __restrict__ bt, __nv_bfloat16* __restrict__ out, int H,
                  int lrope, int ps, int MP, float sm_scale) {
  constexpr int lkv = LKV;
  extern __shared__ float sc[];                     // [G][ps]
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  const int hg = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = lkv + lrope;
  const int slen = min(max(seq_lens[b], 0), MP * ps);
  const int npages = (slen + ps - 1) / ps;

  float qn[G][NJ][2], qr[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qh = q + ((size_t)b * H + hg * G + g) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 v = bf16x2(qh + 2 * lane + 64 * j);
      qn[g][j][0] = v.x;
      qn[g][j][1] = v.y;
    }
    const float2 v = 2 * lane < lrope ? bf16x2(qh + lkv + 2 * lane) : make_float2(0.f, 0.f);
    qr[g][0] = v.x;
    qr[g][1] = v.y;
  }
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  const int col = 2 * tid;                          // this thread's P.V columns
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int pg = 0; pg < npages; ++pg) {
    const int page = bt[(size_t)b * MP + pg];
    const __nv_bfloat16* ck = ckv + (size_t)page * ps * lkv;
    const __nv_bfloat16* kr = krope + (size_t)page * ps * lrope;
    const int n = min(ps, slen - pg * ps);          // live tokens of the page
    __syncthreads();                                // the last page's readers are done
    for (int t = warp; t < n; t += WARPS) {
      float s1[G], s2[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s1[g] = s2[g] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 v = bf16x2(ck + (size_t)t * lkv + 2 * lane + 64 * j);
#pragma unroll
        for (int g = 0; g < G; ++g) s1[g] += qn[g][j][0] * v.x + qn[g][j][1] * v.y;
      }
      if (2 * lane < lrope) {
        const float2 v = bf16x2(kr + (size_t)t * lrope + 2 * lane);
#pragma unroll
        for (int g = 0; g < G; ++g) s2[g] += qr[g][0] * v.x + qr[g][1] * v.y;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float s = warp_sum(s1[g]) + warp_sum(s2[g]);
        if (lane == 0) sc[g * ps + t] = s * sm_scale;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += WARPS) {
      float mt = NEG;
      for (int t = lane; t < n; t += 32) mt = fmaxf(mt, sc[g * ps + t]);
      mt = warp_max(mt);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);
      float psum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(sc[g * ps + t] - m_new);
        sc[g * ps + t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + psum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();
    if (col < lkv) {
      float o[G][2];
#pragma unroll
      for (int g = 0; g < G; ++g) o[g][0] = o[g][1] = 0.f;
      for (int t = 0; t < n; ++t) {
        const float2 v = bf16x2(ck + (size_t)t * lkv + col);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sc[g * ps + t];
          o[g][0] += p * v.x;
          o[g][1] += p * v.y;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[g][0] = acc[g][0] * alpha_s[g] + o[g][0];
        acc[g][1] = acc[g][1] * alpha_s[g] + o[g][1];
      }
    }
  }
  __syncthreads();
  if (col < lkv) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float l = fmaxf(l_s[g], 1e-37f);
      __nv_bfloat162 r = __floats2bfloat162_rn(acc[g][0] / l, acc[g][1] / l);
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * H + hg * G + g) * lkv + col) = r;
    }
  }
}

}  // namespace

// lkv must be 512, lrope even and <= 64, H a multiple of 4.
extern "C" int skt_decode_mla(const void* q, const void* ckv, const void* krope,
                              const void* seq_lens, const void* bt, void* out, int B, int H,
                              int lkv, int lrope, int ps, int MP, float sm_scale,
                              void* stream) {
  if (lkv != LKV || lrope % 2 || lrope > 64 || H % G) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const size_t smem = (size_t)G * ps * sizeof(float);
  const cudaError_t e = skt::ensure_smem(decode_mla_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H / G, B);
  decode_mla_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const __nv_bfloat16*>(krope), static_cast<const int*>(seq_lens),
      static_cast<const int*>(bt), static_cast<__nv_bfloat16*>(out), H, lrope, ps, MP,
      sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_decode_mla_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
