// Kernel K10: paged GQA decode over head-major bf16 pages, all math in f32.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_v2.py::decode_gqa_pallas_v2
// (_kernel, decode_v2.py:34-94), the kernel that decode.py::decode_gqa runs
// for head dims that are multiples of 128 (the Qwen3-Next attention layers),
// and decode.py::decode_gqa_pallas (_gqa_decode_kernel, decode.py:101-189),
// the same function one page per grid step.
//
// q [B, Hq, 128] bf16; k, v caches [Hkv, P, ps, 128] bf16 (one layer);
// seq_lens [B] INCLUDING the current token, which is already in the cache;
// block table [B, MP] int32; out [B, Hq, 128] bf16. The G = Hq / Hkv query
// heads h*G .. h*G + G-1 share kv head h.
//
// Rounding, as the TPU kernel takes it: one page per online-softmax step,
// pages past seq_len skipped; the score is the f32 sum of f32 products q.k,
// times sm_scale, columns past seq_len -1e30; m, l, exp, P.V in f32 (p is not
// rounded to bf16); out = acc / max(l, 1e-37), rounded to bf16.
//
// Bound on an H100: the bytes of the cached rows, seq_len * 2 * 128 * 2 per
// (sequence, kv head), over 3.35 TB/s (about 0.01 ms at the Qwen bench shape:
// 128 sequences of about 270 tokens, 2 kv heads). Design: one block per
// (kv head, sequence), so that the G heads read each row once; per page:
//   * scores: a warp per token, 4 columns per lane (8 bytes, 256 per row),
//     the G heads' q columns in registers, warp sums; into shared memory;
//   * softmax: a warp per head;
//   * P.V: a thread per (column pair, head group) accumulates over the
//     page's tokens, rows read as bf16 pairs.
// CUDA cores in f32, as the TPU kernel's f32 dots; no tensor cores, no split
// of the context yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int D = 128;
constexpr int PAIRS = D / 2;                    // column pairs
constexpr int HGROUPS = THREADS / PAIRS;        // head groups of the P.V phase
constexpr float NEG = -1e30f;

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

template <int G>
__global__ void __launch_bounds__(THREADS)
decode_hm_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                 const __nv_bfloat16* __restrict__ vc, const int* __restrict__ seq_lens,
                 const int* __restrict__ bt, __nv_bfloat16* __restrict__ out, int Hkv,
                 int P, int ps, int MP, float sm_scale) {
  constexpr int NH = (G + HGROUPS - 1) / HGROUPS;     // heads per thread in P.V
  extern __shared__ float sc[];                       // [G][ps]
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const int slen = min(max(seq_lens[b], 0), MP * ps);
  const int npages = (slen + ps - 1) / ps;

  // lane's columns 4*lane .. 4*lane+3 of the G heads
  float qr[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qh = q + ((size_t)b * Hq + h * G + g) * D + 4 * lane;
    const float2 a = bf16x2(qh), c = bf16x2(qh + 2);
    qr[g][0] = a.x;
    qr[g][1] = a.y;
    qr[g][2] = c.x;
    qr[g][3] = c.y;
  }
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  const int cp = tid % PAIRS, hg = tid / PAIRS;       // P.V: columns 2cp, 2cp+1
  float acc[NH][2];
#pragma unroll
  for (int i = 0; i < NH; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int pg = 0; pg < npages; ++pg) {
    const size_t page = (size_t)h * P + bt[(size_t)b * MP + pg];
    const __nv_bfloat16* kp = kc + page * ps * D;
    const __nv_bfloat16* vp = vc + page * ps * D;
    const int n = min(ps, slen - pg * ps);            // live tokens of the page
    __syncthreads();                                  // the last page's readers are done
    for (int t = warp; t < n; t += WARPS) {
      const float2 a = bf16x2(kp + (size_t)t * D + 4 * lane);
      const float2 c = bf16x2(kp + (size_t)t * D + 4 * lane + 2);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float part = qr[g][0] * a.x + qr[g][1] * a.y + qr[g][2] * c.x + qr[g][3] * c.y;
        const float s = warp_sum(part);
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
    float o[NH][2];
#pragma unroll
    for (int i = 0; i < NH; ++i) o[i][0] = o[i][1] = 0.f;
    for (int t = 0; t < n; ++t) {
      const float2 vv = bf16x2(vp + (size_t)t * D + 2 * cp);
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const int g = hg + i * HGROUPS;
        if (g < G) {
          const float p = sc[g * ps + t];
          o[i][0] += p * vv.x;
          o[i][1] += p * vv.y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int g = hg + i * HGROUPS;
      if (g < G) {
        acc[i][0] = acc[i][0] * alpha_s[g] + o[i][0];
        acc[i][1] = acc[i][1] * alpha_s[g] + o[i][1];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int g = hg + i * HGROUPS;
    if (g < G) {
      const float l = fmaxf(l_s[g], 1e-37f);
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * Hq + h * G + g) * D + 2 * cp) =
          __floats2bfloat162_rn(acc[i][0] / l, acc[i][1] / l);
    }
  }
}

template <int G>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* seq_lens,
                   const void* bt, void* out, int B, int Hkv, int P, int ps, int MP,
                   float sm_scale, cudaStream_t st) {
  const size_t smem = (size_t)G * ps * sizeof(float);
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(decode_hm_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  const dim3 grid(Hkv, B);
  decode_hm_kernel<G><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(seq_lens),
      static_cast<const int*>(bt), static_cast<__nv_bfloat16*>(out), Hkv, P, ps, MP,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// D must be 128 and G = Hq / Hkv one of 1, 2, 4, 8, 16.
extern "C" int skt_decode_hm(const void* q, const void* kc, const void* vc, const void* seq_lens,
                             const void* bt, void* out, int B, int Hq, int Hkv, int d, int P,
                             int ps, int MP, float sm_scale, void* stream) {
  if (d != D || Hkv <= 0 || Hq % Hkv != 0 || ps <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hq / Hkv) {
    case 1: return (int)launch<1>(q, kc, vc, seq_lens, bt, out, B, Hkv, P, ps, MP, sm_scale, st);
    case 2: return (int)launch<2>(q, kc, vc, seq_lens, bt, out, B, Hkv, P, ps, MP, sm_scale, st);
    case 4: return (int)launch<4>(q, kc, vc, seq_lens, bt, out, B, Hkv, P, ps, MP, sm_scale, st);
    case 8: return (int)launch<8>(q, kc, vc, seq_lens, bt, out, B, Hkv, P, ps, MP, sm_scale, st);
    case 16: return (int)launch<16>(q, kc, vc, seq_lens, bt, out, B, Hkv, P, ps, MP, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* skt_decode_hm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
