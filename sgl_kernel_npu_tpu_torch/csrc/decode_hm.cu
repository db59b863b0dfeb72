// Kernels K10, K14 and K16: paged GQA decode over bf16 or int8 pages, one
// loop for every contract, each contract its own C entry point and launch
// counter.
//
// K10 replaces sgl_kernel_npu_tpu/ops/attention/decode_v2.py::
// decode_gqa_pallas_v2 (_kernel, decode_v2.py:34-94), the kernel that
// decode.py::decode_gqa runs for head dims that are multiples of 128 (the
// Qwen3-Next attention layers), and decode.py::decode_gqa_pallas
// (_gqa_decode_kernel, decode.py:101-189), the same function one page per
// grid step: head-major bf16 pages [Hkv, P, ps, 128], the current token
// already in the cache. Entry point skt_decode_hm.
//
// K16 is K10's rounding on the page-major ("hm") pages of the Llama path,
// [P, Hkv, ps, 128]:
//   decode_v3             decode_v3.py:94  decode_gqa_pallas_v3: bf16, the
//                         current token already in the cache;
//   decode_v3_int8        decode_v3.py:217 decode_gqa_pallas_v3_int8: int8
//                         rows with per-token f32 scales [P, Hkv, 1, ps];
//   decode_v3_defer       decode_v3.py:492 decode_gqa_pallas_v3_defer: bf16,
//                         the cache holds `cached` tokens, the current token's
//                         k / v [B, Hkv, 128] bf16 fold in last;
//   decode_v3_int8_defer  decode_v3.py:368 decode_gqa_pallas_v3_int8_defer;
//   decode_int8kv         decode.py:366 decode_gqa_int8kv_pallas: int8
//                         head-major pages [Hkv, P, ps, 128], scales
//                         [Hkv, P, 1, ps], the current token in the cache.
//
// K14 is the deferred contract of decode_v6.py, with bf16 products:
//   decode_v6_defer       decode_v6.py:309 decode_gqa_pallas_v6_defer
//                         (_kernel_v6, decode_v6.py:232-306): bf16 pages, the
//                         default attention of `bench.py --bf16-kv` and of
//                         the JAX engine on a bf16 cache;
//   decode_v6_int8_defer  decode_v6.py:168 decode_gqa_pallas_v6_int8_defer
//                         (_kernel_v6_int8, decode_v6.py:81-165).
// The layout is two strides (elements between pages of one head, between
// heads of one page), so one loop serves both.
//
// q [B, Hq, 128] bf16; seq_lens [B] INCLUDING the current token (or the
// cached count, clamped at 0, when it is deferred); block table [B, MP]
// int32; out [B, Hq, 128] bf16. The G = Hq / Hkv query heads h*G .. h*G + G-1
// share kv head h.
//
// Rounding, as the TPU kernels take it: one page per online-softmax step,
// pages past seq_len skipped; the score is an f32 sum of f32 products, times
// sm_scale, columns past seq_len -1e30; m, l (the sum of the unrounded p) and
// exp in f32; the P.V dot sums in f32; a deferred token folds in after the
// last page as one more step of one column (decode_v3.py::_new_token_update,
// decode_v6.py::_finalize_rows); out = acc / max(l, 1e-37), rounded to bf16.
// The two roundings differ in where int8 scales apply and whether p is
// rounded (the template flag ROUND_P):
//   K10 / K16 (ROUND_P false): an int8 row is dequantised element by element
//     as f32(k * scale) before the dot; p is not rounded;
//   K14 (ROUND_P true): int8 rows enter the dot as they are (exact in bf16),
//     the K scale multiplies the score; p (int8: p times the row's V scale)
//     is rounded to bf16 before the P.V dot, the current token's p too.
// bf16 times bf16 is exact in f32, so CUDA-core FMAs give the bf16 mma's
// products; only the order of the f32 sums differs.
//
// Bound on an H100: the bytes of the cached rows, seq_len * 2 * 128 * elt
// (+ 8 bytes of scales for int8) per (sequence, kv head), over 3.35 TB/s
// (about 0.01 ms at the Qwen bench shape: 128 sequences of about 270 tokens,
// 2 kv heads; about 0.05 ms at the Llama bench shape, 8 kv heads). Design:
// one block per (kv head, sequence), so that the G heads read each row once;
// a page (512 tokens of one head are 128 KB bf16) is streamed, never held:
//   * scores: a half-warp per token, 8 columns per lane (16 bytes bf16, 8
//     int8), the G heads' q columns in registers, half-warp sums; into shared
//     memory [G][ps];
//   * softmax: a warp per head; p (rounded for K14) replaces the score;
//   * P.V: a thread per (column pair, token slice of 4), all G heads, the V
//     rows read once; the 4 slices' sums meet in shared memory.
// Both token loops are unrolled (4 and 8) so that several rows' loads are in
// flight per thread; left to itself the compiler unrolled them differently
// in each contract. CUDA cores in f32; no tensor cores, no split of the
// context yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int D = 128;
constexpr int PAIRS = D / 2;                  // column pairs
constexpr int SLICES = THREADS / PAIRS;       // token slices of the P.V phase
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

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Read-only loads (ld.global.nc): the caches, q and the new rows are not
// written during the launch. 8 consecutive elements of a row as f32 (int8
// and bf16 convert exactly).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = (float)e[i];
}

// two consecutive elements of a row as f32
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 v = __ldg(reinterpret_cast<const char2*>(p));
  return make_float2((float)v.x, (float)v.y);
}

struct Operands {
  const __nv_bfloat16* q;
  const void* kc;
  const void* vc;
  const float* ks;                              // int8 only
  const float* vs;
  const __nv_bfloat16* knew;                    // deferred only, [B, Hkv, 128]
  const __nv_bfloat16* vnew;
  const int* seq_lens;
  const int* bt;
  __nv_bfloat16* out;
  int Hkv, ps, MP;
  long long page_stride, head_stride;           // elements of k / v
  long long spage_stride, shead_stride;         // elements of the scales
  float sm_scale;
};

template <int G, typename T, bool DEFER, bool ROUND_P>
__global__ void __launch_bounds__(THREADS) decode_hm_kernel(const Operands a) {
  constexpr bool INT8 = sizeof(T) == 1;
  extern __shared__ float smem[];
  float* sc = smem;                                   // [G][ps]: scores, then p
  float* red = smem + G * a.ps;                       // [SLICES][G][D]: P.V partial sums
  __shared__ float m_s[G], l_s[G], alpha_s[G], pn_s[G];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l16 = lane & 15;
  const int Hq = a.Hkv * G, ps = a.ps;
  const int slen = min(max(a.seq_lens[b], 0), a.MP * ps);
  const int npages = (slen + ps - 1) / ps;
  const T* kc = static_cast<const T*>(a.kc);
  const T* vc = static_cast<const T*>(a.vc);

  // this lane's columns 8*l16 .. 8*l16+7 of the G heads
  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) load8(a.q + ((size_t)b * Hq + h * G + g) * D + 8 * l16, qr[g]);
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  const int cp = tid % PAIRS, ts = tid / PAIRS;       // P.V: columns 2cp, 2cp+1; slice ts
  float acc[G][2];                                    // kept by the threads of slice 0
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int pg = 0; pg < npages; ++pg) {
    const long long page = a.bt[(size_t)b * a.MP + pg];
    const T* kp = kc + page * a.page_stride + h * a.head_stride;
    const T* vp = vc + page * a.page_stride + h * a.head_stride;
    const float* ksp = INT8 ? a.ks + page * a.spage_stride + h * a.shead_stride : nullptr;
    const float* vsp = INT8 ? a.vs + page * a.spage_stride + h * a.shead_stride : nullptr;
    const int n = min(ps, slen - pg * ps);            // live tokens of the page
    __syncthreads();                                  // the last page's readers are done
#pragma unroll 4
    for (int t0 = warp * 2; t0 < n; t0 += 2 * WARPS) {
      const int t = t0 + (lane >> 4);
      float x[8];
      float s8 = 1.f;
      if (t < n) {
        load8(kp + (size_t)t * D + 8 * l16, x);
        if (INT8) s8 = __ldg(ksp + t);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
      }
      if (INT8 && !ROUND_P) {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(x[i], s8);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) part = fmaf(qr[g][i], x[i], part);
        const float s = half_sum(part);
        if (l16 == 0 && t < n) sc[g * ps + t] = (INT8 && ROUND_P ? s * s8 : s) * a.sm_scale;
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
        psum += p;
        sc[g * ps + t] = ROUND_P ? round_bf16(INT8 ? p * __ldg(vsp + t) : p) : p;
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
    float o[G][2];
#pragma unroll
    for (int g = 0; g < G; ++g) o[g][0] = o[g][1] = 0.f;
#pragma unroll 8
    for (int t = ts; t < n; t += SLICES) {
      float2 vv = load2(vp + (size_t)t * D + 2 * cp);
      if (INT8 && !ROUND_P) {
        const float s8 = __ldg(vsp + t);
        vv = make_float2(__fmul_rn(vv.x, s8), __fmul_rn(vv.y, s8));
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sc[g * ps + t];
        o[g][0] = fmaf(p, vv.x, o[g][0]);
        o[g][1] = fmaf(p, vv.y, o[g][1]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red[(ts * G + g) * D + 2 * cp] = o[g][0];
      red[(ts * G + g) * D + 2 * cp + 1] = o[g][1];
    }
    __syncthreads();
    if (ts == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float sum = red[g * D + 2 * cp + c];
#pragma unroll
          for (int s = 1; s < SLICES; ++s) sum += red[(s * G + g) * D + 2 * cp + c];
          acc[g][c] = acc[g][c] * alpha_s[g] + sum;
        }
      }
    }
  }
  __syncthreads();
  if (DEFER) {
    // the current token: s = q . k_new * sm_scale, one more online-softmax
    // step of one column (its p rounded to bf16 for K14)
    const __nv_bfloat16* kn = a.knew + ((size_t)b * a.Hkv + h) * D;
    const float2 x = load2(kn + 4 * lane), y = load2(kn + 4 * lane + 2);
    for (int g = warp; g < G; g += WARPS) {
      const __nv_bfloat16* qh = a.q + ((size_t)b * Hq + h * G + g) * D + 4 * lane;
      const float2 qa = load2(qh), qb = load2(qh + 2);
      const float s = warp_sum(qa.x * x.x + qa.y * x.y + qb.x * y.x + qb.y * y.y) * a.sm_scale;
      if (lane == 0) {
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, s);
        const float alpha = expf(m_old - m_new);
        const float p = expf(s - m_new);
        l_s[g] = l_s[g] * alpha + p;
        alpha_s[g] = alpha;
        pn_s[g] = ROUND_P ? round_bf16(p) : p;
      }
    }
    __syncthreads();
  }
  if (ts == 0) {
    const float2 vv = DEFER ? load2(a.vnew + ((size_t)b * a.Hkv + h) * D + 2 * cp)
                            : make_float2(0.f, 0.f);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a0 = acc[g][0], a1 = acc[g][1];
      if (DEFER) {
        a0 = a0 * alpha_s[g] + pn_s[g] * vv.x;
        a1 = a1 * alpha_s[g] + pn_s[g] * vv.y;
      }
      const float l = fmaxf(l_s[g], 1e-37f);
      *reinterpret_cast<__nv_bfloat162*>(a.out + ((size_t)b * Hq + h * G + g) * D + 2 * cp) =
          __floats2bfloat162_rn(a0 / l, a1 / l);
    }
  }
}

template <int G, typename T, bool DEFER, bool ROUND_P>
cudaError_t launch(const Operands& a, int B, cudaStream_t st) {
  auto kern = decode_hm_kernel<G, T, DEFER, ROUND_P>;
  const size_t smem = ((size_t)G * a.ps + (size_t)SLICES * G * D) * sizeof(float);
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  kern<<<dim3(a.Hkv, B), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

enum Layout { HEAD_MAJOR, PAGE_MAJOR };

// Fills the operands of one contract and launches it. D must be 128 and
// G = Hq / Hkv one of 1, 2, 4, 8, 16.
template <typename T, bool DEFER, bool ROUND_P>
int run(Layout layout, const void* q, const void* kc, const void* vc, const void* ks,
        const void* vs, const void* knew, const void* vnew, const void* seq_lens,
        const void* bt, void* out, int B, int Hq, int Hkv, int d, int P, int ps, int MP,
        float sm_scale, void* stream) {
  if (d != D || Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Operands a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kc = kc;
  a.vc = vc;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.knew = static_cast<const __nv_bfloat16*>(knew);
  a.vnew = static_cast<const __nv_bfloat16*>(vnew);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.bt = static_cast<const int*>(bt);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.Hkv = Hkv;
  a.ps = ps;
  a.MP = MP;
  a.sm_scale = sm_scale;
  if (layout == HEAD_MAJOR) {                 // [Hkv, P, ps, D], scales [Hkv, P, 1, ps]
    a.page_stride = (long long)ps * D;
    a.head_stride = (long long)P * ps * D;
    a.spage_stride = ps;
    a.shead_stride = (long long)P * ps;
  } else {                                    // [P, Hkv, ps, D], scales [P, Hkv, 1, ps]
    a.page_stride = (long long)Hkv * ps * D;
    a.head_stride = (long long)ps * D;
    a.spage_stride = (long long)Hkv * ps;
    a.shead_stride = ps;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hq / Hkv) {
    case 1: return (int)launch<1, T, DEFER, ROUND_P>(a, B, st);
    case 2: return (int)launch<2, T, DEFER, ROUND_P>(a, B, st);
    case 4: return (int)launch<4, T, DEFER, ROUND_P>(a, B, st);
    case 8: return (int)launch<8, T, DEFER, ROUND_P>(a, B, st);
    case 16: return (int)launch<16, T, DEFER, ROUND_P>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Every contract has one signature: q, k cache, v cache, k scales, v scales
// (int8; else null), k_new, v_new (deferred; else null), seq_lens, block
// table, out, B, Hq, Hkv, D, P, ps, MP, sm_scale, stream.
#define SKT_HM(name, T, DEFER, ROUND_P, LAYOUT)                                                \
  extern "C" int name(const void* q, const void* kc, const void* vc, const void* ks,          \
                      const void* vs, const void* knew, const void* vnew, const void* sl,     \
                      const void* bt, void* out, int B, int Hq, int Hkv, int d, int P, int ps, \
                      int MP, float sm_scale, void* stream) {                                  \
    return run<T, DEFER, ROUND_P>(LAYOUT, q, kc, vc, ks, vs, knew, vnew, sl, bt, out, B, Hq,   \
                                  Hkv, d, P, ps, MP, sm_scale, stream);                        \
  }

SKT_HM(skt_decode_hm, __nv_bfloat16, false, false, HEAD_MAJOR)            // K10
SKT_HM(skt_decode_v3, __nv_bfloat16, false, false, PAGE_MAJOR)            // K16
SKT_HM(skt_decode_v3_int8, int8_t, false, false, PAGE_MAJOR)
SKT_HM(skt_decode_v3_defer, __nv_bfloat16, true, false, PAGE_MAJOR)
SKT_HM(skt_decode_v3_int8_defer, int8_t, true, false, PAGE_MAJOR)
SKT_HM(skt_decode_int8kv, int8_t, false, false, HEAD_MAJOR)
SKT_HM(skt_decode_v6_defer, __nv_bfloat16, true, true, PAGE_MAJOR)        // K14
SKT_HM(skt_decode_v6_int8_defer, int8_t, true, true, PAGE_MAJOR)

extern "C" const char* skt_decode_hm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
