// Device code of the paged GQA decodes K10 (decode_hm.cu: head-major bf16
// pages) and K24 (decode_v7.cu: page-major int8 pages and a bf16 sidecar).
// One block per (kv head, sequence) walks the sequence's pages with one
// online-softmax step per page (`page_step`); the contract (`Mode`) says
// where the current token is.
//
// q [B, Hq, 128] bf16; block table [B, MP] int32; out [B, Hq, 128] bf16. The
// G = Hq / Hkv query heads h*G .. h*G + G-1 share kv head h. Pages are bf16,
// or int8 rows with per-token f32 scales; their layout is two strides
// (elements between pages of one head, between heads of one page).
//
// Rounding, as the TPU kernels take it: pages past the live count skipped;
// the score is an f32 sum of f32 products, times sm_scale, columns past the
// live count -1e30; m, l (the sum of the unrounded p) and exp in f32; the P.V
// dot sums in f32; a current token kept apart folds in after the last page
// as one more step of one column; out = acc / max(l, 1e-37), rounded to bf16.
// ROUND_P picks one of two roundings:
//   false (K10, bf16 pages): p is not rounded;
//   true (K24): int8 rows enter the dot as they are (exact in bf16), the K
//     scale multiplies the score; p (int8: p times the row's V scale) is
//     rounded to bf16 before the P.V dot, the current token's p too.
// bf16 times bf16 is exact in f32, so CUDA-core FMAs give the bf16 MXU's
// products; only the order of the f32 sums differs. (K16 and K23, the
// page-major f32 contracts, run C's tensor-core loop: decode_v3.cu.)
//
// Design: a page (512 tokens of one head are 128 KB bf16) is streamed, never
// held, and the G heads read each row once:
//   * scores: a half-warp per token, 8 columns per lane (16 bytes bf16, 8
//     int8), the G heads' q columns in registers, half-warp sums; into shared
//     memory [G][ldsc];
//   * softmax: a warp per head; p (rounded for ROUND_P) replaces the score;
//   * P.V: a thread per (column pair, token slice of 4), all G heads, the V
//     rows read once; the 4 slices' sums meet in shared memory.
// Both token loops are unrolled (4 and 8) so that several rows' loads are in
// flight per thread. CUDA cores in f32; no tensor cores, no split of the
// context yet.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_once.cuh"

namespace skt_hm {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int D = 128;
constexpr int PAIRS = D / 2;                  // column pairs
constexpr int SLICES = THREADS / PAIRS;       // token slices of the P.V phase
constexpr float NEG = -1e30f;

// Where the current token is:
enum Mode {
  IN_CACHE = 0,  // K10: already in the pages; seq_lens counts it
  TWO_TIER = 3,  // K24: seq_lens counts the cached tokens; the first
                 // cached / window * window are in the int8 pages, the rest
                 // in row side_rows[b] of a bf16 sidecar [S, window,
                 // Hkv*128] (one more step), then k_new / v_new
};

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

// Read-only loads (ld.global.nc) of rows no block writes during the launch.
// 8 consecutive elements of a row as f32 (int8 and bf16 convert exactly).
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
  const __nv_bfloat16* knew;                    // TWO_TIER: [B, Hkv, 128]
  const __nv_bfloat16* vnew;
  const int* seq_lens;
  const int* bt;
  __nv_bfloat16* out;
  const __nv_bfloat16* kside;                   // TWO_TIER: [S, window, Hkv*128]
  const __nv_bfloat16* vside;
  const int* side_rows;                         // TWO_TIER: [B]
  int Hkv, ps, MP, P, window;
  long long page_stride, head_stride;           // elements of k / v
  long long spage_stride, shead_stride;         // elements of the scales
  float sm_scale;
};

// One online-softmax step of a block over n (>= 1) rows of its kv head, rows
// rs elements apart from kp / vp (int8 rows with the scales ksp / vsp).
// sc: the [G][ldsc] score buffer, red: the [SLICES][G][128] P.V sums;
// acc: the threads of slice 0 keep columns 2cp, 2cp+1 of the G heads.
template <int G, typename T, bool ROUND_P>
__device__ __forceinline__ void page_step(const T* kp, const T* vp, const float* ksp,
                                          const float* vsp, int n, long long rs,
                                          float sm_scale, const float (&qr)[G][8], float* sc,
                                          int ldsc, float* red, float* m_s, float* l_s,
                                          float* alpha_s, float (&acc)[G][2]) {
  constexpr bool INT8 = sizeof(T) == 1;
  static_assert(!INT8 || ROUND_P, "int8 rows enter the dot as they are (K24)");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l16 = lane & 15;
  const int cp = tid % PAIRS, ts = tid / PAIRS;
  __syncthreads();                                    // the last step's readers are done
#pragma unroll 4
  for (int t0 = warp * 2; t0 < n; t0 += 2 * WARPS) {
    const int t = t0 + (lane >> 4);
    float x[8];
    float s8 = 1.f;
    if (t < n) {
      load8(kp + (size_t)t * rs + 8 * l16, x);
      if (INT8) s8 = __ldg(ksp + t);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) part = fmaf(qr[g][i], x[i], part);
      const float s = half_sum(part);
      if (l16 == 0 && t < n) sc[g * ldsc + t] = (INT8 ? s * s8 : s) * sm_scale;
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += WARPS) {
    float mt = NEG;
    for (int t = lane; t < n; t += 32) mt = fmaxf(mt, sc[g * ldsc + t]);
    mt = warp_max(mt);
    const float m_old = m_s[g];
    const float m_new = fmaxf(m_old, mt);
    float psum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sc[g * ldsc + t] - m_new);
      psum += p;
      sc[g * ldsc + t] = ROUND_P ? round_bf16(INT8 ? p * __ldg(vsp + t) : p) : p;
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
    const float2 vv = load2(vp + (size_t)t * rs + 2 * cp);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = sc[g * ldsc + t];
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

template <int G, typename T, int MODE, bool ROUND_P>
__global__ void __launch_bounds__(THREADS) decode_hm_kernel(const Operands a) {
  extern __shared__ float smem[];
  const int ps = a.ps;
  const int ldsc = MODE == TWO_TIER ? max(ps, a.window) : ps;
  float* sc = smem;                                   // [G][ldsc]: scores, then p
  float* red = smem + G * ldsc;                       // [SLICES][G][D]: P.V partial sums
  __shared__ float m_s[G], l_s[G], alpha_s[G], pn_s[G];
  __shared__ float kn_s[D], vn_s[D];                  // the current token's k / v in f32
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l16 = lane & 15;
  const int Hq = a.Hkv * G;
  const T* kc = static_cast<const T*>(a.kc);
  const T* vc = static_cast<const T*>(a.vc);
  const float* ks = sizeof(T) == 1 ? a.ks : nullptr;
  const float* vs = sizeof(T) == 1 ? a.vs : nullptr;
  const int cached = max(a.seq_lens[b], 0);
  // tokens read from the pages
  const int slen = min(MODE == TWO_TIER ? cached / a.window * a.window : cached, a.MP * ps);
  const int npages = (slen + ps - 1) / ps;

  if (MODE != IN_CACHE && tid < D) {
    const size_t row = ((size_t)b * a.Hkv + h) * D;
    kn_s[tid] = __bfloat162float(a.knew[row + tid]);
    vn_s[tid] = __bfloat162float(a.vnew[row + tid]);
  }
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
    const long long so = page * a.spage_stride + h * a.shead_stride;
    page_step<G, T, ROUND_P>(kc + page * a.page_stride + h * a.head_stride,
                             vc + page * a.page_stride + h * a.head_stride,
                             ks != nullptr ? ks + so : nullptr, vs != nullptr ? vs + so : nullptr,
                             min(ps, slen - pg * ps), D, a.sm_scale, qr, sc, ldsc, red, m_s, l_s,
                             alpha_s, acc);
  }
  if (MODE == TWO_TIER) {
    const int nside = min(cached - cached / a.window * a.window, a.window);
    if (nside > 0) {
      const long long hd = (long long)a.Hkv * D;
      const long long base = (long long)a.side_rows[b] * a.window * hd + h * D;
      page_step<G, __nv_bfloat16, ROUND_P>(a.kside + base, a.vside + base, nullptr, nullptr,
                                           nside, hd, a.sm_scale, qr, sc, ldsc, red, m_s, l_s,
                                           alpha_s, acc);
    }
  }
  __syncthreads();
  if (MODE != IN_CACHE) {
    // the current token: s = q . k_new * sm_scale, one more online-softmax
    // step of one column (its p rounded to bf16 for ROUND_P)
    const float2 x = make_float2(kn_s[4 * lane], kn_s[4 * lane + 1]);
    const float2 y = make_float2(kn_s[4 * lane + 2], kn_s[4 * lane + 3]);
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
    const float2 vv = MODE != IN_CACHE ? make_float2(vn_s[2 * cp], vn_s[2 * cp + 1])
                                       : make_float2(0.f, 0.f);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a0 = acc[g][0], a1 = acc[g][1];
      if (MODE != IN_CACHE) {
        a0 = a0 * alpha_s[g] + pn_s[g] * vv.x;
        a1 = a1 * alpha_s[g] + pn_s[g] * vv.y;
      }
      const float l = fmaxf(l_s[g], 1e-37f);
      *reinterpret_cast<__nv_bfloat162*>(a.out + ((size_t)b * Hq + h * G + g) * D + 2 * cp) =
          __floats2bfloat162_rn(a0 / l, a1 / l);
    }
  }
}

template <int G, typename T, int MODE, bool ROUND_P>
cudaError_t launch(const Operands& a, int B, cudaStream_t st) {
  auto kern = decode_hm_kernel<G, T, MODE, ROUND_P>;
  const int ldsc = MODE == TWO_TIER ? (a.ps > a.window ? a.ps : a.window) : a.ps;
  const size_t smem = ((size_t)G * ldsc + (size_t)SLICES * G * D) * sizeof(float);
  const cudaError_t e = skt::ensure_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.Hkv, B), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

enum Layout { HEAD_MAJOR, PAGE_MAJOR };

// The operands every contract shares; the strides of one layer's pages.
inline Operands operands(Layout layout, const void* q, const void* kc, const void* vc,
                         const void* ks, const void* vs, const void* knew, const void* vnew,
                         const void* seq_lens, const void* bt, void* out, int Hkv, int P,
                         int ps, int MP, float sm_scale) {
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
  a.P = P;
  a.window = 1;
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
  return a;
}

// Launches one contract. D must be 128 and G = Hq / Hkv one of 1, 2, 4, 8, 16.
template <typename T, int MODE, bool ROUND_P>
int run(const Operands& a, int B, int Hq, int d, void* stream) {
  if (d != D || a.Hkv <= 0 || Hq % a.Hkv != 0 || a.ps <= 0 || a.P <= 0 || a.window <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Hq / a.Hkv) {
    case 1: return (int)launch<1, T, MODE, ROUND_P>(a, B, st);
    case 2: return (int)launch<2, T, MODE, ROUND_P>(a, B, st);
    case 4: return (int)launch<4, T, MODE, ROUND_P>(a, B, st);
    case 8: return (int)launch<8, T, MODE, ROUND_P>(a, B, st);
    case 16: return (int)launch<16, T, MODE, ROUND_P>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace skt_hm
