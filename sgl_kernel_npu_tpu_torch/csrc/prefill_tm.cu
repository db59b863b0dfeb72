// Kernel B: chunked-prefill flash attention over token-major int8 pages plus
// the in-flight bf16 chunk (deferred write: the cache is only read).
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/paged_prefill_tm.py::
// paged_prefill_attention_tm (_kernel). One launch covers every sequence of
// the prefill batch (the JAX model loops over sequences in Python).
//
// For sequence s, query token i (position prefix_len[s] + i) and query head
// hq = h*G + g, the keys are
//   * prefix positions 0 .. prefix_len[s]-1 from the int8 pages of layer li
//     (row r = t*hkv + h, scales f32 per row), all visible;
//   * chunk tokens j of the bf16 operands, visible iff j <= i and j < valid_len[s].
// Rows past valid_len still get finite outputs; the caller ignores them.
//
// Bound on an H100: the larger of its bytes (q, chunk k/v, the prefix pages it
// reads, the output) over 3.35 TB/s and its 4*hq*D*(visible pairs) operations
// over the bf16 tensor-core rate. Design: one block per (query tile, kv head,
// sequence) with 64 query rows (64/G tokens x G heads), so each key tile of 64
// tokens read into shared memory (dequantized to f32, per-row scales kept
// beside it) serves the whole group. Scores and P.V are register-tiled 8x4 and
// 8x8 per thread on the CUDA cores with an f32 online softmax, rounding
// p*v_scale to bf16 before P.V as the TPU kernel's MXU operand does. A tile
// that no row may see is never loaded, and masked columns get probability 0
// (never 0*NaN: invalid key rows are zero-filled, paged_prefill_tm.py:110-111).
// Simple first: no tensor cores or TMA yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head dim
constexpr int R = 64;         // query rows per block: (64 / G) tokens x G heads
constexpr int TK = 64;        // keys per tile
constexpr int VROW = D + 4;   // padded V row in shared memory
constexpr int THREADS = 128;

struct Smem {
  float qT[D][R];
  float kT[D][TK];
  float v[TK][VROW];
  float p[R][TK];
  float kscale[TK];
  float vscale[TK];
  int kpos[TK];               // key position (prefix) or chunk index; -1 = none
  float m[R], l[R], alpha[R];
};

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

__global__ void __launch_bounds__(THREADS)
prefill_tm_kernel(const __nv_bfloat16* __restrict__ q,    // [S, T, hq, D]
                  const __nv_bfloat16* __restrict__ ck,   // [S, T, hkv, D]
                  const __nv_bfloat16* __restrict__ cv,
                  const int8_t* __restrict__ kc,          // [L, P, ps*hkv, D]
                  const int8_t* __restrict__ vc,
                  const float* __restrict__ ksc,          // [L, P, 1, ps*hkv]
                  const float* __restrict__ vsc,
                  const int* __restrict__ bt,             // [S, MP]
                  const int* __restrict__ plen,           // [S]
                  const int* __restrict__ vlen,           // [S]
                  __nv_bfloat16* __restrict__ out,        // [S, T, hq, D]
                  int T, int hkv, int G, int P, int ps, int MP, int li,
                  float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int qtile = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * G;
  const int bq = R / G;                      // query tokens per block
  const int q0 = qtile * bq;
  // a block table maps at most MP*ps tokens: never read past it
  const int prefix_len = min(max(plen[s], 0), MP * ps);
  const int valid_len = vlen[s];
  const long long rows = (long long)ps * hkv;

  // query rows r = i*G + g, stored transposed [d][r]
  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx % R, d = idx / R;
    const int i = r / G, g = r % G;
    const int qt = q0 + i;
    float v = 0.f;
    if (qt < T) v = __bfloat162float(q[(((size_t)s * T + qt) * hq + h * G + g) * D + d]);
    sm.qT[d][r] = v;
  }
  if (tid < R) {
    sm.m[tid] = -CUDART_INF_F;
    sm.l[tid] = 0.f;
  }

  const int rg = tid >> 4;            // rows rg*8 .. rg*8+7
  const int cg = tid & 15;            // score cols cg*4 .., output cols cg*8 ..
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  // chunk keys a row of this block may see: j < min(valid_len, last query + 1)
  const int jmax = max(0, min(valid_len, min(T, q0 + bq)));
  const int n_pre = (prefix_len + TK - 1) / TK;
  const int n_tiles = n_pre + (jmax + TK - 1) / TK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool is_pre = tile < n_pre;
    __syncthreads();     // previous tile's readers are done

    // ---- load a tile of 64 keys: thread pair (c, half) copies 64 dims ----
    {
      const int c = tid >> 1, half = tid & 1, d0 = half * 64;
      int pos = -1;
      float ks = 0.f, vs = 0.f;
      if (is_pre) {
        const int t = tile * TK + c;
        if (t < prefix_len) {
          const int page = bt[(size_t)s * MP + t / ps];
          const long long row = ((long long)li * P + page) * rows
                                + (long long)(t % ps) * hkv + h;
          const int8_t* kp = kc + row * D + d0;
          const int8_t* vp = vc + row * D + d0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int4 k4 = *reinterpret_cast<const int4*>(kp + u * 16);
            const int4 v4 = *reinterpret_cast<const int4*>(vp + u * 16);
            const int8_t* k8 = reinterpret_cast<const int8_t*>(&k4);
            const int8_t* v8 = reinterpret_cast<const int8_t*>(&v4);
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              sm.kT[d0 + u * 16 + e][c] = (float)k8[e];
              sm.v[c][d0 + u * 16 + e] = (float)v8[e];
            }
          }
          pos = t;
          ks = ksc[row];
          vs = vsc[row];
        }
      } else {
        const int j = (tile - n_pre) * TK + c;
        if (j < jmax) {
          const size_t off = (((size_t)s * T + j) * hkv + h) * D + d0;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int4 k4 = *reinterpret_cast<const int4*>(ck + off + u * 8);
            const int4 v4 = *reinterpret_cast<const int4*>(cv + off + u * 8);
            const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(&k4);
            const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&v4);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              sm.kT[d0 + u * 8 + e][c] = __bfloat162float(kb[e]);
              sm.v[c][d0 + u * 8 + e] = __bfloat162float(vb[e]);
            }
          }
          pos = j;
          ks = 1.f;
          vs = 1.f;
        }
      }
      if (pos < 0) {     // no key here: zeros, so P.V never meets stale data
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          sm.kT[d0 + e][c] = 0.f;
          sm.v[c][d0 + e] = 0.f;
        }
      }
      if (half == 0) {
        sm.kpos[c] = pos;
        sm.kscale[c] = ks;
        sm.vscale[c] = vs;
      }
    }
    __syncthreads();

    // ---- scores: rows rg*8..+8 x cols cg*4..+4 ----
    {
      float sacc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 a0 = *reinterpret_cast<const float4*>(&sm.qT[d][rg * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&sm.qT[d][rg * 8 + 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&sm.kT[d][cg * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] += a[i] * bb[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rg * 8 + i;
        const int qi = q0 + r / G;           // query token index in the chunk
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg * 4 + j;
          const int pos = sm.kpos[c];
          const bool vis = pos >= 0 && (is_pre || pos <= qi);
          o[j] = vis ? sacc[i][j] * sm.kscale[c] * sm_scale : -CUDART_INF_F;
        }
        *reinterpret_cast<float4*>(&sm.p[r][cg * 4]) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // ---- online softmax: warp w owns rows w*16 .. w*16+15 ----
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const float s0 = sm.p[r][lane], s1 = sm.p[r][lane + 32];
      const float mt = warp_max(fmaxf(s0, s1));
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mt);
      float alpha = 1.f, p0 = 0.f, p1 = 0.f;
      if (m_new != -CUDART_INF_F) {
        alpha = expf(m_old - m_new);
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
      }
      const float psum = warp_sum(p0 + p1);
      sm.p[r][lane] = bf16_round(p0 * sm.vscale[lane]);
      sm.p[r][lane + 32] = bf16_round(p1 * sm.vscale[lane + 32]);
      if (lane == 0) {
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * alpha + psum;
        sm.alpha[r] = alpha;
      }
    }
    __syncthreads();

    // ---- P.V: rows rg*8..+8 x cols cg*8..+8 ----
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = sm.alpha[rg * 8 + i];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= a;
    }
#pragma unroll 4
    for (int t = 0; t < TK; ++t) {
      const float4 v0 = *reinterpret_cast<const float4*>(&sm.v[t][cg * 8]);
      const float4 v1 = *reinterpret_cast<const float4*>(&sm.v[t][cg * 8 + 4]);
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = sm.p[rg * 8 + i][t];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] += p * vv[e];
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    const int qt = q0 + r / G, g = r % G;
    if (qt >= T) continue;
    const float l = fmaxf(sm.l[r], 1e-37f);
    __nv_bfloat16* op = out + (((size_t)s * T + qt) * hq + h * G + g) * D + cg * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) op[e] = __float2bfloat16_rn(acc[i][e] / l);
  }
}

}  // namespace

extern "C" int skt_prefill_tm(const void* q, const void* ck, const void* cv,
                              const void* kc, const void* vc, const void* ksc,
                              const void* vsc, const void* bt, const void* plen,
                              const void* vlen, void* out, int S, int T, int hkv,
                              int G, int P, int ps, int MP, int li, float sm_scale,
                              void* stream) {
  if (G < 1 || R % G != 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      prefill_tm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int bq = R / G;
  const dim3 grid((T + bq - 1) / bq, hkv, S);
  prefill_tm_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ck),
      static_cast<const __nv_bfloat16*>(cv), static_cast<const int8_t*>(kc),
      static_cast<const int8_t*>(vc), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(bt),
      static_cast<const int*>(plen), static_cast<const int*>(vlen),
      static_cast<__nv_bfloat16*>(out), T, hkv, G, P, ps, MP, li, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_prefill_tm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
