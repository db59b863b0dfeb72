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
// Rows past valid_len still get what the plain version gives them.
//
// Rounding, as the TPU kernel takes it: s = (q . k) * k_scale * sm_scale
// (k_scale 1 for the chunk), an online softmax over the prefix in steps of
// one page (ps keys), then over the chunk in steps of ps keys, the P operand
// bf16(p * v_scale) (paged_prefill_tm.py:88) with p = exp(s - m) and m the
// running maximum at the end of the key's step, out = acc / max(l, 1e-37).
// Every MMA operand is bf16-exact (q and the chunk are bf16, int8 converts to
// bf16 exactly, P is rounded where the TPU kernel rounds it), so both products
// run on bf16 tensor cores (mma.sync m16n8k16, f32 accumulation) and differ
// from the plain version only in the order of the f32 sums. The steps must
// be the plain version's: a step of another size rounds bf16(p * v_scale)
// against another maximum (64-key steps over pages of 16 put a tenth of the
// outputs an ulp off, enough to turn a small engine's greedy token).
//
// Bound on an H100: the larger of its bytes (q, chunk k/v, the prefix pages it
// reads, the output) over 3.35 TB/s and its 4*hq*D*(visible pairs) operations
// over the bf16 tensor-core rate; at the engine's shapes the work is small,
// so latency, waves and barriers set the time. Design: one block per (query
// tile, kv head, sequence) with 64 query rows (64/G tokens x G heads, so one
// key tile serves the whole GQA group), 4 warps of 16 rows, q fragments in
// registers straight from global memory. Rounds of at most 64 keys, never
// across a step, stream through a ring of 3 shared-memory stages by
// cp.async, 16 bytes a copy with the page taken from the block table per
// token; round i+2 is in flight while round i is multiplied. A step of at
// most 64 keys is one round; a longer one (pages of 128) is walked twice,
// first K alone for the step's maximum, then K and V for p . v. Missing rows are zero-filled,
// so P.V never meets stale data. An int8 prefix tile lands at the start of
// each 272-byte row and is widened to bf16 in place once it has arrived; K
// then goes through ldmatrix, V through ldmatrix.trans. Scores are scaled by
// k_scale column by column and masked in registers, the softmax reduces over
// quads of lanes, and the score accumulators become the P A-fragments without
// a trip through shared memory.
// 106 KB of shared memory a block: two blocks per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 128;        // head dim
constexpr int R = 64;         // query rows per block: (64 / G) tokens x G heads
constexpr int TK = 64;        // keys per tile
constexpr int STAGES = 3;     // cp.async ring
constexpr int THREADS = 128;
constexpr int LDS = D + 8;    // bf16 per shared row: 272 bytes, conflict-free ldmatrix

struct Smem {
  __nv_bfloat16 k[STAGES][TK * LDS];
  __nv_bfloat16 v[STAGES][TK * LDS];
  float kscale[STAGES][TK];
  float vscale[STAGES][TK];
};

struct Args {
  const __nv_bfloat16* q;    // [S, T, hq, D]
  const __nv_bfloat16* ck;   // [S, T, hkv, D]
  const __nv_bfloat16* cv;
  const int8_t* kc;          // [L, P, ps*hkv, D]
  const int8_t* vc;
  const float* ksc;          // [L, P, 1, ps*hkv]
  const float* vsc;
  const int* bt;             // [S, MP]
  const int* plen;           // [S]
  const int* vlen;           // [S]
  __nv_bfloat16* out;        // [S, T, hq, D]
  int T, hkv, G, P, ps, MP, li;
  float sm_scale;
};

// Start the copies of a round into ring stage `st`: keys k0 .. k0 + n - 1
// (n <= TK) of the prefix (int8 K rows and k scales; with V, V rows and v
// scales too) or of the chunk (bf16 K rows, and V rows). Rows past n are
// zero-filled.
__device__ __forceinline__ void issue_round(Smem& sm, const Args& a, int st, bool pre, int k0,
                                            int n, bool with_v, int s, int h) {
  const int tid = threadIdx.x;
  if (pre) {
    const int c = tid & 7;                     // 16-byte chunk of a 128-byte row
    const int* bts = a.bt + (size_t)s * a.MP;
    // key t's page bt[t / ps] and slot t % ps (shifts for a power-of-2 ps)
    const bool pow2 = (a.ps & (a.ps - 1)) == 0;
    const int shift = __ffs(a.ps) - 1;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int key = i < 4 ? (tid >> 3) + 16 * i : tid & 63;
      const int t = k0 + key;
      const bool ok = key < n;
      const int pg = pow2 ? t >> shift : t / a.ps, slot = pow2 ? t & (a.ps - 1) : t % a.ps;
      const long long row =
          ok ? ((long long)a.li * a.P + __ldg(bts + pg)) * a.ps * a.hkv
                   + (long long)slot * a.hkv + h
             : 0;
      if (i < 4) {
        const long long off = row * D + c * 16;
        cp_async16(reinterpret_cast<int8_t*>(sm.k[st] + key * LDS) + c * 16, a.kc + off, ok);
        if (with_v)
          cp_async16(reinterpret_cast<int8_t*>(sm.v[st] + key * LDS) + c * 16, a.vc + off, ok);
      } else if (tid < 64 || with_v) {
        cp_async4(tid < 64 ? &sm.kscale[st][key] : &sm.vscale[st][key],
                  (tid < 64 ? a.ksc : a.vsc) + row, ok);
      }
    }
  } else {
    const int c = tid & 15;                    // 16-byte chunk of a 256-byte row
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = (tid >> 4) + 8 * i;
      const bool ok = key < n;
      const size_t off = ok ? (((size_t)s * a.T + k0 + key) * a.hkv + h) * D + c * 8 : 0;
      cp_async16(sm.k[st] + key * LDS + c * 8, a.ck + off, ok);
      if (with_v) cp_async16(sm.v[st] + key * LDS + c * 8, a.cv + off, ok);
    }
  }
}

// The rounds of a block, in the plain version's order: the prefix in steps
// of ps keys (its pages), then the chunk in steps of ps keys. A step of at
// most TK keys is one round (kind 2: scores, the step's maximum, p, p . v);
// a longer one is walked twice, first for its maximum (kind 0, K only), then
// for p . v (kind 1), TK keys a round.
struct Walk {
  int pre, a, b, kind, t;     // segment, step [a, b), kind, next key
  bool first;                 // the next round opens its step's p . v
};

__device__ __forceinline__ void walk_step(Walk& w) {
  w.kind = w.b - w.a > TK ? 0 : 2;
  w.t = w.a;
  w.first = true;
}

__device__ __forceinline__ bool walk_next(Walk& w, int ps, int prefix_len, int jmax, bool& pre,
                                          int& kind, int& k0, int& n, bool& first) {
  while (w.t >= w.b) {
    if (w.kind == 0) {                         // the maximum is known: p . v
      w.kind = 1;
      w.t = w.a;
      w.first = true;
      continue;
    }
    w.a = w.b;
    if (w.pre && w.a >= prefix_len) {
      w.pre = 0;
      w.a = 0;
    }
    const int limit = w.pre ? prefix_len : jmax;
    if (w.a >= limit) return false;
    w.b = min(w.a + ps, limit);
    walk_step(w);
  }
  pre = w.pre;
  kind = w.kind;
  k0 = w.t;
  n = min(TK, w.b - w.t);
  first = w.first && kind != 0;
  if (kind != 0) w.first = false;
  w.t += TK;
  return true;
}

// Widen an arrived int8 tile to bf16 in place: thread t takes K row t (t < 64)
// or V row t - 64, reads its 128 bytes, then writes 256.
__device__ __forceinline__ void widen_tile(Smem& sm, int st) {
  const int tid = threadIdx.x;
  int4* row = reinterpret_cast<int4*>((tid < 64 ? sm.k[st] : sm.v[st]) + (tid & 63) * LDS);
  int4 raw[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) raw[u] = row[u];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw[u]);
    int4 lo, hi;
    lo.x = (int)pack((float)b[0], (float)b[1]);
    lo.y = (int)pack((float)b[2], (float)b[3]);
    lo.z = (int)pack((float)b[4], (float)b[5]);
    lo.w = (int)pack((float)b[6], (float)b[7]);
    hi.x = (int)pack((float)b[8], (float)b[9]);
    hi.y = (int)pack((float)b[10], (float)b[11]);
    hi.z = (int)pack((float)b[12], (float)b[13]);
    hi.w = (int)pack((float)b[14], (float)b[15]);
    row[2 * u] = lo;
    row[2 * u + 1] = hi;
  }
}

__global__ void __launch_bounds__(THREADS, 2) prefill_tm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int qtile = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int G = a.G, hq = a.hkv * G;
  const int bq = R / G;                      // query tokens per block
  const int q0 = qtile * bq;
  // a block table maps at most MP*ps tokens: never read past it
  const int prefix_len = min(max(a.plen[s], 0), a.MP * a.ps);
  const int valid_len = a.vlen[s];
  // chunk keys a row of this block may see: j < min(valid_len, last query + 1)
  const int jmax = max(0, min(valid_len, min(a.T, q0 + bq)));
  Walk lw;
  lw.pre = prefix_len > 0;
  lw.a = 0;
  lw.b = min(a.ps, lw.pre ? prefix_len : jmax);
  walk_step(lw);
  Walk cw = lw;
  bool pre, first;
  int kind, k0, n;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (walk_next(lw, a.ps, prefix_len, jmax, pre, kind, k0, n, first))
      issue_round(sm, a, i, pre, k0, n, kind != 0, s, h);
    cp_commit();
  }

  // this thread's rows r = warp*16 + g (+ 8): token q0 + r / G, head h*G + r % G
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  const int qi_lo = q0 + r_lo / G, qi_hi = q0 + r_hi / G;
  unsigned qa[D / 16][4];
  {
    const unsigned* pl = reinterpret_cast<const unsigned*>(
        a.q + (((size_t)s * a.T + min(qi_lo, a.T - 1)) * hq + h * G + r_lo % G) * D);
    const unsigned* ph = reinterpret_cast<const unsigned*>(
        a.q + (((size_t)s * a.T + min(qi_hi, a.T - 1)) * hq + h * G + r_hi % G) * D);
    const bool in_lo = qi_lo < a.T, in_hi = qi_hi < a.T;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = in_lo ? __ldg(pl + kk * 8 + tig) : 0u;
      qa[kk][1] = in_hi ? __ldg(ph + kk * 8 + tig) : 0u;
      qa[kk][2] = in_lo ? __ldg(pl + kk * 8 + 4 + tig) : 0u;
      qa[kk][3] = in_hi ? __ldg(ph + kk * 8 + 4 + tig) : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n2 = 0; n2 < D / 8; ++n2)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n2][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};                  // this thread's columns only; quad sum at the end
  float step_max[2] = {-CUDART_INF_F, -CUDART_INF_F};

  for (int i = 0; walk_next(cw, a.ps, prefix_len, jmax, pre, kind, k0, n, first); ++i) {
    cp_wait<STAGES - 2>();                  // this thread's copies of round i landed
    __syncthreads();                        // everyone's, and round i - 1 is consumed
    {
      bool lpre, lfirst;
      int lkind, lk0, ln;
      if (walk_next(lw, a.ps, prefix_len, jmax, lpre, lkind, lk0, ln, lfirst))
        issue_round(sm, a, (i + STAGES - 1) % STAGES, lpre, lk0, ln, lkind != 0, s, h);
      cp_commit();
    }
    const int st = i % STAGES;
    if (pre) {
      widen_tile(sm, st);
      __syncthreads();
    }
    const __nv_bfloat16* kt = sm.k[st];
    const __nv_bfloat16* vt = sm.v[st];

    float sc[TK / 8][4];
#pragma unroll
    for (int n2 = 0; n2 < TK / 8; ++n2) {
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) sc[n2][i2] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        unsigned r[4];
        ldsm_x4(r, kt + (n2 * 8 + (lane & 7)) * LDS + kk * 16 + (lane >> 3) * 8);
        mma(sc[n2], qa[kk], r[0], r[1]);
        mma(sc[n2], qa[kk + 1], r[2], r[3]);
      }
    }

    // k scale, sm_scale and the mask, column by column in registers
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n2 = 0; n2 < TK / 8; ++n2) {
      const int c = n2 * 8 + 2 * tig;
      const float2 ks = pre ? *reinterpret_cast<const float2*>(&sm.kscale[st][c])
                            : make_float2(1.f, 1.f);
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) {
        const int key = c + (i2 & 1);
        const bool vis = key < n && (pre || k0 + key <= ((i2 >> 1) ? qi_hi : qi_lo));
        sc[n2][i2] = vis ? (pre ? sc[n2][i2] * ((i2 & 1) ? ks.y : ks.x) * a.sm_scale
                                : sc[n2][i2] * a.sm_scale)
                         : -CUDART_INF_F;
        mx[i2 >> 1] = fmaxf(mx[i2 >> 1], sc[n2][i2]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {            // each row lives in the four lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (kind == 0) {                         // a long step's maximum, round by round
      step_max[0] = fmaxf(step_max[0], mx[0]);
      step_max[1] = fmaxf(step_max[1], mx[1]);
      continue;
    }

    // the step opens: its maximum joins the running one, o and l rescale
    if (first) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], kind == 2 ? mx[r] : step_max[r]);
        const float alpha = mn == -CUDART_INF_F ? 1.f : expf(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha;
        step_max[r] = -CUDART_INF_F;
#pragma unroll
        for (int n2 = 0; n2 < D / 8; ++n2) {
          o[n2][2 * r] *= alpha;
          o[n2][2 * r + 1] *= alpha;
        }
      }
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n2 = 0; n2 < TK / 8; ++n2)
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) {
        const float mr = m[i2 >> 1];
        sc[n2][i2] = mr == -CUDART_INF_F ? 0.f : expf(sc[n2][i2] - mr);
        ps[i2 >> 1] += sc[n2][i2];
      }
    l[0] += ps[0];
    l[1] += ps[1];
    if (pre) {                               // P operand: bf16(p * v_scale)
#pragma unroll
      for (int n2 = 0; n2 < TK / 8; ++n2) {
        const float2 vs = *reinterpret_cast<const float2*>(&sm.vscale[st][n2 * 8 + 2 * tig]);
        sc[n2][0] *= vs.x;
        sc[n2][1] *= vs.y;
        sc[n2][2] *= vs.x;
        sc[n2][3] *= vs.y;
      }
    }

    // o += P . V, the score accumulators repacked as A fragments
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const unsigned pa[4] = {pack(sc[2 * kk][0], sc[2 * kk][1]),
                              pack(sc[2 * kk][2], sc[2 * kk][3]),
                              pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < D / 8; n2 += 2) {
        unsigned r[4];
        const int mi = lane >> 3;
        ldsm_x4_t(r, vt + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LDS + n2 * 8 + (mi >> 1) * 8);
        mma(o[n2], pa, r[0], r[1]);
        mma(o[n2 + 1], pa, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = r ? r_hi : r_lo;
    const int qt = q0 + rr / G;
    if (qt >= a.T) continue;
    const float lr = fmaxf(l[r], 1e-37f);
    __nv_bfloat16* op = a.out + (((size_t)s * a.T + qt) * hq + h * G + rr % G) * D + 2 * tig;
#pragma unroll
    for (int n2 = 0; n2 < D / 8; ++n2)
      *reinterpret_cast<__nv_bfloat162*>(op + n2 * 8) =
          __floats2bfloat162_rn(o[n2][2 * r] / lr, o[n2][2 * r + 1] / lr);
  }
}

}  // namespace

extern "C" int skt_prefill_tm(const void* q, const void* ck, const void* cv,
                              const void* kc, const void* vc, const void* ksc,
                              const void* vsc, const void* bt, const void* plen,
                              const void* vlen, void* out, int S, int T, int hkv,
                              int G, int P, int ps, int MP, int li, float sm_scale,
                              void* stream) {
  if (G < 1 || R % G != 0 || S <= 0 || T <= 0 || hkv <= 0 || ps <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  const cudaError_t e = skt::ensure_smem(prefill_tm_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.ck = static_cast<const __nv_bfloat16*>(ck);
  a.cv = static_cast<const __nv_bfloat16*>(cv);
  a.kc = static_cast<const int8_t*>(kc);
  a.vc = static_cast<const int8_t*>(vc);
  a.ksc = static_cast<const float*>(ksc);
  a.vsc = static_cast<const float*>(vsc);
  a.bt = static_cast<const int*>(bt);
  a.plen = static_cast<const int*>(plen);
  a.vlen = static_cast<const int*>(vlen);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.T = T;
  a.hkv = hkv;
  a.G = G;
  a.P = P;
  a.ps = ps;
  a.MP = MP;
  a.li = li;
  a.sm_scale = sm_scale;
  const int bq = R / G;
  const dim3 grid((T + bq - 1) / bq, hkv, S);
  prefill_tm_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_prefill_tm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
