// Kernel C: paged GQA decode over the read-only int8 token-major cache, with
// the current token folded in (deferred write).
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/decode_v9.py::
// decode_gqa_pallas_v9_int8_defer (_kernel_v9_int8) and its finalization
// decode_v6.py::_finalize_rows.
//
// Cache: k/v int8 [L, P, ps*hkv, D], row r = t*hkv + h; scales f32
// [L, P, 1, ps*hkv] with the same row order. Only rows t < cached are read.
// Rounding, as the TPU kernel takes it: k scales multiply the scores (s =
// (q . k) * k_scale * sm_scale), v scales the probabilities, and p * v_scale
// is rounded to bf16 before it meets V (the MXU dot there takes bf16
// operands); the online softmax steps through `step` tokens at a time (the
// TPU kernel's CHUNK_PAGES pages, or one page for decode_v8's contract), so
// p = exp(s - m) with m the running maximum at the end of the token's step;
// then the current token is folded in with its p rounded to bf16.
//
// Bound on an H100: the bytes of the cached rows it must read,
// cached*hkv*(2*D + 8) per sequence per layer, over 3.35 TB/s; at decode
// batch 8 that is a few MB, so what limits it is the latency of the walk.
// Design: each (sequence, kv head)'s cached tokens are split over S blocks
// (S from the card's co-resident blocks over B * hkv and the block table's
// width, csrc/device_once.cuh; the spans themselves from the cached length
// on the device, so nothing syncs the host and a CUDA graph replays it).
// A block of four warps walks its span in rounds of 64 tokens (16 a warp;
// 128 for scores alone) through a 3-stage cp.async ring of coalesced
// 16-byte copies (int8 rows padded to 144 bytes, so the fragment reads
// below meet no bank conflict).
// Both products run on the tensor cores as bf16 mma.sync m16n8k16 with f32
// sums; int8 values and bf16(p * v_scale) are exact in bf16, so every
// product is exact: S^T = K . q^T (16 tokens x the G <= 8 heads as n = 8; D
// is permuted alike in K and q so that each lane reads 4 bytes a row) and O^T
// = V^T . P^T (V^T's fragments gathered from 4-byte reads of the int8 rows,
// P^T through a small transpose in shared memory). To round p where the TPU
// kernel does, a block first takes the scores of every token from 0 to the
// end of its first step (and of each later step it touches) for their
// maximum, then recomputes its own tokens' scores for p: the scores are a
// sliver of the bound, and the re-read keys come from L2. Each split writes
// (m, l, acc) to a workspace and takes a ticket from its row's integer
// arrival counter; the last to arrive merges the S partials in split order,
// folds in the current token, writes the output and resets the counter to 0
// (no float atomics: a second call is bit-identical).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 128;           // head dim (the tm layout's lane width)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16 * WARPS; // tokens of a p . v round (a scores round takes 2 TILE)
constexpr int STAGES = 3;
constexpr int ROW = D + 16;      // bytes of a staged int8 row
constexpr int MAXG = 8;          // query heads per kv head (mma's n)
constexpr int PT = 24;           // bf16 row stride of a warp's p transpose
constexpr int MAX_SPLITS = 8;
constexpr float NEG = -1e30f;

// a scores round: K rows and scales of 2 TILE tokens; a p . v round: K
// rows of TILE tokens, then their V rows, and the k and v scales alike
struct Stage {
  int8_t r[2 * TILE][ROW];
  float sc[2 * TILE];
};
constexpr size_t SMEM = STAGES * sizeof(Stage) + (size_t)WARPS * MAXG * PT * 2;
constexpr int PART = 2 * MAXG + MAXG * D;   // a split's floats: m, l, acc [G][D]

struct Args {
  const __nv_bfloat16* q;     // [B, hq, D]
  const __nv_bfloat16* kn;    // [B, hkv, D]
  const __nv_bfloat16* vn;    // [B, hkv, D]
  const int8_t* kc;           // [L, P, ps*hkv, D]
  const int8_t* vc;
  const float* ksc;           // [L, P, 1, ps*hkv]
  const float* vsc;
  const int* cached;          // [B]
  const int* bt;              // [B, MP]
  __nv_bfloat16* out;         // [B, hq, D]
  float* ws;                  // [B * hkv, S, PART]
  int* arrivals;              // [B * hkv]
  int hkv, G, P, ps, MP, li, step;
  float sm_scale;
};

// The rounds of a block: for each step k it touches, the scores of the
// step's tokens (from token 0 for its first step) for their maximum, then
// p . v over its own tokens in that step.
struct Walk {
  int k, kind, t, t1;         // step, 0 scores / 1 p . v, next token, end of the range
  bool first;                 // the next round opens its range
};

__device__ __forceinline__ bool walk_next(Walk& w, int& kind, int& t0, int& t1, bool& first,
                                          int k1, int ts, int te, int step, int clen) {
  while (w.t >= w.t1) {
    if (w.kind == 0) {
      w.kind = 1;
      w.t = max(ts, w.k * step);
      w.t1 = min(te, (w.k + 1) * step);
    } else {
      if (w.k >= k1) return false;
      ++w.k;
      w.kind = 0;
      w.t = w.k * step;
      w.t1 = min(clen, (w.k + 1) * step);
    }
    w.first = true;
  }
  kind = w.kind;
  t0 = w.t;
  t1 = w.t1;
  first = w.first;
  w.first = false;
  w.t += w.kind == 0 ? 2 * TILE : TILE;
  return true;
}

// bf16x2 of two int8 values (exact), the first in the low half
__device__ __forceinline__ uint32_t i8x2(uint32_t a, int sa, uint32_t b, int sb) {
  return pack((float)(int8_t)(a >> sa), (float)(int8_t)(b >> sb));
}

// one round's loads for kv head h: scores (kind 0), K rows and k scales of
// tokens t0 .. t0 + 2 TILE - 1; p . v (kind 1), K rows and k scales of t0 ..
// t0 + TILE - 1, then their V rows and v scales. Tokens at or past t1 are
// zero-filled.
__device__ __forceinline__ void load_round(const Args& a, Stage& s, int b, int h, int t0,
                                           int t1, int kind) {
  const int tid = threadIdx.x;
  const size_t layer = (size_t)a.li * a.P;
  const int* btb = a.bt + (size_t)b * a.MP;
  const int span = kind == 0 ? 2 * TILE : TILE;   // tokens of the round
  // token t's row: page bt[t / ps], slot t % ps (shifts for a power-of-2 ps)
  const bool pow2 = (a.ps & (a.ps - 1)) == 0;
  const int shift = __ffs(a.ps) - 1;
  auto row_of = [&](int t) -> size_t {
    const int pg = pow2 ? t >> shift : t / a.ps, slot = pow2 ? t & (a.ps - 1) : t % a.ps;
    return ((layer + __ldg(btb + pg)) * a.ps + slot) * a.hkv + h;
  };
#pragma unroll
  for (int i = 0; i < 2 * TILE * 8 / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / 8, c = (e % 8) * 16;
    const int t = t0 + r % span;
    const bool ok = t < t1;
    const size_t row = ok ? row_of(t) : 0;
    cp_async16(&s.r[r][c], (r < span ? a.kc : a.vc) + row * D + c, ok);
  }
  const int t = t0 + tid % span;
  const bool ok = t < t1;
  cp_async4(&s.sc[tid], (tid < span ? a.ksc : a.vsc) + (ok ? row_of(t) : 0), ok);
}

// S^T of the 16 tokens at stage row r0: c = (token g, heads 2t, 2t+1),
// (token g + 8, the same heads), unscaled
__device__ __forceinline__ void scores(const Stage& s, int r0, int lane,
                                       const uint32_t (&qb)[D / 16][2], float (&c)[4]) {
  const int g = lane >> 2, tig = lane & 3;
  const int8_t* ra = s.r[r0 + g];
  const int8_t* rb = s.r[r0 + g + 8];
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // D permuted: logical k (2t, 2t+1, 2t+8, 2t+9) of step kk is byte 16 kk + 4t + (0..3)
    const uint32_t wa = *reinterpret_cast<const uint32_t*>(ra + 16 * kk + 4 * tig);
    const uint32_t wb = *reinterpret_cast<const uint32_t*>(rb + 16 * kk + 4 * tig);
    const uint32_t a[4] = {i8x2(wa, 0, wa, 8), i8x2(wb, 0, wb, 8), i8x2(wa, 16, wa, 24),
                           i8x2(wb, 16, wb, 24)};
    mma(c, a, qb[kk][0], qb[kk][1]);
  }
}

__global__ void __launch_bounds__(THREADS, 3)
decode_tm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stages = reinterpret_cast<Stage*>(smem);
  __nv_bfloat16* ptb = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * sizeof(Stage));
  __shared__ float wmax[WARPS][MAXG], mfin[MAXG], lred[WARPS][MAXG], scur[MAXG];
  __shared__ float wgt[MAXG][MAX_SPLITS];
  __shared__ int last;
  const int split = blockIdx.x, S = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int hq = a.hkv * a.G, row = b * a.hkv + h;
  // a block table maps at most MP*ps tokens: never read past it
  const int clen = min(max(__ldg(a.cached + b), 0), a.MP * a.ps);
  // this split's tokens: a share of the 16-token tiles of the cached ones
  const int nt = (clen + 15) / 16;
  const int ts = 16 * (int)((long long)nt * split / S);
  const int te = min(clen, 16 * (int)((long long)nt * (split + 1) / S));
  const __nv_bfloat16* qh = a.q + ((size_t)b * hq + h * a.G) * D;

  // q^T as mma's B fragments (n = head g; D permuted as in `scores`)
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bool ok = g < a.G;
    qb[kk][0] = ok ? __ldg(reinterpret_cast<const unsigned*>(qh + g * D + 16 * kk + 4 * tig)) : 0u;
    qb[kk][1] = ok ? __ldg(reinterpret_cast<const unsigned*>(qh + g * D + 16 * kk + 4 * tig + 2))
                   : 0u;
  }
  float acc[D / 16][4];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float mk[2] = {NEG, NEG}, lsum[2] = {0.f, 0.f}, mstep[2] = {NEG, NEG};
  __nv_bfloat16* pt = ptb + warp * MAXG * PT;

  if (ts < te) {
    const int k0 = ts / a.step, k1 = (te - 1) / a.step;
    Walk lw = {k0, 0, 0, min(clen, (k0 + 1) * a.step), true}, cw = lw;
    int kind, t0, t1;
    bool first;
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (walk_next(lw, kind, t0, t1, first, k1, ts, te, a.step, clen))
        load_round(a, stages[st], b, h, t0, t1, kind);
      cp_commit();
    }
    for (int i = 0; walk_next(cw, kind, t0, t1, first, k1, ts, te, a.step, clen); ++i) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      {
        int lk, l0, l1;
        bool lf;
        if (walk_next(lw, lk, l0, l1, lf, k1, ts, te, a.step, clen))
          load_round(a, stages[(i + STAGES - 1) % STAGES], b, h, l0, l1, lk);
        cp_commit();
      }
      const Stage& s = stages[i % STAGES];
      // the scores of this warp's 16 tokens (and, in a scores round, of 16
      // more TILE rows on), scaled; -inf past the range
      float sc[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half == 1 && kind == 1) break;
        const int r0 = 16 * warp + half * TILE;
        float c[4];
        scores(s, r0, lane, qb, c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1);
          sc[half][e] = t0 + r < t1 ? c[e] * s.sc[r] * a.sm_scale : -CUDART_INF_F;
        }
      }
      if (kind == 0) {
        // the step's maximum: this warp's running share, posted each round
        if (first) mstep[0] = mstep[1] = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mstep[j] = fmaxf(mstep[j], fmaxf(fmaxf(sc[0][j], sc[0][j + 2]),
                                           fmaxf(sc[1][j], sc[1][j + 2])));
        float mx[2] = {mstep[0], mstep[1]};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
        if (g == 0) {
          wmax[warp][2 * tig] = mx[0];
          wmax[warp][2 * tig + 1] = mx[1];
        }
      } else {
        if (first) {
          // the running maximum at the end of this step, and the rescale
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float mn = mk[j];
#pragma unroll
            for (int w = 0; w < WARPS; ++w) mn = fmaxf(mn, wmax[w][2 * tig + j]);
            const float alpha = expf(mk[j] - mn);
            mk[j] = mn;
            lsum[j] *= alpha;
#pragma unroll
            for (int i2 = 0; i2 < D / 16; ++i2) {
              acc[i2][j] *= alpha;
              acc[i2][j + 2] *= alpha;
            }
          }
        }
        // p, bf16(p * v_scale) into the transpose (head rows, token columns)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1), j = e & 1;
          const bool ok = t0 + 16 * warp + r < t1;
          const float p = ok ? expf(sc[0][e] - mk[j]) : 0.f;
          lsum[j] += p;
          pt[(2 * tig + j) * PT + r] = __float2bfloat16_rn(p * s.sc[TILE + 16 * warp + r]);
        }
        __syncwarp();
        const uint32_t pb0 = *reinterpret_cast<const uint32_t*>(pt + g * PT + 2 * tig);
        const uint32_t pb1 = *reinterpret_cast<const uint32_t*>(pt + g * PT + 2 * tig + 8);
        __syncwarp();
        // O^T += V^T . P^T: for u, the 4 bytes at 32 u + 4 g of a V row are
        // d rows (mt 2u: g, g + 8; mt 2u + 1: g, g + 8)
        const int8_t* v0 = s.r[TILE + 16 * warp + 2 * tig];
#pragma unroll
        for (int u = 0; u < D / 32; ++u) {
          const int off = 32 * u + 4 * g;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(v0 + off);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(v0 + ROW + off);
          const uint32_t w8 = *reinterpret_cast<const uint32_t*>(v0 + 8 * ROW + off);
          const uint32_t w9 = *reinterpret_cast<const uint32_t*>(v0 + 9 * ROW + off);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int lo = 16 * j, hi = 16 * j + 8;
            const uint32_t va[4] = {i8x2(w0, lo, w1, lo), i8x2(w0, hi, w1, hi),
                                    i8x2(w8, lo, w9, lo), i8x2(w8, hi, w9, hi)};
            mma(acc[2 * u + j], va, pb0, pb1);
          }
        }
      }
    }
    cp_wait<0>();
  }
  __syncthreads();

  // this block's (m, l, acc): the warps' shares added in warp order
  float* red = reinterpret_cast<float*>(smem);     // [WARPS][MAXG][D], over the stages
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float v = lsum[j];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (g == 0) lred[warp][2 * tig + j] = v;
  }
  if (warp == 0 && g == 0) {
    mfin[2 * tig] = mk[0];
    mfin[2 * tig + 1] = mk[1];
  }
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
    const int d = 32 * (mt / 2) + 4 * g + 2 * (mt % 2);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * MAXG + 2 * tig + (e & 1)) * D + d + (e >> 1)] = acc[mt][e];
  }
  __syncthreads();
  float o[MAXG], lt[MAXG], mt_[MAXG];
#pragma unroll
  for (int hh = 0; hh < MAXG; ++hh) {
    o[hh] = red[hh * D + tid];
    lt[hh] = lred[0][hh];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      o[hh] += red[(w * MAXG + hh) * D + tid];
      lt[hh] += lred[w][hh];
    }
    mt_[hh] = mfin[hh];
  }

  if (S > 1) {
    float* part = a.ws + ((size_t)row * S + split) * PART;
    if (tid < MAXG) {
      part[tid] = mt_[tid];
      part[MAXG + tid] = lt[tid];
    }
#pragma unroll
    for (int hh = 0; hh < MAXG; ++hh) part[2 * MAXG + hh * D + tid] = o[hh];
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.arrivals + row, 1) == S - 1;
    __syncthreads();
    if (!last) return;
    // the last split of the row merges all S in split order
    __threadfence();
    const float* base = a.ws + (size_t)row * S * PART;
    // (every load of a loop issued before its sums, which go in split order)
    if (tid < MAXG) {
      float ms[MAX_SPLITS], lp[MAX_SPLITS];
#pragma unroll
      for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
        ms[s2] = s2 < S ? __ldcg(base + s2 * PART + tid) : NEG;
        lp[s2] = s2 < S ? __ldcg(base + s2 * PART + MAXG + tid) : 0.f;
      }
      float mx = NEG;
#pragma unroll
      for (int s2 = 0; s2 < MAX_SPLITS; ++s2) mx = fmaxf(mx, ms[s2]);
      float ls = 0.f;
#pragma unroll
      for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
        if (s2 >= S) break;
        const float w = expf(ms[s2] - mx);
        wgt[tid][s2] = w;
        ls += w * lp[s2];
      }
      mfin[tid] = mx;
      lred[0][tid] = ls;
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < MAXG; ++hh) {
      float pv[MAX_SPLITS];
#pragma unroll
      for (int s2 = 0; s2 < MAX_SPLITS; ++s2)
        pv[s2] = s2 < S ? __ldcg(base + s2 * PART + 2 * MAXG + hh * D + tid) : 0.f;
      float v = 0.f;
#pragma unroll
      for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
        if (s2 >= S) break;
        v += wgt[hh][s2] * pv[s2];
      }
      o[hh] = v;
      lt[hh] = lred[0][hh];
      mt_[hh] = mfin[hh];
    }
  }

  // fold the current token in (decode_v6.py::_finalize_rows)
  const size_t cur = ((size_t)b * a.hkv + h) * D;
  for (int hh = warp; hh < a.G; hh += WARPS) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += __bfloat162float(qh[hh * D + d]) * __bfloat162float(a.kn[cur + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) scur[hh] = s * a.sm_scale;
  }
  __syncthreads();
  const float vcur = __bfloat162float(a.vn[cur + tid]);
#pragma unroll
  for (int hh = 0; hh < MAXG; ++hh) {
    if (hh >= a.G) break;
    const float s = scur[hh];
    const float mn = fmaxf(mt_[hh], s);
    const float alpha = expf(mt_[hh] - mn);
    const float p = expf(s - mn);
    const float l = lt[hh] * alpha + p;
    const float ov = o[hh] * alpha + __bfloat162float(__float2bfloat16_rn(p)) * vcur;
    a.out[((size_t)b * hq + h * a.G + hh) * D + tid] = __float2bfloat16_rn(ov / fmaxf(l, 1e-37f));
  }
  if (S > 1 && tid == 0) a.arrivals[row] = 0;     // ready for the next call
}

}  // namespace

// The number of splits S of each (sequence, kv head) that skt_decode_tm
// takes on the current device (from its co-resident blocks and the block
// table's width), or minus a CUDA error. The workspace holds B * hkv * S *
// (2 * 8 + 8 * 128) floats (none for S = 1), the arrival counters B * hkv
// ints, zero before the first call.
extern "C" int skt_decode_tm_splits(int B, int hkv, int MP, int ps) {
  if (B <= 0 || hkv <= 0 || MP <= 0 || ps <= 0) return -(int)cudaErrorInvalidValue;
  cudaError_t e = skt::ensure_smem(decode_tm_kernel, SMEM);
  if (e != cudaSuccess) return -(int)e;
  int resident = 0;
  if ((e = skt::resident_blocks(decode_tm_kernel, THREADS, SMEM, resident)) != cudaSuccess)
    return -(int)e;
  const long long tiles = ((long long)MP * ps + 15) / 16;
  return (int)std::max(1LL, std::min({(long long)resident / ((long long)B * hkv), tiles,
                                      (long long)MAX_SPLITS}));
}

// q [B, hq, D] bf16, k_new / v_new [B, hkv, D] bf16, caches int8 [L, P,
// ps*hkv, D], scales f32 [L, P, 1, ps*hkv], cached [B], block table [B, MP]
// int32, out [B, hq, D]; step_pages pages per online-softmax step; S from
// skt_decode_tm_splits, ws and arrivals as it says.
extern "C" int skt_decode_tm(const void* q, const void* kn, const void* vn,
                             const void* kc, const void* vc, const void* ksc,
                             const void* vsc, const void* cached, const void* bt,
                             void* out, void* ws, void* arrivals, int B, int hkv, int G, int P,
                             int ps, int MP, int li, int step_pages, int S, float sm_scale,
                             void* stream) {
  if (B <= 0 || hkv <= 0 || G <= 0 || G > MAXG || ps <= 0 || MP <= 0 || step_pages <= 0 ||
      S < 1 || S > MAX_SPLITS || (S > 1 && (ws == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = skt::ensure_smem(decode_tm_kernel, SMEM);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kn = static_cast<const __nv_bfloat16*>(kn);
  a.vn = static_cast<const __nv_bfloat16*>(vn);
  a.kc = static_cast<const int8_t*>(kc);
  a.vc = static_cast<const int8_t*>(vc);
  a.ksc = static_cast<const float*>(ksc);
  a.vsc = static_cast<const float*>(vsc);
  a.cached = static_cast<const int*>(cached);
  a.bt = static_cast<const int*>(bt);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = static_cast<float*>(ws);
  a.arrivals = static_cast<int*>(arrivals);
  a.hkv = hkv;
  a.G = G;
  a.P = P;
  a.ps = ps;
  a.MP = MP;
  a.li = li;
  a.step = min(step_pages, MP) * ps;
  a.sm_scale = sm_scale;
  decode_tm_kernel<<<dim3(S, hkv, B), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_decode_tm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
