// The paged GQA decode that kernels C (decode_tm.cu, token-major int8
// pages), K3 (decode_tm2.cu, head-major int8 pages), K14 (decode_v6.cu,
// page-major bf16 or int8 pages, which are head-major pages at L = 1), K16 /
// K23 (decode_v3.cu: the same pages, stacked caches at a layer read on the
// device, and kv-head-major [Hkv, P, ps, D] pages), K10 (decode_hm.cu:
// kv-head-major bf16 pages, at head dim 128 or 256) and K24 (decode_v7.cu:
// page-major int8 pages and a bf16 sidecar window) instantiate:
// online-softmax steps of `step` tokens, rounded where the TPU kernels
// round. The page layout is a template parameter (`Layout::row`: the cache
// row, and scale, of a page slot), and so are the element type (int8 rows
// with per-token f32 scales, or bf16 rows without), the rounding of p
// (`Round`) and where the current token is (`Mode`: folded in last, already
// in the cache, or written by the launch, then folded in). More than MAXG
// query heads a kv head run as `ng` groups of G heads, one block each, over
// the same rows.
//
// Rounding, P_BF16 (C, K3, K14), as their TPU kernels take it: k scales
// multiply the scores (s = (q . k) * k_scale * sm_scale), v scales the
// probabilities, and p * v_scale is rounded to bf16 before it meets V (the
// MXU dot there takes bf16 operands); the online softmax steps through
// `step` tokens at a time, so p = exp(s - m) with m the running maximum at
// the end of the token's step; then the current token is folded in with its
// p rounded to bf16. P_F32 (K16, K23), whose TPU kernels work in f32: the
// same score, p = exp(s - m) unrounded, p * v_scale rounded once in f32 and
// split into three bf16 parts hi + mid + lo that sum to it exactly (three
// MMAs a 16-token slice); each slice's three products run into a zeroed
// accumulator whose sum is added to the output in f32 (the tensor cores'
// own accumulation truncates); l sums the unrounded p, and the current token
// folds in with its p unrounded. That differs from the f32 version only in
// the order of the f32 sums. As p is not rounded, a split needs no running
// maximum from the tokens before it: it starts at its own first step. K24
// (TWO_TIER) is P_BF16 with one more step after the pages: the sidecar's
// bf16 rows, folded in by the block that writes the output.
//
// Bound on an H100: the bytes of the cached rows it must read,
// cached*hkv*(2*D + 8) per sequence per layer (int8; 4*D for bf16), over
// 3.35 TB/s.
// Design: C splits each (sequence, kv head)'s cached tokens over S blocks
// (S from the card's co-resident blocks over B * hkv and the block table's
// width; the spans themselves from the cached length on the device, so
// nothing syncs the host and a CUDA graph replays it); K3 runs one block a
// (sequence, kv head), S = 1; K10, K14, K16, K23 and K24 split where the
// card has room, on step (page) boundaries. A block of four warps walks its
// span in rounds through a cp.async ring (3 stages; K24 2, so that 4 blocks
// an SM fit: NST) of coalesced 16-byte copies (K10 and K24 read the block
// table once a round: PAGE_ONCE; rows padded by 16 bytes, 144 for int8 and
// 272 for bf16, so the fragment reads
// below meet no bank conflict; TMA boxes into swizzled rows were no faster:
// PERF.md); a stage holds 16 KB of rows, 128 int8 or 64 bf16 ones. Both
// products run on the tensor cores as bf16 mma.sync m16n8k16 with f32 sums;
// int8 and bf16 values and bf16(p * v_scale) (or its three parts) are exact
// in bf16, so every product is exact: S^T = K . q^T (16 tokens x the G <= 8
// heads as n = 8; for int8 rows D is permuted alike in K and q so that each
// lane reads 4 bytes a row) and O^T = V^T . P^T (V^T's fragments gathered
// from 4-byte reads of the rows, paired by byte permutes, P^T through a
// small transpose in shared memory; int8 widened to bf16 by byte permutes
// and one f32 subtraction, off the slow conversion pipe). To round p where
// the TPU kernel does (P_BF16), a block first takes the scores of every
// token from 0 to the end of its first step (and of each later step it
// touches) for their maximum, in scores rounds. Then, with KEEP off (C:
// steps of several pages), it recomputes its own tokens' scores for p in
// rounds of 64 tokens that load K and V (the re-read keys come from L2);
// with KEEP on (K3, K14, K16, K23: steps of one page), the scores of the
// step are kept in shared memory (G x (step + 4) f32) as they are taken, and
// the p . v rounds load V rows alone, so each key of a split's own steps
// leaves the cache once. Where S > 1, each split writes (m, l, acc) to a
// workspace and takes a ticket from its row's integer arrival counter; the
// last to arrive merges the S partials in split order, folds in the current
// token, writes the output and resets the counter to 0 (no float atomics: a
// second call is bit-identical).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 128;           // head dim of every contract but K10's D 256 (HD below)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16 * WARPS; // tokens of a p . v round with K and V (int8, KEEP off)
constexpr int STAGES = 3;        // the ring's depth, unless a kernel picks its own (NST)
constexpr int MAXG = 8;          // query heads of a block (mma's n)
constexpr int PT = 24;           // bf16 row stride of a warp's p transpose
constexpr int MAX_SPLITS = 8;
constexpr int SPAD = 4;          // floats past a kept score row (heads 2t, 2t+2 on other banks)
constexpr float NEG = -1e30f;
constexpr float INV127 = (float)(1.0 / 127.0);

// how p meets V (the header above): rounded to bf16, or three exact parts
enum Round { P_BF16 = 0, P_F32 = 1 };
// where the current token is. DEFER: k_new / v_new [B, hkv, D] bf16 fold in
// last, `cached` counts the cached tokens (clamped at 0). IN_CACHE: the
// pages hold it and `cached` counts it. FUSED: `cached` counts it; the
// launch writes it at slots[b] (int8: quantised per (token, head) as the
// int8 scatter reshape_and_cache_gqa_page_major_int8 does), reads the pages
// before it and folds it in from shared memory (int8: the dequantised row).
// TWO_TIER (K24, P_BF16): `cached` counts the cached tokens; the pages hold
// the first cached / W * W of them, row side_rows[b] of a bf16 sidecar [*,
// W, hkv * D] the rest (fold_sidecar: one more step, p rounded to bf16), then
// k_new / v_new fold in as DEFER's do.
enum Mode { DEFER = 0, IN_CACHE = 1, FUSED = 2, TWO_TIER = 3 };

// The rows of element type T (int8, or bf16 with no scales): a stage holds
// RS of them, 16 KB; a scores round (and, with KEEP, a p . v round) takes RS
// tokens, HALVES 16-token tiles a warp.
template <typename T, int HD = D>
struct Rows {
  static constexpr bool I8 = sizeof(T) == 1;
  static constexpr int HALVES = I8 ? 2 : 1;
  static constexpr int RS = HALVES * TILE;
  static constexpr int ROWB = HD * (int)sizeof(T) + 16;   // bytes of a staged row
  static constexpr int CPR = HD * (int)sizeof(T) / 16;    // 16-byte copies a row
};

// a scores round: K rows and scales of RS tokens; a p . v round (int8 with
// KEEP off): K rows of TILE tokens, then their V rows, and the k and v
// scales alike; with KEEP: the V rows and v scales of RS tokens
template <typename T, int HD = D>
struct Stage {
  int8_t r[Rows<T, HD>::RS][Rows<T, HD>::ROWB];
  float sc[Rows<T, HD>::RS];
};
constexpr int PART = 2 * MAXG + MAXG * D;   // a split's floats: m, l, acc [G][D]
static_assert(WARPS * MAXG * D * sizeof(float) <= 2 * sizeof(Stage<__nv_bfloat16>) &&
                  WARPS * MAXG * 256 * sizeof(float) <= 2 * sizeof(Stage<__nv_bfloat16, 256>),
              "a block's sums fit over a ring of 2 stages");

// the dynamic shared memory of a launch with G heads and steps of `step`:
// the ring of `stages` and the p transposes (`parts` of them a warp: 3 for
// P_F32); KEEP adds the kept scores after them
template <typename T = int8_t, int HD = D>
__host__ __device__ constexpr size_t smem_bytes(bool keep, int G, int step, int parts = 1,
                                                int stages = STAGES) {
  return stages * sizeof(Stage<T, HD>) + (size_t)WARPS * parts * MAXG * PT * 2 +
         (keep ? (size_t)G * (step + SPAD) * sizeof(float) : 0);
}

// token-major pages (C): k/v [L, P, ps*hkv, D], row t*hkv + h of a page;
// scales [L, P, 1, ps*hkv] in the same order
// (lp: page p of layer l as l * P + p)
struct TokenMajor {
  static __device__ __forceinline__ size_t row(size_t lp, int slot, int h, int ps, int hkv,
                                               int) {
    return (lp * ps + slot) * hkv + h;
  }
};
// head-major pages (K3, K23's stacked caches; K14's and K16's page-major
// [P, hkv, ps, D] at L = 1): k/v [L, P, hkv, ps, D], head h's tokens of a
// page one contiguous [ps, D] block; scales [L, P, hkv, ps]
struct HeadMajor {
  static __device__ __forceinline__ size_t row(size_t lp, int slot, int h, int ps, int hkv,
                                               int) {
    return (lp * hkv + h) * ps + slot;
  }
};
// kv-head-major pages (K16's decode_int8kv, one layer): k/v [hkv, P, ps,
// D], each head's pages one after another; scales [hkv, P, ps]
struct KvHeadMajor {
  static __device__ __forceinline__ size_t row(size_t lp, int slot, int h, int ps, int,
                                               int P) {
    return ((size_t)h * P + lp) * ps + slot;
  }
};

struct Args {
  const __nv_bfloat16* q;     // [B, hq, D]
  const __nv_bfloat16* kn;    // [B, hkv, D]
  const __nv_bfloat16* vn;    // [B, hkv, D]
  const void* kc;             // the layout's pages (int8 or bf16 rows; FUSED writes one)
  const void* vc;
  const float* ksc;           // the layout's scales (int8 rows only)
  const float* vsc;
  const int* layer;           // a stacked cache's layer on the device, or null (li)
  const int* slots;           // FUSED: the current token's slot [B] (< 0 writes nothing)
  const int* cached;          // [B]
  const int* bt;              // [B, MP]
  __nv_bfloat16* out;         // [B, hq, D]
  float* ws;                  // [B * hkv * ng, S, PART]
  int* arrivals;              // [B * hkv * ng]
  float* kept_g;              // KEEP: a step's kept scores in device memory, [B * hkv *
                              // ng * S][G][step + SPAD], where shared memory has no room
  int hkv, G, ng, P, ps, MP, li, layers, step;   // G heads a block, ng blocks a kv head
  float sm_scale;
  const __nv_bfloat16* kside;   // TWO_TIER: the sidecars [*, window, hkv * D]
  const __nv_bfloat16* vside;
  const int* side_rows;         // TWO_TIER: sequence b's sidecar row [B]
  int window;                   // TWO_TIER: W (0 otherwise)
};

// The rounds of a block: for each step k it touches, the scores of the
// step's tokens (from token 0 for its first step) for their maximum, then
// p . v over its own tokens in that step, `pv` tokens a round.
struct Walk {
  int k, kind, t, t1;         // step, 0 scores / 1 p . v, next token, end of the range
  bool first;                 // the next round opens its range
};

__device__ __forceinline__ bool walk_next(Walk& w, int& kind, int& t0, int& t1, bool& first,
                                          int k1, int ts, int te, int step, int clen, int sr,
                                          int pv) {
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
  w.t += w.kind == 0 ? sr : pv;
  return true;
}

// one round's loads for kv head h: scores (kind 0), K rows and k scales of
// tokens t0 .. t0 + RS - 1; p . v (kind 1), K rows and k scales of t0 ..
// t0 + TILE - 1, then their V rows and v scales (KEEP: the V rows and v
// scales of t0 .. t0 + RS - 1). Tokens at or past t1 are zero-filled.
// layer: the first page of the layer, l * P. PAGE_ONCE: a round whose
// tokens lie in one page reads the block table once, not once for every
// copy (a round that crosses a page edge reads it for every copy).
template <class Layout, bool KEEP, typename T, bool PAGE_ONCE = false, int HD = D>
__device__ __forceinline__ void load_round(const Args& a, Stage<T, HD>& s, size_t layer, int b,
                                           int h, int t0, int t1, int kind) {
  using R = Rows<T, HD>;
  static_assert(KEEP || R::I8, "a p . v round of K and V rows is int8 only");
  const int tid = threadIdx.x;
  const int* btb = a.bt + (size_t)b * a.MP;
  const int krows = kind == 0 ? R::RS : KEEP ? 0 : TILE;   // staged rows from K
  const int span = kind == 0 || KEEP ? R::RS : TILE;       // tokens of the round
  const char* kc = static_cast<const char*>(a.kc);
  const char* vc = static_cast<const char*>(a.vc);
  // token t's row: page bt[t / ps], slot t % ps (shifts for a power-of-2 ps)
  const bool pow2 = (a.ps & (a.ps - 1)) == 0;
  const int shift = __ffs(a.ps) - 1;
  auto row_of = [&](int t) -> size_t {
    const int pg = pow2 ? t >> shift : t / a.ps, slot = t - pg * a.ps;
    return Layout::row(layer + __ldg(btb + pg), slot, h, a.ps, a.hkv, a.P);
  };
  auto copy = [&](auto row_at) {
#pragma unroll
    for (int i = 0; i < R::RS * R::CPR / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / R::CPR, c = (e % R::CPR) * 16;
      const int t = t0 + r % span;
      const bool ok = t < t1;
      const size_t row = ok ? row_at(t) : 0;
      cp_async16(&s.r[r][c], (r < krows ? kc : vc) + row * (HD * sizeof(T)) + c, ok);
    }
    if (R::I8) {
      static_assert(!R::I8 || R::RS == THREADS, "a thread a scale");
      const int t = t0 + tid % span;
      const bool ok = t < t1;
      cp_async4(&s.sc[tid], (tid < krows ? a.ksc : a.vsc) + (ok ? row_at(t) : 0), ok);
    }
  };
  const int pg0 = PAGE_ONCE ? (pow2 ? t0 >> shift : t0 / a.ps) : 0;
  if (PAGE_ONCE && t0 < t1 && min(t0 + span, t1) <= (pg0 + 1) * a.ps) {
    const size_t page0 = layer + __ldg(btb + pg0);
    copy([&](int t) -> size_t {
      return Layout::row(page0, t - pg0 * a.ps, h, a.ps, a.hkv, a.P);
    });
  } else {
    copy(row_of);
  }
}

// S^T of the 16 tokens at stage row r0: c = (token g, heads 2t, 2t+1),
// (token g + 8, the same heads), unscaled
template <typename T, int HD = D>
__device__ __forceinline__ void scores(const Stage<T, HD>& s, int r0, int lane,
                                       const uint32_t (&qb)[HD / 16][2], float (&c)[4]) {
  const int g = lane >> 2, tig = lane & 3;
  const int8_t* ra = s.r[r0 + g];
  const int8_t* rb = s.r[r0 + g + 8];
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if (Rows<T, HD>::I8) {
      // D permuted: logical k (2t, 2t+1, 2t+8, 2t+9) of step kk is byte 16 kk + 4t + (0..3)
      const uint32_t wa = *reinterpret_cast<const uint32_t*>(ra + 16 * kk + 4 * tig) ^ BIAS;
      const uint32_t wb = *reinterpret_cast<const uint32_t*>(rb + 16 * kk + 4 * tig) ^ BIAS;
      const uint32_t a[4] = {i8x2(wa, 0, wa, 8), i8x2(wb, 0, wb, 8), i8x2(wa, 16, wa, 24),
                             i8x2(wb, 16, wb, 24)};
      mma(c, a, qb[kk][0], qb[kk][1]);
    } else {
      // bf16 rows in D's own order: k (2t, 2t+1) at byte 32 kk + 4t, (2t+8, 2t+9) 16 on
      const int o = 32 * kk + 4 * tig;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ra + o),
                             *reinterpret_cast<const uint32_t*>(rb + o),
                             *reinterpret_cast<const uint32_t*>(ra + o + 16),
                             *reinterpret_cast<const uint32_t*>(rb + o + 16)};
      mma(c, a, qb[kk][0], qb[kk][1]);
    }
  }
}

// acc += V^T . P^T for one m-tile of a 16-token slice: one MMA into acc
// (P_BF16); or the three parts' MMAs, the smallest first, into a zeroed
// accumulator whose sum is added to acc in f32 (P_F32)
template <int PARTS>
__device__ __forceinline__ void pv_mma(float (&acc)[4], const uint32_t (&va)[4],
                                       const uint32_t (&pb)[PARTS][2]) {
  if (PARTS == 1) {
    mma(acc, va, pb[0][0], pb[0][1]);
  } else {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = PARTS - 1; k >= 0; --k) mma(t, va, pb[k][0], pb[k][1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += t[e];
  }
}

// FUSED: the current token's k and v rows (b, h) as the cache holds them
// once written, f32 into fnew [2][D]: int8 quantised per row (scale =
// max(absmax, 1e-7) * f32(1/127), q = clamp(rint(x / scale), -128, 127),
// each step rounded on its own) and dequantised, bf16 as they are. The
// writer block also stores them at slot slots[b] of the layer. A block
// thread a column; every thread of the block takes part.
template <class Layout, typename T>
__device__ __forceinline__ void fused_row(const Args& a, size_t layer, int b, int h,
                                          bool writer, float* fnew, float (&amax)[2][WARPS]) {
  constexpr bool I8 = sizeof(T) == 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cur = ((size_t)b * a.hkv + h) * D + tid;
  const __nv_bfloat16 raw[2] = {a.kn[cur], a.vn[cur]};
  const int slot = a.slots[b];
  const bool write = writer && slot >= 0 && slot < a.P * a.ps;
  const size_t row = write ? Layout::row(layer + slot / a.ps, slot % a.ps, h, a.ps, a.hkv, a.P)
                           : 0;
  if (I8) {
    float x[2], m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      x[i] = __bfloat162float(raw[i]);
      m[i] = fabsf(x[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
      if (lane == 0) amax[i][warp] = m[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = amax[i][0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, amax[i][w]);
      const float scale = __fmul_rn(fmaxf(mx, 1e-7f), INV127);
      const int qv = max(-128, min(127, __float2int_rn(__fdiv_rn(x[i], scale))));
      fnew[i * D + tid] = __fmul_rn((float)qv, scale);
      if (write) {
        static_cast<int8_t*>(const_cast<void*>(i ? a.vc : a.kc))[row * D + tid] = (int8_t)qv;
        if (tid == 0) const_cast<float*>(i ? a.vsc : a.ksc)[row] = scale;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      fnew[i * D + tid] = __bfloat162float(raw[i]);
      if (write)
        static_cast<__nv_bfloat16*>(const_cast<void*>(i ? a.vc : a.kc))[row * D + tid] = raw[i];
    }
  }
}

// TWO_TIER: the kept score row of the sidecar step, W rounded up to whole
// rounds of bf16 rows
__host__ __device__ constexpr int side_step(int window) {
  return (window + Rows<__nv_bfloat16>::RS - 1) / Rows<__nv_bfloat16>::RS *
         Rows<__nv_bfloat16>::RS;
}

// TWO_TIER: fold the nside (>= 1) sidecar rows of sequence b, kv head h (row
// side_rows[b] of [*, W, hkv * D] bf16, head h's 128 columns) into the
// block's merged (m, l, o) as one online-softmax step, p rounded to bf16
// before P.V (decode_v6.py's _step without scales). Rounds of RS = 64 rows:
// K rows in the ring's slot 0, V rows in slot 1 (a bf16 round fits in a slot
// of either element type's ring; the last K round and the first V round are
// copied together, so at the reference's W of 64 one wait serves both); a
// warp scores its 16 rows of a round into `kept` ([G][side_step(W) + SPAD])
// and posts their maximum to wmax; q . k and p . v on mma.sync as the
// loop's bf16 rounds take them, the warps' sums added over the ring's slot 0
// (its K rows read by then) in warp order. Thread t holds column t of o and
// every head's m and l (m also in mnew[head], which the step's maximum
// replaces); every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void fold_sidecar(const Args& a, unsigned char* ring, float* kept,
                                             __nv_bfloat16* pt,
                                             const __nv_bfloat16 (&qrow)[MAXG][D], int b, int h,
                                             int nside, float (&o)[MAXG], float (&lt)[MAXG],
                                             float (&mt)[MAXG], float* mnew,
                                             float (&wmax)[WARPS][MAXG],
                                             float (&lred)[WARPS][MAXG]) {
  using R = Rows<__nv_bfloat16>;
  static_assert(WARPS * MAXG * D * sizeof(float) <= sizeof(Stage<int8_t>) &&
                    WARPS * MAXG * D * sizeof(float) <= sizeof(Stage<__nv_bfloat16>),
                "the warps' sums fit in slot 0");
  Stage<__nv_bfloat16>& ks = *reinterpret_cast<Stage<__nv_bfloat16>*>(ring);
  Stage<__nv_bfloat16>& vs = *reinterpret_cast<Stage<__nv_bfloat16>*>(ring + sizeof(Stage<T>));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int kst = side_step(a.window) + SPAD, nr = (nside + R::RS - 1) / R::RS;
  const size_t hd = (size_t)a.hkv * D;
  const size_t base = (size_t)__ldg(a.side_rows + b) * a.window * hd + (size_t)h * D;
  auto load = [&](Stage<__nv_bfloat16>& s, const __nv_bfloat16* side, int r0) {
#pragma unroll
    for (int i = 0; i < R::RS * R::CPR / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / R::CPR, c = (e % R::CPR) * 16;
      const bool ok = r0 + r < nside;
      cp_async16(&s.r[r][c],
                 reinterpret_cast<const char*>(side + base + (ok ? (r0 + r) * hd : 0)) + c, ok);
    }
  };
  // q^T as mma's B fragments in D's own order (the bf16 rows')
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bool ok = g < a.G;
    qb[kk][0] = ok ? *reinterpret_cast<const uint32_t*>(&qrow[g][16 * kk + 2 * tig]) : 0u;
    qb[kk][1] = ok ? *reinterpret_cast<const uint32_t*>(&qrow[g][16 * kk + 2 * tig + 8]) : 0u;
  }
  __syncthreads();                      // the ring's last readers are done
  for (int j = 0; j < nr; ++j) {
    load(ks, a.kside, j * R::RS);
    if (j == nr - 1) load(vs, a.vside, 0);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    float c[4];
    scores(ks, 16 * warp, lane, qb, c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = j * R::RS + 16 * warp + g + 8 * (e >> 1), hh = 2 * tig + (e & 1);
      if (hh < a.G) kept[hh * kst + t] = t < nside ? c[e] * a.sm_scale : -CUDART_INF_F;
    }
    if (j < nr - 1) __syncthreads();    // slot 0 free for the next round
  }
  // the step's maximum: each warp's share over the scores it kept (its own
  // rows, read back by the lanes that wrote them), then with the running one
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int hh = 2 * tig + j;
    float mx = -CUDART_INF_F;
    if (hh < a.G)
      for (int j2 = 0; j2 < nr; ++j2) {
        const float* kr = kept + hh * kst + j2 * R::RS + 16 * warp + g;
        mx = fmaxf(mx, fmaxf(kr[0], kr[8]));
      }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (g == 0) wmax[warp][hh] = mx;
  }
  __syncthreads();
  float mn[2], ls[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int hh = 2 * tig + j;
    mn[j] = 0.f;
    if (hh < a.G) {
      mn[j] = mnew[hh];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mn[j] = fmaxf(mn[j], wmax[w][hh]);
    }
  }
  // the step's maximum replaces mnew[head] for the final sums below (read
  // after a barrier); a thread above that reads it already replaced gets the
  // same mn, the maximum of it and the warps' shares
  if (warp == 0 && g == 0) {
    mnew[2 * tig] = mn[0];
    mnew[2 * tig + 1] = mn[1];
  }
  float acc[D / 16][4];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int j = 0; j < nr; ++j) {
    if (j > 0) {
      __syncthreads();                  // slot 1 free
      load(vs, a.vside, j * R::RS);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
    }
    // p of this warp's 16 rows, rounded to bf16, into its transpose
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), jj = e & 1, t = j * R::RS + 16 * warp + r;
      const bool ok = t < nside && 2 * tig + jj < a.G;
      const float p = ok ? expf(kept[(2 * tig + jj) * kst + t] - mn[jj]) : 0.f;
      ls[jj] += p;
      pt[(2 * tig + jj) * PT + r] = __float2bfloat16_rn(p);
    }
    __syncwarp();
    const uint32_t pb0 = *reinterpret_cast<const uint32_t*>(pt + g * PT + 2 * tig);
    const uint32_t pb1 = *reinterpret_cast<const uint32_t*>(pt + g * PT + 2 * tig + 8);
    __syncwarp();
    const int8_t* v0 = vs.r[16 * warp + 2 * tig];
    constexpr int RB = R::ROWB;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const int off = 32 * m + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(v0 + off);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(v0 + RB + off);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(v0 + 8 * RB + off);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(v0 + 9 * RB + off);
      const uint32_t va[4] = {__byte_perm(w0, w1, 0x5410), __byte_perm(w0, w1, 0x7632),
                              __byte_perm(w8, w9, 0x5410), __byte_perm(w8, w9, 0x7632)};
      mma(acc[m], va, pb0, pb1);
    }
  }
  // the warps' sums over slot 0, added in warp order
  float* red = reinterpret_cast<float*>(ring);   // [WARPS][MAXG][D]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float v = ls[j];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (g == 0) lred[warp][2 * tig + j] = v;
  }
#pragma unroll
  for (int m = 0; m < D / 16; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * MAXG + 2 * tig + (e & 1)) * D + 16 * m + 2 * g + (e >> 1)] = acc[m][e];
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < MAXG; ++hh) {
    if (hh >= a.G) break;
    float sv = red[hh * D + tid], l = lred[0][hh];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      sv += red[(w * MAXG + hh) * D + tid];
      l += lred[w][hh];
    }
    const float alpha = expf(mt[hh] - mnew[hh]);
    o[hh] = o[hh] * alpha + sv;
    lt[hh] = lt[hh] * alpha + l;
    mt[hh] = mnew[hh];
  }
}

// The body of a decode kernel (each source wraps it in its own __global__,
// so that a profile names the kernel); launched as (S, hkv * ng, B) blocks
// of THREADS with smem_bytes<T>(KEEP && !KG, G, step, PARTS, NST) of dynamic
// shared memory (TWO_TIER: step at least side_step(W)). KG: the kept scores
// are in device memory (a.kept_g), a variant of its own so that the kept
// scores of the others stay known to be shared. ROUND and MODE: the Round
// and Mode enums above (P_F32 with KEEP only; TWO_TIER with int8 pages,
// KEEP and P_BF16 only). NST: the ring's stages (at least 2); PAGE_ONCE as
// load_round takes it. HD: the head dim, D, or 256 with IN_CACHE (K10),
// where each thread holds HD / THREADS columns of the block's output.
template <class Layout, bool KEEP, typename T = int8_t, bool KG = false, int ROUND = P_BF16,
          int MODE = DEFER, int NST = STAGES, bool PAGE_ONCE = false, int HD = D>
__device__ __forceinline__ void decode_body(const Args& a) {
  using R = Rows<T, HD>;
  constexpr int CPT = HD / THREADS;                        // output columns a thread
  constexpr int PARTF = 2 * MAXG + MAXG * HD;              // a split's floats (PART at D)
  constexpr bool F32 = ROUND == P_F32;
  constexpr int PARTS = F32 ? 3 : 1;                       // p . v products a slice
  constexpr bool NEWKV = MODE == DEFER || MODE == TWO_TIER;   // k_new / v_new fold in last
  static_assert(!F32 || KEEP, "P_F32 steps through kept scores");
  static_assert(MODE != TWO_TIER || (R::I8 && KEEP && !KG && !F32),
                "TWO_TIER: int8 pages, kept scores in shared memory, p rounded to bf16");
  static_assert(NST >= 2, "a ring of at least 2 stages");
  static_assert(HD == D || (HD == 2 * D && MODE == IN_CACHE),
                "head dim D, or 2 D with the current token in the cache");
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T, HD>* stages = reinterpret_cast<Stage<T, HD>*>(smem);
  __nv_bfloat16* ptb = reinterpret_cast<__nv_bfloat16*>(smem + NST * sizeof(Stage<T, HD>));
  // KEEP: this block's [G][step + SPAD] kept scores, after the transposes
  // or in device memory (read back only by this block, after a barrier)
  float* kept = KG ? a.kept_g + ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                                 blockIdx.x) * a.G * (a.step + SPAD)
                   : reinterpret_cast<float*>(ptb + WARPS * PARTS * MAXG * PT);
  __shared__ float wmax[WARPS][MAXG], mfin[MAXG], lred[WARPS][MAXG], scur[MAXG];
  __shared__ float wgt[MAXG][MAX_SPLITS];
  // the q rows that the current token's fold and the sidecar read (HD 2 D,
  // IN_CACHE, reads neither: none, so that two blocks an SM fit)
  __shared__ __align__(16) __nv_bfloat16 qrow[MAXG][HD == D ? D : 8], newkv[2][D];
  __shared__ float fnew[MODE == FUSED ? 2 * D : 1], amax[2][WARPS];
  __shared__ int last;
  // blockIdx.y = h * ng + (this block's group of G heads of kv head h)
  const int split = blockIdx.x, S = gridDim.x, hy = blockIdx.y, h = hy / a.ng, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int hq = a.hkv * a.ng * a.G, row = b * a.hkv * a.ng + hy;
  const int kst = a.step + SPAD;                           // a kept score row
  const int pv = KEEP ? R::RS : TILE;                       // tokens of a p . v round
  // the layer's first page (a stacked cache's layer clamped to the stack,
  // as no host checks a layer that lies on the device)
  const size_t layer =
      (size_t)(a.layer != nullptr ? min(max(__ldg(a.layer), 0), a.layers - 1) : a.li) * a.P;
  // a block table maps at most MP*ps tokens: never read past it (FUSED:
  // the current token, the last of `cached`, is not read from the pages;
  // TWO_TIER: the pages hold the first cached / W * W)
  const int clen =
      MODE == TWO_TIER
          ? min(max(__ldg(a.cached + b), 0) / a.window * a.window, a.MP * a.ps)
          : min(max(__ldg(a.cached + b) - (MODE == FUSED ? 1 : 0), 0), a.MP * a.ps);
  // this split's tokens: a share of the 16-token tiles of the cached ones
  // (KEEP: of its steps, so that a split keeps the scores of whole steps)
  const int unit = KEEP ? a.step : 16;
  const int nt = (clen + unit - 1) / unit;
  const int ts = unit * (int)((long long)nt * split / S);
  const int te = min(clen, unit * (int)((long long)nt * (split + 1) / S));
  const __nv_bfloat16* qh = a.q + ((size_t)b * hq + hy * a.G) * HD;
  const size_t cur = ((size_t)b * a.hkv + h) * D;

  // the q rows and (DEFER, TWO_TIER) the current token's k and v rows that
  // the end of the block folds in, copied with the ring's first round
  if constexpr (HD == D)
    for (int c = tid; c < (a.G + (NEWKV ? 2 : 0)) * (D / 8); c += THREADS) {
      const int r = c / (D / 8), o = (c % (D / 8)) * 8;
      cp_async16(r < a.G ? &qrow[r][o] : &newkv[r - a.G][o],
                 r < a.G ? qh + r * D + o : (r == a.G ? a.kn : a.vn) + cur + o, true);
    }
  const int k0 = ts / a.step, k1 = ts < te ? (te - 1) / a.step : k0;
  // P_BF16 takes the scores from token 0 for the running maximum at the end
  // of its first step; P_F32 starts at that step
  Walk lw = {k0, 0, F32 ? k0 * a.step : 0, min(clen, (k0 + 1) * a.step), true}, cw = lw;
  if (ts < te) {
    int kind, t0, t1;
    bool first;
#pragma unroll
    for (int st = 0; st < NST - 1; ++st) {
      if (walk_next(lw, kind, t0, t1, first, k1, ts, te, a.step, clen, R::RS, pv))
        load_round<Layout, KEEP, T, PAGE_ONCE, HD>(a, stages[st], layer, b, h, t0, t1, kind);
      cp_commit();
    }
  }
  // FUSED: the slot is the current token's position, cached - 1 of the
  // table, past every split's rows (no block of the launch reads it): the
  // last split, which holds the pages before it, writes it, with the first
  // group of heads
  if constexpr (MODE == FUSED)
    fused_row<Layout, T>(a, layer, b, h, split == S - 1 && hy == h * a.ng, fnew, amax);

  // q^T as mma's B fragments (n = head g; D ordered as in `scores`)
  uint32_t qb[HD / 16][2];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bool ok = g < a.G;
    if (R::I8) {
      qb[kk][0] = ok ? __ldg(reinterpret_cast<const unsigned*>(qh + g * HD + 16 * kk + 4 * tig))
                     : 0u;
      qb[kk][1] =
          ok ? __ldg(reinterpret_cast<const unsigned*>(qh + g * HD + 16 * kk + 4 * tig + 2)) : 0u;
    } else {
      qb[kk][0] = ok ? __ldg(reinterpret_cast<const unsigned*>(qh + g * HD + 16 * kk + 2 * tig))
                     : 0u;
      qb[kk][1] =
          ok ? __ldg(reinterpret_cast<const unsigned*>(qh + g * HD + 16 * kk + 2 * tig + 8)) : 0u;
    }
  }
  float acc[HD / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float mk[2] = {NEG, NEG}, lsum[2] = {0.f, 0.f}, mstep[2] = {NEG, NEG};
  __nv_bfloat16* pt = ptb + warp * PARTS * MAXG * PT;      // this warp's PARTS transposes

  if (ts < te) {
    int kind, t0, t1;
    bool first;
    for (int i = 0; walk_next(cw, kind, t0, t1, first, k1, ts, te, a.step, clen, R::RS, pv);
         ++i) {
      cp_wait<NST - 2>();
      // every thread's copies of this round have landed, and the stage read
      // last time round is free
      __syncthreads();
      {
        int lk, l0, l1;
        bool lf;
        if (walk_next(lw, lk, l0, l1, lf, k1, ts, te, a.step, clen, R::RS, pv))
          load_round<Layout, KEEP, T, PAGE_ONCE, HD>(a, stages[(i + NST - 1) % NST], layer, b,
                                                     h, l0, l1, lk);
        cp_commit();
      }
      const Stage<T, HD>& s = stages[i % NST];
      const int kbase = cw.k * a.step;                   // the step's first token
      // the scores of this warp's 16 tokens (and, in an int8 scores round,
      // of 16 more TILE rows on), scaled; -inf past the range
      float sc[2][4];
      if (R::HALVES == 1) sc[1][0] = sc[1][1] = sc[1][2] = sc[1][3] = -CUDART_INF_F;
      if (kind == 0 || !KEEP) {
#pragma unroll
        for (int half = 0; half < R::HALVES; ++half) {
          if (half == 1 && kind == 1) break;
          const int r0 = 16 * warp + half * TILE;
          float c[4];
          scores(s, r0, lane, qb, c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + g + 8 * (e >> 1);
            const float ks = R::I8 ? c[e] * s.sc[r] : c[e];
            sc[half][e] = t0 + r < t1 ? ks * a.sm_scale : -CUDART_INF_F;
            // KEEP: the step's own tokens keep their score for the p . v rounds
            if (KEEP && t0 + r >= kbase && t0 + r < t1 && 2 * tig + (e & 1) < a.G)
              kept[(2 * tig + (e & 1)) * kst + t0 + r - kbase] = sc[half][e];
          }
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
            for (int i2 = 0; i2 < HD / 16; ++i2) {
              acc[i2][j] *= alpha;
              acc[i2][j + 2] *= alpha;
            }
          }
        }
#pragma unroll
        for (int half = 0; half < (KEEP ? R::HALVES : 1); ++half) {
          // this warp's 16 tokens: stage rows vr .. vr + 15 hold their V
          const int tr = 16 * warp + half * TILE;         // token offset in the round
          const int vr = KEEP ? tr : TILE + 16 * warp;
          // p, p * v_scale into the transposes (head rows, token columns):
          // P_BF16 its bf16 rounding, P_F32 its three bf16 parts
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e >> 1), j = e & 1, t = t0 + tr + r;
            const bool ok = t < t1;
            const float sv = !KEEP ? sc[0][e]
                             : ok && 2 * tig + j < a.G ? kept[(2 * tig + j) * kst + t - kbase]
                                                       : -CUDART_INF_F;
            const float p = ok ? expf(sv - mk[j]) : 0.f;
            lsum[j] += p;
            float x = R::I8 ? p * s.sc[vr + r] : p;
#pragma unroll
            for (int k = 0; k < PARTS; ++k) {
              const __nv_bfloat16 part = __float2bfloat16_rn(x);
              pt[(k * MAXG + 2 * tig + j) * PT + r] = part;
              x -= __bfloat162float(part);
            }
          }
          __syncwarp();
          uint32_t pb[PARTS][2];
#pragma unroll
          for (int k = 0; k < PARTS; ++k) {
            const __nv_bfloat16* pk = pt + (k * MAXG + g) * PT + 2 * tig;
            pb[k][0] = *reinterpret_cast<const uint32_t*>(pk);
            pb[k][1] = *reinterpret_cast<const uint32_t*>(pk + 8);
          }
          __syncwarp();
          // O^T += V^T . P^T over the rows of tokens 2t, 2t+1, 2t+8, 2t+9
          const int8_t* v0 = s.r[vr + 2 * tig];
          constexpr int RB = R::ROWB;
          if (R::I8) {
            // for u, the 4 bytes at 32 u + 4 g of a V row are d rows (mt 2u:
            // g, g + 8; mt 2u + 1: g, g + 8)
#pragma unroll
            for (int u = 0; u < HD / 32; ++u) {
              const int off = 32 * u + 4 * g;
              const uint32_t w0 = *reinterpret_cast<const uint32_t*>(v0 + off) ^ BIAS;
              const uint32_t w1 = *reinterpret_cast<const uint32_t*>(v0 + RB + off) ^ BIAS;
              const uint32_t w8 = *reinterpret_cast<const uint32_t*>(v0 + 8 * RB + off) ^ BIAS;
              const uint32_t w9 = *reinterpret_cast<const uint32_t*>(v0 + 9 * RB + off) ^ BIAS;
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int lo = 16 * j, hi = 16 * j + 8;
                const uint32_t va[4] = {i8x2(w0, lo, w1, lo), i8x2(w0, hi, w1, hi),
                                        i8x2(w8, lo, w9, lo), i8x2(w8, hi, w9, hi)};
                pv_mma<PARTS>(acc[2 * u + j], va, pb);
              }
            }
          } else {
            // for mt, the bf16 pair at 32 mt + 4 g of a V row is d rows g
            // (its low half, d 16 mt + 2g) and g + 8 (its high half)
#pragma unroll
            for (int mt = 0; mt < HD / 16; ++mt) {
              const int off = 32 * mt + 4 * g;
              const uint32_t w0 = *reinterpret_cast<const uint32_t*>(v0 + off);
              const uint32_t w1 = *reinterpret_cast<const uint32_t*>(v0 + RB + off);
              const uint32_t w8 = *reinterpret_cast<const uint32_t*>(v0 + 8 * RB + off);
              const uint32_t w9 = *reinterpret_cast<const uint32_t*>(v0 + 9 * RB + off);
              const uint32_t va[4] = {__byte_perm(w0, w1, 0x5410), __byte_perm(w0, w1, 0x7632),
                                      __byte_perm(w8, w9, 0x5410), __byte_perm(w8, w9, 0x7632)};
              pv_mma<PARTS>(acc[mt], va, pb);
            }
          }
        }
      }
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // this block's (m, l, acc): the warps' shares added in warp order (every
  // round was waited for, so the ring is idle)
  float* red = reinterpret_cast<float*>(smem);     // [WARPS][MAXG][HD], over the ring
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
  for (int mt = 0; mt < HD / 16; ++mt) {
    const int d = R::I8 ? 32 * (mt / 2) + 4 * g + 2 * (mt % 2) : 16 * mt + 2 * g;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * MAXG + 2 * tig + (e & 1)) * HD + d + (e >> 1)] = acc[mt][e];
  }
  __syncthreads();
  // o[c][head]: column tid + c * THREADS
  float o[CPT][MAXG], lt[MAXG], mt_[MAXG];
#pragma unroll
  for (int hh = 0; hh < MAXG; ++hh) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[c][hh] = red[hh * HD + tid + c * THREADS];
    lt[hh] = lred[0][hh];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[c][hh] += red[(w * MAXG + hh) * HD + tid + c * THREADS];
      lt[hh] += lred[w][hh];
    }
    mt_[hh] = mfin[hh];
  }

  if (S > 1) {
    float* part = a.ws + ((size_t)row * S + split) * PARTF;
    if (tid < MAXG) {
      part[tid] = mt_[tid];
      part[MAXG + tid] = lt[tid];
    }
#pragma unroll
    for (int hh = 0; hh < MAXG; ++hh)
#pragma unroll
      for (int c = 0; c < CPT; ++c) part[2 * MAXG + hh * HD + tid + c * THREADS] = o[c][hh];
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.arrivals + row, 1) == S - 1;
    __syncthreads();
    if (!last) return;
    // the last split of the row merges all S in split order
    __threadfence();
    const float* base = a.ws + (size_t)row * S * PARTF;
    // (every load of a loop issued before its sums, which go in split order)
    if (tid < MAXG) {
      float ms[MAX_SPLITS], lp[MAX_SPLITS];
#pragma unroll
      for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
        ms[s2] = s2 < S ? __ldcg(base + s2 * PARTF + tid) : NEG;
        lp[s2] = s2 < S ? __ldcg(base + s2 * PARTF + MAXG + tid) : 0.f;
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
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float pvs[MAX_SPLITS];
#pragma unroll
        for (int s2 = 0; s2 < MAX_SPLITS; ++s2)
          pvs[s2] =
              s2 < S ? __ldcg(base + s2 * PARTF + 2 * MAXG + hh * HD + tid + c * THREADS) : 0.f;
        float v = 0.f;
#pragma unroll
        for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
          if (s2 >= S) break;
          v += wgt[hh][s2] * pvs[s2];
        }
        o[c][hh] = v;
      }
      lt[hh] = lred[0][hh];
      mt_[hh] = mfin[hh];
    }
  }

  if constexpr (MODE == TWO_TIER) {
    // the sidecar's rows after the pages (the merging block, after the merge)
    const int cb = max(__ldg(a.cached + b), 0);
    const int nside = min(cb - cb / a.window * a.window, a.window);
    if (nside > 0)
      fold_sidecar<T>(a, smem, kept, pt, qrow, b, h, nside, o[0], lt, mt_, mfin, wmax, lred);
  }
  if constexpr (MODE == IN_CACHE) {
#pragma unroll
    for (int hh = 0; hh < MAXG; ++hh) {
      if (hh >= a.G) break;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        a.out[((size_t)b * hq + hy * a.G + hh) * HD + tid + c * THREADS] =
            __float2bfloat16_rn(o[c][hh] / fmaxf(lt[hh], 1e-37f));
    }
  } else {
    // fold the current token in (decode_v6.py::_finalize_rows; FUSED: the
    // row as the cache holds it)
    for (int hh = warp; hh < a.G; hh += WARPS) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s += __bfloat162float(qrow[hh][d]) *
             (MODE == FUSED ? fnew[d] : __bfloat162float(newkv[0][d]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) scur[hh] = s * a.sm_scale;
    }
    __syncthreads();
    const float vcur = MODE == FUSED ? fnew[D + tid] : __bfloat162float(newkv[1][tid]);
#pragma unroll
    for (int hh = 0; hh < MAXG; ++hh) {
      if (hh >= a.G) break;
      const float s = scur[hh];
      const float mn = fmaxf(mt_[hh], s);
      const float alpha = expf(mt_[hh] - mn);
      const float p = expf(s - mn);
      const float l = lt[hh] * alpha + p;
      const float pr = ROUND == P_F32 ? p : __bfloat162float(__float2bfloat16_rn(p));
      const float ov = o[0][hh] * alpha + pr * vcur;
      a.out[((size_t)b * hq + hy * a.G + hh) * D + tid] =
          __float2bfloat16_rn(ov / fmaxf(l, 1e-37f));
    }
  }
  if (S > 1 && tid == 0) a.arrivals[row] = 0;     // ready for the next call
}

// The number of splits S of each of the B * rows rows on the current
// device: the card's co-resident blocks of `kern` (with `smem` bytes of
// dynamic shared memory) over B * rows, at most `units` (the 16-token tiles
// of a block table's span; KEEP: its steps) and MAX_SPLITS, at least 1; or
// minus a CUDA error.
template <typename Kernel>
int splits_for(Kernel* kern, size_t smem, int B, int rows, long long units) {
  if (B <= 0 || rows <= 0 || units <= 0) return -(int)cudaErrorInvalidValue;
  cudaError_t e = skt::ensure_smem(kern, smem);
  if (e != cudaSuccess) return -(int)e;
  int resident = 0;
  if ((e = skt::resident_blocks(kern, THREADS, smem, resident)) != cudaSuccess) return -(int)e;
  return (int)std::max(1LL, std::min({(long long)resident / ((long long)B * rows), units,
                                      (long long)MAX_SPLITS}));
}

// Fill the arguments and launch `kern` on (S, hkv * ng, B) blocks of G
// heads each (element type T, rounding ROUND, a ring of NST stages):
// step_pages pages per online-softmax step (or step_tokens tokens where
// that is > 0), S from splits_for, ws and arrivals as it says (B * hkv * ng
// * S * PART floats, none for S = 1; B * hkv * ng counters, zero before the
// first call); a stacked cache's layer on the device (`layer`, of `layers`)
// or li; FUSED's slots; TWO_TIER's sidecars, their rows and W (window > 0).
template <bool KEEP, typename T = int8_t, int ROUND = P_BF16, int NST = STAGES, int HD = D,
          typename Kernel>
int launch(Kernel* kern, const void* q, const void* kn, const void* vn, const void* kc,
           const void* vc, const void* ksc, const void* vsc, const void* cached, const void* bt,
           void* out, void* ws, void* arrivals, int B, int hkv, int G, int P, int ps, int MP,
           int li, int step_pages, int S, float sm_scale, void* stream, int ng = 1,
           void* kept_g = nullptr, const void* layer = nullptr, int layers = 1,
           const void* slots = nullptr, int step_tokens = 0, const void* kside = nullptr,
           const void* vside = nullptr, const void* side_rows = nullptr, int window = 0) {
  if (B <= 0 || hkv <= 0 || G <= 0 || G > MAXG || ng < 1 || ps <= 0 || MP <= 0 ||
      step_pages <= 0 || step_tokens < 0 || S < 1 || S > MAX_SPLITS || layers < 1 ||
      (S > 1 && (ws == nullptr || arrivals == nullptr)) ||
      (sizeof(T) == 1 && (ksc == nullptr || vsc == nullptr)) || window < 0 ||
      (window > 0 && (kside == nullptr || vside == nullptr || side_rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kn = static_cast<const __nv_bfloat16*>(kn);
  a.vn = static_cast<const __nv_bfloat16*>(vn);
  a.kc = kc;
  a.vc = vc;
  a.ksc = static_cast<const float*>(ksc);
  a.vsc = static_cast<const float*>(vsc);
  a.layer = static_cast<const int*>(layer);
  a.slots = static_cast<const int*>(slots);
  a.cached = static_cast<const int*>(cached);
  a.bt = static_cast<const int*>(bt);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = static_cast<float*>(ws);
  a.arrivals = static_cast<int*>(arrivals);
  a.hkv = hkv;
  a.G = G;
  a.ng = ng;
  a.kept_g = static_cast<float*>(kept_g);
  a.P = P;
  a.ps = ps;
  a.MP = MP;
  a.li = li;
  a.layers = layers;
  a.step = step_tokens > 0 ? step_tokens : min(step_pages, MP) * ps;
  a.sm_scale = sm_scale;
  a.kside = static_cast<const __nv_bfloat16*>(kside);
  a.vside = static_cast<const __nv_bfloat16*>(vside);
  a.side_rows = static_cast<const int*>(side_rows);
  a.window = window;
  const size_t smem =
      smem_bytes<T, HD>(KEEP && kept_g == nullptr, G,
                    window > 0 ? std::max(a.step, side_step(window)) : a.step,
                    ROUND == P_F32 ? 3 : 1, NST);
  const cudaError_t e = skt::ensure_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(S, hkv * ng, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
