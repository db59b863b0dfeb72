// Kernel K5: paged MLA decode over a COMBINED latent cache (ctkv | krope in
// one row), read-only, with the current token's latent row folded in
// (deferred write).
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_mla_v2.py::
// decode_mla_pallas_v3_defer (_kernel_mla_v3, bf16 or int8 cache) and
// decode_mla_pallas_v2_defer (_kernel_mla_v2, bf16), one contract.
//
// q [B, 16, C] bf16 (ctkv-space nope | rope), new [B, C] bf16, cache
// [L, P, ps, C] int8 (with per-token scales [L, P, 1, ps] f32) or bf16,
// cached [B] tokens already cached (not counting the current one), block
// table [B, MP], out [B, 16, lkv] bf16, lkv the ctkv width.
//
// Rounding, as _kernel_mla_v3 takes it (decode_mla_v2.py:342-403): an online
// softmax over steps of cp pages; per step the score is (bf16 q . row as
// bf16) in f32, times the row's scale (int8), times sm_scale; columns past
// the cached length score -1e30; p * scale (int8) or p (bf16) is rounded to
// bf16 against the running maximum at the end of the step before P.V, which
// sums in f32; after the last step the current row folds in in f32 and the
// sum is divided by max(l, 1e-37).
//
// Bound on an H100: the bytes of the cached rows, cached * (C + 4) per
// sequence and layer for int8 (2 C for bf16), over 3.35 TB/s. MLA is MQA at
// the latent level: the 16 heads share every row, which is both K and V.
// Design: a sequence is a thread-block cluster of S CTAs of 16 warps (S 1,
// one CTA an SM at the bench path's 128 sequences, doubled up to 8 only
// while a CTA's share of a step does not fit in shared memory); each CTA
// takes 1/S of every step's 16-token tiles.
//   * Rows reach shared memory by one TMA bulk copy each (padded to 16 mod
//     128 bytes, so that the fragment reads meet no bank conflict), in
//     passes of up to `cap` rows through two buffers on mbarriers: the next
//     pass is copied while this one is scored. A share that fits is held
//     whole; otherwise the last two passes are still held for P.V and the
//     earlier ones are copied again (from L2).
//   * S^T = rows . q^T on bf16 mma.sync m16n8k16 (16 tokens x the 16 heads
//     as two n-tiles; int8 widened by byte permutes, exactly; a pass of few
//     tiles splits C over several warps, the parts added in order); the
//     scaled scores stay in shared memory.
//   * The step's maximum: each CTA posts its share's maximum per head, a
//     cluster barrier, and every CTA reads its peers' through distributed
//     shared memory, so all round p against the same maximum, as the plain
//     version does.
//   * O^T = V^T . P^T on mma.sync from the rows in shared memory (each warp
//     32 of the lkv columns); (l, acc) partials share one sequence of
//     maxima, so they add as they are.
//   * The merge: each CTA writes its sums to its shared memory, a cluster
//     barrier, and CTA r adds the S partials of heads 16 r / S .. in rank
//     order through distributed shared memory, folds in the current token
//     and writes the output. No atomics: a second call is bit-identical.
// Columns past the cached length are never read: a tile's rows past them
// are zeroed, and their P is 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "device_once.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int H = 16;                 // heads: two mma n-tiles
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;   // 16: 32 output columns each, lkv <= 512
constexpr int COLS = 32;
constexpr int MT = COLS / 16;         // a warp's 16-column m-tiles of O^T
constexpr int MAX_S = 8;              // CTAs of a cluster (the portable size)
constexpr int MAX_CAP = 16 * WARPS;   // rows of a pass: at most a 16-token tile a warp
constexpr int SMEM_CTA = 226 * 1024;  // a CTA's shared memory where an SM holds one
constexpr float NEG = -1e30f;

struct Args {
  const __nv_bfloat16* q;      // [B, H, C]
  const __nv_bfloat16* nl;     // [B, C]
  const void* cache;           // [L, P, ps, C]
  const float* scales;         // [L, P, 1, ps] (int8 only)
  const int* cached;           // [B]
  const int* bt;               // [B, MP]
  __nv_bfloat16* out;          // [B, H, lkv]
  int C, lkv, P, ps, MP, tc, li;   // tc = cp * ps tokens a step
  int share, cap, nbuf;        // most tokens of a CTA's share of a step; rows a pass; buffers
  int rowb, qsb;               // bytes of a staged row and of a q row
  int kst, pst;                // floats of a kept score row, bf16 values of a p row
  int o_nl, o_rows, o_kept, o_p, o_part, o_ridx, o_rsc;   // byte offsets (q at 0)
  float sm_scale;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The plan of a launch, into a's plan fields; returns S and the dynamic
// shared memory. S starts at 1 (one CTA a sequence: the bench path's 128
// sequences each take an SM) and doubles, at most to MAX_S and the step's
// 16-token tiles, only while a CTA's share of a step does not fit in
// SMEM_CTA. A share whose rows fit beside the rest is held whole (one
// pass); a larger one runs in passes of `cap` rows through two buffers, the
// next pass copied while the last is scored, or through one buffer where
// two do not fit.
int plan(Args& a, int elt, int& total) {
  const int tiles = (a.tc + 15) / 16;
  a.rowb = round_up(a.C * elt, 128) + 16;     // 4 mod 32 words: conflict-free fragments
  a.qsb = round_up(2 * a.C, 128) + (elt == 1 ? 32 : 16);
  for (int S = 1;; S *= 2) {
    a.share = 16 * ((tiles + S - 1) / S);
    a.kst = round_up(a.share, 32) + 4;
    a.pst = round_up(a.share, 64) + 8;
    a.o_nl = H * a.qsb;
    a.o_rows = a.o_nl + round_up(2 * a.C, 16);
    const int rest = H * a.kst * 4 + round_up(H * a.pst * 2, 16) + WARPS * 16 * H * 4 +
                     2 * a.share * 4;
    const int room = SMEM_CTA - a.o_rows - rest;
    a.nbuf = 2;
    if (a.share <= MAX_CAP && a.share * a.rowb <= room) {
      a.cap = a.share;
      a.nbuf = 1;
    } else if (32 * a.rowb <= room) {
      a.cap = std::min(MAX_CAP, room / 2 / a.rowb / 16 * 16);
    } else {
      a.cap = std::min(MAX_CAP, std::max(16, room / a.rowb / 16 * 16));
      a.nbuf = 1;
    }
    a.o_kept = a.o_rows + round_up(std::max(a.nbuf * a.cap * a.rowb, H * a.lkv * 4), 16);
    a.o_p = a.o_kept + H * a.kst * 4;
    a.o_part = a.o_p + round_up(H * a.pst * 2, 16);
    a.o_ridx = a.o_part + WARPS * 16 * H * 4;
    a.o_rsc = a.o_ridx + a.share * 4;
    total = a.o_rsc + a.share * 4;
    if (total <= SMEM_CTA || 2 * S > std::min(MAX_S, tiles)) return S;
  }
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

// The rows of a pass (share tokens p0 .. p0 + len, len > 0) into buffer
// `rows` by one bulk copy each, completed on `full`: warp w's lanes 0-15
// take the rows of its tile w; a tile's rows past the pass are zeroed. With
// `index`, each row's cache row (and int8 scale) is first written at ridx
// and rsc, from the step's first token t0.
template <typename T>
__device__ __forceinline__ void issue_pass(const Args& a, int8_t* rows, uint64_t* full,
                                           int* ridx, float* rsc, int p0, int len, bool index,
                                           int b, int t0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t rb = (uint32_t)a.C * sizeof(T);                 // bytes of a cache row
  if (threadIdx.x == 0) mbar_expect_tx(full, (uint32_t)len * rb);
  const int r = 16 * warp + lane;
  if (lane >= 16 || 16 * warp >= len) return;
  int8_t* dst = rows + r * a.rowb;
  if (r < len) {
    const int si = p0 + r;
    int row;
    if (index) {
      const int pos = t0 + si;
      const int page = __ldg(a.bt + (size_t)b * a.MP + pos / a.ps);
      row = (a.li * a.P + page) * a.ps + pos % a.ps;
      ridx[si] = row;
      if (sizeof(T) == 1) rsc[si] = __ldg(a.scales + row);
    } else {
      row = ridx[si];
    }
    bulk_load(dst, static_cast<const char*>(a.cache) + (size_t)row * rb, rb, full);
  } else {
    // P.V meets these rows with p = 0: zeros, so no stale value (a NaN in
    // bf16) enters a sum; ordered before the async proxy's later copies
    for (uint32_t c = 0; c < rb; c += 16) *reinterpret_cast<int4*>(dst + c) = make_int4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

// S^T of the 16 tokens at `ra` (rows g) and ra + 8 rowb (rows g + 8) at
// k-step kk, both head n-tiles, added to d[nn] = (token g, heads 8 nn + 2t,
// +1), (token g + 8, the same)
template <typename T>
__device__ __forceinline__ void score_step(const int8_t* ra, int rowb, const unsigned char* qs,
                                           int qsb, int kk, float (&d)[2][4]) {
  constexpr bool I8 = sizeof(T) == 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int8_t* rb = ra + 8 * rowb;
  uint32_t af[4];
  if (I8) {
    // C permuted alike in the rows and q: logical k (2t, 2t+1, 2t+8, 2t+9)
    // of step kk is byte 16 kk + 4t + (0..3)
    const uint32_t wa = *reinterpret_cast<const uint32_t*>(ra + 16 * kk + 4 * t4) ^ BIAS;
    const uint32_t wb = *reinterpret_cast<const uint32_t*>(rb + 16 * kk + 4 * t4) ^ BIAS;
    af[0] = i8x2(wa, 0, wa, 8);
    af[1] = i8x2(wb, 0, wb, 8);
    af[2] = i8x2(wa, 16, wa, 24);
    af[3] = i8x2(wb, 16, wb, 24);
  } else {
    const int o = 32 * kk + 4 * t4;
    af[0] = *reinterpret_cast<const uint32_t*>(ra + o);
    af[1] = *reinterpret_cast<const uint32_t*>(rb + o);
    af[2] = *reinterpret_cast<const uint32_t*>(ra + o + 16);
    af[3] = *reinterpret_cast<const uint32_t*>(rb + o + 16);
  }
#pragma unroll
  for (int nn = 0; nn < 2; ++nn) {
    const unsigned char* qh = qs + (8 * nn + g) * qsb;
    uint32_t b0, b1;
    if (I8) {
      const uint2 v = *reinterpret_cast<const uint2*>(qh + 32 * kk + 8 * t4);
      b0 = v.x;
      b1 = v.y;
    } else {
      b0 = *reinterpret_cast<const uint32_t*>(qh + 32 * kk + 4 * t4);
      b1 = *reinterpret_cast<const uint32_t*>(qh + 32 * kk + 4 * t4 + 16);
    }
    mma(d[nn], af, b0, b1);
  }
}

// the tile's S^T over k-steps k0 .. k1 - 1 in two chains a head n-tile
// (even and odd steps), added at the end
template <typename T>
__device__ __forceinline__ void score_tile(const int8_t* ra, int rowb, const unsigned char* qs,
                                           int qsb, int k0, int k1, float (&c)[2][4]) {
  float d0[2][4] = {}, d1[2][4] = {};
  int kk = k0;
  for (; kk + 1 < k1; kk += 2) {
    score_step<T>(ra, rowb, qs, qsb, kk, d0);
    score_step<T>(ra, rowb, qs, qsb, kk + 1, d1);
  }
  if (kk < k1) score_step<T>(ra, rowb, qs, qsb, kk, d0);
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nn][e] = d0[nn][e] + d1[nn][e];
}

// CTA `rank` of NS writes the outputs of heads h0 .. h0 + 16 / NS - 1: the
// NS CTAs' sums `red` [H][lkv] added in rank order (every load issued
// before the sums), the current token folded in: (o * alpha + p * row) /
// lf with the head's factors fin [H][3] = (alpha, p, lf)
template <int NS>
__device__ __forceinline__ void merge_out(const Args& a, cg::cluster_group& cl, float* red,
                                          const float (*fin)[3], const __nv_bfloat16* nrow,
                                          int b, int rank) {
  constexpr int HPC = H / NS;
  constexpr int PER = (HPC * (WARPS * COLS / 4) + THREADS - 1) / THREADS;   // float4s a thread
  const int lkv = a.lkv, l4 = lkv / 4, h0 = rank * HPC;
  const float4* peer[NS];
#pragma unroll
  for (int r = 0; r < NS; ++r)
    peer[r] = reinterpret_cast<const float4*>(NS == 1 ? red : cl.map_shared_rank(red, r));
  float4 v[PER][NS];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < HPC * l4) {
      const int at = (h0 + i / l4) * l4 + i % l4;
#pragma unroll
      for (int r = 0; r < NS; ++r) v[k][r] = peer[r][at];
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i >= HPC * l4) break;
    const int h = h0 + i / l4, col = 4 * (i % l4);
    float4 o = v[k][0];
#pragma unroll
    for (int r = 1; r < NS; ++r) {
      o.x += v[k][r].x;
      o.y += v[k][r].y;
      o.z += v[k][r].z;
      o.w += v[k][r].w;
    }
    const float alpha = fin[h][0], p = fin[h][1], lf = fin[h][2];
    const float ov[4] = {o.x, o.y, o.z, o.w};
    uint32_t w[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      w[j] = pack((ov[2 * j] * alpha + p * __bfloat162float(nrow[col + 2 * j])) / lf,
                  (ov[2 * j + 1] * alpha + p * __bfloat162float(nrow[col + 2 * j + 1])) / lf);
    *reinterpret_cast<uint2*>(a.out + ((size_t)b * H + h) * lkv + col) = make_uint2(w[0], w[1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) decode_mla_c_kernel(const Args a) {
  constexpr bool I8 = sizeof(T) == 1;
  constexpr int HPW = H / WARPS;                 // heads a warp takes in the softmax
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float pmax[2][H];                   // this CTA's step maxima, by step parity
  __shared__ float m_s[H], l_s[H], alpha_s[H], snew[H], fin[H][3];
  __shared__ uint64_t full[2];                   // a buffer's rows have landed
  cg::cluster_group cl = cg::this_cluster();
  const int S = (int)cl.num_blocks(), rank = (int)cl.block_rank(), b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  unsigned char* qs = smem;                                         // [H][qsb bytes]
  const __nv_bfloat16* nrow = reinterpret_cast<const __nv_bfloat16*>(smem + a.o_nl);   // [C]
  int8_t* rows = reinterpret_cast<int8_t*>(smem + a.o_rows);       // [nbuf][cap][rowb bytes]
  float* kept = reinterpret_cast<float*>(smem + a.o_kept);         // [H][kst]
  __nv_bfloat16* pp = reinterpret_cast<__nv_bfloat16*>(smem + a.o_p);   // [H][pst]
  float* part = reinterpret_cast<float*>(smem + a.o_part);         // [WARPS][16][H]
  int* ridx = reinterpret_cast<int*>(smem + a.o_ridx);             // [share]
  float* rsc = reinterpret_cast<float*>(smem + a.o_rsc);           // [share]
  const int C = a.C, lkv = a.lkv, K16 = C / 16;
  const int bufb = a.cap * a.rowb;                                  // bytes of a buffer
  // a block table maps at most MP*ps tokens: never read past it
  const int clen = min(max(__ldg(a.cached + b), 0), a.MP * a.ps);
  const int hpc = H / S, h0 = rank * hpc;        // the heads this CTA merges

  // q rows and the current token's row into shared memory, with the first
  // pass's rows
  const __nv_bfloat16* qb = a.q + (size_t)b * H * C;
  for (int i = tid; i < (H + 1) * (C / 8); i += THREADS) {
    const int h = i / (C / 8), c = i - h * (C / 8);
    cp_async16(h < H ? (void*)(qs + h * a.qsb + 16 * c) : (void*)(smem + a.o_nl + 16 * c),
               h < H ? qb + (size_t)h * C + 8 * c : a.nl + (size_t)b * C + 8 * c, true);
  }
  cp_commit();
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < H) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  uint32_t phases = 0u;                          // bit k: the next phase of full[k]
  auto wait_buf = [&](int k) {
    mbar_wait(&full[k], (phases >> k) & 1u);
    phases ^= 1u << k;
  };
  bool have_snew = false;
  // the current token's scores (f32) of this CTA's heads, a warp a head
  auto current_scores = [&]() {
    for (int h = h0 + warp; h < h0 + hpc; h += WARPS) {
      const __nv_bfloat16* qh = reinterpret_cast<const __nv_bfloat16*>(qs + h * a.qsb);
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += __bfloat162float(qh[c]) * __bfloat162float(nrow[c]);
      s = warp_sum(s) * a.sm_scale;
      if (lane == 0) snew[h] = s;
    }
  };
  // O^T: warp w's columns 32 w .., [mt][head n-tile][4]; for int8 mt 2u + j
  // holds d 32 w + 32 u + 4 g + 2 j (+1 in c[2], c[3]), for bf16 d 32 w +
  // 16 mt + 2 g (+1)
  float acc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
  const int cb = COLS * warp;                     // this warp's first column

  int par = 0;
  for (int c0 = 0; c0 < clen; c0 += a.tc, par ^= 1) {      // one step of cp pages
    const int live = min(a.tc, clen - c0);
    const int nt = (live + 15) / 16;
    const int lo = 16 * (nt * rank / S);
    const int n = max(min(live, 16 * (nt * (rank + 1) / S)) - lo, 0);   // this CTA's share
    const int npass = (n + a.cap - 1) / a.cap;

    // scores, pass by pass: the next pass's rows are copied while this one
    // is scored; a pass of j tiles is scored by WARPS / j warps a tile, each
    // a part of C
    for (int j = 0; j < npass; ++j) {
      __syncthreads();                            // the buffer of pass j + 1 is read
      if (j == 0 || a.nbuf == 1)
        issue_pass<T>(a, rows, &full[0], ridx, rsc, j * a.cap, min(a.cap, n - j * a.cap), true,
                      b, c0 + lo);
      if (a.nbuf == 2 && j + 1 < npass)
        issue_pass<T>(a, rows + ((j + 1) % 2) * bufb, &full[(j + 1) % 2], ridx, rsc,
                      (j + 1) * a.cap, min(a.cap, n - (j + 1) * a.cap), true, b, c0 + lo);
      if (!have_snew) {
        cp_wait<0>();                             // q and the current row
        __syncthreads();
        current_scores();
        have_snew = true;
      }
      wait_buf(j % a.nbuf);                       // pass j's rows have landed
      __syncthreads();                            // (and every warp's rsc)
      const int p0 = j * a.cap, len = min(a.cap, n - p0), ntp = (len + 15) / 16;
      int ks = 1;
      while (2 * ks * ntp <= WARPS) ks *= 2;
      if (warp < ntp * ks) {
        const int tile = warp % ntp, kp = warp / ntp;
        float c[2][4];
        score_tile<T>(rows + (j % a.nbuf) * bufb + (16 * tile + g) * a.rowb, a.rowb, qs, a.qsb,
                      K16 * kp / ks, K16 * (kp + 1) / ks, c);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e >> 1), h = 8 * nn + 2 * t4 + (e & 1), si = p0 + 16 * tile + r;
            if (ks == 1) {
              if (si < n) kept[h * a.kst + si] = (I8 ? c[nn][e] * rsc[si] : c[nn][e]) * a.sm_scale;
            } else {
              part[(warp * 16 + r) * H + h] = c[nn][e];
            }
          }
      }
      if (ks > 1) {
        __syncthreads();
        // the parts of each (token, head) added in part order
        for (int i = tid; i < ntp * 16 * H; i += THREADS) {
          const int tile = i / (16 * H), r = (i / H) % 16, h = i % H, si = p0 + 16 * tile + r;
          float v = 0.f;
          for (int kp = 0; kp < ks; ++kp) v += part[((kp * ntp + tile) * 16 + r) * H + h];
          if (si < n) kept[h * a.kst + si] = (I8 ? v * rsc[si] : v) * a.sm_scale;
        }
      }
    }
    __syncthreads();

    // the step's maximum over the cluster: warp w takes heads HPW w ..
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int h = HPW * warp + j;
      float mt = NEG;
      for (int t = lane; t < n; t += 32) mt = fmaxf(mt, kept[h * a.kst + t]);
      mt = warp_max(mt);
      if (lane == 0) pmax[par][h] = mt;
    }
    cl.sync();
    {
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        const int h = HPW * warp + j;
        // lane r < S reads CTA r's maximum of the head
        const float mx = warp_max(lane < S ? *cl.map_shared_rank(&pmax[par][h], lane) : NEG);
        const float m_old = m_s[h];
        const float m_new = fmaxf(m_old, mx);
        float psum = 0.f;
        const int n16 = (n + 15) & ~15;
        for (int t = lane; t < n16; t += 32) {
          float w = 0.f;
          if (t < n) {
            const float p = expf(kept[h * a.kst + t] - m_new);
            psum += p;
            w = I8 ? p * rsc[t] : p;
          }
          pp[h * a.pst + t] = __float2bfloat16_rn(w);
        }
        psum = warp_sum(psum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          m_s[h] = m_new;
          l_s[h] = l_s[h] * alpha + psum;
          alpha_s[h] = alpha;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const float a0 = alpha_s[8 * nn + 2 * t4], a1 = alpha_s[8 * nn + 2 * t4 + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][nn][0] *= a0;
        acc[m][nn][1] *= a1;
        acc[m][nn][2] *= a0;
        acc[m][nn][3] *= a1;
      }
    }

    // P.V: the passes still held first (the last, then the one before it),
    // then the others read again in order (with two buffers the next copied
    // while one is used); item i of this order is in buffer (npass - 1 + i)
    // % nbuf
    const int held = min(npass, a.nbuf);
    for (int i = 0; i < npass; ++i) {
      const int pass = i < held ? npass - 1 - i : i - held;
      const int nxt = a.nbuf == 2 ? i + 1 : i;   // the item copied in this round
      if (nxt < npass && nxt >= held) {
        __syncthreads();                          // the item before, in its buffer, is read
        const int k = (npass - 1 + nxt) % a.nbuf, np = nxt - held;
        issue_pass<T>(a, rows + k * bufb, &full[k], ridx, rsc, np * a.cap,
                      min(a.cap, n - np * a.cap), false, b, 0);
      }
      if (i >= held) {
        wait_buf((npass - 1 + i) % a.nbuf);
        __syncthreads();                          // (and every warp's zeroed rows)
      }
      const int p0 = pass * a.cap, len = min(a.cap, n - p0);
      const int8_t* buf = rows + ((npass - 1 + i) % a.nbuf) * bufb;
      for (int k0 = 0; k0 < len; k0 += 16) {
        uint32_t pb[2][2];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const __nv_bfloat16* ph = pp + (8 * nn + g) * a.pst + p0 + k0 + 2 * t4;
          pb[nn][0] = *reinterpret_cast<const uint32_t*>(ph);
          pb[nn][1] = *reinterpret_cast<const uint32_t*>(ph + 8);
        }
        const int8_t* v0 = buf + (k0 + 2 * t4) * a.rowb;
        const int rb = a.rowb;
        if (I8) {
#pragma unroll
          for (int u = 0; u < MT / 2; ++u) {
            if (cb + 32 * u >= lkv) break;
            // the 4 bytes at column 32 w + 32 u + 4 g of rows 2t, 2t+1,
            // 2t+8, 2t+9 are d rows g, g + 8 of mt 2u and 2u + 1
            const int off = cb + 32 * u + 4 * g;
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(v0 + off) ^ BIAS;
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(v0 + rb + off) ^ BIAS;
            const uint32_t w8 = *reinterpret_cast<const uint32_t*>(v0 + 8 * rb + off) ^ BIAS;
            const uint32_t w9 = *reinterpret_cast<const uint32_t*>(v0 + 9 * rb + off) ^ BIAS;
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int l8 = 16 * jj, h8 = 16 * jj + 8;
              const uint32_t va[4] = {i8x2(w0, l8, w1, l8), i8x2(w0, h8, w1, h8),
                                      i8x2(w8, l8, w9, l8), i8x2(w8, h8, w9, h8)};
              mma(acc[2 * u + jj][0], va, pb[0][0], pb[0][1]);
              mma(acc[2 * u + jj][1], va, pb[1][0], pb[1][1]);
            }
          }
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (cb + 16 * m >= lkv) break;
            // the bf16 pair at column 32 w + 16 m + 2 g of a row is d rows g
            // (low half) and g + 8 (high half)
            const int off = 2 * (cb + 16 * m) + 4 * g;
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(v0 + off);
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(v0 + rb + off);
            const uint32_t w8 = *reinterpret_cast<const uint32_t*>(v0 + 8 * rb + off);
            const uint32_t w9 = *reinterpret_cast<const uint32_t*>(v0 + 9 * rb + off);
            const uint32_t va[4] = {__byte_perm(w0, w1, 0x5410), __byte_perm(w0, w1, 0x7632),
                                    __byte_perm(w8, w9, 0x5410), __byte_perm(w8, w9, 0x7632)};
            mma(acc[m][0], va, pb[0][0], pb[0][1]);
            mma(acc[m][1], va, pb[1][0], pb[1][1]);
          }
        }
      }
    }
  }

  cp_wait<0>();                                   // q and the current row, where no step ran
  __syncthreads();
  if (!have_snew) current_scores();
  // the current token's factors of head h: fin[h] = (alpha, p, lf), out =
  // (o * alpha + p * row) / lf over the cluster's sums o and l
  auto factors = [&](int h, float l) {
    const float m = m_s[h], s = snew[h];
    const float mn = fmaxf(m, s);
    const float alpha = expf(m - mn), p = expf(s - mn);
    fin[h][0] = alpha;
    fin[h][1] = p;
    fin[h][2] = fmaxf(l * alpha + p, 1e-37f);
  };
  if (S == 1) {
    // one CTA: the output straight from its sums, a bf16 pair of columns a
    // store
    __syncthreads();                              // every head's snew
    if (tid < H) factors(tid, l_s[tid]);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int d = I8 ? cb + 32 * (m / 2) + 4 * g + 2 * (m % 2) : cb + 16 * m + 2 * g;
      if (d >= lkv) continue;
      const float r0 = __bfloat162float(nrow[d]), r1 = __bfloat162float(nrow[d + 1]);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int h = 8 * nn + 2 * t4 + j;
          const float alpha = fin[h][0], p = fin[h][1], lf = fin[h][2];
          *reinterpret_cast<uint32_t*>(a.out + ((size_t)b * H + h) * lkv + d) =
              pack((acc[m][nn][j] * alpha + p * r0) / lf,
                   (acc[m][nn][j + 2] * alpha + p * r1) / lf);
        }
    }
    return;
  }
  // this CTA's sums into its shared memory [H][lkv] f32, over the rows
  float* red = reinterpret_cast<float*>(smem + a.o_rows);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int d = I8 ? cb + 32 * (m / 2) + 4 * g + 2 * (m % 2) : cb + 16 * m + 2 * g;
    if (d >= lkv) continue;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * nn + 2 * t4 + (e & 1)) * lkv + d + (e >> 1)] = acc[m][nn][e];
  }
  cl.sync();                                      // every CTA's sums are posted
  // CTA `rank` merges heads h0 .. h0 + hpc - 1 over the cluster, in rank order
  for (int hh = warp; hh < hpc; hh += WARPS) {
    const int h = h0 + hh;
    const float v = lane < S ? *cl.map_shared_rank(&l_s[h], lane) : 0.f;
    float l = 0.f;
    for (int r = 0; r < S; ++r) l += __shfl_sync(0xffffffffu, v, r);
    if (lane == 0) factors(h, l);
  }
  __syncthreads();
  switch (S) {
    case 1: merge_out<1>(a, cl, red, fin, nrow, b, rank); break;
    case 2: merge_out<2>(a, cl, red, fin, nrow, b, rank); break;
    case 4: merge_out<4>(a, cl, red, fin, nrow, b, rank); break;
    default: merge_out<8>(a, cl, red, fin, nrow, b, rank); break;
  }
  cl.sync();                                      // no CTA leaves while a peer reads it
}

template <typename T>
cudaError_t launch(Args& a, int B, cudaStream_t st) {
  auto kern = decode_mla_c_kernel<T>;
  int total = 0;
  const int S = plan(a, (int)sizeof(T), total);
  cudaError_t e = skt::ensure_smem(kern, (size_t)total);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, kern, a)) != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// H = 16 heads; C % 16 == 0; lkv % 16 == 0 and lkv <= min(512, C); ps % 16
// == 0; cp >= 1 pages a step; int8 = 1: an int8 cache with scales, else
// bf16 (scales ignored).
extern "C" int skt_decode_mla_c(const void* q, const void* nl, const void* cache,
                                const void* scales, const void* cached, const void* bt,
                                void* out, int B, int C, int lkv, int P, int ps, int MP,
                                int cp, int li, float sm_scale, int int8, void* stream) {
  if (C % 16 || lkv % 16 || lkv > WARPS * COLS || lkv > C || ps % 16 || ps <= 0 || cp < 1 ||
      MP < 1 || (int8 && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.nl = static_cast<const __nv_bfloat16*>(nl);
  a.cache = cache;
  a.scales = int8 ? static_cast<const float*>(scales) : nullptr;
  a.cached = static_cast<const int*>(cached);
  a.bt = static_cast<const int*>(bt);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.C = C;
  a.lkv = lkv;
  a.P = P;
  a.ps = ps;
  a.MP = MP;
  a.tc = std::min(cp, MP) * ps;
  a.li = li;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int8 ? (int)launch<int8_t>(a, B, st) : (int)launch<__nv_bfloat16>(a, B, st);
}

extern "C" const char* skt_decode_mla_c_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
