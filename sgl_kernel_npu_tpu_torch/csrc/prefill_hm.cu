// Kernel K15: flash prefill of a chunk off the page-major ("hm") paged cache,
// bf16 or int8 pages.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/paged_prefill.py::
// paged_prefill_attention (_kernel, paged_prefill.py:41-131): a grid of
// (kv head, query tile of block_q tokens), each walking its page list with an
// online softmax, one page per step. The list is the dense causal schedule
// (pages 0 .. ceil((prefix + min((qi+1) * block_q, T)) / ps) - 1, at most
// MP) or a selection: page_sel [NQ, NS] with page_cnt [NQ], or per kv head
// page_sel [Hkv, NQ, NS] with page_cnt [Hkv, NQ] (logical page numbers).
//
// q [S, T, Hq, 128] bf16 (S sequences' chunks, each already written to the
// cache at positions prefix .. prefix + T - 1); caches [P, Hkv, ps, 128] bf16,
// or int8 with per-token f32 scales [P, Hkv, 1, ps]; block tables [S, MP]
// int32 (logical -> physical page); prefix [S] int32; out [S, T, Hq, 128]
// bf16. Tile row r of tile qi is token qi * block_q + r / G, head h*G + r % G.
//
// Rounding. The TPU kernel takes, per page, s = (q . k) * sm_scale in f32
// over all ps columns (an int8 row dequantised as f32(k * scale) first);
// columns with logical position > prefix + token get -1e30; m = max(m,
// rowmax(s)), alpha = exp(m_old - m), p = exp(s - m) for every column (a row
// with nothing visible yet takes p = 1 over its masked columns, until a
// visible page comes and alpha wipes them out; a row whose whole list is
// invisible keeps that mean of V), l = l * alpha + rowsum(p) over the f32 p,
// acc = acc * alpha + p . v; out = acc / max(l, 1e-37) in bf16 (0 for an
// empty list). This kernel computes the same function as follows:
//   * q . k on bf16 tensor cores with f32 accumulation. bf16 x bf16 (and bf16
//     x int8, which widens to bf16 exactly) products are exact in f32; the
//     tensor cores add them 16 at a time, and their accumulation truncates
//     (towards zero, up to an ulp of the sum per MMA) where f32 adds round
//     to nearest. An int8 row's scale is applied after the dot: (q . k_int8)
//     * k_scale, which moves the result by f32 rounding only.
//   * The scores are taken in base 2: s2 = dot * (k_scale) * sm_scale *
//     log2(e), then masked to -1e30 (the mask value itself is not scaled),
//     p = exp2(s2 - m2). Keys past the end of the list are absent, not
//     masked: -inf, p = 0.
//   * P . V keeps p in f32 whole: p (times v's scale for int8 pages, folded
//     in before the split) is split into three bf16 parts, hi = bf16(p), mid
//     = bf16(p - hi), lo = p - hi - mid (exact: 3 x 8 significant bits hold
//     an f32's 24), and P . V = hi . V + mid . V + lo . V, three MMAs, so
//     each product p * v is exact in f32. l sums the f32 p itself.
//   * Over bf16 pages P . V is also summed as f32 sums are (pv_rn): each
//     hi . V MMA (16 keys) runs into a zeroed accumulator and its sum is
//     added to o in f32, rounding to nearest; mid . V + lo . V, below 2^-8
//     of it, are summed over a tile in one accumulator and added to o once.
//     So P . V differs from the TPU's in the order of the f32 sums and by a
//     few ulps of that small sum. Accumulated in the tensor cores instead,
//     P . V leans towards zero by up to an ulp of o per MMA. Either short
//     cut (two parts of p, as K17 takes, or that accumulation) settles a tie
//     of the small hm engine's bf16 logits (chip_smoke.py phase 3) the other
//     way from the CPU's f32 version. Over int8 pages P . V accumulates in
//     the tensor cores: promoting each MMA there costs a fifth of the
//     kernel's time (the body is at its register cap), and the int8 pages'
//     own rounding (steps of 1 / 254 of a row's range) dwarfs an f32 ulp.
//
// Bound on an H100: the larger of the bytes (q, the visited pages, the
// output) over 3.35 TB/s and 4 * 128 operations per (query row, visible key)
// at the bf16 tensor-core rate; the three-part P . V makes the MMA floor 2
// times that. Under either design a block takes rows of one tile (a tile's
// rows share its page list, so any split of them gives the TPU's numbers)
// and, under the dense schedule, stops at the last key its own rows can see:
// every row sees position 0, so the keys after that give p = 0 and alpha = 1
// exactly, and skipping them changes no bit.
//
// bf16 pages, K17's design (csrc/laser_attention.cu) over a page list: a
// block takes 128 tile rows, two consumer warpgroups of 64 that copy their q
// rows into shared memory (wgmma's K-major A operand, any GQA grouping); one
// producer warp walks the list in tiles of 128 keys (128 / ps pages), writes
// each key's logical position to shared memory and has one thread load each
// page by TMA (a 3-D map over [pages * Hkv, ps, 128], a box per page and
// 64-column half, 128-byte swizzle; a page past the list loads the first
// one, masked away) into a ring of two stages on mbarriers. The consumers
// take turns at issuing S = Q . K^T of a tile (both from shared memory) as
// wgmma, so one warpgroup's softmax runs while the other's MMAs do; P . V
// of the previous tile (P from registers, V the MN-major operand) runs
// before each turn (pv_rn). 161 KB of shared memory: one block per SM.
//
// int8 pages, kernel B's design (csrc/prefill_tm.cu): a block takes 64 tile
// rows, 4 warps of 16, q fragments in registers straight from global
// memory. The list's keys stream in tiles of 64 (64 / ps pages a tile below
// ps 64, half a page at ps 128) through a ring of 3 shared-memory stages by
// cp.async, 16 bytes a copy, the page of each key taken from the list and
// the block table a tile ahead; keys past the list are zero-filled. An int8
// tile lands at the start of each 272-byte row and is widened to bf16 in
// place once it has arrived (wgmma could not read it as it lands); K then
// goes through ldmatrix, V through ldmatrix.trans, both products on
// mma.sync m16n8k16; the score accumulators become the P A-fragments
// without a trip through shared memory. 106 KB of shared memory a block:
// two blocks per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 128;        // head dim
constexpr int NP = 3;         // bf16 parts of p in P . V
constexpr float NEG = -1e30f;

struct Args {
  const __nv_bfloat16* q;
  const void* kc;
  const void* vc;
  const float* ks;
  const float* vs;
  const int* bt;              // [S, MP]
  const int* prefix;          // [S]
  const int* sel;             // null: dense causal
  const int* cnt;
  __nv_bfloat16* out;
  int T, Hq, Hkv, MP, block_q, NQ, NB, NS, sel_per_head;
  float scale_log2;           // sm_scale * log2(e)
};

// The key list of the block of `rows` tile rows (rb-th) of tile qi, kv head
// h: nkeys keys, the list's pages in its order, PS keys each; `sel` the
// selection (null: the dense schedule, which stops at the last key the
// block's rows see; the rows past the tile or T are not written).
template <int PS>
__device__ __forceinline__ int key_list(const Args& a, int h, int qi, int rb, int rows,
                                        int prefix, const int*& sel) {
  sel = nullptr;
  if (a.sel == nullptr) {
    const int G = a.Hq / a.Hkv;
    const int need = prefix + min((qi + 1) * a.block_q, a.T);
    const int last_row = min(rb * rows + rows, a.block_q * G) - 1;
    const int last_tok = min(qi * a.block_q + last_row / G, a.T - 1);
    return min(min((need + PS - 1) / PS, a.MP) * PS, prefix + last_tok + 1);
  }
  const int idx = a.sel_per_head ? h * a.NQ + qi : qi;
  sel = a.sel + (size_t)idx * a.NS;
  return a.cnt[idx] * PS;
}

// ------------------------------------------------ int8 pages on mma.sync

constexpr int R = 64;         // tile rows per block
constexpr int TK = 64;        // keys per tile
constexpr int STAGES = 3;     // cp.async ring
constexpr int THREADS = 128;
constexpr int LDS = D + 8;    // bf16 per shared row: 272 bytes, conflict-free ldmatrix

struct Smem {
  __nv_bfloat16 k[STAGES][TK * LDS];
  __nv_bfloat16 v[STAGES][TK * LDS];
  float kscale[STAGES][TK];
  float vscale[STAGES][TK];
  int pos[STAGES][TK];        // logical position of each key; -1: past the list
};

// The keys this thread copies in one int8 tile: K/V rows (tid >> 3) + 16 i
// (8 chunks of 16 bytes a row), and key tid & 63, whose position and scale
// it writes. Cache row index (page * Hkv + h) * ps + column, or -1 past the
// list. Read a tile ahead of its copies, so the list and block-table loads
// are off the critical path.
struct Keys {
  static constexpr int N = 4;
  int row[N];
  int srow, spos;
};

template <int PS>
__device__ __forceinline__ Keys fetch_keys(const Args& a, const int* bt, const int* sel, int tile,
                                           int nkeys, int h) {
  Keys kk;
  const int tid = threadIdx.x;
  auto locate = [&](int u, int& pos) {
    if (u >= nkeys) {
      pos = -1;
      return -1;
    }
    const int j = u / PS, c = u % PS;
    const int lp = sel != nullptr ? __ldg(sel + j) : j;
    pos = lp * PS + c;
    return (__ldg(bt + lp) * a.Hkv + h) * PS + c;
  };
  int unused;
#pragma unroll
  for (int i = 0; i < kk.N; ++i)
    kk.row[i] = locate(tile * TK + (tid >> 3) + 16 * i, unused);
  kk.srow = locate(tile * TK + (tid & 63), kk.spos);
  return kk;
}

// Start the copies of key tile `tile` into ring stage `st`: each int8 row at
// the start of its 272-byte row, and the scales; rows past the list are
// zero-filled.
__device__ __forceinline__ void issue_tile(Smem& sm, const Args& a, const Keys& kk, int st) {
  const int tid = threadIdx.x;
  const int8_t* kc = static_cast<const int8_t*>(a.kc);
  const int8_t* vc = static_cast<const int8_t*>(a.vc);
  const int c = tid & 7;
#pragma unroll
  for (int i = 0; i < kk.N; ++i) {
    const int key = (tid >> 3) + 16 * i;
    const bool ok = kk.row[i] >= 0;
    const size_t off = ok ? (size_t)kk.row[i] * D + c * 16 : 0;
    cp_async16(reinterpret_cast<int8_t*>(sm.k[st] + key * LDS) + c * 16, kc + off, ok);
    cp_async16(reinterpret_cast<int8_t*>(sm.v[st] + key * LDS) + c * 16, vc + off, ok);
  }
  const bool ok = kk.srow >= 0;
  const int key = tid & 63;
  cp_async4(tid < 64 ? &sm.kscale[st][key] : &sm.vscale[st][key],
            (tid < 64 ? a.ks : a.vs) + (ok ? kk.srow : 0), ok);
  if (tid < 64) sm.pos[st][tid] = kk.spos;
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

template <int PS>
__global__ void __launch_bounds__(THREADS, 2) prefill_hm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int h = blockIdx.x, qi = blockIdx.y / a.NB, rb = blockIdx.y % a.NB, s = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int G = a.Hq / a.Hkv;
  const int tile_rows = a.block_q * G;
  const int prefix = a.prefix[s];
  const int* bt = a.bt + (size_t)s * a.MP;

  const int* sel;
  const int nkeys = key_list<PS>(a, h, qi, rb, R, prefix, sel);
  const int n_tiles = (nkeys + TK - 1) / TK;

  Keys next = fetch_keys<PS>(a, bt, sel, 0, nkeys, h);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) issue_tile(sm, a, next, i);
    cp_commit();
    next = fetch_keys<PS>(a, bt, sel, i + 1, nkeys, h);
  }

  // this thread's rows r = warp*16 + g (+ 8) of the block: tile row rb*64 + r
  int lim[2];                               // the last position each row sees
  unsigned qa[D / 16][4];
  {
    const unsigned* pq[2];
    bool in[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = rb * R + warp * 16 + g + 8 * r;
      const int tok = qi * a.block_q + rr / G;
      in[r] = rr < tile_rows && tok < a.T;
      lim[r] = prefix + tok;
      pq[r] = reinterpret_cast<const unsigned*>(
          a.q + (((size_t)s * a.T + (in[r] ? tok : 0)) * a.Hq + h * G + rr % G) * D);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = in[0] ? __ldg(pq[0] + kk * 8 + tig) : 0u;
      qa[kk][1] = in[1] ? __ldg(pq[1] + kk * 8 + tig) : 0u;
      qa[kk][2] = in[0] ? __ldg(pq[0] + kk * 8 + 4 + tig) : 0u;
      qa[kk][3] = in[1] ? __ldg(pq[1] + kk * 8 + 4 + tig) : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};                  // this thread's columns only; quad sum at the end

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<STAGES - 2>();                  // this thread's copies of `tile` landed
    __syncthreads();                        // everyone's, and tile - 1 is consumed
    {
      const int nt = tile + STAGES - 1;
      if (nt < n_tiles) issue_tile(sm, a, next, nt % STAGES);
      cp_commit();
      next = fetch_keys<PS>(a, bt, sel, nt + 1, nkeys, h);
    }
    const int st = tile % STAGES;
    widen_tile(sm, st);
    __syncthreads();
    const __nv_bfloat16* kt = sm.k[st];
    const __nv_bfloat16* vt = sm.v[st];

    float sc[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        unsigned r[4];
        ldsm_x4(r, kt + (n * 8 + (lane & 7)) * LDS + kk * 16 + (lane >> 3) * 8);
        mma(sc[n], qa[kk], r[0], r[1]);
        mma(sc[n], qa[kk + 1], r[2], r[3]);
      }
    }

    // scales and the mask, column by column in registers: absent keys -inf,
    // keys past the row's position -1e30
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
      const int c = n * 8 + 2 * tig;
      const int2 pos = *reinterpret_cast<const int2*>(&sm.pos[st][c]);
      float2 ks = *reinterpret_cast<const float2*>(&sm.kscale[st][c]);
      ks.x *= a.scale_log2;
      ks.y *= a.scale_log2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = (i & 1) ? pos.y : pos.x;
        const float x = sc[n][i] * ((i & 1) ? ks.y : ks.x);
        sc[n][i] = p < 0 ? -CUDART_INF_F : (p <= lim[i >> 1] ? x : NEG);
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
      }
    }

    // online softmax: each row lives in the four lanes of a quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - mn);
      m[r] = mn;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[n][i] = ex2(sc[n][i] - m[i >> 1]);
        ps[i >> 1] += sc[n][i];
      }
    l[0] = l[0] * alpha[0] + ps[0];
    l[1] = l[1] * alpha[1] + ps[1];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {      // v's scale, folded into p before the split
      const float2 vs = *reinterpret_cast<const float2*>(&sm.vscale[st][n * 8 + 2 * tig]);
      sc[n][0] *= vs.x;
      sc[n][1] *= vs.y;
      sc[n][2] *= vs.x;
      sc[n][3] *= vs.y;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P . V, the score accumulators split into NP bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pf[NP][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t part[NP];
        split<NP>(sc[2 * kk + (j >> 1)][2 * (j & 1)], sc[2 * kk + (j >> 1)][2 * (j & 1) + 1],
                  part);
#pragma unroll
        for (int i = 0; i < NP; ++i) pf[i][j] = part[i];
      }
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        unsigned r[4];
        const int mi = lane >> 3;
        ldsm_x4_t(r, vt + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LDS + n * 8 + (mi >> 1) * 8);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          mma(o[n], pf[i], r[0], r[1]);
          mma(o[n + 1], pf[i], r[2], r[3]);
        }
      }
    }
  }
  cp_wait<0>();                             // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = rb * R + warp * 16 + g + 8 * r;
    const int tok = qi * a.block_q + rr / G;
    if (rr >= tile_rows || tok >= a.T) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-37f);
    __nv_bfloat16* op =
        a.out + (((size_t)s * a.T + tok) * a.Hq + h * G + rr % G) * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int PS>
cudaError_t launch(Args a, int S, cudaStream_t st) {
  auto kern = prefill_hm_kernel<PS>;
  a.NB = (a.block_q * (a.Hq / a.Hkv) + R - 1) / R;
  const cudaError_t e = skt::ensure_smem(kern, sizeof(Smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.Hkv, a.NQ * a.NB, S), THREADS, sizeof(Smem), st>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 pages on wgmma

namespace wg {

constexpr int BM = 128;                // tile rows per block: two consumer warpgroups of 64
constexpr int BN = 128;                // keys per tile: BN / PS pages
constexpr int STAGES = 2;
constexpr int THREADS = 384;           // producer warpgroup + two consumer warpgroups
constexpr int HALF = 64;               // bf16 columns of one 128-byte swizzle atom
constexpr uint32_t ROW_BYTES = 128;
constexpr uint32_t KV_BYTES = BN * D * 2;

struct alignas(1024) Smem {
  __nv_bfloat16 q[2][BM * HALF];       // [half][row][64], swizzled rows
  __nv_bfloat16 k[STAGES][2][BN * HALF];
  __nv_bfloat16 v[STAGES][2][BN * HALF];
  int pos[STAGES][BN];                 // logical position of each key; -1: past the list
  uint64_t k_full[STAGES], v_full[STAGES], empty[STAGES];
};

// Mask a tile of scores in place (scaled to base 2): keys past the list
// -inf, keys past the row's last visible position -1e30.
__device__ __forceinline__ void mask_tile(float (&sc)[64], const int* pos, const int (&lim)[2],
                                          int tig, float scale_log2) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int2 p = *reinterpret_cast<const int2*>(pos + n * 8 + 2 * tig);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pi = (i & 1) ? p.y : p.x;
      const float x = sc[4 * n + i] * scale_log2;
      sc[4 * n + i] = pi < 0 ? -CUDART_INF_F : (pi <= lim[i >> 1] ? x : NEG);
    }
  }
}

// d (64 x 64, f32) = A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SKT_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SKT_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// o += P . V of one stage (128 keys), p (f32) in sc, its three bf16 parts
// (split) summed so that o gets f32 sums rounded to nearest: the tensor
// cores' own accumulation across MMAs truncates, leaning towards zero by up
// to an ulp of the accumulator per MMA. mid . V + lo . V (below 2^-8 of p
// . V) are summed over the stage in one accumulator, where that is below
// 2^-8 of an ulp of o, and added to o once; each hi . V MMA (16 keys, one
// 64-column half of V) runs into a zeroed accumulator, and its sum is added
// to o. Two such accumulators take turns, so one MMA runs while the other's
// sum is added.
__device__ __forceinline__ void pv_rn(float (&o)[64], float (&low)[64], float (&sum)[2][32],
                                      const float (&p)[64], uint32_t vb) {
  static_assert(NP == 3, "hi is promoted, mid and lo summed together");
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {       // waited per group (in flight, ptxas waits: C7517)
    uint32_t pl[2][4];                         // mid, lo
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t part[NP];
      split<NP>(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1], part);
      pl[0][j] = part[1];
      pl[1][j] = part[2];
    }
    const uint64_t vd = sw128_desc(vb + kk * 16 * 128, BN * 128, 1024);
    wg_fence();
    wgmma_rs(low, pl[0], vd, kk > 0);
    wgmma_rs(low, pl[1], vd);
    wg_commit();
    wg_wait<0>();
    reg_fence(pl);
    reg_fence(low);
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) o[e] += low[e];

  uint32_t ph[2][4];                           // hi of two groups of 16 keys
#pragma unroll
  for (int t = 0; t < 2 * (BN / 16); ++t) {    // 16 keys kk = t / 2, half t % 2 of V
    const int kk = t / 2;
    if (t % 2 == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ph[kk & 1][j] = pack(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
    }
    wg_fence();
    wgmma_rs_n64(sum[t & 1], ph[kk & 1],
                 sw128_desc(vb + (t % 2) * (BN * 128) + kk * 16 * 128, BN * 128, 1024));
    wg_commit();
    if (t > 0) {
      wg_wait<1>();
      reg_fence(ph);
      reg_fence(sum[(t - 1) & 1]);
#pragma unroll
      for (int e = 0; e < 32; ++e) o[32 * ((t - 1) % 2) + e] += sum[(t - 1) & 1][e];
    }
  }
  wg_wait<0>();
  reg_fence(ph);
  reg_fence(sum[1]);
#pragma unroll
  for (int e = 0; e < 32; ++e) o[32 + e] += sum[1][e];
}

}  // namespace wg

// K15 over bf16 pages, the shape of K17 (csrc/laser_attention.cu): a block
// takes 128 tile rows (two consumer warpgroups of 64, their q rows copied to
// shared memory as wgmma's K-major A operand); one producer warp walks the
// block's key list in tiles of 128 keys, writes each key's position to shared
// memory and has one thread load each page of the tile by TMA (a 3-D map
// [pages * Hkv, ps, 128], a box per page and 64-column half, 128-byte
// swizzle) into a ring of two stages on mbarriers; the consumers take turns
// at issuing S, as K17 does, and run P . V of the previous tile before each
// turn (pv_rn).
template <int PS>
__global__ void __launch_bounds__(wg::THREADS, 1)
    prefill_hm_wg_kernel(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  wg::Smem& sm = *reinterpret_cast<wg::Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~static_cast<uintptr_t>(1023));
  const int h = blockIdx.x, qi = blockIdx.y / a.NB, rb = blockIdx.y % a.NB, s = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int tile_rows = a.block_q * G;
  const int prefix = a.prefix[s];
  const int* bt = a.bt + (size_t)s * a.MP;

  const int* sel;
  const int nkeys = key_list<PS>(a, h, qi, rb, wg::BM, prefix, sel);
  const int nkt = (nkeys + wg::BN - 1) / wg::BN;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < wg::STAGES; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.empty[st], 8);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer warp: every lane writes positions, lane 0 issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int j = 0; j < nkt; ++j) {
        const int st = j % wg::STAGES;
        if (j >= wg::STAGES) mbar_wait(&sm.empty[st], ((j / wg::STAGES) - 1) & 1);
        for (int c = lane; c < wg::BN; c += 32) {
          const int u = j * wg::BN + c;
          sm.pos[st][c] =
              u < nkeys ? (sel != nullptr ? __ldg(sel + u / PS) : u / PS) * PS + u % PS : -1;
        }
        __syncwarp();
        if (lane == 0) {
          // a page past the list loads the list's first one (finite, masked away)
          int rows[wg::BN / PS];
#pragma unroll
          for (int e = 0; e < wg::BN / PS; ++e) {
            const int u = j * wg::BN + e * PS;
            const int lp = sel != nullptr ? __ldg(sel + (u < nkeys ? u / PS : 0))
                                          : (u < nkeys ? u / PS : 0);
            rows[e] = __ldg(bt + lp) * a.Hkv + h;
          }
          mbar_expect_tx(&sm.k_full[st], wg::KV_BYTES);
#pragma unroll
          for (int e = 0; e < wg::BN / PS; ++e) {
            tma_load_3d(sm.k[st][0] + e * PS * wg::HALF, &kmap, &sm.k_full[st], 0, 0,
                        rows[e]);
            tma_load_3d(sm.k[st][1] + e * PS * wg::HALF, &kmap, &sm.k_full[st], wg::HALF,
                        0, rows[e]);
          }
          mbar_expect_tx(&sm.v_full[st], wg::KV_BYTES);
#pragma unroll
          for (int e = 0; e < wg::BN / PS; ++e) {
            tma_load_3d(sm.v[st][0] + e * PS * wg::HALF, &vmap, &sm.v_full[st], 0, 0,
                        rows[e]);
            tma_load_3d(sm.v[st][1] + e * PS * wg::HALF, &vmap, &sm.v_full[st], wg::HALF,
                        0, rows[e]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wgi - 1;                      // block rows 64 cw .. + 63
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int tig = lane & 3;
    const int mine = 1 + cw, other = 2 - cw;
    // this warpgroup's q rows, swizzled as TMA would place them; rows past
    // the tile or T are 0
    for (int e = tid; e < 64 * 16; e += 128) {
      const int r = cw * 64 + e / 16, c = e % 16;
      const int tr = rb * wg::BM + r, tok = qi * a.block_q + tr / G;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (tr < tile_rows && tok < a.T)
        x = __ldg(reinterpret_cast<const uint4*>(
                      a.q + (((size_t)s * a.T + tok) * a.Hq + h * G + tr % G) * D) + c);
      *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(sm.q[c / 8]) + r * wg::ROW_BYTES +
                                (((c % 8) ^ (r & 7)) << 4)) = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(3 + cw) : "memory");

    int lim[2], tok[2], head[2];
    bool in[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tr = rb * wg::BM + cw * 64 + warp * 16 + (lane >> 2) + 8 * r;
      tok[r] = qi * a.block_q + tr / G;
      head[r] = h * G + tr % G;
      in[r] = tr < tile_rows && tok[r] < a.T;
      lim[r] = prefix + tok[r];
    }
    float o[64], sc[64], low[64], part_sum[2][32];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's columns only
    const uint32_t qa = smem_u32(sm.q[0]) + cw * 64 * wg::ROW_BYTES;

    if (nkt > 0) {
      // The warpgroups take turns at S (K17's turns: every wait precedes the
      // wgmma.fence of its turn, no branch inside a group); P . V of tile
      // j - 1 runs before turn j, outside the turns, as it waits on each MMA.
      if (cw == 1) turn_pass(1);                 // warpgroup 0 takes the first turn
      for (int j = 0; j < nkt; ++j) {
        const int st = j % wg::STAGES;
        if (j > 0) {
          const int sp = (j - 1) % wg::STAGES;
          mbar_wait(&sm.v_full[sp], ((j - 1) / wg::STAGES) & 1);
          wg::pv_rn(o, low, part_sum, sc, smem_u32(sm.v[sp][0]));
          __syncwarp();
          if (lane == 0) mbar_arrive(&sm.empty[sp]);
        }
        turn_wait(mine);
        mbar_wait(&sm.k_full[st], (j / wg::STAGES) & 1);
        reg_fence(sc);
        wg_fence();
        issue_qk<wg::BM, wg::BN>(sc, qa, smem_u32(sm.k[st][0]));
        wg_commit();
        if (j + 1 < nkt || cw == 0) turn_pass(other);   // warpgroup 1's last turn ends the chain
        wg_wait<0>();
        reg_fence(sc);
        wg::mask_tile(sc, sm.pos[st], lim, tig, a.scale_log2);
        softmax_step(sc, o, m, l);               // p left in sc
      }
      const int sp = (nkt - 1) % wg::STAGES;
      mbar_wait(&sm.v_full[sp], ((nkt - 1) / wg::STAGES) & 1);
      wg::pv_rn(o, low, part_sum, sc, smem_u32(sm.v[sp][0]));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!in[r]) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-37f);
      __nv_bfloat16* op =
          a.out + (((size_t)s * a.T + tok[r]) * a.Hq + head[r]) * D + 2 * tig;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
}

// [pages * Hkv, ps, 128] bf16 as a 3-D map: boxes of 64 columns x ps rows of
// one (page, kv head). The page count is not passed; the map's last dimension
// is the largest a 40-bit span allows, and only pages of the block tables are
// addressed.
bool encode_pages(CUtensorMap* map, const void* base, int ps) {
  const EncodeTiled f = encode_fn();
  if (f == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)ps * D * 2;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)ps, ((1ull << 40) - 1) / row};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, row};
  const cuuint32_t box[3] = {(cuuint32_t)wg::HALF, (cuuint32_t)ps, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return f(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
           elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int PS>
cudaError_t launch_wg(Args a, int S, cudaStream_t st) {
  auto kern = prefill_hm_wg_kernel<PS>;
  CUtensorMap kmap, vmap;
  if (!encode_pages(&kmap, a.kc, PS) || !encode_pages(&vmap, a.vc, PS))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(wg::Smem) + 1024;   // + the base's alignment to 1 KB
  const cudaError_t e = skt::ensure_smem(kern, smem);
  if (e != cudaSuccess) return e;
  a.NB = (a.block_q * (a.Hq / a.Hkv) + wg::BM - 1) / wg::BM;
  kern<<<dim3(a.Hkv, a.NQ * a.NB, S), wg::THREADS, smem, st>>>(kmap, vmap, a);
  return cudaGetLastError();
}

// int8 pages on mma.sync, bf16 pages on wgmma
int dispatch(const Args& a, bool int8, int S, int ps, cudaStream_t st) {
  switch (ps) {
    case 16: return (int)(int8 ? launch<16>(a, S, st) : launch_wg<16>(a, S, st));
    case 32: return (int)(int8 ? launch<32>(a, S, st) : launch_wg<32>(a, S, st));
    case 64: return (int)(int8 ? launch<64>(a, S, st) : launch_wg<64>(a, S, st));
    case 128: return (int)(int8 ? launch<128>(a, S, st) : launch_wg<128>(a, S, st));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k cache, v cache, k scales, v scales (null for bf16), block tables,
// prefix, page_sel, page_cnt (null for the dense schedule), out, int8 flag,
// S, T, Hq, Hkv, D, ps, MP, block_q, NS (page_sel's last dim), sel_per_head,
// sm_scale, stream. D must be 128, ps one of 16, 32, 64, 128.
extern "C" int skt_prefill_hm(const void* q, const void* kc, const void* vc, const void* ks,
                              const void* vs, const void* bt, const void* prefix,
                              const void* sel, const void* cnt, void* out, int int8, int S,
                              int T, int Hq, int Hkv, int d, int ps, int MP, int block_q, int NS,
                              int sel_per_head, float sm_scale, void* stream) {
  if (d != D || Hkv <= 0 || Hq % Hkv != 0 || block_q <= 0 || MP <= 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0) return 0;
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kc = kc;
  a.vc = vc;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.bt = static_cast<const int*>(bt);
  a.prefix = static_cast<const int*>(prefix);
  a.sel = static_cast<const int*>(sel);
  a.cnt = static_cast<const int*>(cnt);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.MP = MP;
  a.block_q = block_q;
  a.NQ = (T + block_q - 1) / block_q;
  a.NS = NS;
  a.sel_per_head = sel_per_head;
  a.scale_log2 = static_cast<float>(static_cast<double>(sm_scale) * 1.4426950408889634);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(a, int8 != 0, S, ps, st);
}

extern "C" const char* skt_prefill_hm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
