// The int8 GEMM stage that kernels K1 and A (w8a8_gemm_tiled.cu), K2
// (rmsq_gemm.cu) and K8 (w8a8_gemm.cu) share, and whose 128-row tile K11
// (fused_moe.cu) runs inside its persistent blocks: int8 rows xq [M, K]
// times layer li of an N-major bank pretiled to [L, N/bn, K, bn] (A: a plain
// [L, K, N] bank, one panel of bn = N; K8: the expert of each block_m-row
// tile, eid[m / block_m] clamped to [0, groups)), with exact int32 sums and
// a dequant epilogue whose order is a template parameter, so that each
// kernel rounds as its own plain version does:
//
//   EpiRmsq  (K2): out = (float(acc + bias[n]) * ws[n]) * xs[m]
//   EpiTiled (K1), EpiBank (A), EpiGrouped (K8): out = (float(acc) * xs[m]) * ws[n]
//
// Bound on an H100: at decode (M = 8 to 128) a call moves the K*N weight
// bytes of its bank panel, below the int8 tensor-core line, so 3.35 TB/s
// bounds it; at prefill widths (M in the hundreds) the int8 rate comes
// close. The stage streams the weights in 256-column tiles through rings in
// shared memory, so each x row is read once per 256 columns. The bank is
// N-major [K, bn], and the 8-bit tensor-core operands must be K-major, so
// the weights are byte-transposed on chip. A 256-column tile may straddle
// two panels (bn 128 or 384): the loaders find the panel of each 128-column
// box (M > 32) or 16-byte chunk (M <= 32).
//   * M > 32 (K8: block_m a multiple of 128): 128-row tiles on int8
//     wgmma. One producer thread loads 128 K bytes a stage of weights by
//     TMA (32 KB in a ring of 3, freed once transposed), another the 16 KB
//     of x rows (a ring of 3); the two consumer warpgroups transpose each
//     weight tile into the 128-byte swizzled K-major layout (two buffers;
//     16 k-rows of 8 columns a thread, byte permutes, conflict-free by the
//     weight map's own swizzle), then each runs four wgmma m64n256k32 on its
//     64 x rows while the next tile is transposed; setmaxnreg gives the
//     producers 56 registers and the consumers 224. The epilogue stages the
//     tile through shared memory and stores 16-byte pieces. The producers'
//     loads (produce_weights), the consumers' loop (consume_tile) and the
//     staged epilogue (store_tile, rows to wherever a functor says) are
//     device functions that K11 calls on its own items.
//   * M <= 32 (K8: any other block_m, a multiple of 32): 16-row tiles on
//     int8 mma.sync m16n8k32: a producer warp's cp.async ring of 8 stages
//     of 64 K bytes, four consumer warps of 16 x 64 outputs that read four
//     8-byte pieces of rows 4t .. 4t + 3 (a swizzled layout: no bank
//     conflicts) and byte-transpose them in registers into B fragments
//     (n-tile j holds columns 8g + j, so a lane ends with 16 contiguous
//     output columns).
// K8 finds its row tile's expert on the card (the host never reads eid):
// the 128-row tiles' weight map covers the whole bank, expert e's panels
// being contiguous, so the expert is a panel coordinate (e * N / bn + j);
// the 16-row tiles offset their cp.async source by the expert's block. A
// K8 row tile whose rows all have x_scale 0 (the padding of the aligned
// compaction) is zero whatever the weights: its split 0 writes the zeros
// and no split streams weights.
// Where there are several row tiles (M > 16 on 16-row tiles, M > 128 on
// 128-row ones) the grid is (row tiles, column tiles, splits), the row tile
// fastest: the card issues the row tiles of one weight tile together, so
// that the repeats of a weight tile come from L2 (K8: the row tiles of one
// expert); otherwise it is (column tiles, 1, splits). When the output has
// too few tiles for the card, the wrapper splits K over blocks (the plan is
// ops/matmul.py::gemm_plan); each split writes its int32 partial, and the
// last split of a tile to take a ticket from the tile's integer arrival
// counter adds the others (exact in any order; 128-row tiles by bulk
// copies of the partials, 16-row tiles with at most 8 rows below M moving
// those rows' sums alone), runs the epilogue and resets the counter to 0:
// no host memset, no float atomic, no second kernel, and a second call is
// bit-identical.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int BN = 256;            // output columns of a block
constexpr int WN = 64;             // output columns of a consumer warp (16-row tiles)
constexpr int MAX_SPLITS = 16;

// arrive on `bar` when every cp.async this thread issued so far has landed
// (counted against the barrier's expected arrivals: no increment)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

#define SKT_OUT128I(d) "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
    "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), \
    "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), \
    "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), \
    "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), \
    "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), \
    "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), \
    "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), \
    "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), \
    "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), \
    "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), \
    "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), \
    "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), \
    "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), \
    "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), \
    "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), \
    "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), \
    "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), \
    "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), \
    "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), \
    "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), \
    "+r"(d[127])

// d (64 x 256, s32) += A (64 x 32, shared, K-major) . B (32 x 256, shared, K-major)
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " SKT_ACC128 ", %128, %129, p;\n}\n"
      : SKT_OUT128I(d)
      : "l"(a), "l"(b), "r"(1));
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
__device__ __forceinline__ void reg_fence_i(int32_t (&r)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 4 rows (k..k+3) of 4 bytes (n..n+3) -> 4 words, word c = k..k+3 of column n+c.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

struct Args {
  const int8_t* xq;      // [M, K]
  const int8_t* w;       // layer li of the bank: [N / bn, K, bn] (K8: the bank [G, N / bn, K, bn])
  const float* wsc;      // [N] of layer li (K8: [G, N])
  const int32_t* bias;   // [N] of layer li, or null
  const float* xs;       // [M]
  void* out;             // [M, N] bf16, or f32 when out_f32
  int4* part;            // split partials, or null
  int* arrivals;         // [tiles], or null
  const int32_t* eid;    // K8: [M / block_m] expert of each row tile; else null
  int M, N, K, bn, splits, out_f32;
  int block_m, groups;   // K8: rows of an expert tile, experts in the bank
};

// The epilogue orders: each rounds every product on its own (no FMA).
// `grouped` marks K8's, whose row tiles each read their own expert.
struct EpiRmsq {
  static constexpr bool grouped = false;
  static __device__ __forceinline__ float apply(int32_t acc, int32_t bias, float ws, float xs) {
    return __fmul_rn(__fmul_rn((float)(acc + bias), ws), xs);
  }
};
struct EpiTiled {
  static constexpr bool grouped = false;
  static __device__ __forceinline__ float apply(int32_t acc, int32_t, float ws, float xs) {
    return __fmul_rn(__fmul_rn((float)acc, xs), ws);
  }
};
// A (a bank [L, K, N], one panel of N columns) rounds as K1: a type of its
// own, so that a profile tells A's launches from K1's
struct EpiBank : EpiTiled {};
// K8 rounds as K1 too, with an expert per row tile
struct EpiGrouped : EpiTiled {
  static constexpr bool grouped = true;
};

// K8: the expert of the row tile at m0, clamped to [0, groups) as the
// plain version clamps it
__device__ __forceinline__ int tile_expert(const Args& a, int m0) {
  return min(max(__ldg(a.eid + m0 / a.block_m), 0), a.groups - 1);
}

// K8, block-wide at the top of a kernel of THREADS threads: true where the
// BM rows at m0 all have x_scale 0 (the padding of the aligned compaction).
// Such a tile is zero whatever the weights, so split 0 writes its zeros and
// no split streams weights (nor takes a ticket: no counter moves).
template <int BM, int THREADS>
__device__ __forceinline__ bool padding_tile(const Args& a, int m0, int n0) {
  const int t = threadIdx.x;
  if (__syncthreads_or(t < BM && m0 + t < a.M && a.xs[m0 + t] != 0.f)) return false;
  if (blockIdx.z == 0) {
    const int esz = a.out_f32 ? 4 : 2;
    const int rows = min(BM, a.M - m0), chunks = min(BN, a.N - n0) * esz / 16;
    unsigned char* out = static_cast<unsigned char*>(a.out) + ((size_t)m0 * a.N + n0) * esz;
    for (int i = t; i < rows * chunks; i += THREADS)
      *reinterpret_cast<uint4*>(out + (size_t)(i / chunks) * a.N * esz + 16 * (i % chunks)) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  return true;
}

// this split's K stages (of bk bytes) of a tile: [k0, k0 + n)
__device__ __forceinline__ void split_range(const Args& a, int bk, int& k0, int& n) {
  const int ksteps = (a.K + bk - 1) / bk, sp = blockIdx.z;
  k0 = (int)((long long)ksteps * sp / a.splits);
  n = (int)((long long)ksteps * (sp + 1) / a.splits) - k0;
}

// Split K: once this split's int32 sums are in the workspace, it takes a
// ticket from the tile's arrival counter. Returns true for the last split
// of the tile to arrive, which then adds the others' sums (exact in any
// order) and resets the counter, ready for the next call. Named barrier 1
// holds the NCT consumer threads together.
template <int NCT>
__device__ __forceinline__ bool ticket_last(const Args& a, int ct, int* last) {
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  bar_sync(1, NCT);
  if (ct == 0) *last = atomicAdd(a.arrivals + tile, 1) == a.splits - 1;
  bar_sync(1, NCT);
  if (!*last) return false;
  __threadfence();
  return true;
}

// This split's sums to the workspace in register order (NQ int4 per
// consumer thread), then its ticket.
template <int NCT, int N>
__device__ __forceinline__ bool arrive_last(const Args& a, int ct, const int32_t (&acc)[N],
                                            int* last) {
  constexpr int NQ = N / 4;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x, sp = blockIdx.z;
  int4* mine = a.part + ((size_t)tile * a.splits + sp) * NQ * NCT;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    __stcg(mine + q * NCT + ct, make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                                          acc[4 * q + 3]));
  return ticket_last<NCT>(a, ct, last);
}

// The whole merge of the partials of the 16-row tiles (`rows` of the tile's
// rows below M): the last split adds the others' sums with eight loads in
// flight a thread. A thread holds rows g and g + 8 of the tile (int4 q of
// its sums: x, y of row g, z, w of row g + 8), and rows at or past M are
// never written out; so where the tile has at most 8 rows below M, only the
// row-g halves move, as int2 packed 8 KB a partial, and only from threads
// whose row g is below M (1 KB a partial at M 1, against 16 KB).
template <int NCT, int N>
__device__ __forceinline__ bool merge_splits(const Args& a, int ct, int rows, int32_t (&acc)[N],
                                             int* last) {
  constexpr int NQ = N / 4;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x, sp = blockIdx.z;
  if (rows > 8) {
    if (!arrive_last<NCT>(a, ct, acc, last)) return false;
    const int4* base = a.part + (size_t)tile * a.splits * NQ * NCT;
    for (int s2 = 0; s2 < a.splits; ++s2) {
      if (s2 == sp) continue;
      const int4* other = base + (size_t)s2 * NQ * NCT + ct;
#pragma unroll
      for (int q0 = 0; q0 < NQ; q0 += 8) {
        int4 u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) u[i] = __ldcg(other + (q0 + i) * NCT);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[4 * (q0 + i)] += u[i].x;
          acc[4 * (q0 + i) + 1] += u[i].y;
          acc[4 * (q0 + i) + 2] += u[i].z;
          acc[4 * (q0 + i) + 3] += u[i].w;
        }
      }
    }
  } else {
    // the tile's own region of the workspace, read as int2
    int2* base = reinterpret_cast<int2*>(a.part + (size_t)tile * a.splits * NQ * NCT);
    const bool live = ((ct & 31) >> 2) < rows;
    if (live) {
      int2* mine = base + (size_t)sp * NQ * NCT + ct;
#pragma unroll
      for (int q = 0; q < NQ; ++q) __stcg(mine + q * NCT, make_int2(acc[4 * q], acc[4 * q + 1]));
    }
    if (!ticket_last<NCT>(a, ct, last)) return false;
    if (live) {
      for (int s2 = 0; s2 < a.splits; ++s2) {
        if (s2 == sp) continue;
        const int2* other = base + (size_t)s2 * NQ * NCT + ct;
#pragma unroll
        for (int q0 = 0; q0 < NQ; q0 += 8) {
          int2 u[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) u[i] = __ldcg(other + (q0 + i) * NCT);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[4 * (q0 + i)] += u[i].x;
            acc[4 * (q0 + i) + 1] += u[i].y;
          }
        }
      }
    }
  }
  if (ct == 0) a.arrivals[tile] = 0;           // ready for the next call
  return true;
}

// ---------------------------------------------- M <= 32: int8 mma.sync

// A block of 16 rows x 256 columns: four consumer warps of 16 x 64 and a
// producer warp, stages of 64 K bytes in a ring of 8. (At M 17-32 two row
// tiles read each weight tile, the second from L2: a 128-row wgmma tile
// there computes 4-7 times the rows it keeps, and its split merge moves 128
// KB a partial, PERF.md.)
constexpr int S_BK = 64;
constexpr int S_STAGES = 8;
constexpr int S_NCW = 4;                           // consumer warps
constexpr int S_THREADS = 32 * (S_NCW + 1);
constexpr int S_STAGE = S_BK * BN + 16 * S_BK;     // weights, then 16 x rows
constexpr size_t S_SMEM = (size_t)S_STAGES * S_STAGE;

template <class Epi>
__global__ void __launch_bounds__(S_THREADS, 1) int8_mma_gemm(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[S_STAGES], empty[S_STAGES];
  __shared__ int last;
  // the grid runs the row tiles fastest where there are several (see launch_gemm)
  const bool rows_fast = a.M > 16;
  const int m0 = (rows_fast ? blockIdx.x : 0) * 16;
  const int n0 = (rows_fast ? blockIdx.y : blockIdx.x) * BN;
  int kb, nk;
  split_range(a, S_BK, kb, nk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the bank block and column scales of the tile's layer (K8: its expert)
  const int8_t* w = a.w;
  const float* wsc = a.wsc;
  if constexpr (Epi::grouped) {
    if (padding_tile<16, S_THREADS>(a, m0, n0)) return;
    const int e = tile_expert(a, m0);
    w += (size_t)e * a.N * a.K;
    wsc += (size_t)e * a.N;
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < S_STAGES; ++st) {
      mbar_init(&full[st], 32);                  // one arrival per producer lane
      mbar_init(&empty[st], S_NCW);              // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == S_NCW) {
    // producer: lane brings weight chunk cc (16 columns) of rows lane / 16 +
    // 2 i, and x chunk xc of rows lane / 4 + 8 i; a weight row r keeps chunk
    // c at c ^ 2 ((r / 4) % 4), an x row r at c ^ ((r / 2) % 4)
    const int cc = lane % 16, xc = lane % 4;
    const int col = n0 + 16 * cc;
    const bool wok = col < a.N;
    const int panel = wok ? col / a.bn : 0;
    const int8_t* wsrc = w + (size_t)panel * a.K * a.bn + (wok ? col - panel * a.bn : 0);
    for (int j = 0; j < nk; ++j) {
      const int st = j % S_STAGES;
      if (j >= S_STAGES) mbar_wait(&empty[st], ((j / S_STAGES) - 1) & 1);
      unsigned char* wt = smem + (size_t)st * S_STAGE;
      unsigned char* xt = wt + S_BK * BN;
      const int k0 = (kb + j) * S_BK;
#pragma unroll 8
      for (int i = 0; i < S_BK / 2; ++i) {
        const int r = lane / 16 + 2 * i;
        cp_async16(wt + r * BN + 16 * (cc ^ (((r >> 2) & 3) << 1)),
                   wsrc + (size_t)(k0 + r) * a.bn, wok);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane / 4 + 8 * i;
        const bool ok = m0 + r < a.M;
        cp_async16(xt + r * S_BK + 16 * (xc ^ ((r >> 1) & 3)),
                   a.xq + (size_t)(ok ? m0 + r : 0) * a.K + k0 + 16 * xc, ok);
      }
      cp_async_arrive(&full[st]);
    }
    cp_wait<0>();
    return;
  }

  // consumers: warp wn holds the 16 rows and columns wn * 64 ..
  const int wn = warp;
  const int g = lane >> 2, t = lane & 3;
  int32_t acc[32];                               // [n-tile j][4]
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  // ldmatrix rows and chunks of this lane (A: rows 0-7 | 8-15, k 0-15 | 16-31)
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achk = lane >> 4;
  // B: 8 bytes at column wn * 64 + 8 g of rows 4 t + i (+ 16), whose chunk
  // sits at c ^ 2 t in every row this lane reads
  const int bchk = ((wn * 4 + (g >> 1)) ^ (2 * t)) * 16 + (g & 1) * 8;

  for (int j = 0; j < nk; ++j) {
    const int st = j % S_STAGES;
    mbar_wait(&full[st], (j / S_STAGES) & 1);
    const unsigned char* wt = smem + (size_t)st * S_STAGE;
    const unsigned char* xt = wt + S_BK * BN;
#pragma unroll
    for (int kk = 0; kk < S_BK / 32; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, xt + arow * S_BK + 16 * ((2 * kk + achk) ^ ((arow >> 1) & 3)));
      uint32_t bf[8][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 v =
              *reinterpret_cast<const uint2*>(wt + (kk * 32 + 16 * h + 4 * t + i) * BN + bchk);
          lo[i] = v.x;
          hi[i] = v.y;
        }
        uint32_t o[4];
        transpose4x4(lo, o);
#pragma unroll
        for (int c = 0; c < 4; ++c) bf[c][h] = o[c];
        transpose4x4(hi, o);
#pragma unroll
        for (int c = 0; c < 4; ++c) bf[4 + c][h] = o[c];
      }
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) mma_s8(acc + 4 * jn, af, bf[jn][0], bf[jn][1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  if (a.splits > 1 && !merge_splits<32 * S_NCW>(a, threadIdx.x, min(16, a.M - m0), acc, &last))
    return;

  // epilogue: n-tile j holds columns 8 g + j of the mma, so per row this
  // lane has the 16 columns wn * 64 + 16 t ..
  const int c0 = n0 + wn * WN + 16 * t;
  if (c0 >= a.N) return;
  float wsv[16];
  int32_t bv[16];
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(wsc + c0 + i));
    wsv[i] = f.x, wsv[i + 1] = f.y, wsv[i + 2] = f.z, wsv[i + 3] = f.w;
    const int4 b4 = a.bias != nullptr ? __ldg(reinterpret_cast<const int4*>(a.bias + c0 + i))
                                      : make_int4(0, 0, 0, 0);
    bv[i] = b4.x, bv[i + 1] = b4.y, bv[i + 2] = b4.z, bv[i + 3] = b4.w;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = m0 + g + 8 * hr;
    if (r >= a.M) continue;
    const float xsr = a.xs[r];
    float o[16];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * e + jn;
        o[c] = Epi::apply(acc[4 * jn + 2 * hr + e], bv[c], wsv[c], xsr);
      }
    const size_t off = (size_t)r * a.N + c0;
    if (a.out_f32) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(a.out) + off);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
    } else {
      uint32_t pk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pk[i] = pack(o[2 * i], o[2 * i + 1]);
      uint4* dst = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) + off);
      dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
  }
}

// ------------------------------------------------- M > 32: int8 wgmma

// A block of 128 rows x 256 columns: a producer warpgroup and two consumer
// warpgroups of 64 rows, stages of 128 K bytes. One producer thread loads
// the raw weight tile by TMA (32 KB a stage, a ring of 3), another the x
// rows (16 KB, a ring of 3): the weight ring refills as soon as a stage is
// transposed, the x ring once its wgmma is done. (With cp.async from 64
// producer threads, K1's wo unsplit on 16 SMs took 1.5x as long, and its
// 672-row prefill 1.4x: PERF.md.)
// Per stage the consumers transpose the N-major weight tile into the
// K-major, 128-byte swizzled layout that wgmma's 8-bit B operand needs (two
// buffers), half each, then each runs four wgmma m64n256k32 on its 64 x
// rows while the next stage is transposed.
//
// The weight map views a layer's bank as [panel][k / 16][k % 16][n] with
// k % 16 the outer of the two k dimensions of a box (box {128 n, 8 k / 16,
// 16 k % 16, 1 panel}, two boxes a stage): raw k-row r = 16 kc + i of a
// 128-column half lands on 128-byte line kc + 8 i, its 16-byte chunk c at
// c ^ kc (the 128-byte swizzle), so the transposer's reads, eight k-rows
// 16 apart from eight lanes, hit distinct banks. The x map is [m][k] with
// boxes of 128 rows x 128 bytes, the K-major swizzled layout wgmma reads.
constexpr int W_BK = 128;
constexpr int W_BM = 128;
constexpr int W_RAW = 3;               // raw weight stages
constexpr int W_X = 3;                 // x stages
constexpr int W_BKBUF = 2;             // transposed weight buffers
constexpr int W_THREADS = 384;
constexpr int W_HALF = W_BK * BN / 2;  // bytes of a 128-column half of a raw stage
// the rings, which the epilogue reuses once the loop is done: the staged
// output tile from their start, the tile's column scales and biases in their
// last 2 KB
constexpr int W_RINGS = (W_BKBUF * BN + W_X * W_BM + W_RAW * BN) * W_BK;
constexpr int W_SCALES = W_RINGS - 2 * BN * 4;
// the last split's merge: 32 KB chunks of the others' partials (8 int4 a
// consumer thread) by bulk copy into the idle rings, up to 6 in flight
constexpr int M_CQ = 8;
constexpr int M_CHUNK = M_CQ * 256 * 16;
constexpr int M_SLOTS = W_SCALES / M_CHUNK < 6 ? W_SCALES / M_CHUNK : 6;

struct alignas(1024) WgSmem {
  int8_t bk[W_BKBUF][BN * W_BK];       // [n][k] weights, 128-byte swizzled rows
  int8_t x[W_X][W_BM * W_BK];          // [m][k] x rows, 128-byte swizzled
  int8_t raw[W_RAW][W_BK * BN];        // two halves of [k][128 n] weight lines as loaded
  uint64_t wfull[W_RAW], wempty[W_RAW], xfull[W_X], xempty[W_X], mfull[M_SLOTS];
  int last;
};
constexpr size_t W_SMEM = sizeof(WgSmem) + 1024;   // + alignment slack
static_assert(W_RINGS == sizeof(WgSmem::bk) + sizeof(WgSmem::x) + sizeof(WgSmem::raw),
              "the rings are contiguous");
static_assert(W_BM * (BN * 4 + 16) <= W_SCALES, "the staged f32 tile leaves the scales be");

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The last split adds the others' 128 KB partials: bulk copies of 32 KB
// chunks into the idle rings (M_SLOTS in flight, issued by consumer thread
// 0), each thread adding its own int4s; eight loads a thread in flight held
// this merge to some 50 GB/s (PERF.md).
__device__ __forceinline__ void add_splits_bulk(const Args& a, int ct, int32_t (&acc)[128],
                                                unsigned char* slots, uint64_t* bars) {
  constexpr int NQ = 32, NCT = 256, PER = NQ / M_CQ;   // chunks a partial
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int4* base = a.part + (size_t)tile * a.splits * NQ * NCT;
  const int nch = (a.splits - 1) * PER;
  auto issue = [&](int c) {
    const int s = c / PER + (c / PER >= (int)blockIdx.z);   // the others, in order
    const int slot = c % M_SLOTS;
    mbar_expect_tx(&bars[slot], M_CHUNK);
    bulk_load(slots + slot * M_CHUNK, base + ((size_t)s * NQ + (c % PER) * M_CQ) * NCT, M_CHUNK,
              &bars[slot]);
  };
  if (ct == 0) {
    // the partials were written by other blocks' generic stores
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int c = 0; c < nch && c < M_SLOTS; ++c) issue(c);
  }
  for (int s2 = 0; s2 < a.splits - 1; ++s2) {
#pragma unroll
    for (int cq = 0; cq < PER; ++cq) {
      const int c = s2 * PER + cq;
      mbar_wait(&bars[c % M_SLOTS], (c / M_SLOTS) & 1);
      const int4* v = reinterpret_cast<const int4*>(slots + (c % M_SLOTS) * M_CHUNK) + ct;
#pragma unroll
      for (int i = 0; i < M_CQ; ++i) {
        const int4 u = v[i * NCT];
        const int q = cq * M_CQ + i;
        acc[4 * q] += u.x;
        acc[4 * q + 1] += u.y;
        acc[4 * q + 2] += u.z;
        acc[4 * q + 3] += u.w;
      }
      bar_sync(1, NCT);                          // the slot is read
      if (ct == 0 && c + M_SLOTS < nch) issue(c + M_SLOTS);
    }
  }
  if (ct == 0) a.arrivals[tile] = 0;           // ready for the next call
}

// The barriers of the rings, by thread 0 before the block's first barrier.
__device__ __forceinline__ void init_rings(WgSmem& sm) {
#pragma unroll
  for (int st = 0; st < W_RAW; ++st) {
    mbar_init(&sm.wfull[st], 1);                 // the loading thread's expect_tx
    mbar_init(&sm.wempty[st], 8);                // one per consumer warp
  }
#pragma unroll
  for (int st = 0; st < W_X; ++st) {
    mbar_init(&sm.xfull[st], 1);
    mbar_init(&sm.xempty[st], 8);
  }
#pragma unroll
  for (int st = 0; st < M_SLOTS; ++st) mbar_init(&sm.mfull[st], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The weight producer of one tile (one thread): K stages kb .. kb + nk - 1
// of the 256 columns from n0 into the raw ring, w0 stages having gone
// through the ring before them, each stage two 128-column boxes, each in
// the panel of its first column (plus panel0: K8's expert); columns past N
// and rows past K come as zeros.
__device__ __forceinline__ void produce_weights(WgSmem& sm, const CUtensorMap* wmap, uint32_t w0,
                                                int nk, int kb, int n0, int N, int bn,
                                                int panel0) {
  for (int j = 0; j < nk; ++j) {
    const uint32_t s = w0 + j;
    const int st = s % W_RAW;
    if (s >= W_RAW) mbar_wait(&sm.wempty[st], ((s / W_RAW) - 1) & 1);
    mbar_expect_tx(&sm.wfull[st], 2 * W_HALF);
    const int khi = (kb + j) * (W_BK / 16);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a box past N reads past the last panel's columns: zeros
      const int col = n0 + 128 * h, panel = min(col / bn, N / bn - 1);
      tma_load_4d(sm.raw[st] + h * W_HALF, wmap, &sm.wfull[st], col - panel * bn, khi, 0,
                  panel0 + panel);
    }
  }
}

// The consumers' loop over one 128 x 256 tile (the 256 consumer threads,
// ct = 0 .. 255): nk K stages through the rings, w0 weight and x0 x stages
// having gone through them before; the sums into d. Every wgmma is done on
// return, and every x stage but the last released.
__device__ __forceinline__ void consume_tile(WgSmem& sm, uint32_t w0, uint32_t x0, int nk,
                                             int ct, int32_t (&d)[128]) {
  const int cw = ct / 128;                       // rows 64 cw .. of the tile
  const int warp = ct / 32, lane = ct % 32;
  // transposer: thread (kc, nh, nb) turns k-rows 16 kc .. + 15 of the 8
  // columns at 16 nb + 8 nh into eight 16-byte K-major chunks
  const int kc = lane & 7, nh = (lane >> 3) & 1, nb = 2 * warp + (lane >> 4);
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  // the wgmma descriptors of x stage 0 (this warpgroup's 64 rows) and of
  // transposed buffer 0; the stages follow each other in shared memory, and
  // the descriptor of an address 16 b further on is this one plus b (no
  // carry: shared addresses stay below 2^18)
  const uint64_t dx0 = sw128_desc(smem_u32(sm.x[0]) + cw * 64 * W_BK, 16, 1024);
  const uint64_t db0 = sw128_desc(smem_u32(sm.bk[0]), 16, 1024);
  for (int j = 0; j < nk; ++j) {
    const uint32_t ws = w0 + j, xs = x0 + j;
    const int wst = ws % W_RAW, xst = xs % W_X;
    int8_t* bk = sm.bk[j % W_BKBUF];
    // bk was last read by wgmma j - 2, done in both warpgroups before the
    // second barrier of stage j - 1 (or by the tile before, all done)
    mbar_wait(&sm.wfull[wst], (ws / W_RAW) & 1);
    {
      uint32_t w[16][2];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        // k-row 16 kc + i of column chunk nb: line kc + 8 i of half nb / 8
        const uint2 v = *reinterpret_cast<const uint2*>(
            sm.raw[wst] + (nb >> 3) * W_HALF + (kc + 8 * i) * 128 + 16 * ((nb & 7) ^ kc) + 8 * nh);
        w[i][0] = v.x;
        w[i][1] = v.y;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.wempty[wst]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t o[4][4];                        // [k group][column]
#pragma unroll
        for (int kg = 0; kg < 4; ++kg) {
          const uint32_t in[4] = {w[4 * kg][q], w[4 * kg + 1][q], w[4 * kg + 2][q],
                                  w[4 * kg + 3][q]};
          transpose4x4(in, o[kg]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = 16 * nb + 8 * nh + 4 * q + c;
          *reinterpret_cast<uint4*>(bk + n * W_BK + 16 * (kc ^ (n & 7))) =
              make_uint4(o[0][c], o[1][c], o[2][c], o[3][c]);
        }
      }
    }
    // the transposed rows are generic-proxy writes, which wgmma reads
    // through the async proxy (the x rows came by TMA, in that proxy)
    mbar_wait(&sm.xfull[xst], (xs / W_X) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1, 256);                            // both halves of bk written
    wg_fence();
    const uint64_t da = dx0 + (uint64_t)xst * (W_BM * W_BK / 16);
    const uint64_t db = db0 + (uint64_t)(j % W_BKBUF) * (BN * W_BK / 16);
#pragma unroll
    for (int kk = 0; kk < W_BK / 32; ++kk)
      wgmma_s8(d, da + 2 * kk, db + 2 * kk);
    wg_commit();
    // wgmma j - 1 is done (its x stage is free, and after the barrier its
    // bk buffer in both warpgroups); wgmma j runs on under the next stage's
    // transpose
    wg_wait<1>();
    if (j >= 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.xempty[(xs - 1) % W_X]);
    }
    bar_sync(2, 256);
  }
  wg_wait<0>();
  reg_fence_i(d);
}

// The consumers' epilogue of one 128 x 256 tile in Epi's order: d[4 j + e]
// is row 16 w + g (+ 8 for e >= 2) of this warpgroup, columns 8 j + 2 t
// (+ 1); xs0 / xs1 are the x scales of rows g and g + 8 of this thread's
// 16, my_ws and my_bias the scale and bias of column ct. The tile goes
// through shared memory (the rings are idle: every stage was waited for,
// and after the barrier no wgmma reads them) so that its rows leave in
// 16-byte stores; stored from the fragments directly, its 4-byte pieces
// took 8 us of K2's w13's 62 (scripts/probe_rmsq_split.py). Row r < rows
// of the tile (its first `cols` columns, f32 or bf16) goes to row_dst(r),
// or nowhere where that is null.
template <class Epi, class RowDst>
__device__ __forceinline__ void store_tile(WgSmem& sm, int ct, const int32_t (&d)[128],
                                           float my_ws, int32_t my_bias, float xs0, float xs1,
                                           bool f32, int rows, int cols, RowDst row_dst) {
  const int lane = ct % 32, g = lane >> 2, t = lane & 3;
  const int lr = 64 * (ct / 128) + 16 * ((ct / 32) % 4) + g;   // row g of this thread's 16
  bar_sync(1, 256);
  unsigned char* ot = reinterpret_cast<unsigned char*>(sm.bk);
  float* wsv = reinterpret_cast<float*>(ot + W_SCALES);
  int32_t* bsv = reinterpret_cast<int32_t*>(wsv + BN);
  wsv[ct] = my_ws;
  bsv[ct] = my_bias;
  bar_sync(1, 256);
  const int esz = f32 ? 4 : 2;
  const int orow = BN * esz + 16;                // bytes of a staged row
#pragma unroll
  for (int jn = 0; jn < 32; ++jn) {
    const int cl = 8 * jn + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float xsr = hr ? xs1 : xs0;
      const float v0 = Epi::apply(d[4 * jn + 2 * hr], bsv[cl], wsv[cl], xsr);
      const float v1 = Epi::apply(d[4 * jn + 2 * hr + 1], bsv[cl + 1], wsv[cl + 1], xsr);
      unsigned char* dst = ot + (lr + 8 * hr) * orow + cl * esz;
      if (f32)
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(dst) = pack(v0, v1);
    }
  }
  bar_sync(1, 256);
  const int chunks = cols * esz / 16;            // N % 16 == 0: whole chunks
  for (int i = ct; i < rows * chunks; i += 256) {
    const int r = i / chunks, c = i % chunks;
    unsigned char* dst = row_dst(r);
    if (dst == nullptr) continue;
    *reinterpret_cast<uint4*>(dst + 16 * c) =
        *reinterpret_cast<const uint4*>(ot + r * orow + 16 * c);
  }
}

template <class Epi>
__global__ void __launch_bounds__(W_THREADS, 1)
    int8_wgmma_gemm(const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap xmap, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic on the shared array, so that the compiler
  // keeps every access to `sm` a shared-memory one (through an integer
  // cast it fell back to generic loads)
  WgSmem& sm = *reinterpret_cast<WgSmem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  // the grid runs the row tiles fastest where there are several (see launch_gemm)
  const bool rows_fast = a.M > W_BM;
  const int m0 = (rows_fast ? blockIdx.x : 0) * W_BM;
  const int n0 = (rows_fast ? blockIdx.y : blockIdx.x) * BN;
  int kb, nk;
  split_range(a, W_BK, kb, nk);
  const int wg = threadIdx.x / 128;
  // the first panel and the column scales of the tile's layer (K8: its
  // expert, whose panels follow each other in the bank the map covers)
  int panel0 = 0;
  const float* wsc = a.wsc;
  if constexpr (Epi::grouped) {
    if (padding_tile<W_BM, W_THREADS>(a, m0, n0)) return;
    const int e = tile_expert(a, m0);
    panel0 = e * (a.N / a.bn);
    wsc += (size_t)e * a.N;
  }

  if (threadIdx.x == 0) init_rings(sm);
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 0) {
      produce_weights(sm, &wmap, 0, nk, kb, n0, a.N, a.bn, panel0);
    } else if (threadIdx.x == 32) {
      // x: rows past M and columns past K come as zeros
      for (int j = 0; j < nk; ++j) {
        const int st = j % W_X;
        if (j >= W_X) mbar_wait(&sm.xempty[st], ((j / W_X) - 1) & 1);
        mbar_expect_tx(&sm.xfull[st], W_BM * W_BK);
        tma_load_2d(sm.x[st], &xmap, &sm.xfull[st], (kb + j) * W_BK, m0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int ct = threadIdx.x - 128;              // consumer thread 0 .. 255
  const int lane = ct % 32;
  // the epilogue's scale and bias of column n0 + ct, read before any output
  // is written (a store through a.out could alias them, so the compiler
  // would otherwise issue each load after the last store, one latency at a
  // time) and kept in two registers until the rings are free
  const float my_ws = n0 + ct < a.N ? __ldg(wsc + n0 + ct) : 0.f;
  const int32_t my_bias = n0 + ct < a.N && a.bias != nullptr ? __ldg(a.bias + n0 + ct) : 0;
  const int r0 = m0 + 64 * (ct / 128) + 16 * ((ct / 32) % 4) + (lane >> 2);
  const float xs0 = r0 < a.M ? a.xs[r0] : 0.f, xs1 = r0 + 8 < a.M ? a.xs[r0 + 8] : 0.f;
  int32_t d[128];
  consume_tile(sm, 0, 0, nk, ct, d);

  if (a.splits > 1) {
    if (!arrive_last<256>(a, ct, d, &sm.last)) return;
    add_splits_bulk(a, ct, d, reinterpret_cast<unsigned char*>(sm.bk), sm.mfull);
  }

  const int esz = a.out_f32 ? 4 : 2;
  unsigned char* out = static_cast<unsigned char*>(a.out) + ((size_t)m0 * a.N + n0) * esz;
  store_tile<Epi>(sm, ct, d, my_ws, my_bias, xs0, xs1, a.out_f32, min(W_BM, a.M - m0),
                  min(BN, a.N - n0), [&](int r) { return out + (size_t)r * a.N * esz; });
}

// ------------------------------------------------------------- launch

// Whether the stage takes these operands with row tiles of bm and `splits`
// splits of K (the plan of ops/matmul.py::gemm_plan): K % 64 == 0, N % 16
// == 0, a bank of panels bn wide with bn % 16 == 0 and N % bn == 0 (bn == N
// for a plain [K, N] weight; at bm 128 the TMA boxes of 128 columns need bn
// % 128 == 0 or bn == N), bm 16 (M <= 32, or K8's row tiles of any block_m)
// or 128, 1 <= splits <= 16 and no
// more splits than K stages (64 bytes at bm 16, 128 above), and the
// partials and counters where splits > 1.
inline bool plan_ok(int M, int N, int K, int bn, int bm, int splits, const void* partials,
                    const void* arrivals, bool grouped = false) {
  const int ksteps = bm == 16 ? K / S_BK : (K + W_BK - 1) / W_BK;
  return bn > 0 && bn % 16 == 0 && N % bn == 0 && N % 16 == 0 && K % 64 == 0 &&
         (bm == 16 || (bm == W_BM && (bn % 128 == 0 || bn == N))) &&
         !(bm == 16 && M > 32 && !grouped) &&
         splits >= 1 && splits <= MAX_SPLITS && splits <= ksteps &&
         (splits == 1 || (partials != nullptr && arrivals != nullptr));
}

// The weight map of the wgmma stage: `panels` panels of [K, bn] bytes (a
// layer's N / bn; K8's bank G * N / bn, K11's experts) as [panel][K / 16]
// [16][bn] with boxes {128, 8, 16, 1} (k / 16 inner to k % 16 in the box,
// see above), 128-byte swizzle.
inline bool encode_wmap(CUtensorMap* map, const int8_t* w, int K, int bn, int panels) {
  const EncodeTiled f = encode_fn();
  if (f == nullptr) return false;
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const cuuint64_t dims[4] = {(cuuint64_t)bn, (cuuint64_t)K / 16, 16, (cuuint64_t)panels};
  const cuuint64_t str[3] = {(cuuint64_t)bn * 16, (cuuint64_t)bn, (cuuint64_t)bn * K};
  const cuuint32_t box[4] = {128, W_BK / 16, 16, 1};
  return f(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(w), dims, str, box, one,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma stage's tensor maps: the layer's bank (K8: the whole bank) and
// x [M][K] with boxes of 128 x 128 bytes, both with the 128-byte swizzle.
inline bool encode_maps(const Args& a, CUtensorMap* wmap, CUtensorMap* xmap) {
  const EncodeTiled f = encode_fn();
  if (f == nullptr) return false;
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M};
  const cuuint64_t xstr[1] = {(cuuint64_t)a.K};
  const cuuint32_t xbox[2] = {W_BK, W_BM};
  return encode_wmap(wmap, a.w, a.K, a.bn, (a.eid != nullptr ? a.groups : 1) * (a.N / a.bn)) &&
         f(xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(a.xq), xdims, xstr,
           xbox, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS;
}

// Launch the stage on `st`: a grid of (row tiles, column tiles, splits).
// With splits > 1, a.part holds tiles * splits * bm * 256 int32 and
// a.arrivals one counter per tile, zero before the first call.
template <class Epi>
cudaError_t launch_gemm(const Args& a, int bm, cudaStream_t st) {
  const int tiles_n = (a.N + BN - 1) / BN;
  cudaError_t e;
  if (bm == 16) {
    if ((e = skt::ensure_smem(int8_mma_gemm<Epi>, S_SMEM)) != cudaSuccess) return e;
    // several row tiles (M 17-32, or K8's): (row tiles, column tiles,
    // splits); one: (column tiles, 1, splits)
    const int tiles_m = (a.M + 15) / 16;
    const dim3 grid = tiles_m > 1 ? dim3(tiles_m, tiles_n, a.splits) : dim3(tiles_n, 1, a.splits);
    int8_mma_gemm<Epi><<<grid, S_THREADS, S_SMEM, st>>>(a);
  } else {
    CUtensorMap wmap{}, xmap{};
    if (!encode_maps(a, &wmap, &xmap)) return cudaErrorInvalidValue;
    if ((e = skt::ensure_smem(int8_wgmma_gemm<Epi>, W_SMEM)) != cudaSuccess) return e;
    // several row tiles: (row tiles, column tiles, splits), the row tiles of a
    // weight tile issued together; one: (column tiles, 1, splits)
    const int tiles_m = (a.M + W_BM - 1) / W_BM;
    const dim3 grid = tiles_m > 1 ? dim3(tiles_m, tiles_n, a.splits) : dim3(tiles_n, 1, a.splits);
    int8_wgmma_gemm<Epi><<<grid, W_THREADS, W_SMEM, st>>>(wmap, xmap, a);
  }
  return cudaGetLastError();
}

}  // namespace
