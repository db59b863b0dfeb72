// Kernel K21: soft-FP8 W8A16 GEMM, bf16 activations times fp8 e4m3 weights
// with f32 scales per 128 x 128 block, dense or grouped over a per-m-tile
// expert map.
//
// Replaces sgl_kernel_npu_tpu/ops/matmul.py::mm_wfp8a16_pallas
// (_wfp8a16_kernel, matmul.py:287-306) and gmm_wfp8a16_pallas_aligned
// (_gmm_wfp8a16_kernel, matmul.py:356-378): x [M, K] bf16, w [G, K, N] fp8
// e4m3 (row-major over N), scales [G, ceil(K/128), ceil(N/128)] f32, row
// tile i of block_m rows reads expert eid[i] (clamped to [0, G)); the dense
// GEMM is G = 1 with no map. out [M, N] bf16.
//
//   w16[k, n] = bf16( f32(w[e, k, n]) * ws[e, k / 128, n / 128] )
//   out[m, n] = bf16( sum_k f32(x[m, k]) * f32(w16[k, n]) )
//
// e4m3 -> f32 is exact (NaN codes stay NaN), the product is rounded once in
// f32 and once to bf16, as the TPU kernel dequantises each 128 x 128 block
// in VMEM; the sum runs on bf16 tensor cores (wgmma, f32 accumulation: bf16 x
// bf16 products are exact in f32), so it differs from the TPU kernel's f32
// sum of per-block partial sums only in the order of the f32 additions. K
// and N need not be multiples of 128: rows past K and columns past N are
// zero inside the tile, as _dequant_w_fp8_block pads, and nothing past the
// arrays is read.
//
// Bound on an H100: at decode widths (M 128) the fp8 weight bytes, K * N per
// expert read, over 3.35 TB/s (0.039 ms for DeepSeek-V3's gate_proj, 7168 x
// 18432); from M of about 600 up, 2 * M * K * N operations at the bf16
// tensor-core rate (1.09 ms at M 4096).
//
// Design: the transposed product out^T = w16^T . x^T, with the dequantised
// weights as wgmma's register A operand, so that each consumer warp turns
// the e4m3 bytes of the next stage into bf16 A fragments while its
// warpgroup's wgmma of this stage runs, and no bf16 weight tile is written
// to or read from shared memory. A block owns 128 weight columns (two
// consumer warpgroups of 64: wgmma's M) by TOK rows of x (64, 128 or 256:
// wgmma's N) and walks K in stages of 64 through a ring of shared memory:
//   * one producer thread loads each stage by TMA: the x tile (TOK x 64
//     bf16, 128-byte swizzle: the K-major B operand) and the raw weights
//     (64 x 128 bytes of one expert from a 3-D map [G, K, N], 128-byte
//     swizzle), completed on the stage's mbarrier; boxes past K, N or M
//     arrive as zeros. Where a row stride is not a multiple of 16 bytes, as
//     TMA needs, the producer warp writes the same layouts with cp.async (4
//     bytes a copy where rows are word-aligned) or plain loads: a second load
//     path in the kernel, not a fallback to the plain version;
//   * each consumer warp reads its 16 weight columns of a stage with
//     ldmatrix.trans (two byte columns a 16-bit element, so that a thread
//     holds columns 2g and 2g + 1: A's rows g and g + 8 stand for them),
//     converts them exactly to f32, multiplies by the stage's scale (64 rows
//     of K lie in one scale block) and packs bf16 A fragments; then
//     wgmma m64nTOKk16 runs four K steps asynchronously while the warp
//     prepares the next stage; one group stays queued behind the running
//     one, and a stage is freed once its group has retired (the fragments
//     of a group in flight are held live until then);
//   * the epilogue stages the tile through shared memory (transposing it
//     back to out's row-major layout) for whole-row 16-byte stores.
// setmaxnreg moves the producer's registers to the consumers. Tiles are
// rastered in groups of 8 row tiles, so that a wave's x and weight tiles stay
// in L2. With an expert map, a tile from row m_live on (the padding past the
// aligned groups) is written as zeros without reading weights, and a tile
// never spans two experts (below 64 rows an expert's tile steps by block_m
// and discards the rest). The tiles that fill whole waves of the card's SMs
// run unsplit; the tail (every tile, where there are fewer than the SMs)
// splits K over blocks, so that the last wave fills the card: f32 partial
// sums in a workspace, added in split order by a second kernel (a repeat
// gives the same bits).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int BN = 128;                   // weight columns per block: two warpgroups of 64
constexpr int BK = 64;                    // K per stage (half a scale block)
constexpr int SBLK = 128;                 // the scale block
constexpr int GROUP_M = 8;                // row tiles per raster group
constexpr int THREADS = 384;              // producer warpgroup + two consumer warpgroups
constexpr uint32_t ROW = 128;             // bytes of one swizzled row: 64 bf16 of x, 128 e4m3
constexpr uint32_t W_BYTES = BK * BN;     // raw e4m3 weights of a stage
constexpr int OUT_LD = BN + 8;            // bf16 per row of the epilogue's staging tile

// TOK rows of x per block
template <int TOK>
struct Cfg {
  static constexpr uint32_t X_BYTES = TOK * ROW;
  static constexpr uint32_t STAGE = X_BYTES + W_BYTES;
  static constexpr int STAGES = TOK == 256 ? 5 : (TOK == 128 ? 8 : 12);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert((size_t)TOK * OUT_LD * 2 <= (size_t)STAGES * STAGE, "staging tile fits the ring");
};

struct Args {
  const __nv_bfloat16* x;        // [M, K]
  const uint8_t* w;              // [G, K, N] e4m3 bytes
  const float* ws;               // [G, sk, sn]
  const int* eid;                // [M / block_m] or null
  const int* m_live;             // one int or null
  __nv_bfloat16* out;            // [M, N]
  float* part;                   // split tail: [splits, n_tail, TOK, BN] f32 partial sums
  int M, N, K, G, block_m, mstep, sk, sn, kchunk, tiles_m, tiles_n, n_full, n_tail, splits, tma;
};

// Tile pid of the raster: groups of GROUP_M row tiles walk every column tile
// in turn, so that a wave's x and weight tiles stay in L2.
__device__ __forceinline__ void tile_of(const Args& p, int pid, int& m0, int& n0) {
  const int group = pid / (GROUP_M * p.tiles_n);
  const int first = group * GROUP_M;
  const int gsize = min(p.tiles_m - first, GROUP_M);
  m0 = (first + (pid % (GROUP_M * p.tiles_n)) % gsize) * p.mstep;
  n0 = ((pid % (GROUP_M * p.tiles_n)) / gsize) * BN;
}

// 4 bytes of a row into shared memory: the `valid` bytes from src (0 to 4),
// zeros after. cp.async where whole words are aligned (`vec`: valid is 0 or
// 4), else byte loads; nothing is read past `valid`.
__device__ __forceinline__ void copy4(uint8_t* dst, const uint8_t* src, int valid, bool vec) {
  if (vec && valid == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
    return;
  }
  uint32_t v = 0;
  for (int i = 0; i < valid; ++i) v |= static_cast<uint32_t>(src[i]) << (8 * i);
  *reinterpret_cast<uint32_t*>(dst) = v;
}

// byte offset of byte `b` of row r in a tile of 128-byte rows, 128-byte swizzle
__device__ __forceinline__ uint32_t sw128(int r, int b) {
  return r * ROW + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (64 x TOK, f32) += A (64 x 16, registers) . B (16 x TOK, shared, K-major)
template <int TOK>
struct Wgmma;
#define SKT_WGMMA_RS(TOK, NACC, ACC, OUT, IA, IB, IC, ID, IDESC, IP)                       \
  template <>                                                                             \
  struct Wgmma<TOK> {                                                                     \
    static __device__ __forceinline__ void rs(float (&d)[NACC], const uint32_t (&a)[4],  \
                                              uint64_t b) {                               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"                      \
                   "wgmma.mma_async.sync.aligned.m64n" #TOK "k16.f32.bf16.bf16 " ACC     \
                   ", {%" #IA ", %" #IB ", %" #IC ", %" #ID "}, %" #IDESC ", p, 1, 1, 0;\n}\n" \
                   : OUT(d)                                                               \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));         \
    }                                                                                     \
  };
SKT_WGMMA_RS(64, 32, SKT_ACC32, SKT_OUT32, 32, 33, 34, 35, 36, 37)
SKT_WGMMA_RS(128, 64, SKT_ACC64, SKT_OUT64, 64, 65, 66, 67, 68, 69)
SKT_WGMMA_RS(256, 128, SKT_ACC128, SKT_OUT128, 128, 129, 130, 131, 132, 133)

// two e4m3 bytes (lo, hi) -> f32, exactly (through fp16, which holds every
// e4m3 value)
__device__ __forceinline__ float2 fp8x2_to_float2(uint16_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(v),
                                                   __NV_E4M3);
  return __half22float2(__half2(h));
}

// One register of ldmatrix.trans over the raw weights: bytes (k, 2g),
// (k, 2g + 1), (k + 1, 2g), (k + 1, 2g + 1). Returns A's row g (column 2g) and
// row g + 8 (column 2g + 1) as bf16 pairs over k, k + 1, times the scale.
__device__ __forceinline__ void dequant_pair(uint32_t r, float scale, uint32_t& even,
                                             uint32_t& odd) {
  const float2 k0 = fp8x2_to_float2(static_cast<uint16_t>(r));
  const float2 k1 = fp8x2_to_float2(static_cast<uint16_t>(r >> 16));
  const __nv_bfloat162 e = __floats2bfloat162_rn(__fmul_rn(k0.x, scale), __fmul_rn(k1.x, scale));
  const __nv_bfloat162 o = __floats2bfloat162_rn(__fmul_rn(k0.y, scale), __fmul_rn(k1.y, scale));
  even = *reinterpret_cast<const uint32_t*>(&e);
  odd = *reinterpret_cast<const uint32_t*>(&o);
}

// The A fragments of one stage for this warp's 16 weight columns: four K
// steps of 16, from two ldmatrix.x4.trans of the raw tile (matrices: rows
// 16 kk + 0..7 and 8..15 for kk and kk + 1; 16 bytes of each row).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t wraw, int chunk, int lane,
                                       float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = 32 * h + ((lane >> 3) & 1) * 8 + (lane >> 4) * 16 + (lane & 7);
    uint32_t r[4];
    ldsm_x4_t(r, wraw + k * ROW + (((chunk ^ k) & 7) << 4));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t* f = a[2 * h + j];
      dequant_pair(r[2 * j], scale, f[0], f[1]);
      dequant_pair(r[2 * j + 1], scale, f[2], f[3]);
    }
  }
}

template <int TOK>
__global__ void __launch_bounds__(THREADS, 1)
    wfp8a16_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const Args p) {
  using C = Cfg<TOK>;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::STAGE);  // x and raw w arrived
  uint64_t* empty = full + S;                                         // the MMAs retired

  // the work: tile blockIdx.x of the whole waves, or split z of a tail tile
  // (its partial sums to a tile of the workspace)
  int pid = blockIdx.x, z = 0;
  float* part = nullptr;
  if (pid >= p.n_full && p.splits > 1) {
    const int u = pid - p.n_full;
    pid = p.n_full + u / p.splits;
    z = u % p.splits;
    part = p.part + ((size_t)z * p.n_tail + (pid - p.n_full)) * TOK * BN;   // [TOK][BN]
  }
  int m0, n0;
  tile_of(p, pid, m0, n0);
  const int M = p.M, N = p.N, K = p.K;
  const int rows = min(p.mstep, M - m0);     // rows of x this block writes

  if (p.m_live != nullptr && m0 >= __ldg(p.m_live)) {
    // padding tiles past the aligned groups: zeros, no weights read
    for (int i = threadIdx.x; i < TOK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      if (part != nullptr)
        part[i] = 0.f;
      else if (r < rows && n0 + c < N)
        p.out[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16_rn(0.f);
    }
    return;
  }

  const int e = p.eid != nullptr ? min(max(p.eid[m0 / p.block_m], 0), p.G - 1) : 0;
  // this block's K range (a split: chunk z, a multiple of BK)
  const int kbeg = part != nullptr ? z * p.kchunk : 0;
  const int KT = ((part != nullptr ? min(K, kbeg + p.kchunk) : K) - kbeg + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], p.tma ? 1 : 32);
      mbar_init(&empty[s], 8);           // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (p.tma && threadIdx.x == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], ((kt / S) - 1) & 1);
        uint8_t* st = ring + s * C::STAGE;
        const int k0 = kbeg + kt * BK;
        mbar_expect_tx(&full[s], C::X_BYTES + W_BYTES);
        tma_load_2d(st, &xmap, &full[s], k0, m0);
        tma_load_3d(st + C::X_BYTES, &wmap, &full[s], n0, k0, e);
      }
    } else if (!p.tma && threadIdx.x < 32) {
      // the second load path: the same swizzled layouts by cp.async (4 bytes
      // a copy where rows are word-aligned) or plain loads, then the async
      // proxy fence that wgmma's reads of x need
      const int lane = threadIdx.x;
      const uint8_t* xb = reinterpret_cast<const uint8_t*>(p.x);
      const uint8_t* wb = p.w + (size_t)e * K * N;
      const bool xvec = K % 2 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 3) == 0;
      const bool wvec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(p.w) & 3) == 0;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], ((kt / S) - 1) & 1);
        uint8_t* st = ring + s * C::STAGE;
        const int k0 = kbeg + kt * BK;
        for (int v = lane; v < TOK * 32; v += 32) {         // x: words of 2 bf16
          const int r = v / 32, kw = v % 32, k = k0 + 2 * kw;
          const int valid = m0 + r < M ? 2 * max(0, min(2, K - k)) : 0;
          copy4(st + sw128(r, 4 * kw), xb + ((size_t)(m0 + r) * K + k) * 2, valid, xvec);
        }
        for (int v = lane; v < BK * 32; v += 32) {           // w: words of 4 bytes
          const int r = v / 32, n = n0 + 4 * (v % 32), k = k0 + r;
          const int valid = k < K ? max(0, min(4, N - n)) : 0;
          copy4(st + C::X_BYTES + sw128(r, 4 * (v % 32)), wb + (size_t)k * N + n, valid, wvec);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // consumers: weight columns n0 + 64 cw + 16 warp + (2g, 2g + 1) as A's
    // rows g and g + 8 of warp `warp`
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128, warp = (tid >> 5) & 3, lane = tid & 31;
    const int chunk = 4 * cw + warp;           // its 16-byte column of the raw rows
    const float* wsc = p.ws + (size_t)e * p.sk * p.sn + n0 / SBLK;
    float acc[TOK / 2];
#pragma unroll
    for (int i = 0; i < TOK / 2; ++i) acc[i] = 0.f;
    uint32_t a[3][4][4] = {};                  // A fragments of three stages

    // Stage kt, its fragments in `cur`: issue its four wgmmas behind the
    // group of stage kt - 1, then (while both run) wait for stage kt + 1 and
    // build its fragments in `nxt`; then retire the group of kt - 1 and free
    // that stage, whose fragments `prev` are held live until then. Every
    // wait precedes a wgmma.fence, so no wgmma group has a branch inside.
    auto stage = [&](int kt, uint32_t(&prev)[4][4], uint32_t(&cur)[4][4],
                     uint32_t(&nxt)[4][4]) {
      const uint32_t xs = smem_u32(ring + (kt % S) * C::STAGE);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<TOK>::rs(acc, cur[kk], sw128_desc(xs + kk * 32, 16, 1024));
      wg_commit();
      if (kt + 1 < KT) {
        const int s1 = (kt + 1) % S;
        const float scale = __ldg(wsc + (size_t)((kbeg + (kt + 1) * BK) / SBLK) * p.sn);
        mbar_wait(&full[s1], ((kt + 1) / S) & 1);
        load_a(nxt, smem_u32(ring + s1 * C::STAGE + C::X_BYTES), chunk, lane, scale);
      }
      wg_wait<1>();
      reg_fence(prev);
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
      }
    };

    mbar_wait(&full[0], 0);
    load_a(a[0], smem_u32(ring + C::X_BYTES), chunk, lane,
           __ldg(wsc + (size_t)(kbeg / SBLK) * p.sn));
    for (int kt = 0; kt < KT; kt += 3) {
      stage(kt, a[2], a[0], a[1]);
      if (kt + 1 < KT) stage(kt + 1, a[0], a[1], a[2]);
      if (kt + 2 < KT) stage(kt + 2, a[1], a[2], a[0]);
    }
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(a[0]);
    reg_fence(a[1]);
    reg_fence(a[2]);

    // Epilogue. D's row g / g + 8 of this warp is column 2g / 2g + 1 of its
    // 16; its columns are rows of x: acc[4j + q] holds row 8j + 2t + (q & 1)
    // of x (t = lane & 3), column 2g + (q >> 1).
    const int g = lane >> 2, t = lane & 3;
    const int col = 64 * cw + 16 * warp + 2 * g;          // within the block's 128
    asm volatile("bar.sync 1, 256;\n" ::: "memory");       // both warpgroups left the ring
    if (part != nullptr) {
#pragma unroll
      for (int j = 0; j < TOK / 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          *reinterpret_cast<float2*>(part + (8 * j + 2 * t + q) * BN + col) =
              make_float2(acc[4 * j + q], acc[4 * j + 2 + q]);
      return;
    }
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);   // [TOK][OUT_LD]
#pragma unroll
    for (int j = 0; j < TOK / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        *reinterpret_cast<__nv_bfloat162*>(tile + (8 * j + 2 * t + q) * OUT_LD + col) =
            __floats2bfloat162_rn(acc[4 * j + q], acc[4 * j + 2 + q]);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const bool vec = N % 8 == 0;
    for (int i = tid; i < rows * (BN / 8); i += 256) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const __nv_bfloat16* src = tile + r * OUT_LD + c;
      __nv_bfloat16* dst = p.out + (size_t)(m0 + r) * N + n0 + c;
      if (vec && n0 + c + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int u = 0; u < 8 && n0 + c + u < N; ++u) dst[u] = src[u];
      }
    }
  }
}

// The split tail: out = bf16(sum over the splits of the f32 partial sums),
// in split order, so a repeat gives the same bits; one thread a value of a
// TOK x BN tail tile.
template <int TOK>
__global__ void wfp8a16_reduce(const Args p) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t tile_vals = (size_t)TOK * BN, mn = (size_t)p.n_tail * tile_vals;
  if (i >= mn) return;
  int m0, n0;
  tile_of(p, p.n_full + (int)(i / tile_vals), m0, n0);
  const int r = (int)(i % tile_vals) / BN, c = (int)(i % BN);
  if (r >= min(p.mstep, p.M - m0) || n0 + c >= p.N) return;
  float s = p.part[i];
  for (int z = 1; z < p.splits; ++z) s += p.part[z * mn + i];
  p.out[(size_t)(m0 + r) * p.N + n0 + c] = __float2bfloat16_rn(s);
}

// x [M, K] bf16: boxes of 64 columns x tok rows; w [G, K, N] bytes: boxes of
// 128 columns x 64 rows of one expert; both with the 128-byte swizzle.
bool encode_maps(const Args& p, int tok, CUtensorMap* xmap, CUtensorMap* wmap) {
  const EncodeTiled f = encode_fn();
  if (f == nullptr) return false;
  const cuuint32_t one[3] = {1, 1, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
  const cuuint64_t xstr[1] = {(cuuint64_t)p.K * 2};
  const cuuint32_t xbox[2] = {(cuuint32_t)BK, (cuuint32_t)tok};
  const cuuint64_t wdims[3] = {(cuuint64_t)p.N, (cuuint64_t)p.K, (cuuint64_t)p.G};
  const cuuint64_t wstr[2] = {(cuuint64_t)p.N, (cuuint64_t)p.K * p.N};
  const cuuint32_t wbox[3] = {(cuuint32_t)BN, (cuuint32_t)BK, 1};
  return f(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(p.x), xdims,
           xstr, xbox, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS &&
         f(wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<uint8_t*>(p.w), wdims, wstr, wbox,
           one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS;
}

template <int TOK>
cudaError_t launch(Args p, cudaStream_t st) {
  using C = Cfg<TOK>;
  auto kern = wfp8a16_kernel<TOK>;
  CUtensorMap xmap{}, wmap{};
  // TMA needs 16-byte-aligned bases and row strides
  p.tma = p.K % 8 == 0 && p.N % 16 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(p.w) & 15) == 0;
  if (p.tma && !encode_maps(p, TOK, &xmap, &wmap)) return cudaErrorInvalidValue;
  cudaError_t e = skt::ensure_smem(kern, C::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<p.n_full + p.n_tail * p.splits, THREADS, C::SMEM, st>>>(xmap, wmap, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const size_t mn = (size_t)p.n_tail * TOK * BN;
  wfp8a16_reduce<TOK><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(p);
  return cudaGetLastError();
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

int run(const void* x, const void* w, const void* ws, const void* eid, const void* m_live,
        void* out, void* workspace, int M, int N, int K, int G, int block_m, int bm, int splits,
        void* stream) {
  if (M < 0 || N < 0 || K <= 0 || G <= 0 || (bm != 64 && bm != 128 && bm != 256) ||
      splits < 1 || (splits > 1 && workspace == nullptr) ||
      (eid != nullptr && (block_m <= 0 || block_m % 32 || M % block_m)))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  Args p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.ws = static_cast<const float*>(ws);
  p.eid = static_cast<const int*>(eid);
  p.m_live = static_cast<const int*>(m_live);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.G = G;
  p.block_m = block_m;
  // a grouped tile never spans two experts' rows
  p.mstep = eid != nullptr ? gcd(block_m, bm) : bm;
  p.sk = (K + SBLK - 1) / SBLK;
  p.sn = (N + SBLK - 1) / SBLK;
  p.tiles_m = (M + p.mstep - 1) / p.mstep;
  p.tiles_n = (N + BN - 1) / BN;
  // the tiles of whole waves of the card run unsplit; the tail (every tile
  // where there are fewer than the SMs) splits K in chunks of whole stages,
  // the last of which may be short
  int sms = 0;
  const cudaError_t e = skt::sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const int tiles = p.tiles_m * p.tiles_n;
  p.n_tail = tiles >= sms ? tiles % sms : tiles;
  p.n_full = tiles - p.n_tail;
  p.kchunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  p.splits = p.n_tail > 0 ? (K + p.kchunk - 1) / p.kchunk : 1;
  p.part = static_cast<float*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 256: return (int)launch<256>(p, st);
    case 128: return (int)launch<128>(p, st);
    default: return (int)launch<64>(p, st);
  }
}

}  // namespace

// Dense: x [M, K] bf16, w [K, N] e4m3, ws [ceil(K/128), ceil(N/128)] f32,
// out [M, N] bf16 (eid, m_live null, G 1; block_m unused). bm: the row tile,
// 64, 128 or 256. The tiles past the card's whole waves (all of them where
// there are fewer tiles than SMs: n_tail) split K `splits` ways; splits > 1
// needs workspace, [splits, n_tail, bm, 128] f32.
extern "C" int skt_wfp8a16_gemm(const void* x, const void* w, const void* ws, const void* eid,
                                const void* m_live, void* out, void* workspace, int M, int N,
                                int K, int G, int block_m, int bm, int splits, void* stream) {
  if (eid != nullptr || m_live != nullptr || G != 1) return (int)cudaErrorInvalidValue;
  return run(x, w, ws, nullptr, nullptr, out, workspace, M, N, K, 1, block_m, bm, splits,
             stream);
}

// Grouped: w [G, K, N], ws [G, ceil(K/128), ceil(N/128)], eid [M / block_m]
// int32 (block_m a multiple of 32, M of block_m), m_live null or one int32.
// A row tile of bm rows steps by gcd(block_m, bm).
extern "C" int skt_wfp8a16_gemm_grouped(const void* x, const void* w, const void* ws,
                                        const void* eid, const void* m_live, void* out,
                                        void* workspace, int M, int N, int K, int G,
                                        int block_m, int bm, int splits, void* stream) {
  if (eid == nullptr) return (int)cudaErrorInvalidValue;
  return run(x, w, ws, eid, m_live, out, workspace, M, N, K, G, block_m, bm, splits, stream);
}

extern "C" const char* skt_wfp8a16_gemm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
