// Kernel K17: laser attention, a flash forward over dense [B, H, T, D]
// tensors on the tensor cores, causal or not, GQA read in place.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/prefill.py::laser_attention_pallas
// (_flash_kernel, prefill.py:42-110; the wrapper prefill.py:113 repeats K and
// V to Hq heads first, K17 reads kv head h / G where it is). q [B, Hq, T, D],
// k [B, Hkv, T, D], v [B, Hkv, T, Dv], out [B, Hq, T, Dv], all bf16 or all
// fp16. The kernel is instantiated at four tiles (Dp, Dvp): (64, 64), (128,
// 128), (192, 128) (DeepSeek-V3's MLA prefill in its MHA form), (256, 256).
// Routes (ops/attention/prefill.py::laser_route and laser_tile pick):
//   * (D, Dv) one of the four: the exact instantiation (PAD false);
//   * any other D and Dv that are multiples of 8 up to 256 (Phi-2's 80,
//     Phi-3's 96, (128, 64)): the padded instantiation (PAD true) of the
//     tile with the least Dp + Dvp that holds both. Its TMA maps have the
//     real widths, so columns past D and Dv arrive as zeros (the same
//     out-of-bounds fill that gives the rows past T); a box wholly past the
//     width is not loaded, and its shared memory is zeroed once. The score
//     products over zero columns add exact zeros and P . V's columns past
//     Dv are never stored, so the result is that of the real widths; the
//     work is the tile's: (Dp + Dvp) / (D + Dv) of the real widths' bound
//     (D 96 -> (128, 128): 4 / 3; D 80: 8 / 5). TMA needs 16-byte row
//     strides, hence the multiples of 8;
//   * every other width up to 256, and f32 inputs: the split-TF32 kernel
//     csrc/laser_attention_general.cu.
// PAD is a template parameter, not a run-time branch, so the four exact
// instantiations keep their machine code (a run-time choice in a kernel's
// loop cost K3 3.6%).
//
// Rounding, as the TPU kernel takes it (its dots and p are f32): per kv tile,
// s = (q . k) * sm_scale, -1e30 where masked (causal: row < column; and every
// column >= T, which the TPU kernel leaves in and reads past the end:
// prefill.py's fault at a T that is not a multiple of its block);
// m = max(m, rowmax(s)), alpha = exp(m_old - m), p = exp(s - m),
// l = l * alpha + rowsum(p) over the f32 p, acc = acc * alpha + p . v;
// out = acc / max(l, 1e-37) in the input type. The kernel takes the scores in
// base 2 (s * sm_scale * log2(e), then exp2), the same function up to f32
// rounding. The score product runs on tensor cores with f32 accumulation:
// bf16 x bf16 and fp16 x fp16 products are exact in f32, so it differs from
// an f32 dot only in the order of the sums. P . V keeps p in f32 to 16 bits
// (bf16) or 22 bits (fp16): p is split into hi = elt(p) and lo = elt(p - hi)
// in the input type, and P . V = hi . V + lo . V, two MMAs with f32
// accumulation (bf16: |p - hi - lo| <= 2^-16 p; fp16: 2^-22 p, and below
// fp16's normal range 2^-25 absolute). Against the plain version
// (ops/attention/prefill.py::laser_attention_blocked_ref, all f32 in blocks
// of 256) the output differs by that and the order of f32 sums: within one
// ulp of the output type plus 1e-4 of max|out|.
//
// Bound on an H100: operations, 2 * (D + Dv) per (query row, visible key)
// per head: 5.50e11 at T = 8192 causal with 32 query heads of 128, 0.556 ms
// at the bf16 / fp16 tensor-core rate; K17 spends 1.5 times that in MMAs
// (the split P . V), and a padded tile (Dp + Dvp) / (D + Dv) times more.
// Design, the shape Hopper's tensor cores want: a block takes 128 query rows
// of one head; one producer thread streams Q once and K and V tiles of BN
// rows through a ring of two shared-memory stages by TMA (3-D tensor maps
// [B*H, T, D] and [B*H, T, Dv], so rows >= T arrive as zeros, never as the
// next head's; 128-byte swizzle, Dp / 64 boxes of 64 columns a Q or K tile,
// Dvp / 64 a V tile), each completed on an mbarrier. Two consumer warpgroups
// of 64 query rows run S = Q . K^T as wgmma with both operands in shared
// memory, mask (only on the diagonal or ragged tile), softmax in registers
// with quad shuffles, then O += P . V as wgmma with P from registers and V
// the MN-major operand (transposed by the instruction), and free the stage
// on an mbarrier. The two warpgroups take turns at the tensor cores (named
// barriers): a turn issues P . V of tile j - 1 and S of tile j, so one
// warpgroup's softmax runs while the other's MMAs do. setmaxnreg moves the
// producer's registers to the consumers. Causal grids start with the longest
// (last) query tiles.
// Sizes per instantiation (a consumer thread holds Dvp / 2 floats of O, BN / 2
// of S and BN / 2 registers of P's two parts; shared memory is Q + two
// stages of K and V):
//   (64, 64)    BN 128: 32 + 64 + 64 registers, 80 KB
//   (128, 128)  BN 128: 64 + 64 + 64, 160 KB
//   (192, 128)  BN 128: 64 + 64 + 64, 208 KB (K's tiles 48 KB, V's 32 KB)
//   (256, 256)  BN 64: 128 + 32 + 32, 192 KB. At BN 128 two stages of K and
//               V would take 256 KB beside Q's 64 KB, over the 227 KB a
//               block may use, and a thread's O (128 floats), S (64) and P
//               (64) would pass the 232 registers setmaxnreg gives it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128;                // query rows per block: two warpgroups of 64
constexpr int STAGES = 2;
constexpr int THREADS = 384;           // producer warpgroup + two consumer warpgroups
constexpr int HALF = 64;               // 16-bit columns of one 128-byte swizzle atom
constexpr uint32_t ROW_BYTES = 128;    // one row of a 64-column half
constexpr float NEG = -1e30f;

// ------------------------------------------------ wgmma of either type

// d (64 x N, f32) = or += A (64 x 16) . B (16 x N): ss with A and B in shared
// memory (K-major), rs with A from registers and B MN-major
template <int N, typename T>
struct Mma;
#define SKT_LASER_MMA(N, NACC, ACC, OUT, TY, SA, SB, SP, RA, RB, RC, RD, RDESC, RP)            \
  template <>                                                                                \
  struct Mma<N, TY##_t> {                                                                    \
    static __device__ __forceinline__ void ss(float (&d)[NACC], uint64_t a, uint64_t b,      \
                                              int accumulate) {                              \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SP ", 0;\n"                         \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." #TY "." #TY " " ACC     \
                   ", %" #SA ", %" #SB ", p, 1, 1, 0, 0;\n}\n"                               \
                   : OUT(d)                                                                  \
                   : "l"(a), "l"(b), "r"(accumulate));                                       \
    }                                                                                        \
    static __device__ __forceinline__ void rs(float (&d)[NACC], const uint32_t (&a)[4],     \
                                              uint64_t b, int accumulate = 1) {              \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #RP ", 0;\n"                         \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." #TY "." #TY " " ACC     \
                   ", {%" #RA ", %" #RB ", %" #RC ", %" #RD "}, %" #RDESC ", p, 1, 1, 1;\n}\n" \
                   : OUT(d)                                                                  \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));   \
    }                                                                                        \
  };
using bf16_t = __nv_bfloat16;
using f16_t = __half;
SKT_LASER_MMA(64, 32, SKT_ACC32, SKT_OUT32, bf16, 32, 33, 34, 32, 33, 34, 35, 36, 37)
SKT_LASER_MMA(128, 64, SKT_ACC64, SKT_OUT64, bf16, 64, 65, 66, 64, 65, 66, 67, 68, 69)
SKT_LASER_MMA(256, 128, SKT_ACC128, SKT_OUT128, bf16, 128, 129, 130, 128, 129, 130, 131, 132,
              133)
SKT_LASER_MMA(64, 32, SKT_ACC32, SKT_OUT32, f16, 32, 33, 34, 32, 33, 34, 35, 36, 37)
SKT_LASER_MMA(128, 64, SKT_ACC64, SKT_OUT64, f16, 64, 65, 66, 64, 65, 66, 67, 68, 69)
SKT_LASER_MMA(256, 128, SKT_ACC128, SKT_OUT128, f16, 128, 129, 130, 128, 129, 130, 131, 132,
              133)
#undef SKT_LASER_MMA

// the two parts of two f32 values in the input type, each pair packed as an
// A-fragment register (bf16: hopper.cuh's split)
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t (&part)[2]) {
  if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __half2 h = __floats2half2_rn(x, y);
      part[i] = *reinterpret_cast<const uint32_t*>(&h);
      const float2 hf = __half22float2(h);
      x -= hf.x;
      y -= hf.y;
    }
  } else {
    split<2>(x, y, part);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack_out(float x, float y) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <int D, int DV, typename T>
struct Cfg {
  // kv rows per tile: 64 where O is 256 wide (the header's sizes)
  static constexpr int BN = DV > 128 ? 64 : 128;
  static constexpr int QH = D / HALF;           // 64-column halves of a Q or K row
  static constexpr int VH = DV / HALF;          // of a V row
  static constexpr int NS = BN / 2;             // S accumulators of a consumer thread
  static constexpr int NO = DV / 2;             // O accumulators
  static constexpr int KS = BN / 16;            // k-steps of P . V
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t K_BYTES = BN * D * 2;
  static constexpr uint32_t V_BYTES = BN * DV * 2;
  static_assert(D % HALF == 0 && DV % HALF == 0, "widths of whole 64-column halves");
};

template <int D, int DV, typename T>
struct alignas(1024) Smem {
  using C = Cfg<D, DV, T>;
  T q[C::QH][BM * HALF];                        // [half][row][64], swizzled rows
  T k[STAGES][C::QH][C::BN * HALF];
  T v[STAGES][C::VH][C::BN * HALF];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

// s (64 x BN) = Q (this warpgroup's 64 rows) . K^T of one stage, issued; Q
// and K tiles of BM and BN rows of D values as D / 64 halves of 128-byte
// swizzled rows
template <int D, int BN, typename T>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<BN, T>::ss(sc, sw128_desc(qa + (kk / 4) * (BM * 128) + (kk % 4) * 32, 16, 1024),
                   sw128_desc(kb + (kk / 4) * (BN * 128) + (kk % 4) * 32, 16, 1024), kk > 0);
}

// o += P . V of one stage (BN keys), P as its two parts, issued. V is the
// MN-major B operand: 64-column halves BN rows apart, 8-row groups 1 KB apart.
template <int DV, int BN, typename T>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], const uint32_t (&pf)[2][BN / 16][4],
                                         uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t vd = sw128_desc(vb + kk * 16 * 128, BN * 128, 1024);
#pragma unroll
    for (int i = 0; i < 2; ++i) Mma<DV, T>::rs(o, pf[i][kk], vd);
  }
}

// The online softmax of one tile of scores (base 2): mask where `edge`,
// then update m, this thread's part of l, rescale o and leave p as the A
// fragments of its two parts (hopper.cuh's softmax_core at these widths)
template <int NS, int NO, typename T>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&o)[NO], float (&m)[2],
                                             float (&l)[2], uint32_t (&pf)[2][NS / 8][4],
                                             bool edge, int c0, int row0, int tig, int T_,
                                             int causal, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = c0 + (i / 4) * 8 + 2 * tig + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      const bool keep = col < T_ && (!causal || row >= col);
      sc[i] = keep ? sc[i] * scale_log2 : NEG;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] *= scale_log2;
  }
  float mx[2] = {-1e30f, -1e30f};
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = ex2(sc[8 * kk + e] - m[(e >> 1) & 1]);
    ps[0] += p[0] + p[1] + p[4] + p[5];
    ps[1] += p[2] + p[3] + p[6] + p[7];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t part[2];
      split2<T>(p[2 * j], p[2 * j + 1], part);
#pragma unroll
      for (int i = 0; i < 2; ++i) pf[i][kk][j] = part[i];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    o[4 * n] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
}

// PAD: d, dv are the real widths (below D, DV; the maps have them), else
// unused
template <int D, int DV, typename T, bool PAD>
__global__ void __launch_bounds__(THREADS, 1)
laser_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, T* __restrict__ out, int Hq, int Hkv,
             int T_, int causal, float scale_log2, int d, int dv) {
  using C = Cfg<D, DV, T>;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  Smem<D, DV, T>& sm = *reinterpret_cast<Smem<D, DV, T>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BM;
  const int nkt_all = (T_ + BN - 1) / BN;
  // causal: the tiles up to the block's last row (BM == BN: qt is the diagonal)
  const int nkt = causal ? min(nkt_all, BM == BN ? qt + 1 : (q0 + BM + BN - 1) / BN) : nkt_all;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 8);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (PAD) {
    // the boxes wholly past d or dv are never loaded: zero them once, for
    // the wgmmas (the async proxy) to read
    const int qhl = (d + HALF - 1) / HALF, vhl = (dv + HALF - 1) / HALF;
    uint4* q4 = reinterpret_cast<uint4*>(&sm.q[0][0]) + qhl * (BM * HALF / 8);
    for (int e = threadIdx.x; e < (C::QH - qhl) * BM * HALF / 8; e += THREADS)
      q4[e] = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      uint4* k4 = reinterpret_cast<uint4*>(&sm.k[s][0][0]) + qhl * (BN * HALF / 8);
      for (int e = threadIdx.x; e < (C::QH - qhl) * BN * HALF / 8; e += THREADS)
        k4[e] = make_uint4(0, 0, 0, 0);
      uint4* v4 = reinterpret_cast<uint4*>(&sm.v[s][0][0]) + vhl * (BN * HALF / 8);
      for (int e = threadIdx.x; e < (C::VH - vhl) * BN * HALF / 8; e += THREADS)
        v4[e] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (PAD) {
      if (threadIdx.x == 0) {                  // only the boxes inside d and dv
        const int qhl = (d + HALF - 1) / HALF, vhl = (dv + HALF - 1) / HALF;
        const int qh = b * Hq + h, kh = b * Hkv + h / (Hq / Hkv);
        mbar_expect_tx(&sm.q_full, qhl * BM * ROW_BYTES);
        for (int i = 0; i < qhl; ++i) tma_load_3d(sm.q[i], &qmap, &sm.q_full, i * HALF, q0, qh);
        for (int j = 0; j < nkt; ++j) {
          const int s = j % STAGES;
          if (j >= STAGES) mbar_wait(&sm.empty[s], ((j / STAGES) - 1) & 1);
          mbar_expect_tx(&sm.k_full[s], qhl * BN * ROW_BYTES);
          for (int i = 0; i < qhl; ++i)
            tma_load_3d(sm.k[s][i], &kmap, &sm.k_full[s], i * HALF, j * BN, kh);
          mbar_expect_tx(&sm.v_full[s], vhl * BN * ROW_BYTES);
          for (int i = 0; i < vhl; ++i)
            tma_load_3d(sm.v[s][i], &vmap, &sm.v_full[s], i * HALF, j * BN, kh);
        }
      }
    } else if (threadIdx.x == 0) {
      const int qh = b * Hq + h, kh = b * Hkv + h / (Hq / Hkv);
      mbar_expect_tx(&sm.q_full, C::Q_BYTES);
#pragma unroll
      for (int i = 0; i < C::QH; ++i) tma_load_3d(sm.q[i], &qmap, &sm.q_full, i * HALF, q0, qh);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&sm.empty[s], ((j / STAGES) - 1) & 1);
        mbar_expect_tx(&sm.k_full[s], C::K_BYTES);
#pragma unroll
        for (int i = 0; i < C::QH; ++i)
          tma_load_3d(sm.k[s][i], &kmap, &sm.k_full[s], i * HALF, j * BN, kh);
        mbar_expect_tx(&sm.v_full[s], C::V_BYTES);
#pragma unroll
        for (int i = 0; i < C::VH; ++i)
          tma_load_3d(sm.v[s][i], &vmap, &sm.v_full[s], i * HALF, j * BN, kh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // Consumers. A turn issues P . V of tile j - 1 and S of tile j; the two
    // warpgroups take turns, so one's softmax runs under the other's MMAs.
    const int cw = wg - 1;                       // rows q0 + 64 cw .. + 63
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int tig = lane & 3;
    const int row0 = q0 + cw * 64 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
    const int mine = 1 + cw, other = 2 - cw;

    float o[C::NO], sc[C::NS];
#pragma unroll
    for (int i = 0; i < C::NO; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // l: this thread's columns only
    uint32_t pf[2][C::KS][4];                    // p's hi and lo parts
    const uint32_t qa = smem_u32(sm.q[0]) + cw * 64 * ROW_BYTES;
    if (cw == 1) turn_pass(1);                   // warpgroup 0 takes the first turn
    mbar_wait(&sm.q_full, 0);

    // Every wait precedes the wgmma.fence of its turn, and the first and last
    // turns are peeled, so no wgmma group has a branch inside. With the waits
    // inside the groups ptxas serialised every wgmma of the kernel (a wait on
    // each before the next; 1.45x the time). -Xptxas -v reports it (C7512,
    // C7515): check after any change here.
    // Turn 0: S of tile 0.
    turn_wait(mine);
    mbar_wait(&sm.k_full[0], 0);
    wg_fence();
    issue_qk<D, BN, T>(sc, qa, smem_u32(sm.k[0][0]));
    wg_commit();
    turn_pass(other);
    wg_wait<0>();
    reg_fence(sc);
    // a tile takes the mask where a column may pass a row of the block (the
    // causal diagonal; BM == BN: tile qt) or T
    softmax_tile<C::NS, C::NO, T>(sc, o, m, l, pf,
                                  (causal && (BM == BN ? qt == 0 : BN - 1 > q0)) || BN > T_, 0,
                                  row0, tig, T_, causal, scale_log2);
    for (int j = 1; j < nkt; ++j) {              // turn j: P . V of j - 1, S of j
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      turn_wait(mine);
      mbar_wait(&sm.v_full[sp], ((j - 1) / STAGES) & 1);
      mbar_wait(&sm.k_full[s], (j / STAGES) & 1);
      reg_fence(o);
      wg_fence();
      issue_pv<DV, BN, T>(o, pf, smem_u32(sm.v[sp][0]));
      issue_qk<D, BN, T>(sc, qa, smem_u32(sm.k[s][0]));
      wg_commit();
      turn_pass(other);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(sc);
      reg_fence(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[sp]);
      const int c0 = j * BN;
      softmax_tile<C::NS, C::NO, T>(sc, o, m, l, pf,
                                    (causal && (BM == BN ? j == qt : c0 + BN - 1 > q0)) ||
                                        c0 + BN > T_,
                                    c0, row0, tig, T_, causal, scale_log2);
    }
    {                                            // turn nkt: P . V of the last tile
      const int sp = (nkt - 1) % STAGES;
      turn_wait(mine);
      mbar_wait(&sm.v_full[sp], ((nkt - 1) / STAGES) & 1);
      reg_fence(o);
      wg_fence();
      issue_pv<DV, BN, T>(o, pf, smem_u32(sm.v[sp][0]));
      wg_commit();
      if (cw == 0) turn_pass(other);             // warpgroup 1's last turn ends the chain
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pf);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / fmaxf(l[0], 1e-37f), inv1 = 1.f / fmaxf(l[1], 1e-37f);
    if constexpr (PAD) {                         // rows of dv values, columns < dv
      T* og = out + ((size_t)b * Hq + h) * T_ * dv + 2 * tig;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        if (n * 8 >= dv) break;
        if (row0 < T_)
          *reinterpret_cast<uint32_t*>(og + (size_t)row0 * dv + n * 8) =
              pack_out<T>(o[4 * n] * inv0, o[4 * n + 1] * inv0);
        if (row0 + 8 < T_)
          *reinterpret_cast<uint32_t*>(og + (size_t)(row0 + 8) * dv + n * 8) =
              pack_out<T>(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
      }
    } else {
      T* og = out + ((size_t)b * Hq + h) * T_ * DV + 2 * tig;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        if (row0 < T_)
          *reinterpret_cast<uint32_t*>(og + (size_t)row0 * DV + n * 8) =
              pack_out<T>(o[4 * n] * inv0, o[4 * n + 1] * inv0);
        if (row0 + 8 < T_)
          *reinterpret_cast<uint32_t*>(og + (size_t)(row0 + 8) * DV + n * 8) =
              pack_out<T>(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
      }
    }
  }
}

// [heads, T, width] 16-bit values as a 3-D map: boxes of 64 columns x `rows`
// rows of one head
bool encode(EncodeTiled f, CUtensorMap* map, const void* base, int heads, int T, int width,
            int rows, CUtensorMapDataType type) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(T) * width * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(HALF), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return f(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// d, dv: the real widths, at most D, DV (PAD: below; else equal)
template <int D, int DV, typename T, bool PAD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv, int T_,
           int d, int dv, int causal, float sm_scale, cudaStream_t stream) {
  const EncodeTiled f = encode_fn();
  if (f == nullptr) return (int)cudaErrorSymbolNotFound;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr int BN = Cfg<D, DV, T>::BN;
  CUtensorMap qmap, kmap, vmap;
  if (!encode(f, &qmap, q, B * Hq, T_, d, BM, type) ||
      !encode(f, &kmap, k, B * Hkv, T_, d, BN, type) ||
      !encode(f, &vmap, v, B * Hkv, T_, dv, BN, type))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem<D, DV, T>) + 1024;   // + the base's alignment to 1 KB
  const cudaError_t e = skt::ensure_smem(laser_kernel<D, DV, T, PAD>, smem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = static_cast<float>(static_cast<double>(sm_scale) * 1.4426950408889634);
  const dim3 grid(Hq, B, (T_ + BM - 1) / BM);
  laser_kernel<D, DV, T, PAD><<<grid, THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<T*>(out), Hq, Hkv, T_, causal, scale_log2, d, dv);
  return (int)cudaGetLastError();
}

// The four tiles (Dp, Dvp), each at its own width or padded. A (d, dv) that
// is not one of them takes the padded tile with the least Dp + Dvp that
// holds both (ops/attention/prefill.py::laser_tile); d and dv must be
// multiples of 8 (TMA's 16-byte row strides).
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
             int T_, int d, int dv, int causal, float sm_scale, cudaStream_t st) {
#define SKT_LASER_TILE(DP, DVP)                                                              \
  if (d == DP && dv == DVP)                                                                  \
    return launch<DP, DVP, T, false>(q, k, v, out, B, Hq, Hkv, T_, d, dv, causal, sm_scale, st);
  SKT_LASER_TILE(64, 64)
  SKT_LASER_TILE(128, 128)
  SKT_LASER_TILE(192, 128)
  SKT_LASER_TILE(256, 256)
#undef SKT_LASER_TILE
  if (d < 8 || dv < 8 || d % 8 != 0 || dv % 8 != 0) return (int)cudaErrorInvalidValue;
#define SKT_LASER_TILE(DP, DVP)                                                              \
  if (d <= DP && dv <= DVP)                                                                  \
    return launch<DP, DVP, T, true>(q, k, v, out, B, Hq, Hkv, T_, d, dv, causal, sm_scale, st);
  SKT_LASER_TILE(64, 64)                       // in the order of Dp + Dvp
  SKT_LASER_TILE(128, 128)
  SKT_LASER_TILE(192, 128)
  SKT_LASER_TILE(256, 256)
#undef SKT_LASER_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, T, D], k [B, Hkv, T, D], v [B, Hkv, T, Dv], out [B, Hq, T, Dv];
// dtype 0 bf16, 1 fp16 (all four the same); (D, Dv) one of (64, 64),
// (128, 128), (192, 128), (256, 256), or multiples of 8 up to 256 on a
// padded tile; causal 0 / 1.
extern "C" int skt_laser_attention(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int T, int d, int dv, int causal,
                                   int dtype, float sm_scale, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal,
                                              sm_scale, st)
                    : dispatch<__half>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal, sm_scale, st);
}

extern "C" const char* skt_laser_attention_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
