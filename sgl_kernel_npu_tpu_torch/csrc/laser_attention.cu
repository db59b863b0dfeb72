// Kernel K17: laser attention, a flash forward over dense [B, H, T, 128]
// tensors, causal or not, GQA read in place.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/prefill.py::laser_attention_pallas
// (_flash_kernel, prefill.py:42-110; the wrapper prefill.py:113 repeats K and
// V to Hq heads first, K17 reads kv head h / G where it is). q [B, Hq, T, D],
// k / v [B, Hkv, T, D], out [B, Hq, T, D], all bf16, D = 128.
//
// Rounding, as the TPU kernel takes it (its dots and p are f32): per kv tile,
// s = (q . k) * sm_scale, -1e30 where masked (causal: row < column; and every
// column >= T, which the TPU kernel leaves in and reads past the end:
// prefill.py's fault at a T that is not a multiple of its block);
// m = max(m, rowmax(s)), alpha = exp(m_old - m), p = exp(s - m),
// l = l * alpha + rowsum(p) over the f32 p, acc = acc * alpha + p . v;
// out = acc / max(l, 1e-37) in bf16. The kernel takes the scores in base 2
// (s * sm_scale * log2(e), then exp2), the same function up to f32 rounding.
// The score product runs on bf16 tensor cores with f32 accumulation: bf16 x
// bf16 products are exact in f32, so it differs from an f32 dot only in the
// order of the sums. P . V keeps p in f32 to 16 bits: p is split into hi =
// bf16(p) and lo = bf16(p - hi), and P . V = hi . V + lo . V, two MMAs with f32
// accumulation (|p - hi - lo| <= 2^-16 p). Against the plain version
// (ops/attention/prefill.py::laser_attention_blocked_ref, all f32 in blocks
// of 256) the output differs by that and the order of f32 sums: within one
// bf16 ulp plus 1e-4 of max|out|.
//
// Bound on an H100: operations, 4 * D per (query row, visible key) per head:
// 5.50e11 at T = 8192 causal with 32 query heads, 0.556 ms at the bf16
// tensor-core rate; K17 spends 1.5 times that in MMAs (the split P . V).
// Design, the shape Hopper's tensor cores want: a block takes 128 query rows
// of one head; one producer thread streams Q once and K and V tiles of 128
// rows through a ring of two shared-memory stages by TMA (a 3-D tensor map
// [B*H, T, 128], so rows >= T arrive as zeros, never as the next head's;
// 128-byte swizzle, two 64-column boxes a tile), each completed on an
// mbarrier. Two consumer warpgroups of 64 query rows run S = Q . K^T as
// wgmma with both operands in shared memory, mask (only on the diagonal or
// ragged tile), softmax in registers with quad shuffles, then O += P . V as
// wgmma with P from registers and V the MN-major operand (transposed by the
// instruction), and free the stage on an mbarrier. The two warpgroups take
// turns at the tensor cores (named barriers): a turn issues P . V of tile
// j - 1 and S of tile j, so one warpgroup's softmax runs while the other's
// MMAs do. setmaxnreg moves the producer's registers to the consumers.
// Causal grids start with the longest (last) query tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 128;
constexpr int BM = 128;                // query rows per block: two warpgroups of 64
constexpr int BN = 128;                // kv rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;           // producer warpgroup + two consumer warpgroups
constexpr int HALF = 64;               // bf16 columns of one 128-byte swizzle atom
constexpr uint32_t ROW_BYTES = 128;    // one row of a 64-column half
constexpr uint32_t Q_BYTES = BM * D * 2;
constexpr uint32_t KV_BYTES = BN * D * 2;
constexpr float NEG = -1e30f;

struct alignas(1024) Smem {
  __nv_bfloat16 q[2][BM * HALF];               // [half][row][64], swizzled rows
  __nv_bfloat16 k[STAGES][2][BN * HALF];
  __nv_bfloat16 v[STAGES][2][BN * HALF];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

// The online softmax of one tile of scores (base 2): mask where `edge`,
// then softmax_step.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&o)[64], float (&m)[2],
                                             float (&l)[2], uint32_t (&pf)[2][8][4], bool edge,
                                             int c0, int row0,
                                             int tig, int T, int causal, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = c0 + (i / 4) * 8 + 2 * tig + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      const bool keep = col < T && (!causal || row >= col);
      sc[i] = keep ? sc[i] * scale_log2 : NEG;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
  }
  softmax_step(sc, o, m, l, pf);
}

__global__ void __launch_bounds__(THREADS, 1)
laser_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out, int Hq,
             int Hkv, int T, int causal, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~static_cast<uintptr_t>(1023));
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BM;
  const int nkt_all = (T + BN - 1) / BN;
  const int nkt = causal ? min(nkt_all, qt + 1) : nkt_all;   // BM == BN: qt is the diagonal
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
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int qh = b * Hq + h, kh = b * Hkv + h / (Hq / Hkv);
      mbar_expect_tx(&sm.q_full, Q_BYTES);
      tma_load_3d(sm.q[0], &qmap, &sm.q_full, 0, q0, qh);
      tma_load_3d(sm.q[1], &qmap, &sm.q_full, HALF, q0, qh);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&sm.empty[s], ((j / STAGES) - 1) & 1);
        mbar_expect_tx(&sm.k_full[s], KV_BYTES);
        tma_load_3d(sm.k[s][0], &kmap, &sm.k_full[s], 0, j * BN, kh);
        tma_load_3d(sm.k[s][1], &kmap, &sm.k_full[s], HALF, j * BN, kh);
        mbar_expect_tx(&sm.v_full[s], KV_BYTES);
        tma_load_3d(sm.v[s][0], &vmap, &sm.v_full[s], 0, j * BN, kh);
        tma_load_3d(sm.v[s][1], &vmap, &sm.v_full[s], HALF, j * BN, kh);
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

    float o[64], sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // l: this thread's columns only
    uint32_t pf[2][8][4];                        // p's hi and lo parts
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
    issue_qk<BM, BN>(sc, qa, smem_u32(sm.k[0][0]));
    wg_commit();
    turn_pass(other);
    wg_wait<0>();
    reg_fence(sc);
    softmax_tile(sc, o, m, l, pf, (causal && qt == 0) || BN > T, 0, row0, tig, T, causal,
                 scale_log2);
    for (int j = 1; j < nkt; ++j) {              // turn j: P . V of j - 1, S of j
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      turn_wait(mine);
      mbar_wait(&sm.v_full[sp], ((j - 1) / STAGES) & 1);
      mbar_wait(&sm.k_full[s], (j / STAGES) & 1);
      reg_fence(o);
      wg_fence();
      issue_pv<BN>(o, pf, smem_u32(sm.v[sp][0]));
      issue_qk<BM, BN>(sc, qa, smem_u32(sm.k[s][0]));
      wg_commit();
      turn_pass(other);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(sc);
      reg_fence(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[sp]);
      const int c0 = j * BN;
      softmax_tile(sc, o, m, l, pf, (causal && j == qt) || c0 + BN > T, c0, row0, tig, T,
                   causal, scale_log2);
    }
    {                                            // turn nkt: P . V of the last tile
      const int sp = (nkt - 1) % STAGES;
      turn_wait(mine);
      mbar_wait(&sm.v_full[sp], ((nkt - 1) / STAGES) & 1);
      reg_fence(o);
      wg_fence();
      issue_pv<BN>(o, pf, smem_u32(sm.v[sp][0]));
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
    __nv_bfloat16* og = out + ((size_t)b * Hq + h) * T * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      if (row0 < T)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row0 * D + n * 8) =
            __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (row0 + 8 < T)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)(row0 + 8) * D + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// [heads, T, 128] bf16 as a 3-D map: boxes of 64 columns x `rows` rows of one head
bool encode(EncodeTiled f, CUtensorMap* map, const void* base, int heads, int T, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(HALF), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return f(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
           elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q [B, Hq, T, D], k, v [B, Hkv, T, D], out [B, Hq, T, D], bf16, D = 128;
// causal 0 / 1.
extern "C" int skt_laser_attention(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int T, int d, int causal,
                                   float sm_scale, void* stream) {
  if (d != D || B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled f = encode_fn();
  if (f == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap qmap, kmap, vmap;
  if (!encode(f, &qmap, q, B * Hq, T, BM) || !encode(f, &kmap, k, B * Hkv, T, BN) ||
      !encode(f, &vmap, v, B * Hkv, T, BN))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem) + 1024;       // + the base's alignment to 1 KB
  const cudaError_t e = skt::ensure_smem(laser_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = static_cast<float>(static_cast<double>(sm_scale) * 1.4426950408889634);
  const dim3 grid(Hq, B, (T + BM - 1) / BM);
  laser_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), Hq, Hkv, T, causal, scale_log2);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_laser_attention_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
