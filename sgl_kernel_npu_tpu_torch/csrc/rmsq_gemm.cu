// Kernel K2: fused RMSNorm -> int8 quant -> W8A8 GEMM (+ int32 bias) -> dequant.
//
// Replaces sgl_kernel_npu_tpu/ops/rmsq_gemm.py::rmsnorm_quant_gemm
// (_rmsq_kernel, rmsq_gemm.py:148) in both of its modes, with the row
// statistics of rmsq_gemm.py::_row_stats:
//
//   rstd[m]  = rsqrt(mean_k x[m, k]^2 + eps)          (1 without the norm)
//   xn       = x * rstd * gamma + beta
//   per_token:  qdiv[m] = max(max_k |xn|, 1e-7) * f32(1/127), qoff = 0,
//               x_scale[m] = qdiv[m], no bias
//   per_tensor: qdiv[m] = quant_scale, qoff = quant_offset, x_scale[m] = 1,
//               an optional int32 bias [L, N]
//   v        = xn / qdiv + qoff                      (divided, not multiplied)
//   xq       = clamp(rint(fp16_cast ? float(half(v)) : v), -128, 127)
//   out[m,n] = (float(sum_k xq[m, k] * w[li, k, n] + bias[li, n]) * w_scale[li, n])
//              * x_scale[m]
//
// x is bf16 or f32, with rows ldx elements apart: the MLA path's second stage
// feeds a column slice of the first stage's f32 output without a copy.
//
// Bound on an H100: at decode (M = 8 to 128) the call moves the K*N weight
// bytes of its bank panel and some 2*M*K bytes of activations, below the int8
// tensor-core line, so 3.35 TB/s bounds it (wqkv + w13 of Llama-3-8B at M 128:
// 143 MB, 0.046 ms). Two launches:
//   * a row pass, one block per row, quantises each row ONCE into xq [M, K]
//     int8 (0.5 MB at M 128, read back from L2) and writes x_scale [M]. Its
//     sum of squares runs in float64: every bf16 or f32 square is exact there
//     and the sum of K of them is exact or within 2^-53, so the f32 mean does
//     not depend on the order of the sum; 1/sqrt is taken in float64 and
//     rounded once. Every later step rounds on its own (__fmul_rn, __fdiv_rn,
//     __fadd_rn: no FMA contraction), and fp16_cast rounds through
//     __float2half_rn, as the plain version's cast to float16. The plain
//     version (ops/rmsq_gemm.py::_quant_rows) computes the same, bit for bit;
//   * the GEMM streams the weights through a ring of asynchronous copies
//     (cp.async, completed on mbarriers) of 256-column tiles, so each x row
//     is read once per 256 columns (w13 at M 128: 112 reads of the 0.5 MB
//     xq, from L2). The bank is N-major [K, bn], and the 8-bit tensor-core
//     operands must be K-major, so the weights are byte-transposed on chip.
//     M > 16: 128-row tiles on int8 wgmma. A producer warpgroup brings 128 K
//     bytes a stage (32 KB of weights in a ring of 3, freed once transposed;
//     the 16 KB of x rows in a ring of 3); the two consumer warpgroups
//     transpose each weight tile into the 128-byte swizzled K-major layout
//     (two buffers; 16 k-rows of 8 columns a thread, byte permutes,
//     conflict-free by the raw tile's own swizzle), then each runs four
//     wgmma m64n256k32 on its 64 x rows while the next tile is transposed;
//     setmaxnreg gives the producers 56 registers (40 spilled their copy
//     loop) and the consumers 224. int8 mma.sync at M 128 measured slower
//     (PERF.md: this kernel's first loop). M <= 16: 16-row tiles on
//     int8 mma.sync m16n8k32: a producer warp's ring of 8 stages of 64 K
//     bytes, four consumer warps of 16 x 64 outputs that read four 8-byte
//     pieces of rows 4t .. 4t + 3 (a swizzled layout: no bank conflicts) and
//     byte-transpose them in registers into B fragments (n-tile j holds
//     columns 8g + j, so a lane ends with 16 contiguous output columns).
//     Sums are exact int32 either way. When the output has too few tiles for
//     the card (wqkv: 24), the wrapper splits K over blocks
//     (ops/rmsq_gemm.py::rmsq_plan); each split writes its int32 partial, and
//     the last split of a tile to take a ticket from the tile's integer
//     arrival counter adds the others (exact in any order), runs the epilogue
//     and resets the counter to 0 (no host memset, no float atomics: a second
//     call is bit-identical);
//   * the epilogue adds the bias and multiplies in the plain version's order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int ROW_THREADS = 256;
constexpr float INV_INT8_MAX = (float)(1.0 / 127.0);
constexpr int BN = 256;            // output columns of a block
constexpr int WN = 64;             // output columns of a consumer warp (M <= 16)
constexpr int MAX_SPLITS = 16;

// ------------------------------------------------------------- row pass

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// eight consecutive elements of a row as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ float normed(float x, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x, rstd), g), b);
}

// One quantised activation. fp16_cast rounds to fp16 (nearest even, with
// fp16's subnormals and overflow to inf) before rint, as the plain version's
// cast to float16 does.
__device__ __forceinline__ int quant_one(float xn, float qdiv, float qoff, int fp16_cast) {
  float v = __fadd_rn(__fdiv_rn(xn, qdiv), qoff);
  if (fp16_cast) v = __half2float(__float2half_rn(v));
  const int q = __float2int_rn(v);      // round half to even; saturates out of range
  return max(-128, min(127, q));
}

// xq [M, K] int8 and xs [M] (the epilogue's row scale) of each row of x. A
// thread keeps up to CACHE groups of 8 columns of its row, gamma and beta in
// registers, all loaded at once (K <= 8,192 in one read); columns past
// those are read again in each step.
constexpr int CACHE = 4;

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
rmsq_rows(const T* __restrict__ x, int ldx, const float* __restrict__ gamma,
          const float* __restrict__ beta, const float* __restrict__ quant_scale,
          const float* __restrict__ quant_offset, int8_t* __restrict__ xq,
          float* __restrict__ xs, int M, int K, float eps, int apply_norm, int per_tensor,
          int fp16_cast) {
  __shared__ double dsum[ROW_THREADS / 32];
  __shared__ float fmax_[ROW_THREADS / 32];
  __shared__ float rs_s, qd_s;
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (size_t)m * ldx;
  const int ng = K / 8;
  float v[CACHE][8], gv[CACHE][8], bv[CACHE][8];
#pragma unroll
  for (int c = 0; c < CACHE; ++c) {
    const int gi = tid + c * ROW_THREADS;
    if (gi < ng) {
      load8(xr + 8 * gi, v[c]);
      load8(gamma + 8 * gi, gv[c]);
      load8(beta + 8 * gi, bv[c]);
    }
  }
  const int rest = tid + CACHE * ROW_THREADS;      // the first group not cached

  float rs = 1.f;
  if (apply_norm) {
    double s = 0.0;
#pragma unroll
    for (int c = 0; c < CACHE; ++c)
      if (tid + c * ROW_THREADS < ng)
#pragma unroll
        for (int i = 0; i < 8; ++i) s += (double)v[c][i] * (double)v[c][i];
    for (int gi = rest; gi < ng; gi += ROW_THREADS) {
      float u[8];
      load8(xr + 8 * gi, u);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += (double)u[i] * (double)u[i];
    }
    s = warp_sum(s);
    if (lane == 0) dsum[warp] = s;
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int i = 0; i < ROW_THREADS / 32; ++i) t += dsum[i];
      const float f = __fadd_rn(__fdiv_rn((float)t, (float)K), eps);
      rs_s = (float)(1.0 / sqrt((double)f));      // correctly rounded, unlike rsqrtf
    }
    __syncthreads();
    rs = rs_s;
  }
  float qdiv, qoff = 0.f;
  if (per_tensor) {
    qdiv = *quant_scale;
    if (quant_offset != nullptr) qoff = *quant_offset;
    if (tid == 0) xs[m] = 1.f;
  } else {
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < CACHE; ++c)
      if (tid + c * ROW_THREADS < ng)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          amax = fmaxf(amax, fabsf(normed(v[c][i], rs, gv[c][i], bv[c][i])));
    for (int gi = rest; gi < ng; gi += ROW_THREADS) {
      float u[8], ug[8], ub[8];
      load8(xr + 8 * gi, u);
      load8(gamma + 8 * gi, ug);
      load8(beta + 8 * gi, ub);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(normed(u[i], rs, ug[i], ub[i])));
    }
    amax = warp_max(amax);
    if (lane == 0) fmax_[warp] = amax;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int i = 0; i < ROW_THREADS / 32; ++i) t = fmaxf(t, fmax_[i]);
      qd_s = __fmul_rn(fmaxf(t, 1e-7f), INV_INT8_MAX);
      xs[m] = qd_s;
    }
    __syncthreads();
    qdiv = qd_s;
  }
  int8_t* qr = xq + (size_t)m * K;
  auto emit = [&](int gi, const float (&u)[8], const float (&ug)[8], const float (&ub)[8]) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = quant_one(normed(u[i], rs, ug[i], ub[i]), qdiv, qoff, fp16_cast);
      packed[i >> 2] |= (uint32_t)(uint8_t)(int8_t)q << ((i & 3) * 8);
    }
    *reinterpret_cast<uint2*>(qr + 8 * gi) = make_uint2(packed[0], packed[1]);
  };
#pragma unroll
  for (int c = 0; c < CACHE; ++c)
    if (tid + c * ROW_THREADS < ng) emit(tid + c * ROW_THREADS, v[c], gv[c], bv[c]);
  for (int gi = rest; gi < ng; gi += ROW_THREADS) {
    float u[8], ug[8], ub[8];
    load8(xr + 8 * gi, u);
    load8(gamma + 8 * gi, ug);
    load8(beta + 8 * gi, ub);
    emit(gi, u, ug, ub);
  }
}

// ----------------------------------------------------------------- GEMM

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
  const int8_t* w;       // layer li of the bank: [N / bn, K, bn]
  const float* wsc;      // [N] of layer li
  const int32_t* bias;   // [N] of layer li, or null
  const float* xs;       // [M]
  void* out;             // [M, N] bf16, or f32 when out_f32
  int4* part;            // split partials, or null
  int* arrivals;         // [tiles], or null
  int M, N, K, bn, splits, out_f32;
};

// this split's K stages (of bk bytes) of a tile: [k0, k0 + n)
__device__ __forceinline__ void split_range(const Args& a, int bk, int& k0, int& n) {
  const int ksteps = (a.K + bk - 1) / bk, sp = blockIdx.z;
  k0 = (int)((long long)ksteps * sp / a.splits);
  n = (int)((long long)ksteps * (sp + 1) / a.splits) - k0;
}

// Split K: this split's int32 sums go to the workspace (in register order,
// NQ int4 per consumer thread), then it takes a ticket from the tile's
// arrival counter; the last split of the tile adds the others (exact in any
// order) and resets the counter. Returns false for every split but the last.
// Named barrier 1 holds the NCT consumer threads together.
template <int NCT, int N>
__device__ __forceinline__ bool merge_splits(const Args& a, int ct, int32_t (&acc)[N],
                                             int* last) {
  constexpr int NQ = N / 4;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x, sp = blockIdx.z;
  int4* mine = a.part + ((size_t)tile * a.splits + sp) * NQ * NCT;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    __stcg(mine + q * NCT + ct, make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                                          acc[4 * q + 3]));
  __threadfence();
  bar_sync(1, NCT);
  if (ct == 0) *last = atomicAdd(a.arrivals + tile, 1) == a.splits - 1;
  bar_sync(1, NCT);
  if (!*last) return false;
  __threadfence();
  const int4* base = a.part + (size_t)tile * a.splits * NQ * NCT;
  // the other splits' sums, eight loads in flight before they are added
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
  if (ct == 0) a.arrivals[tile] = 0;           // ready for the next call
  return true;
}

__device__ __forceinline__ float dequant(int32_t acc, int32_t bias, float ws, float xs) {
  return __fmul_rn(__fmul_rn((float)(acc + bias), ws), xs);
}

// ---------------------------------------------- M <= 16: int8 mma.sync

// A block of 16 rows x 256 columns: four consumer warps of 16 x 64 and a
// producer warp, stages of 64 K bytes in a ring of 8.
constexpr int S_BK = 64;
constexpr int S_STAGES = 8;
constexpr int S_NCW = 4;                           // consumer warps
constexpr int S_THREADS = 32 * (S_NCW + 1);
constexpr int S_STAGE = S_BK * BN + 16 * S_BK;     // weights, then 16 x rows
constexpr size_t S_SMEM = (size_t)S_STAGES * S_STAGE;

__global__ void __launch_bounds__(S_THREADS, 1) rmsq_mma_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[S_STAGES], empty[S_STAGES];
  __shared__ int last;
  const int n0 = blockIdx.x * BN;
  int kb, nk;
  split_range(a, S_BK, kb, nk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

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
    const int8_t* wsrc = a.w + (size_t)panel * a.K * a.bn + (wok ? col - panel * a.bn : 0);
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
        const bool ok = r < a.M;
        cp_async16(xt + r * S_BK + 16 * (xc ^ ((r >> 1) & 3)),
                   a.xq + (size_t)(ok ? r : 0) * a.K + k0 + 16 * xc, ok);
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

  if (a.splits > 1 && !merge_splits<32 * S_NCW>(a, threadIdx.x, acc, &last)) return;

  // epilogue: n-tile j holds columns 8 g + j of the mma, so per row this
  // lane has the 16 columns wn * 64 + 16 t ..
  const int c0 = n0 + wn * WN + 16 * t;
  if (c0 >= a.N) return;
  float wsv[16];
  int32_t bv[16];
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(a.wsc + c0 + i));
    wsv[i] = f.x, wsv[i + 1] = f.y, wsv[i + 2] = f.z, wsv[i + 3] = f.w;
    const int4 b4 = a.bias != nullptr ? __ldg(reinterpret_cast<const int4*>(a.bias + c0 + i))
                                      : make_int4(0, 0, 0, 0);
    bv[i] = b4.x, bv[i + 1] = b4.y, bv[i + 2] = b4.z, bv[i + 3] = b4.w;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = g + 8 * hr;
    if (r >= a.M) continue;
    const float xsr = a.xs[r];
    float o[16];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * e + jn;
        o[c] = dequant(acc[4 * jn + 2 * hr + e], bv[c], wsv[c], xsr);
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

// ------------------------------------------------- M > 16: int8 wgmma

// A block of 128 rows x 256 columns: a producer warpgroup and two consumer
// warpgroups of 64 rows, stages of 128 K bytes. Two producer warps bring the
// raw weight rows (32 KB a stage, a ring of 3), the other two the x rows
// (16 KB, a ring of 3): the weight ring refills as soon as a stage is
// transposed, the x ring once its wgmma is done. Per stage the consumers
// transpose the N-major weight tile into the K-major, 128-byte swizzled
// layout that wgmma's 8-bit B operand needs (two buffers), half each, then
// each runs four wgmma m64n256k32 on its 64 x rows while the next stage is
// transposed.
constexpr int W_BK = 128;
constexpr int W_BM = 128;
constexpr int W_RAW = 3;               // raw weight stages
constexpr int W_X = 3;                 // x stages
constexpr int W_BKBUF = 2;             // transposed weight buffers
constexpr int W_THREADS = 384;

struct alignas(1024) WgSmem {
  int8_t bk[W_BKBUF][BN * W_BK];       // [n][k] weights, 128-byte swizzled rows
  int8_t x[W_X][W_BM * W_BK];          // [m][k] x rows, 128-byte swizzled
  int8_t raw[W_RAW][W_BK * BN];        // [k][n] weight rows as loaded
  uint64_t wfull[W_RAW], wempty[W_RAW], xfull[W_X], xempty[W_X];
};
constexpr size_t W_SMEM = sizeof(WgSmem) + 1024;   // + alignment slack

__global__ void __launch_bounds__(W_THREADS, 1) rmsq_wgmma_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  WgSmem& sm = *reinterpret_cast<WgSmem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
  __shared__ int last;
  __shared__ float wsv[BN];
  __shared__ int32_t bsv[BN];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * W_BM;
  int kb, nk;
  split_range(a, W_BK, kb, nk);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < W_RAW; ++st) {
      mbar_init(&sm.wfull[st], 64);              // one arrival per weight-loading thread
      mbar_init(&sm.wempty[st], 8);              // one per consumer warp
    }
#pragma unroll
    for (int st = 0; st < W_X; ++st) {
      mbar_init(&sm.xfull[st], 64);
      mbar_init(&sm.xempty[st], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int p = threadIdx.x % 64;
    if (threadIdx.x < 64) {
      // weights: thread p brings chunk cc of rows p / 16 + 4 i; a raw row r
      // keeps chunk c at c ^ ((r / 16) % 8), so that the transposing reads
      // below (eight k-rows 16 apart) hit distinct banks. Rows past K and
      // columns past N are zeros.
      const int cc = p % 16;
      const int col = n0 + 16 * cc;
      const bool wok = col < a.N;
      const int panel = wok ? col / a.bn : 0;
      const int8_t* wsrc = a.w + (size_t)panel * a.K * a.bn + (wok ? col - panel * a.bn : 0);
      for (int j = 0; j < nk; ++j) {
        const int st = j % W_RAW;
        if (j >= W_RAW) mbar_wait(&sm.wempty[st], ((j / W_RAW) - 1) & 1);
        const int k0 = (kb + j) * W_BK;
#pragma unroll 8
        for (int i = 0; i < W_BK / 4; ++i) {
          const int r = p / 16 + 4 * i;
          const bool ok = wok && k0 + r < a.K;
          cp_async16(sm.raw[st] + r * BN + 16 * (cc ^ ((r >> 4) & 7)),
                     ok ? wsrc + (size_t)(k0 + r) * a.bn : a.w, ok);
        }
        cp_async_arrive(&sm.wfull[st]);
      }
    } else {
      // x: thread p brings chunk xc of rows p / 8 + 8 i, chunk c of row r at
      // c ^ (r % 8) (wgmma's 128-byte swizzle); rows past M are zeros
      const int xc = p % 8;
      for (int j = 0; j < nk; ++j) {
        const int st = j % W_X;
        if (j >= W_X) mbar_wait(&sm.xempty[st], ((j / W_X) - 1) & 1);
        const int k0 = (kb + j) * W_BK;
        const bool kok = k0 + 16 * xc < a.K;
#pragma unroll
        for (int i = 0; i < W_BM / 8; ++i) {
          const int r = p / 8 + 8 * i;
          const bool ok = kok && m0 + r < a.M;
          cp_async16(sm.x[st] + r * W_BK + 16 * (xc ^ (r & 7)),
                     ok ? a.xq + (size_t)(m0 + r) * a.K + k0 + 16 * xc : a.xq, ok);
        }
        cp_async_arrive(&sm.xfull[st]);
      }
    }
    cp_wait<0>();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int ct = threadIdx.x - 128;              // consumer thread 0 .. 255
  const int cw = ct / 128;                       // rows m0 + 64 cw ..
  const int warp = ct / 32, lane = ct % 32;
  // transposer: thread (kc, nh, nb) turns k-rows 16 kc .. + 15 of the 8
  // columns at 16 nb + 8 nh into eight 16-byte K-major chunks
  const int kc = lane & 7, nh = (lane >> 3) & 1, nb = 2 * warp + (lane >> 4);
  int32_t d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  // the epilogue's scales and biases, read before any output is written (a
  // store through a.out could alias them, so the compiler would otherwise
  // issue each load after the last store, one latency at a time); the
  // loop's barriers order these writes before the epilogue's reads
  {
    const int c = n0 + ct;
    wsv[ct] = c < a.N ? __ldg(a.wsc + c) : 0.f;
    bsv[ct] = c < a.N && a.bias != nullptr ? __ldg(a.bias + c) : 0;
  }
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + 64 * cw + 16 * (warp % 4) + g;
  const float xs0 = r0 < a.M ? a.xs[r0] : 0.f, xs1 = r0 + 8 < a.M ? a.xs[r0 + 8] : 0.f;

  for (int j = 0; j < nk; ++j) {
    const int wst = j % W_RAW, xst = j % W_X;
    int8_t* bk = sm.bk[j % W_BKBUF];
    // bk was last read by wgmma j - 2, done in both warpgroups before the
    // second barrier of stage j - 1
    mbar_wait(&sm.wfull[wst], (j / W_RAW) & 1);
    {
      uint32_t w[16][2];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = 16 * kc + i;                // (r / 16) % 8 == kc
        const uint2 v =
            *reinterpret_cast<const uint2*>(sm.raw[wst] + r * BN + 16 * (nb ^ kc) + 8 * nh);
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
    // the transposed rows and the x rows (cp.async) are generic-proxy
    // writes, which wgmma reads through the async proxy
    mbar_wait(&sm.xfull[xst], (j / W_X) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1, 256);                            // both halves of bk written
    wg_fence();
    const uint32_t xa = smem_u32(sm.x[xst]) + cw * 64 * W_BK;
    const uint32_t ba = smem_u32(bk);
#pragma unroll
    for (int kk = 0; kk < W_BK / 32; ++kk)
      wgmma_s8(d, sw128_desc(xa + 32 * kk, 16, 1024), sw128_desc(ba + 32 * kk, 16, 1024));
    wg_commit();
    // wgmma j - 1 is done (its x stage is free, and after the barrier its
    // bk buffer in both warpgroups); wgmma j runs on under the next stage's
    // transpose
    wg_wait<1>();
    if (j >= 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.xempty[(j - 1) % W_X]);
    }
    bar_sync(2, 256);
  }
  wg_wait<0>();
  reg_fence_i(d);

  if (a.splits > 1 && !merge_splits<256>(a, ct, d, &last)) return;

  // epilogue: d[4 j + e] is row 16 w + g (+ 8 for e >= 2) of this warpgroup,
  // columns 8 j + 2 t (+ 1). The tile goes through shared memory (the
  // rings are idle: every stage was waited for, and after the barrier no
  // wgmma reads them) so that its rows leave in 16-byte stores; stored from
  // the fragments directly, its 4-byte pieces took 8 us of w13's 62
  // (scripts/probe_rmsq_split.py).
  bar_sync(1, 256);
  const int esz = a.out_f32 ? 4 : 2;
  const int orow = BN * esz + 16;                // bytes of a staged row
  unsigned char* ot = reinterpret_cast<unsigned char*>(sm.bk);
#pragma unroll
  for (int jn = 0; jn < 32; ++jn) {
    const int cl = 8 * jn + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float xsr = hr ? xs1 : xs0;
      const float v0 = dequant(d[4 * jn + 2 * hr], bsv[cl], wsv[cl], xsr);
      const float v1 = dequant(d[4 * jn + 2 * hr + 1], bsv[cl + 1], wsv[cl + 1], xsr);
      unsigned char* dst = ot + (r0 - m0 + 8 * hr) * orow + cl * esz;
      if (a.out_f32)
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(dst) = pack(v0, v1);
    }
  }
  bar_sync(1, 256);
  const int rows = min(W_BM, a.M - m0);
  const int chunks = min(BN, a.N - n0) * esz / 16;   // N % 16 == 0: whole chunks
  unsigned char* out = static_cast<unsigned char*>(a.out) + ((size_t)m0 * a.N + n0) * esz;
  for (int i = ct; i < rows * chunks; i += 256) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<uint4*>(out + (size_t)r * a.N * esz + 16 * c) =
        *reinterpret_cast<const uint4*>(ot + r * orow + 16 * c);
  }
}

}  // namespace

// x [M, ldx] bf16 (x_f32 = 0) or f32 (x_f32 = 1), its first K columns used;
// gamma, beta [K] f32; w [L, N/bn, K, bn] int8 (bn = N: a plain [K, N] weight
// with L = 1); ws [L, N] f32; bias [L, N] int32 or null; quant_scale and
// quant_offset one f32 each (per_tensor; quant_offset may be null); xq [M, K]
// int8 and xs [M] f32 written here; out [M, N] bf16 or f32 (out_f32). The
// plan (ops/rmsq_gemm.py::rmsq_plan): row tiles of bm (16 for M <= 16, else
// 128), 256-column tiles, K split `splits` ways (<= 16, and at most one split
// per K stage: 64 bytes at bm 16, 128 above); with
// splits > 1, partials holds tiles * splits * bm * 256 int32 and arrivals
// tiles ints, zero before the first call. Needs K % 64 == 0, N % 16 == 0,
// bn == N or bn % 16 == 0 with N % bn == 0, and rows of x 16-byte aligned.
extern "C" int skt_rmsq_gemm(const void* x, const void* gamma, const void* beta,
                             const void* w, const void* ws, const void* bias,
                             const void* quant_scale, const void* quant_offset, void* xq,
                             void* xs, void* out, void* partials, void* arrivals, int M, int N,
                             int K, int ldx, int li, int bn, int bm, int splits, float eps,
                             int apply_norm, int per_tensor, int x_f32, int fp16_cast,
                             int out_f32, void* stream) {
  const int ksteps = bm == 16 ? K / S_BK : (K + W_BK - 1) / W_BK;
  if (bn <= 0 || bn % 16 || N % bn != 0 || N % 16 || K % 64 || ldx < K || li < 0 ||
      (per_tensor && quant_scale == nullptr) || (bm != 16 && bm != W_BM) ||
      (bm == 16 && M > 16) || splits < 1 || splits > MAX_SPLITS || splits > ksteps ||
      (splits > 1 && (partials == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* qs = static_cast<const float*>(quant_scale);
  const float* qo = static_cast<const float*>(quant_offset);
  int8_t* q8 = static_cast<int8_t*>(xq);
  float* xsv = static_cast<float*>(xs);
  if (x_f32)
    rmsq_rows<float><<<M, ROW_THREADS, 0, st>>>(static_cast<const float*>(x), ldx, g, b, qs, qo,
                                                q8, xsv, M, K, eps, apply_norm, per_tensor,
                                                fp16_cast);
  else
    rmsq_rows<__nv_bfloat16><<<M, ROW_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, g, b, qs, qo, q8, xsv, M, K, eps,
        apply_norm, per_tensor, fp16_cast);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Args a{};
  a.xq = q8;
  a.w = static_cast<const int8_t*>(w) + (size_t)li * N * K;
  a.wsc = static_cast<const float*>(ws) + (size_t)li * N;
  a.bias = bias != nullptr ? static_cast<const int32_t*>(bias) + (size_t)li * N : nullptr;
  a.xs = xsv;
  a.out = out;
  a.part = static_cast<int4*>(partials);
  a.arrivals = static_cast<int*>(arrivals);
  a.M = M;
  a.N = N;
  a.K = K;
  a.bn = bn;
  a.splits = splits;
  a.out_f32 = out_f32;
  const int tiles_n = (N + BN - 1) / BN;
  if (bm == 16) {
    if ((e = skt::ensure_smem(rmsq_mma_kernel, S_SMEM)) != cudaSuccess) return (int)e;
    rmsq_mma_kernel<<<dim3(tiles_n, 1, splits), S_THREADS, S_SMEM, st>>>(a);
  } else {
    if ((e = skt::ensure_smem(rmsq_wgmma_kernel, W_SMEM)) != cudaSuccess) return (int)e;
    rmsq_wgmma_kernel<<<dim3(tiles_n, (M + W_BM - 1) / W_BM, splits), W_THREADS, W_SMEM,
                        st>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* skt_rmsq_gemm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
