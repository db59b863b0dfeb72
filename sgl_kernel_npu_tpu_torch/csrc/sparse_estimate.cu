// Kernel K18: the sparse-block estimator's block scores: block sums of q and
// of k, one dot per (query block, kv block), causal -1e30.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/sparse.py::
// sparse_block_estimate_pallas (_estimate_kernel, sparse.py:302-320): for
// each (batch, head) row of q [BH, NQ*bs, D] and k [BH, NK*bs, D] (bf16,
// fp16 or f32, any D), in f32:
//   qs[i] = sum of q rows i*bs .. i*bs + bs - 1, ks[j] likewise (SUMS, as the
//           TPU kernel; the plain estimator takes means)
//   sc[i][j] = (qs[i] . ks[j]) * f32(1 / bs^2), -1e30 where j > i if causal
// -> scores [BH, NQ, NK] f32. The top-k threshold that turns the scores into
// the mask stays outside (a PyTorch sort, as it stays in XLA there). Against
// the plain version (ops/attention/sparse.py::block_scores_ref) the sums are
// taken in another order: f32 rounding only, so a mask entry can flip only
// where a score lies within that rounding of its row's threshold.
//
// Bound on an H100: bytes, q and k read once (the dots are 2 * NQ * NK * D
// f32 operations a head: about 2 us at T 32768, against 40 us of reads).
// Design: two kernels on the caller's stream, no block waiting on another.
//   1. pool_kernel<T, EP>: one block of 256 threads per pooled block (bs rows
//      of q or of k of one (batch, head)), BH * (NQ + NK) blocks over the
//      whole card. A row is read in pieces of EP values: 16 bytes where a
//      row is a whole number of 16-byte pieces (EP 8 for bf16 and fp16, 4
//      for f32), else one value. D / EP threads a row (all 256 threads over
//      the row's pieces where a row has more), 256 / (D / EP) row groups a
//      pass, each thread DEPTH loads in flight; the row groups' sums reduced
//      in a fixed order (the groups that share a warp by shuffles, then the
//      warps' in order: at D 128 in bf16 the order, and so the bits, of the
//      kernel's D 128 form). It writes the pooled f32 rows to the workspace ws
//      [BH, NQ + NK, Dp] (q's blocks, then k's; Dp = D rounded up to 4, the
//      columns past D zero), so no shared-memory cap bounds NQ + NK or D.
//      D 128 (the sparse prefill's) has its own instantiation with the width
//      fixed at compile time, as both kernels had it before they took any D.
//   2. score_kernel<M>: one block of 256 threads per tile of 16M x 16M
//      scores of one (batch, head): the tile's pooled rows staged in shared
//      memory 128 columns at a time (a chunk's columns past D staged as
//      zeros), each thread an M x M piece of f32 FMAs over d in order; tiles
//      wholly above the diagonal (causal) only write -1e30. M (2 or 4) is
//      the caller's plan (ops/attention/sparse.py::estimate_plan).
// The sums are f32 and deterministic: the same inputs give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "device_once.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int DEPTH = 8;                          // loads a thread keeps in flight
constexpr int DC = 128;                           // columns the score kernel stages at once
constexpr int PS = DC + 4;                        // staged row stride (floats): 16-byte
                                                  // aligned, conflict-free float4 reads
constexpr int MAX_EP = 8;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// acc[0 .. EP) += the EP values of a 16-byte piece
template <typename T, int EP>
__device__ __forceinline__ void add_piece(const int4& raw, float (&acc)[EP]) {
  if constexpr (std::is_same<T, float>::value) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < EP; ++i) acc[i] += f[i];
  } else if constexpr (std::is_same<T, __half>::value) {
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < EP / 2; ++i) {
      const float2 f = __half22float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < EP / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
}

// ws[bh][blk][:] = sum of rows blk*bs .. blk*bs + bs - 1 of q (blk < NQ) or
// of k (blk - NQ); EP values a piece (16 / sizeof(T), or 1); the width d, or
// DK where DK > 0
template <typename T, int EP, int DK>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ ws, int NQ,
            int NK, int bs, int d, int dp) {
  __shared__ float red[THREADS * MAX_EP];         // [row group][D] where RG > 1
  const int D = DK > 0 ? DK : d, Dp = DK > 0 ? (DK + 3) / 4 * 4 : dp;
  const int blk = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int pieces = D / EP;
  const int pp = min(pieces, THREADS);            // pieces a pass
  const int rg = THREADS / pp;                    // row groups
  const int rl = tid / pp, cp = tid % pp;
  // row groups within a warp, summed by shuffles (pp a power of two <= 16)
  const int wl = pp <= 16 && 32 % pp == 0 ? 32 / pp : 1;
  const T* base = blk < NQ ? q + ((size_t)bh * NQ + blk) * bs * D
                           : k + ((size_t)bh * NK + (blk - NQ)) * bs * D;
  float* dst = ws + ((size_t)bh * (NQ + NK) + blk) * Dp;
  if (rl < rg) {
    for (int pc = cp; pc < pieces; pc += pp) {    // more than one pass only where rg == 1
      const T* col = base + pc * EP;
      float acc[EP];
#pragma unroll
      for (int i = 0; i < EP; ++i) acc[i] = 0.f;
      for (int r0 = rl; r0 < bs; r0 += rg * DEPTH) {
        if constexpr (EP == 1) {
          float raw[DEPTH];
#pragma unroll
          for (int u = 0; u < DEPTH; ++u) {
            const int r = r0 + u * rg;
            raw[u] = r < bs ? to_f(col[(size_t)r * D]) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < DEPTH; ++u) acc[0] += raw[u];
        } else {
          int4 raw[DEPTH];
#pragma unroll
          for (int u = 0; u < DEPTH; ++u) {
            const int r = r0 + u * rg;
            raw[u] = r < bs ? __ldcs(reinterpret_cast<const int4*>(col + (size_t)r * D))
                            : make_int4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < DEPTH; ++u) add_piece<T, EP>(raw[u], acc);
        }
      }
      if (rg == 1) {
#pragma unroll
        for (int i = 0; i < EP; ++i) dst[pc * EP + i] = acc[i];
      } else {
        // wl > 1: every thread is here (pp divides 256), one pass
        for (int o = pp; o < 32 && wl > 1; o <<= 1)
#pragma unroll
          for (int i = 0; i < EP; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
        if (tid % 32 < 32 / wl)
#pragma unroll
          for (int i = 0; i < EP; ++i) red[(rl / wl) * D + pc * EP + i] = acc[i];
      }
    }
  }
  if (rg > 1) {
    // the warps' (or row groups') sums in order
    __syncthreads();
    for (int c = tid; c < D; c += THREADS) {
      float s = 0.f;
      for (int g = 0; g < rg / wl; ++g) s += red[g * D + c];
      dst[c] = s;
    }
  }
  if (tid < Dp - D) dst[D + tid] = 0.f;
}

// scores of the tile (blockIdx.y, blockIdx.x) of (batch, head) blockIdx.z;
// pooled rows of dp floats, or DP where DP > 0
template <int M, int DP>
__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ ws, float* __restrict__ out, int NQ, int NK, int dp,
             float inv, int causal) {
  constexpr int T = 16 * M;
  const int Dp = DP > 0 ? DP : dp;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);    // [T][PS]
  float* sk = sq + T * PS;                        // [T][PS]
  const int bh = blockIdx.z, i0 = blockIdx.y * T, j0 = blockIdx.x * T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float* o = out + (size_t)bh * NQ * NK;
  if (causal && j0 > i0 + T - 1) {                // every entry above the diagonal
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < M; ++n) {
        const int i = i0 + ty + 16 * m, j = j0 + tx + 16 * n;
        if (i < NQ && j < NK) o[(size_t)i * NK + j] = NEG;
      }
    return;
  }
  const float* pq = ws + (size_t)bh * (NQ + NK) * Dp;
  const float* pk = pq + (size_t)NQ * Dp;
  float acc[M][M];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < M; ++n) acc[m][n] = 0.f;
  for (int d0 = 0; d0 < Dp; d0 += DC) {
    if (d0 > 0) __syncthreads();                  // the last chunk is read
    for (int e = tid; e < T * (DC / 4); e += THREADS) {
      const int r = e / (DC / 4), c = (e % (DC / 4)) * 4;
      const bool in = d0 + c < Dp;                // Dp is a multiple of 4
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sq + r * PS + c) =
          in && i0 + r < NQ
              ? *reinterpret_cast<const float4*>(pq + (size_t)(i0 + r) * Dp + d0 + c) : zero;
      *reinterpret_cast<float4*>(sk + r * PS + c) =
          in && j0 + r < NK
              ? *reinterpret_cast<const float4*>(pk + (size_t)(j0 + r) * Dp + d0 + c) : zero;
    }
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < DC; d += 4) {
      float4 a[M], b[M];
#pragma unroll
      for (int m = 0; m < M; ++m)
        a[m] = *reinterpret_cast<const float4*>(sq + (ty + 16 * m) * PS + d);
#pragma unroll
      for (int n = 0; n < M; ++n)
        b[n] = *reinterpret_cast<const float4*>(sk + (tx + 16 * n) * PS + d);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < M; ++n) {
          float s = acc[m][n];
          s = fmaf(a[m].x, b[n].x, s);
          s = fmaf(a[m].y, b[n].y, s);
          s = fmaf(a[m].z, b[n].z, s);
          acc[m][n] = fmaf(a[m].w, b[n].w, s);
        }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < M; ++n) {
      const int i = i0 + ty + 16 * m, j = j0 + tx + 16 * n;
      if (i < NQ && j < NK) o[(size_t)i * NK + j] = causal && j > i ? NEG : acc[m][n] * inv;
    }
}

template <int M, int DP>
cudaError_t launch_scores_at(const float* ws, float* out, int BH, int NQ, int NK, int Dp,
                             float inv, int causal, cudaStream_t st) {
  constexpr int T = 16 * M;
  const size_t smem = 2 * (size_t)T * PS * sizeof(float);
  const cudaError_t e = skt::ensure_smem(score_kernel<M, DP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((NK + T - 1) / T, (NQ + T - 1) / T, BH);
  score_kernel<M, DP><<<grid, THREADS, smem, st>>>(ws, out, NQ, NK, Dp, inv, causal);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_scores(const float* ws, float* out, int BH, int NQ, int NK, int Dp, float inv,
                          int causal, cudaStream_t st) {
  return Dp == 128 ? launch_scores_at<M, 128>(ws, out, BH, NQ, NK, Dp, inv, causal, st)
                   : launch_scores_at<M, 0>(ws, out, BH, NQ, NK, Dp, inv, causal, st);
}

template <typename T>
void launch_pool(const void* q, const void* k, void* ws, int BH, int NQ, int NK, int bs, int D,
                 int Dp, cudaStream_t st) {
  constexpr int EP = 16 / sizeof(T);
  const dim3 grid(NQ + NK, BH);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  float* w = static_cast<float*>(ws);
  if (D == 128)
    pool_kernel<T, EP, 128><<<grid, THREADS, 0, st>>>(qt, kt, w, NQ, NK, bs, D, Dp);
  else if ((D * sizeof(T)) % 16 == 0)
    pool_kernel<T, EP, 0><<<grid, THREADS, 0, st>>>(qt, kt, w, NQ, NK, bs, D, Dp);
  else
    pool_kernel<T, 1, 0><<<grid, THREADS, 0, st>>>(qt, kt, w, NQ, NK, bs, D, Dp);
}

}  // namespace

// q [BH, NQ*bs, D], k [BH, NK*bs, D], dtype 0 bf16, 1 fp16, 2 f32; ws
// [BH, NQ + NK, Dp] f32, Dp = D rounded up to a multiple of 4 (written, then
// read: no state between calls); scores [BH, NQ, NK] f32; tile 32 or 64
// scores a side (M 2 or 4). Two launches.
extern "C" int skt_sparse_estimate(const void* q, const void* k, void* ws, void* scores, int BH,
                                   int NQ, int NK, int bs, int d, int dp, int causal, int tile,
                                   int dtype, void* stream) {
  if (d <= 0 || dp != (d + 3) / 4 * 4 || BH <= 0 || BH > 65535 || NQ <= 0 || NK <= 0 ||
      bs <= 0 || bs > 46340 || (tile != 32 && tile != 64) || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_pool<__nv_bfloat16>(q, k, ws, BH, NQ, NK, bs, d, dp, st);
  else if (dtype == 1) launch_pool<__half>(q, k, ws, BH, NQ, NK, bs, d, dp, st);
  else launch_pool<float>(q, k, ws, BH, NQ, NK, bs, d, dp, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float inv = 1.0f / (float)(bs * bs);
  const float* w = static_cast<const float*>(ws);
  float* out = static_cast<float*>(scores);
  e = tile == 64 ? launch_scores<4>(w, out, BH, NQ, NK, dp, inv, causal, st)
                 : launch_scores<2>(w, out, BH, NQ, NK, dp, inv, causal, st);
  return (int)e;
}

extern "C" const char* skt_sparse_estimate_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
