// Kernel K18: the sparse-block estimator's block scores: block sums of q and
// of k, one dot per (query block, kv block), causal -1e30.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/sparse.py::
// sparse_block_estimate_pallas (_estimate_kernel, sparse.py:302-320): for
// each (batch, head) row of q [BH, NQ*bs, D] and k [BH, NK*bs, D] (bf16,
// D = 128), in f32:
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
//   1. pool_kernel: one block of 256 threads per pooled block (bs rows of q
//      or of k of one (batch, head)), BH * (NQ + NK) blocks over the whole
//      card; 16 threads a row (16-byte pieces), 16 rows a pass, each thread
//      DEPTH loads in flight; the 16 row groups' sums reduced in a fixed
//      order. It writes the pooled f32 rows to the workspace ws
//      [BH, NQ + NK, D] (q's blocks, then k's), so no shared-memory cap
//      bounds NQ + NK.
//   2. score_kernel<M>: one block of 256 threads per tile of 16M x 16M
//      scores of one (batch, head): the tile's pooled rows staged in shared
//      memory, each thread an M x M piece of f32 FMAs over d in order;
//      tiles wholly above the diagonal (causal) only write -1e30. M (2 or
//      4) is the caller's plan (ops/attention/sparse.py::estimate_plan).
// The sums are f32 and deterministic: the same inputs give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_once.cuh"

namespace {

constexpr int D = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_LANES = D / 8;                  // 16-byte pieces of a bf16 row
constexpr int ROWS = THREADS / ROW_LANES;         // rows a pass
constexpr int DEPTH = 8;                          // loads a thread keeps in flight
constexpr int PS = D + 4;                         // staged row stride (floats): 16-byte
                                                  // aligned, conflict-free float4 reads
constexpr float NEG = -1e30f;

// ws[bh][blk][:] = sum of rows blk*bs .. blk*bs + bs - 1 of q (blk < NQ) or
// of k (blk - NQ)
__global__ void __launch_bounds__(THREADS)
pool_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            float* __restrict__ ws, int NQ, int NK, int bs) {
  __shared__ float red[WARPS][D];
  const int blk = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c8 = tid % ROW_LANES, rl = tid / ROW_LANES;
  const __nv_bfloat16* base =
      blk < NQ ? q + ((size_t)bh * NQ + blk) * bs * D
               : k + ((size_t)bh * NK + (blk - NQ)) * bs * D;
  base += c8 * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r0 = rl; r0 < bs; r0 += ROWS * DEPTH) {
    int4 raw[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int r = r0 + u * ROWS;
      raw[u] = r < bs ? __ldcs(reinterpret_cast<const int4*>(base + (size_t)r * D))
                      : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        acc[2 * i] += f.x;
        acc[2 * i + 1] += f.y;
      }
    }
  }
  // the warp's two row groups, then the eight warps in order
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  if (lane < 16)
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp][c8 * 8 + i] = acc[i];
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][tid];
    ws[((size_t)bh * (NQ + NK) + blk) * D + tid] = s;
  }
}

// scores of the tile (blockIdx.y, blockIdx.x) of (batch, head) blockIdx.z
template <int M>
__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ ws, float* __restrict__ out, int NQ, int NK, float inv,
             int causal) {
  constexpr int T = 16 * M;
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
  const float* pq = ws + (size_t)bh * (NQ + NK) * D;
  const float* pk = pq + (size_t)NQ * D;
  for (int e = tid; e < T * (D / 4); e += THREADS) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(sq + r * PS + c) =
        i0 + r < NQ ? *reinterpret_cast<const float4*>(pq + (size_t)(i0 + r) * D + c) : zero;
    *reinterpret_cast<float4*>(sk + r * PS + c) =
        j0 + r < NK ? *reinterpret_cast<const float4*>(pk + (size_t)(j0 + r) * D + c) : zero;
  }
  __syncthreads();
  float acc[M][M];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < M; ++n) acc[m][n] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
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
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < M; ++n) {
      const int i = i0 + ty + 16 * m, j = j0 + tx + 16 * n;
      if (i < NQ && j < NK) o[(size_t)i * NK + j] = causal && j > i ? NEG : acc[m][n] * inv;
    }
}

template <int M>
cudaError_t launch_scores(const float* ws, float* out, int BH, int NQ, int NK, float inv,
                          int causal, cudaStream_t st) {
  constexpr int T = 16 * M;
  const size_t smem = 2 * (size_t)T * PS * sizeof(float);
  const cudaError_t e = skt::ensure_smem(score_kernel<M>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((NK + T - 1) / T, (NQ + T - 1) / T, BH);
  score_kernel<M><<<grid, THREADS, smem, st>>>(ws, out, NQ, NK, inv, causal);
  return cudaGetLastError();
}

}  // namespace

// q [BH, NQ*bs, D], k [BH, NK*bs, D] bf16, D = 128; ws [BH, NQ + NK, D] f32
// (written, then read: no state between calls); scores [BH, NQ, NK] f32;
// tile 32 or 64 scores a side (M 2 or 4). Two launches.
extern "C" int skt_sparse_estimate(const void* q, const void* k, void* ws, void* scores, int BH,
                                   int NQ, int NK, int bs, int d, int causal, int tile,
                                   void* stream) {
  if (d != D || BH <= 0 || BH > 65535 || NQ <= 0 || NK <= 0 || bs <= 0 || bs > 46340 ||
      (tile != 32 && tile != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pool_kernel<<<dim3(NQ + NK, BH), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<float*>(ws), NQ, NK, bs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float inv = 1.0f / (float)(bs * bs);
  const float* w = static_cast<const float*>(ws);
  float* out = static_cast<float*>(scores);
  e = tile == 64 ? launch_scores<4>(w, out, BH, NQ, NK, inv, causal, st)
                 : launch_scores<2>(w, out, BH, NQ, NK, inv, causal, st);
  return (int)e;
}

extern "C" const char* skt_sparse_estimate_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
