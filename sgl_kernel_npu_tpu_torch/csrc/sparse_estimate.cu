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
// operations a head, nothing beside them). Design: one block of 512 threads
// per (batch, head), streaming q then k: a warp's lanes read 16-byte pieces of
// two rows at a time (32 rows in flight per block), sums reduced across
// warps in a fixed order into pooled rows in shared memory (f32 [NQ + NK]
// [129], 198 KB at NQ + NK = 384); then one thread per score, 128 fused
// multiply-adds each. The grid is BH blocks (32 or 64 on the main path): it
// under-fills the 132 SMs, and each SM streams its 1-2 MB alone.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_once.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int D = 128;
constexpr int PS = D + 1;              // pooled row stride (floats): no bank conflicts
constexpr float NEG = -1e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// pooled[blk][:] = sum of rows blk*bs .. blk*bs + bs - 1 of x [n*bs, D]
__device__ void pool(const __nv_bfloat16* __restrict__ x, int n, int bs, float* pooled,
                     float* red) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c8 = lane % 16, rl = tid / 16;          // 16-byte column piece, row lane 0..31
  for (int blk = 0; blk < n; ++blk) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* base = x + (size_t)blk * bs * D + c8 * 8;
#pragma unroll 4
    for (int r = rl; r < bs; r += THREADS / 16) {
      float v[8];
      load8(base + (size_t)r * D, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += v[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    if (lane < 16)
#pragma unroll
      for (int i = 0; i < 8; ++i) red[warp * D + c8 * 8 + i] = acc[i];
    __syncthreads();
    if (tid < D) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += red[w * D + tid];
      pooled[blk * PS + tid] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
estimate_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                float* __restrict__ out, int NQ, int NK, int bs, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                                 // [NQ][PS]
  float* ks = qs + NQ * PS;                         // [NK][PS]
  float* red = ks + NK * PS;                        // [WARPS][D]
  const int bh = blockIdx.x;
  pool(q + (size_t)bh * NQ * bs * D, NQ, bs, qs, red);
  pool(k + (size_t)bh * NK * bs * D, NK, bs, ks, red);
  const float inv = 1.0f / (float)(bs * bs);
  float* o = out + (size_t)bh * NQ * NK;
  for (int e = threadIdx.x; e < NQ * NK; e += THREADS) {
    const int i = e / NK, j = e % NK;
    if (causal && j > i) {
      o[e] = NEG;
      continue;
    }
    const float* a = qs + i * PS;
    const float* b = ks + j * PS;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
    o[e] = s * inv;
  }
}

}  // namespace

// q [BH, NQ*bs, D], k [BH, NK*bs, D] bf16, D = 128; scores [BH, NQ, NK] f32.
extern "C" int skt_sparse_estimate(const void* q, const void* k, void* scores, int BH, int NQ,
                                   int NK, int bs, int d, int causal, void* stream) {
  constexpr int MAX_SMEM = 227 * 1024;
  const size_t smem = ((size_t)(NQ + NK) * PS + (size_t)WARPS * D) * sizeof(float);
  if (d != D || BH <= 0 || NQ <= 0 || NK <= 0 || bs <= 0 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = skt::ensure_smem(estimate_kernel, MAX_SMEM);
  if (e != cudaSuccess) return (int)e;
  estimate_kernel<<<BH, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<float*>(scores), NQ, NK, bs, causal);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_sparse_estimate_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
