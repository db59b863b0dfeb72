// Kernel K19: top-k block-sparse decode attention ("rainfusion"), over
// selected 8-token blocks of one shared paged cache.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/sparse.py::
// topk_block_sparse_attention_pallas (_topk_blk_kernel, sparse.py:125-290).
// q [B, H, D] bf16; k cache [P, ps, D], v cache [P, ps, Dv] bf16 (MLA's
// single-head layout: every head reads the same rows); block_ids [B, KB]
// int32, id = token slot / 8, -1 unused; out [B, H, Dv] bf16. (D, Dv) is
// (128, 128) or (576, 512).
//
// Rounding, as the TPU kernel takes it (all f32): the ids are taken in chunks
// of `chunk` blocks (chunk * 8 rows; the last chunk padded with -1); a -1 id
// reads block 0 and scores -1e30 (not -inf); per chunk s = (q . k) *
// sm_scale, m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m -
// m_new), l = l * alpha + rowsum(p), acc = acc * alpha + p . v; out = acc /
// max(l, 1e-20). A row whose ids are all -1 thus returns the mean of block
// 0's eight V rows, as the TPU kernel does. Against the plain version
// (ops/attention/sparse.py::topk_block_sparse_attention_ref) only the order
// of the f32 sums differs.
//
// Bound on an H100: bytes, the selected K and V rows read once per sequence
// (at B 128, 256 blocks of 8 rows of 576 + 512 bf16: 570 MB, 0.170 ms); the
// f32 operations are 2 (D + Dv) per (head, row), 0.136 ms at the f32 rate
// there. Design: one block of 256 threads per (sequence, group of 8 or 16
// heads), so a row read serves every head of the group; per chunk, a pass
// over sub-chunks of 64 rows stages K by cp.async and scores them (a warp
// takes 8 rows, 4 lanes a row over interleaved words, q transposed in f32),
// one softmax step over the chunk's scores in shared memory, then a pass
// that stages V and accumulates p . v (a thread owns 2 columns of its heads).
// Loads and compute do not overlap (one buffer).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_once.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 64;                  // rows per sub-chunk: 8 warps x 8 rows
constexpr int BLK = 8;
constexpr int MAXROWS = 64 * BLK;      // rows of a chunk of 64 blocks
constexpr float NEG = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int DK, int DV, int HG>
struct Cfg {
  static constexpr int QS = HG + 4;                // qT row stride (floats)
  static constexpr int KS = DK + 8;                // staged K row stride (bf16)
  static constexpr int HSETS = 2 * THREADS / DV;   // head sets of the P.V pass
  static constexpr int HPV = HG / HSETS;           // heads a P.V thread owns
  static constexpr size_t Q_BYTES = (size_t)DK * QS * 4;
  static constexpr size_t KV_BYTES =
      (size_t)R * (KS > DV ? KS : DV) * 2;
  static constexpr size_t P_BYTES = (size_t)MAXROWS * HG * 4;
  static constexpr size_t SMEM = Q_BYTES + KV_BYTES + P_BYTES;
  static_assert(DV % 2 == 0 && 2 * THREADS % DV == 0 && HG % HSETS == 0, "shape");
  static_assert(HG % 4 == 0 && DK % 8 == 0, "shape");
};

template <int DK, int DV, int HG>
__global__ void __launch_bounds__(THREADS)
topk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
            const __nv_bfloat16* __restrict__ vc, const int* __restrict__ ids,
            __nv_bfloat16* __restrict__ out, int H, int KB, int chunk, float sm_scale) {
  using C = Cfg<DK, DV, HG>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qT = reinterpret_cast<float*>(smem);                         // [DK][QS]
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem + C::Q_BYTES);
  float* pT = reinterpret_cast<float*>(smem + C::Q_BYTES + C::KV_BYTES);  // [rows][HG]
  __shared__ float m_s[HG], l_s[HG], alpha_s[HG], red[WARPS][HG];
  const int b = blockIdx.x, h0 = blockIdx.y * HG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* idb = ids + (size_t)b * KB;

  for (int e = tid; e < HG * DK; e += THREADS) {
    const int hh = e / DK, d = e % DK;
    qT[d * C::QS + hh] = __bfloat162float(q[((size_t)b * H + h0 + hh) * DK + d]);
  }
  if (tid < HG) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  const int pair = tid % (DV / 2), hs = tid / (DV / 2);
  float acc[C::HPV][2];
#pragma unroll
  for (int i = 0; i < C::HPV; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int rows = chunk * BLK;
  const int nc = (KB + chunk - 1) / chunk;
  for (int c = 0; c < nc; ++c) {
    auto block_of = [&](int r) {                   // block id of chunk row r, or -1
      const int j = c * chunk + r / BLK;
      return j < KB ? idb[j] : -1;
    };
    // scores of the chunk's rows, sub-chunk by sub-chunk
    for (int r0 = 0; r0 < rows; r0 += R) {
      const int nr = min(R, rows - r0);
      for (int e = tid; e < nr * (DK / 8); e += THREADS) {
        const int r = e / (DK / 8), cc = (e % (DK / 8)) * 8;
        const int id = max(block_of(r0 + r), 0);
        cp_async16(kv + r * C::KS + cc, kc + ((size_t)id * BLK + (r0 + r) % BLK) * DK + cc);
      }
      cp_commit_wait();
      __syncthreads();
      const int rr = warp * 8 + lane / 4, q4 = lane % 4;
      float s[HG];
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) s[hh] = 0.f;
      const unsigned* krow = reinterpret_cast<const unsigned*>(kv + rr * C::KS);
#pragma unroll 2
      for (int w = q4; w < DK / 2; w += 4) {
        const unsigned raw = krow[w];
        const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        const float4* q0 = reinterpret_cast<const float4*>(qT + (2 * w) * C::QS);
        const float4* q1 = reinterpret_cast<const float4*>(qT + (2 * w + 1) * C::QS);
#pragma unroll
        for (int v4 = 0; v4 < HG / 4; ++v4) {
          const float4 a = q0[v4], bb = q1[v4];
          s[4 * v4] = fmaf(kf.y, bb.x, fmaf(kf.x, a.x, s[4 * v4]));
          s[4 * v4 + 1] = fmaf(kf.y, bb.y, fmaf(kf.x, a.y, s[4 * v4 + 1]));
          s[4 * v4 + 2] = fmaf(kf.y, bb.z, fmaf(kf.x, a.z, s[4 * v4 + 2]));
          s[4 * v4 + 3] = fmaf(kf.y, bb.w, fmaf(kf.x, a.w, s[4 * v4 + 3]));
        }
      }
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
        s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
      }
      if (rr < nr) {
        const bool valid = block_of(r0 + rr) >= 0;
#pragma unroll
        for (int hh = 0; hh < HG; ++hh)
          if (hh % 4 == q4) pT[(r0 + rr) * HG + hh] = valid ? s[hh] * sm_scale : NEG;
      }
      __syncthreads();
    }

    // one online-softmax step over the chunk: thread (head tid % HG, rows
    // tid / HG + k * THREADS / HG)
    {
      const int hh = tid % HG;
      float mx = NEG;
      for (int r = tid / HG; r < rows; r += THREADS / HG) mx = fmaxf(mx, pT[r * HG + hh]);
      for (int o = HG; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane < HG) red[warp][hh] = mx;
      __syncthreads();
      if (tid < HG) {
        float mt = red[0][tid];
        for (int w = 1; w < WARPS; ++w) mt = fmaxf(mt, red[w][tid]);
        const float mn = fmaxf(m_s[tid], mt);
        alpha_s[tid] = expf(m_s[tid] - mn);
        m_s[tid] = mn;
      }
      __syncthreads();
      const float mn = m_s[hh];
      float ps = 0.f;
      for (int r = tid / HG; r < rows; r += THREADS / HG) {
        const float p = expf(pT[r * HG + hh] - mn);
        pT[r * HG + hh] = p;
        ps += p;
      }
      for (int o = HG; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      if (lane < HG) red[warp][hh] = ps;
      __syncthreads();
      if (tid < HG) {
        float st = 0.f;
        for (int w = 0; w < WARPS; ++w) st += red[w][tid];
        l_s[tid] = l_s[tid] * alpha_s[tid] + st;
      }
    }

    // p . v over the chunk, V staged sub-chunk by sub-chunk
    float o[C::HPV][2];
#pragma unroll
    for (int i = 0; i < C::HPV; ++i) o[i][0] = o[i][1] = 0.f;
    for (int r0 = 0; r0 < rows; r0 += R) {
      const int nr = min(R, rows - r0);
      __syncthreads();                             // the buffer's last readers are done
      for (int e = tid; e < nr * (DV / 8); e += THREADS) {
        const int r = e / (DV / 8), cc = (e % (DV / 8)) * 8;
        const int id = max(block_of(r0 + r), 0);
        cp_async16(kv + r * DV + cc, vc + ((size_t)id * BLK + (r0 + r) % BLK) * DV + cc);
      }
      cp_commit_wait();
      __syncthreads();
      for (int r = 0; r < nr; ++r) {
        const unsigned raw = reinterpret_cast<const unsigned*>(kv + r * DV)[pair];
        const float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        const float* pr = pT + (r0 + r) * HG + hs * C::HPV;
#pragma unroll
        for (int i = 0; i < C::HPV; ++i) {
          const float p = pr[i];
          o[i][0] = fmaf(p, vf.x, o[i][0]);
          o[i][1] = fmaf(p, vf.y, o[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C::HPV; ++i) {
      const float al = alpha_s[hs * C::HPV + i];
      acc[i][0] = acc[i][0] * al + o[i][0];
      acc[i][1] = acc[i][1] * al + o[i][1];
    }
    __syncthreads();                               // pT, alpha_s and the buffer are reused
  }

#pragma unroll
  for (int i = 0; i < C::HPV; ++i) {
    const int hh = hs * C::HPV + i;
    const float l = fmaxf(l_s[hh], 1e-20f);
    *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * H + h0 + hh) * DV + pair * 2) =
        __floats2bfloat162_rn(acc[i][0] / l, acc[i][1] / l);
  }
}

template <int DK, int DV, int HG>
cudaError_t launch(const void* q, const void* k, const void* v, const int* ids, void* out,
                   int B, int H, int KB, int chunk, float sm_scale, cudaStream_t st) {
  auto kern = topk_kernel<DK, DV, HG>;
  const cudaError_t e = skt::ensure_smem(kern, (size_t)Cfg<DK, DV, HG>::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<dim3(B, H / HG), THREADS, Cfg<DK, DV, HG>::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ids, static_cast<__nv_bfloat16*>(out), H, KB,
      chunk, sm_scale);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t by_group(const void* q, const void* k, const void* v, const int* ids, void* out,
                     int B, int H, int KB, int chunk, float sm_scale, cudaStream_t st) {
  // 16 heads a block once that still gives a block per SM or so, else 8
  if (H % 16 == 0 && B * (H / 16) >= 128)
    return launch<DK, DV, 16>(q, k, v, ids, out, B, H, KB, chunk, sm_scale, st);
  return launch<DK, DV, 8>(q, k, v, ids, out, B, H, KB, chunk, sm_scale, st);
}

}  // namespace

// q [B, H, D], k cache [P, ps, D], v cache [P, ps, Dv], block_ids [B, KB]
// int32, out [B, H, Dv]; bf16. H % 8 == 0, 0 < chunk <= 64, (D, Dv) one of
// (128, 128), (576, 512).
extern "C" int skt_topk_block_sparse(const void* q, const void* k, const void* v,
                                     const void* ids, void* out, int B, int H, int KB,
                                     int chunk, int d, int dv, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || H % 8 || KB <= 0 || chunk <= 0 || chunk > 64)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (d == 128 && dv == 128)
    return (int)by_group<128, 128>(q, k, v, id, out, B, H, KB, chunk, sm_scale, st);
  if (d == 576 && dv == 512)
    return (int)by_group<576, 512>(q, k, v, id, out, B, H, KB, chunk, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* skt_topk_sparse_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
