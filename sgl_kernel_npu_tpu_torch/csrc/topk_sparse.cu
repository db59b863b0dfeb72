// Kernel K19: top-k block-sparse decode attention ("rainfusion"), over
// selected 8-token blocks of one shared paged cache.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/sparse.py::
// topk_block_sparse_attention_pallas (_topk_blk_kernel, sparse.py:125-290).
// q [B, H, D]; k cache [P, ps, D], v cache [P, ps, Dv] (MLA's single-head
// layout, or one kv head shared by every query head, as multi-query models
// keep it: every head reads the same rows); block_ids [B, KB] int32, id =
// token slot / 8, -1 unused; out [B, H, Dv]; all bf16 or all fp16, any H >=
// 1. (D, Dv) is (64, 64) (Falcon-7B), (128, 128), (256, 256) (Gemma-3) or
// (576, 512) (the MLA latent rows).
//
// Rounding, as the TPU kernel takes it (all f32): the ids are taken in chunks
// of `chunk` blocks (chunk * 8 rows; the last chunk padded with -1); a -1 id
// reads block 0 and scores -1e30 (not -inf); per chunk s = (q . k) *
// sm_scale, m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m -
// m_new), l = l * alpha + rowsum(p), acc = acc * alpha + p . v; out = acc /
// max(l, 1e-20). A row whose ids are all -1 thus returns the mean of block
// 0's eight V rows, as the TPU kernel does. Against the plain version
// (ops/attention/sparse.py::topk_block_sparse_attention_ref) only the order
// of the f32 sums and the steps of the online softmax differ (this kernel
// steps every two blocks and merges splits; f32 rescales either way).
//
// Bound on an H100: bytes, the selected K and V rows read once per sequence
// (at B 128, 256 blocks of 8 rows of 576 + 512 bf16: 570 MB, 0.170 ms; 0.135
// ms for the distinct blocks of phase 1's ids). On the tensor cores the
// operations are far below that: q . k of bf16 operands is exact per product
// in f32, and p . v takes p as three bf16 parts (hi + mid + lo = p exactly),
// so three products per element (fp16: two parts, hi + lo, 22 of p's 24
// bits, and 2^-25 absolute below fp16's normal range).
//
// Design. A block of four consumer warps and one producer warp per
// (sequence, 16 heads, split): every head of the sequence in one block, so a
// row read serves all of them. The KB selected blocks of a row are split
// over S blocks (S from the card's co-resident blocks over the rows,
// csrc/device_once.cuh), each walking its share two blocks (16 tokens) a
// stage. The producer brings a stage's 16 K rows and 16 V rows by 1-D bulk
// copies (one per row, into rows padded to 16 mod 128 bytes, so ldmatrix
// reads them without bank conflicts) into a ring of 3-4 stages completed on
// mbarriers; the consumers release a stage by an arrival each. S = Q . K^T
// (16 heads x 16 tokens) is mma.sync m16n8k16 with the heads as M (a head
// block's rows past H read q as 0 and are never written), each
// consumer warp summing a quarter of D, the four partials added in a fixed
// order through shared memory; every consumer warp then runs the same
// online-softmax step and adds P . V for its quarter of Dv's columns (V by
// ldmatrix.trans, p in three bf16 or two fp16 parts). A split writes its (m, l, acc) to a
// workspace and takes a ticket from an integer arrival counter of its row;
// the last split to arrive merges the S partials in split order, writes the
// output and resets the counter to 0 (no float atomics, no host sync: a
// second call is bit-identical and a CUDA graph replays it). With S = 1 the
// block writes the output itself.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int BLK = 8;                    // tokens of a selected block
constexpr int NC = 4;                     // consumer warps
constexpr int THREADS = 32 * (NC + 1);    // + one producer warp
constexpr int HT = 16;                    // heads of a block (mma's M)
constexpr int MAX_SPLITS = 16;
constexpr float NEG = -1e30f;

template <int DK, int DV>
struct Cfg {
  static constexpr int STAGES = DK > 128 ? 3 : 4;
  static constexpr int KROW = 2 * DK + 16;         // bytes of a padded K row
  static constexpr int VROW = 2 * DV + 16;
  static constexpr int KBYTES = 2 * BLK * KROW;    // a stage: 16 K rows, then 16 V rows
  static constexpr int STAGE = KBYTES + 2 * BLK * VROW;
  static constexpr int KSW = DK / 16 / NC;         // k-steps of q . k per consumer warp
  static constexpr int NTW = DV / 8 / NC;          // 8-column tiles of p . v per warp
  static constexpr size_t SX = (size_t)NC * HT * 16 * 4;   // the partial scores
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + SX;
  static constexpr uint32_t TX = 2 * BLK * 2 * (DK + DV);  // bytes a stage's copies bring
  static_assert(DK % (16 * NC) == 0 && DV % (16 * NC) == 0 && NTW % 2 == 0, "shape");
  static_assert(KROW % 128 == 16 && VROW % 128 == 16, "padded rows");
};

template <typename T>
__device__ __forceinline__ uint32_t ld_u32(const T* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// c += a (16 x 16, row) . b (16 x 8, col), T in, f32 accumulate
template <typename T>
__device__ __forceinline__ void mma_t(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    mma(c, a, b0, b1);
}

// the NP parts of two f32 values in T (bf16: hopper.cuh's split)
template <typename T, int NP>
__device__ __forceinline__ void split_t(float x, float y, uint32_t (&part)[NP]) {
  if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const __half2 h = __floats2half2_rn(x, y);
      part[i] = *reinterpret_cast<const uint32_t*>(&h);
      const float2 hf = __half22float2(h);
      x -= hf.x;
      y -= hf.y;
    }
  } else {
    split<NP>(x, y, part);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (std::is_same<T, __half>::value)
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <int DK, int DV, typename T>
__global__ void __launch_bounds__(THREADS, 2)
topk_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
            const int* __restrict__ ids, T* __restrict__ out, float* __restrict__ ws,
            int* __restrict__ arrivals, int H, int KB, float sm_scale) {
  using C = Cfg<DK, DV>;
  // p's parts: bf16 three (exact), fp16 two
  constexpr int NP = std::is_same<T, __half>::value ? 2 : 3;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[C::STAGES], empty[C::STAGES];
  __shared__ float wgt[HT][MAX_SPLITS], lsum[HT];
  __shared__ int last;
  const int si = blockIdx.x, S = gridDim.x, ht = blockIdx.y, b = blockIdx.z;
  const int row = b * gridDim.y + ht, h0 = ht * HT;
  const int j0 = (int)((long long)KB * si / S), j1 = (int)((long long)KB * (si + 1) / S);
  const int nst = (j1 - j0 + 1) / 2;               // stages of two blocks
  const int* idb = ids + (size_t)b * KB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NC);                   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NC) {
    // producer: a stage's 32 rows, one bulk copy each; a -1 id and the
    // missing second block of an odd tail read block 0
    for (int j = 0; j < nst; ++j) {
      const int st = j % C::STAGES;
      if (j >= C::STAGES) mbar_wait(&empty[st], ((j / C::STAGES) - 1) & 1);
      if (lane == 0) mbar_expect_tx(&full[st], C::TX);
      __syncwarp();
      if (lane < 2 * BLK) {
        const int jb = j0 + 2 * j + lane / BLK;
        const int id = jb < j1 ? max(__ldg(idb + jb), 0) : 0;
        const size_t r = (size_t)id * BLK + lane % BLK;
        unsigned char* base = smem + (size_t)st * C::STAGE;
        bulk_load(base + lane * C::KROW, kc + r * DK, 2 * DK, &full[st]);
        bulk_load(base + C::KBYTES + lane * C::VROW, vc + r * DV, 2 * DV, &full[st]);
      }
    }
  } else {
    const int tid = threadIdx.x, g = lane >> 2, tig = lane & 3;
    // q fragments (A, 16 heads x this warp's k-steps); heads past H are 0
    uint32_t qa[C::KSW][4];
    const bool ha = h0 + g < H, hb = h0 + g + 8 < H;
    const T* qA = q + ((size_t)b * H + h0 + g) * DK;
    const T* qB = qA + 8 * DK;
#pragma unroll
    for (int kk = 0; kk < C::KSW; ++kk) {
      const int d = (warp * C::KSW + kk) * 16 + 2 * tig;
      qa[kk][0] = ha ? ld_u32(qA + d) : 0u;
      qa[kk][1] = hb ? ld_u32(qB + d) : 0u;
      qa[kk][2] = ha ? ld_u32(qA + d + 8) : 0u;
      qa[kk][3] = hb ? ld_u32(qB + d + 8) : 0u;
    }
    float acc[C::NTW][4];
#pragma unroll
    for (int t = 0; t < C::NTW; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    float* sx = reinterpret_cast<float*>(smem + (size_t)C::STAGES * C::STAGE);  // [NC][16][16]
    // ldmatrix lanes: K rows (tokens) for the B operand of S, V rows for P . V
    const int kr = (lane & 7) + ((lane >> 4) << 3), kc8 = ((lane >> 3) & 1) * 8;
    const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vc8 = (lane >> 4) * 8;

    for (int j = 0; j < nst; ++j) {
      const int st = j % C::STAGES;
      const unsigned char* kb = smem + (size_t)st * C::STAGE;
      const unsigned char* vb = kb + C::KBYTES;
      mbar_wait(&full[st], (j / C::STAGES) & 1);

      // this warp's quarter of q . k for the stage's 16 tokens
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < C::KSW; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, kb + kr * C::KROW + ((warp * C::KSW + kk) * 16 + kc8) * 2);
        mma_t<T>(s[0], qa[kk], kf[0], kf[1]);
        mma_t<T>(s[1], qa[kk], kf[2], kf[3]);
      }
      bar_sync(2, 32 * NC);                         // the last stage's partials are read
      float* mine = sx + warp * HT * 16;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        *reinterpret_cast<float2*>(mine + g * 16 + nb * 8 + 2 * tig) = make_float2(s[nb][0], s[nb][1]);
        *reinterpret_cast<float2*>(mine + (g + 8) * 16 + nb * 8 + 2 * tig) =
            make_float2(s[nb][2], s[nb][3]);
      }
      bar_sync(1, 32 * NC);
      // the full scores, the partials added in warp order (the same in every
      // warp); masked: -1e30 for a -1 id, -inf for the missing tail block
      float sc[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int jb = j0 + 2 * j + nb;
        const int id = jb < j1 ? __ldg(idb + jb) : 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = (g + 8 * (e >> 1)) * 16 + nb * 8 + 2 * tig + (e & 1);
          float v = sx[off];
#pragma unroll
          for (int w = 1; w < NC; ++w) v += sx[w * HT * 16 + off];
          sc[nb][e] = jb >= j1 ? -CUDART_INF_F : id < 0 ? NEG : v * sm_scale;
        }
      }
      // online-softmax step (rows g and g + 8 of the 16 heads)
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]), fmaxf(sc[1][2 * r], sc[1][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r], mx);
        alpha[r] = expf(m[r] - mn);
        m[r] = mn;
      }
      float p[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nb][e] = expf(sc[nb][e] - m[e >> 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] + ((p[0][2 * r] + p[0][2 * r + 1]) + (p[1][2 * r] + p[1][2 * r + 1]));
#pragma unroll
      for (int t = 0; t < C::NTW; ++t) {
        acc[t][0] *= alpha[0];
        acc[t][1] *= alpha[0];
        acc[t][2] *= alpha[1];
        acc[t][3] *= alpha[1];
      }
      // p as the A fragments of its NP parts (tokens 0-7: block 0)
      uint32_t pa[NP][4];
      {
        uint32_t part[NP];
        split_t<T, NP>(p[0][0], p[0][1], part);
#pragma unroll
        for (int i = 0; i < NP; ++i) pa[i][0] = part[i];
        split_t<T, NP>(p[0][2], p[0][3], part);
#pragma unroll
        for (int i = 0; i < NP; ++i) pa[i][1] = part[i];
        split_t<T, NP>(p[1][0], p[1][1], part);
#pragma unroll
        for (int i = 0; i < NP; ++i) pa[i][2] = part[i];
        split_t<T, NP>(p[1][2], p[1][3], part);
#pragma unroll
        for (int i = 0; i < NP; ++i) pa[i][3] = part[i];
      }
      // P . V over this warp's columns, the small parts first
#pragma unroll
      for (int t = 0; t < C::NTW; t += 2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vb + vr * C::VROW + ((warp * C::NTW + t) * 8 + vc8) * 2);
#pragma unroll
        for (int i = NP - 1; i >= 0; --i) {
          mma_t<T>(acc[t], pa[i], vf[0], vf[1]);
          mma_t<T>(acc[t + 1], pa[i], vf[2], vf[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }

    const bool hv[2] = {ha, hb};
    if (S == 1) {
#pragma unroll
      for (int t = 0; t < C::NTW; ++t) {
        const int c = (warp * C::NTW + t) * 8 + 2 * tig;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!hv[r]) continue;
          const float lr = fmaxf(l[r], 1e-20f);
          store2(out + ((size_t)b * H + h0 + g + 8 * r) * DV + c, acc[t][2 * r] / lr,
                 acc[t][2 * r + 1] / lr);
        }
      }
    } else {
      // this split's partial: m [16], l [16], acc [16][Dv]
      constexpr size_t PART = 2 * HT + (size_t)HT * DV;
      float* part = ws + ((size_t)row * S + si) * PART;
      if (warp == 0 && tig == 0) {
        part[g] = m[0];
        part[g + 8] = m[1];
        part[HT + g] = l[0];
        part[HT + g + 8] = l[1];
      }
#pragma unroll
      for (int t = 0; t < C::NTW; ++t) {
        const int c = (warp * C::NTW + t) * 8 + 2 * tig;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(part + 2 * HT + (size_t)(g + 8 * r) * DV + c) =
              make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
      }
      __threadfence();
      bar_sync(1, 32 * NC);
      if (tid == 0) last = atomicAdd(arrivals + row, 1) == S - 1;
      bar_sync(1, 32 * NC);
      if (last) {
        // the last split of the row merges all S in split order
        __threadfence();
        const float* base = ws + (size_t)row * S * PART;
        // (every load of a loop issued before its sums, which go in split order)
        if (tid < HT) {
          float ms[MAX_SPLITS], lp[MAX_SPLITS];
#pragma unroll
          for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
            ms[s2] = s2 < S ? __ldcg(base + s2 * PART + tid) : -CUDART_INF_F;
            lp[s2] = s2 < S ? __ldcg(base + s2 * PART + HT + tid) : 0.f;
          }
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int s2 = 0; s2 < MAX_SPLITS; ++s2) mx = fmaxf(mx, ms[s2]);
          float ls = 0.f;
#pragma unroll
          for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
            if (s2 >= S) break;
            const float w = expf(ms[s2] - mx);
            wgt[tid][s2] = w;
            ls += w * lp[s2];
          }
          lsum[tid] = fmaxf(ls, 1e-20f);
        }
        bar_sync(1, 32 * NC);
        for (int e = tid; e < HT * DV / 2; e += 32 * NC) {
          const int hh = e / (DV / 2), c = 2 * (e % (DV / 2));
          if (h0 + hh >= H) continue;
          float2 pv[MAX_SPLITS];
#pragma unroll
          for (int s2 = 0; s2 < MAX_SPLITS; ++s2)
            pv[s2] = s2 < S ? __ldcg(reinterpret_cast<const float2*>(
                                  base + s2 * PART + 2 * HT + (size_t)hh * DV + c))
                            : make_float2(0.f, 0.f);
          float2 o = make_float2(0.f, 0.f);
#pragma unroll
          for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
            if (s2 >= S) break;
            o.x += wgt[hh][s2] * pv[s2].x;
            o.y += wgt[hh][s2] * pv[s2].y;
          }
          store2(out + ((size_t)b * H + h0 + hh) * DV + c, o.x / lsum[hh], o.y / lsum[hh]);
        }
        if (tid == 0) arrivals[row] = 0;            // ready for the next call
      }
    }
  }
}

template <int DK, int DV, typename T>
cudaError_t splits(int B, int H, int KB, int& S) {
  auto kern = topk_kernel<DK, DV, T>;
  cudaError_t e = skt::ensure_smem(kern, Cfg<DK, DV>::SMEM);
  if (e != cudaSuccess) return e;
  int resident = 0;
  if ((e = skt::resident_blocks(kern, THREADS, Cfg<DK, DV>::SMEM, resident)) != cudaSuccess)
    return e;
  // one wave: as many splits as the card holds blocks for every row, each
  // split at least two stages
  const int rows = B * ((H + HT - 1) / HT);
  S = std::max(1, std::min({resident / rows, MAX_SPLITS, KB / 4}));
  return cudaSuccess;
}

template <int DK, int DV, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* ids, void* out,
                   void* ws, void* arrivals, int B, int H, int KB, int S, float sm_scale,
                   cudaStream_t st) {
  auto kern = topk_kernel<DK, DV, T>;
  const cudaError_t e = skt::ensure_smem(kern, Cfg<DK, DV>::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<dim3(S, (H + HT - 1) / HT, B), THREADS, Cfg<DK, DV>::SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ids,
      static_cast<T*>(out), static_cast<float*>(ws), static_cast<int*>(arrivals), H, KB,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// (D, Dv) and the element type of each instantiation: CALL(DK, DV, T)
#define SKT_TOPK_CASES(d, dv, dtype, CALL)                                   \
  if (dtype == 0 && d == 64 && dv == 64) return CALL(64, 64, __nv_bfloat16);   \
  if (dtype == 0 && d == 128 && dv == 128) return CALL(128, 128, __nv_bfloat16); \
  if (dtype == 0 && d == 256 && dv == 256) return CALL(256, 256, __nv_bfloat16); \
  if (dtype == 0 && d == 576 && dv == 512) return CALL(576, 512, __nv_bfloat16); \
  if (dtype == 1 && d == 64 && dv == 64) return CALL(64, 64, __half);          \
  if (dtype == 1 && d == 128 && dv == 128) return CALL(128, 128, __half);      \
  if (dtype == 1 && d == 256 && dv == 256) return CALL(256, 256, __half);      \
  if (dtype == 1 && d == 576 && dv == 512) return CALL(576, 512, __half);

namespace {
template <int DK, int DV, typename T>
int splits_or_error(int B, int H, int KB) {
  int S = 0;
  const cudaError_t e = splits<DK, DV, T>(B, H, KB, S);
  return e == cudaSuccess ? S : -(int)e;
}
}  // namespace

// The number of splits S of each row that skt_topk_block_sparse takes on
// the current device, or minus a CUDA error. The workspace it needs holds
// B * ceil(H / 16) * S * (32 + 16 * Dv) floats (none for S = 1), the arrival
// counters B * ceil(H / 16) ints, zero before the first call.
extern "C" int skt_topk_block_sparse_splits(int B, int H, int KB, int d, int dv, int dtype) {
  if (B <= 0 || H <= 0 || KB <= 0) return -(int)cudaErrorInvalidValue;
#define SKT_SPLITS(DK, DV, T) splits_or_error<DK, DV, T>(B, H, KB)
  SKT_TOPK_CASES(d, dv, dtype, SKT_SPLITS)
#undef SKT_SPLITS
  return -(int)cudaErrorInvalidValue;
}

// q [B, H, D], k cache [P, ps, D], v cache [P, ps, Dv], block_ids [B, KB]
// int32, out [B, H, Dv]; dtype 0 bf16, 1 fp16. H >= 1, 0 < chunk <= 64 (the
// plain version's softmax step; this kernel steps every two blocks), (D, Dv)
// one of (64, 64), (128, 128), (256, 256), (576, 512); S from
// skt_topk_block_sparse_splits, ws and arrivals as it says.
extern "C" int skt_topk_block_sparse(const void* q, const void* k, const void* v,
                                     const void* ids, void* out, void* ws, void* arrivals,
                                     int B, int H, int KB, int chunk, int S, int d, int dv,
                                     int dtype, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || KB <= 0 || chunk <= 0 || chunk > 64 || S < 1 || S > MAX_SPLITS ||
      S > KB || (S > 1 && (ws == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
#define SKT_LAUNCH(DK, DV, T) \
  (int)launch<DK, DV, T>(q, k, v, id, out, ws, arrivals, B, H, KB, S, sm_scale, st)
  SKT_TOPK_CASES(d, dv, dtype, SKT_LAUNCH)
#undef SKT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* skt_topk_sparse_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
