// Kernel K7: paged MLA decode over split latent caches, all in f32.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode.py::decode_mla_pallas
// (_mla_decode_kernel, decode.py:192-283), the serving engine's attention.
//
// q [B, H, lkv + lrope] bf16; ckv [P, ps, lkv] and krope [P, ps, lrope] bf16
// (one layer's caches, one latent head); seq_lens [B] INCLUDING the current
// token, which is already in the cache; block table [B, MP]; out [B, H, lkv]
// bf16.
//
// Rounding. The score is (q[:lkv] . ckv) + (q[lkv:] . krope) times
// sm_scale; columns past seq_len take no weight; exp, the row sums and P . V
// stay in f32 (p is never rounded to bf16); the result is divided by
// max(l, 1e-37). The TPU kernel steps its online softmax one page at a time;
// this one steps every 32 tokens and splits a sequence over blocks. Since
// nothing inside the loop rounds to bf16, the step size and the splits
// change only the order of f32 sums and rescalings: unlike kernels B and C,
// K7 need not take its softmax in its plain version's steps
// (ops/attention/decode.py::decode_mla_ref, one page a step).
//
// Bound on an H100: the bytes of the cached rows, seq_len * (lkv + lrope) * 2
// per sequence and layer, over 3.35 TB/s (2.7 MB, 0.0008 ms at the engine's
// batch of 8 sequences of 41..701 tokens). At that size the kernel is bound
// by latency: how many rows one block walks one after another. Design:
//   * one block holds the (up to) 16 heads of a sequence, so every cached
//     row is read once per sequence: MLA is MQA at the latent level, and the
//     16 heads are the M = 16 of a bf16 mma.sync m16n8k16;
//   * each sequence's rounds of 32 tokens are split over S_b blocks of at
//     least two rounds each (S_b <= S, the grid's splits, sized by the
//     wrapper from the card's SM count and the batch:
//     ops/attention/decode.py::mla_splits and mla_split_bounds, which
//     splits_of and the kernel's bounds mirror);
//   * all four warps stage 32 tokens a round through a 3-stage cp.async
//     ring: the ckv rows (1,040-byte padded rows: ldmatrix reads them
//     without bank conflicts) and the krope rows, zero-padded to 64 columns;
//   * scores: q (A fragments in registers) . [ckv | krope] as bf16 mma.sync
//     (products exact in f32, sums in f32), each warp a quarter of the 36
//     k-steps, the four partials added in warp order through shared memory;
//   * P . V: p as three bf16 parts (hi + mid + lo = p exactly), ckv by
//     ldmatrix.trans, each warp a quarter of the 512 output columns;
//   * a split writes its (m, l, acc [16, 512]) to a workspace and takes a
//     ticket from an integer arrival counter of its (sequence, head tile);
//     the last split to arrive merges the S_b partials in split order,
//     writes the output and resets the counter to 0 (no float atomics, no
//     host sync: a second call is bit-identical and a CUDA graph replays
//     it). A sequence of one split writes its output directly.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int NC = 4;                       // warps, all consumers, all loaders
constexpr int THREADS = 32 * NC;
constexpr int HT = 16;                      // heads of a block (mma's M)
constexpr int LKV = 512;
constexpr int LR = 64;                      // krope columns as staged (zero past lrope)
constexpr int T = 32;                       // tokens a round
constexpr int STAGES = 3;
constexpr int MIN_ROUNDS = 2;               // rounds a split takes at least
constexpr int MAX_SPLITS = 16;
constexpr int CROW = 2 * LKV + 16;          // bytes of a padded ckv row
constexpr int RROW = 2 * LR + 16;           // bytes of a padded krope row
constexpr int CBYTES = T * CROW;            // a stage: T ckv rows, then T krope rows
constexpr int STAGE = CBYTES + T * RROW;
constexpr int KSTEPS = (LKV + LR) / 16;     // 36 k-steps of q . k
constexpr int KSW = KSTEPS / NC;            // per warp
constexpr int NTW = LKV / 8 / NC;           // 8-column tiles of P . V per warp
constexpr size_t SX = (size_t)NC * HT * T * 4;   // the partial scores
constexpr size_t SMEM = (size_t)STAGES * STAGE + SX;
constexpr size_t PART = 2 * HT + (size_t)HT * LKV;   // floats of a split's partial
static_assert(KSTEPS % NC == 0 && NTW % 2 == 0, "shape");
static_assert(CROW % 128 == 16 && RROW % 128 == 16, "padded rows");

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// the splits of a sequence of R rounds (ops/attention/decode.py::
// mla_split_bounds): split si of S_b takes rounds R si / S_b .. R (si + 1) / S_b
__device__ __forceinline__ int splits_of(int R, int S) {
  return min(S, max(1, R / MIN_ROUNDS));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__global__ void __launch_bounds__(THREADS, 1)
decode_mla_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ckv,
                  const __nv_bfloat16* __restrict__ krope, const int* __restrict__ seq_lens,
                  const int* __restrict__ bt, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ arrivals, int H, int lrope, int ps,
                  int MP, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float wgt[HT][MAX_SPLITS], lsum[HT];
  __shared__ int last;
  const int si = blockIdx.x, S = gridDim.x, ht = blockIdx.y, b = blockIdx.z;
  const int n = min(max(seq_lens[b], 0), MP * ps);
  const int R = cdiv(n, T);
  const int Sb = splits_of(R, S);
  if (si >= Sb) return;
  const int r0 = R * si / Sb, r1 = R * (si + 1) / Sb;
  const int t0 = min(n, T * r0), t1 = min(n, T * r1);
  const int rounds = r1 - r0;
  const int row = b * gridDim.y + ht, h0 = ht * HT;
  const int* btb = bt + (size_t)b * MP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int d = LKV + lrope;
  const bool rope16 = lrope % 8 == 0;

  // loader: thread tid brings row tid / 4 of a round; its 16-byte ckv chunks
  // (tid % 4) + 4 j and its krope chunks (16 bytes, or 4 where lrope % 8)
  const int lr = tid / 4, lq = tid % 4;
  auto load = [&](int j) {
    unsigned char* st = smem + (size_t)(j % STAGES) * STAGE;
    const int tok = t0 + j * T + lr;
    const bool live = tok < t1;
    const size_t r = live ? (size_t)btb[tok / ps] * ps + tok % ps : 0;
    const __nv_bfloat16* src = ckv + r * LKV;
    unsigned char* dst = st + lr * CROW;
#pragma unroll
    for (int c = 0; c < LKV / 8 / 4; ++c) {
      const int ch = lq + 4 * c;
      cp_async16(dst + ch * 16, src + ch * 8, live);
    }
    const __nv_bfloat16* rs = krope + r * lrope;
    unsigned char* rd = st + CBYTES + lr * RROW;
    if (rope16) {
#pragma unroll
      for (int c = 0; c < LR / 8 / 4; ++c) {
        const int ch = lq + 4 * c;
        cp_async16(rd + ch * 16, rs + ch * 8, live && ch * 8 < lrope);
      }
    } else {
#pragma unroll
      for (int c = 0; c < LR / 2 / 4; ++c) {
        const int w = lq + 4 * c;
        cp_async4(rd + w * 4, rs + w * 2, live && w * 2 < lrope);
      }
    }
  };

  // q fragments (A, 16 heads x this warp's k-steps); heads past H and
  // columns past lkv + lrope are 0
  uint32_t qa[KSW][4];
  const bool ha = h0 + g < H, hb = h0 + g + 8 < H;
  const __nv_bfloat16* qA = q + ((size_t)b * H + h0 + g) * d;
  const __nv_bfloat16* qB = qA + 8 * d;
#pragma unroll
  for (int kk = 0; kk < KSW; ++kk) {
    const int ks = warp * KSW + kk;
    const int c = ks < LKV / 16 ? ks * 16 + 2 * tig : LKV + (ks - LKV / 16) * 16 + 2 * tig;
    const bool c0 = c < d, c1 = c + 8 < d;
    qa[kk][0] = ha && c0 ? ld_u32(qA + c) : 0u;
    qa[kk][1] = hb && c0 ? ld_u32(qB + c) : 0u;
    qa[kk][2] = ha && c1 ? ld_u32(qA + c + 8) : 0u;
    qa[kk][3] = hb && c1 ? ld_u32(qB + c + 8) : 0u;
  }

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < rounds) load(j);
    cp_commit();
  }

  float acc[NTW][4];
#pragma unroll
  for (int t = 0; t < NTW; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float* sx = reinterpret_cast<float*>(smem + (size_t)STAGES * STAGE);   // [NC][16][T]
  // ldmatrix lanes: token rows for the B operand of S, then for P . V
  const int kr = (lane & 7) + ((lane >> 4) << 3), kc8 = ((lane >> 3) & 1) * 8;
  const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vc8 = (lane >> 4) * 8;

  for (int j = 0; j < rounds; ++j) {
    cp_wait<STAGES - 2>();
    __syncthreads();                          // round j landed; round j - 1's reads are done
    if (j + STAGES - 1 < rounds) load(j + STAGES - 1);
    cp_commit();
    const unsigned char* cb = smem + (size_t)(j % STAGES) * STAGE;
    const unsigned char* rb = cb + CBYTES;

    // this warp's quarter of q . k for the round's T tokens
    float s[T / 8][4];
#pragma unroll
    for (int nb = 0; nb < T / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSW; ++kk) {
      const int ks = warp * KSW + kk;
#pragma unroll
      for (int h = 0; h < T / 16; ++h) {
        uint32_t kf[4];
        if (ks < LKV / 16)
          ldsm_x4(kf, cb + (h * 16 + kr) * CROW + (ks * 16 + kc8) * 2);
        else
          ldsm_x4(kf, rb + (h * 16 + kr) * RROW + ((ks - LKV / 16) * 16 + kc8) * 2);
        mma(s[2 * h], qa[kk], kf[0], kf[1]);
        mma(s[2 * h + 1], qa[kk], kf[2], kf[3]);
      }
    }
    // (the round's __syncthreads came after every read of the last round's
    // partials)
    float* mine = sx + warp * HT * T;
#pragma unroll
    for (int nb = 0; nb < T / 8; ++nb) {
      *reinterpret_cast<float2*>(mine + g * T + nb * 8 + 2 * tig) = make_float2(s[nb][0], s[nb][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * T + nb * 8 + 2 * tig) =
          make_float2(s[nb][2], s[nb][3]);
    }
    bar_sync(1, THREADS);
    // the full scores, the partials added in warp order (the same in every
    // warp); tokens past the split's end take no weight
    float sc[T / 8][4];
#pragma unroll
    for (int nb = 0; nb < T / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + 2 * tig + (e & 1);
        const int off = (g + 8 * (e >> 1)) * T + col;
        float v = sx[off];
#pragma unroll
        for (int w = 1; w < NC; ++w) v += sx[w * HT * T + off];
        sc[nb][e] = t0 + j * T + col < t1 ? v * sm_scale : -CUDART_INF_F;
      }
    // online-softmax step (rows g and g + 8 of the 16 heads)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < T / 8; ++nb) mx = fmaxf(mx, fmaxf(sc[nb][2 * r], sc[nb][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
    float p[T / 8][4];
#pragma unroll
    for (int nb = 0; nb < T / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nb][e] = expf(sc[nb][e] - m[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float ps_ = 0.f;
#pragma unroll
      for (int nb = 0; nb < T / 8; ++nb) ps_ += p[nb][2 * r] + p[nb][2 * r + 1];
      l[r] = l[r] * alpha[r] + ps_;
    }
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }
    // P . V, 16 tokens a k-step: p as the A fragments of its three bf16
    // parts, the small parts first
#pragma unroll
    for (int h = 0; h < T / 16; ++h) {
      uint32_t pa[3][4];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int nb = 2 * h + (q4 >> 1), e = 2 * (q4 & 1);
        uint32_t part[3];
        split<3>(p[nb][e], p[nb][e + 1], part);
#pragma unroll
        for (int i = 0; i < 3; ++i) pa[i][q4] = part[i];
      }
#pragma unroll
      for (int t = 0; t < NTW; t += 2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, cb + (h * 16 + vr) * CROW + ((warp * NTW + t) * 8 + vc8) * 2);
#pragma unroll
        for (int i = 2; i >= 0; --i) {
          mma(acc[t], pa[i], vf[0], vf[1]);
          mma(acc[t + 1], pa[i], vf[2], vf[3]);
        }
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  const bool hv[2] = {ha, hb};
  if (Sb == 1) {
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
      const int c = (warp * NTW + t) * 8 + 2 * tig;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!hv[r]) continue;
        const float lr_ = fmaxf(l[r], 1e-37f);
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * H + h0 + g + 8 * r) * LKV + c) =
            __floats2bfloat162_rn(acc[t][2 * r] / lr_, acc[t][2 * r + 1] / lr_);
      }
    }
    return;
  }
  // this split's partial: m [16], l [16], acc [16][512]
  float* part = ws + ((size_t)row * S + si) * PART;
  if (warp == 0 && tig == 0) {
    part[g] = m[0];
    part[g + 8] = m[1];
    part[HT + g] = l[0];
    part[HT + g + 8] = l[1];
  }
#pragma unroll
  for (int t = 0; t < NTW; ++t) {
    const int c = (warp * NTW + t) * 8 + 2 * tig;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(part + 2 * HT + (size_t)(g + 8 * r) * LKV + c) =
          make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrivals + row, 1) == Sb - 1;
  __syncthreads();
  if (!last) return;
  // the last split of the row merges all Sb in split order
  __threadfence();
  const float* base = ws + (size_t)row * S * PART;
  // (every load of a loop issued before its sums, which go in split order)
  if (tid < HT) {
    float ms[MAX_SPLITS], lp[MAX_SPLITS];
#pragma unroll
    for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
      ms[s2] = s2 < Sb ? __ldcg(base + s2 * PART + tid) : -CUDART_INF_F;
      lp[s2] = s2 < Sb ? __ldcg(base + s2 * PART + HT + tid) : 0.f;
    }
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int s2 = 0; s2 < MAX_SPLITS; ++s2) mx = fmaxf(mx, ms[s2]);
    float ls = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
      if (s2 >= Sb) break;
      const float w = expf(ms[s2] - mx);
      wgt[tid][s2] = w;
      ls += w * lp[s2];
    }
    lsum[tid] = fmaxf(ls, 1e-37f);
  }
  __syncthreads();
  for (int e = tid; e < HT * LKV / 4; e += THREADS) {
    const int hh = e / (LKV / 4), c = 4 * (e % (LKV / 4));
    if (h0 + hh >= H) continue;
    float4 pv[MAX_SPLITS];
#pragma unroll
    for (int s2 = 0; s2 < MAX_SPLITS; ++s2)
      pv[s2] = s2 < Sb ? __ldcg(reinterpret_cast<const float4*>(base + s2 * PART + 2 * HT +
                                                                  (size_t)hh * LKV + c))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s2 = 0; s2 < MAX_SPLITS; ++s2) {
      if (s2 >= Sb) break;
      const float w = wgt[hh][s2];
      o.x += w * pv[s2].x;
      o.y += w * pv[s2].y;
      o.z += w * pv[s2].z;
      o.w += w * pv[s2].w;
    }
    const float ls = lsum[hh];
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * H + h0 + hh) * LKV + c);
    dst[0] = __floats2bfloat162_rn(o.x / ls, o.y / ls);
    dst[1] = __floats2bfloat162_rn(o.z / ls, o.w / ls);
  }
  if (tid == 0) arrivals[row] = 0;              // ready for the next call
}

}  // namespace

// q [B, H, lkv + lrope], ckv [P, ps, lkv], krope [P, ps, lrope] bf16;
// seq_lens [B], block table [B, MP] int32; out [B, H, lkv] bf16. lkv must be
// 512, lrope even and <= 64, H a multiple of 4, 1 <= S <= 16 (the grid's
// splits, ops/attention/decode.py::mla_splits). With S > 1, ws holds
// B * ceil(H / 16) * S * (32 + 16 * 512) floats and arrivals B * ceil(H / 16)
// ints, zero before the first call.
extern "C" int skt_decode_mla(const void* q, const void* ckv, const void* krope,
                              const void* seq_lens, const void* bt, void* out, void* ws,
                              void* arrivals, int B, int H, int lkv, int lrope, int ps, int MP,
                              int S, float sm_scale, void* stream) {
  if (lkv != LKV || lrope % 2 || lrope > LR || lrope < 0 || H % 4 || ps <= 0 || S < 1 ||
      S > MAX_SPLITS || (S > 1 && (ws == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const cudaError_t e = skt::ensure_smem(decode_mla_kernel, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(S, (H + HT - 1) / HT, B);
  decode_mla_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const __nv_bfloat16*>(krope), static_cast<const int*>(seq_lens),
      static_cast<const int*>(bt), static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      static_cast<int*>(arrivals), H, lrope, ps, MP, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_decode_mla_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
