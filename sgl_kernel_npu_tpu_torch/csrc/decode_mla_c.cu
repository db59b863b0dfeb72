// Kernel K5: paged MLA decode over a COMBINED latent cache (ctkv | krope in
// one row), read-only, with the current token's latent row folded in
// (deferred write).
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_mla_v2.py::
// decode_mla_pallas_v3_defer (_kernel_mla_v3, bf16 or int8 cache) and
// decode_mla_pallas_v2_defer (_kernel_mla_v2, bf16), one contract.
//
// q [B, 16, C] bf16 (ctkv-space nope | rope), new [B, C] bf16, cache
// [L, P, ps, C] int8 (with per-token scales [L, P, 1, ps] f32) or bf16,
// cached [B] tokens already cached (not counting the current one), block
// table [B, MP], out [B, 16, lkv] bf16, lkv the ctkv width.
//
// Rounding, as _kernel_mla_v3 takes it (decode_mla_v2.py:342-403): an online
// softmax over chunks of cp pages; per chunk the score is (bf16 q . row as
// bf16) in f32, times the row's scale (int8), times sm_scale; columns past
// the cached length score -1e30; p * scale (int8) or p (bf16) is rounded to
// bf16 before P.V, which sums in f32; after the last chunk the current row
// folds in in f32 and the sum is divided by max(l, 1e-37).
//
// Bound on an H100: the bytes of the cached rows, cached * (C + 4) per
// sequence and layer for int8, over 3.35 TB/s. MLA is MQA at the latent
// level: the 16 heads share every row, so one block per sequence scores all
// of them from one read of the row, and both products are bf16 tensor-core
// mma.sync m16n8k16 with the 16 heads as the M tile:
//   * scores: each warp takes 8 tokens at a time; its B fragments come
//     straight from the cache row (int8 converted to bf16, exact), q's A
//     fragments from shared memory. A chunk's scores ([16, cp*ps] f32) go to
//     shared memory; a 576-wide int8 chunk of 3 or 4 pages does not fit
//     there beside them;
//   * softmax: one warp per two heads; p rounded to bf16 into shared memory;
//   * P.V: 16 tokens at a time the block stages the rows' first lkv columns
//     as bf16 in shared memory (a second read of the chunk, mostly from L2)
//     and each warp accumulates 64 output columns in registers.
// Columns past the cached length are never read: their P is 0 and their
// staged rows are zeros, so a stale row cannot put 0 * NaN into a sum.
// Simple first: no split of the context over blocks, no TMA, one stage.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_once.cuh"

namespace {

constexpr int H = 16;                 // heads: the mma M tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;   // 8: two heads each in the softmax
constexpr int MAX_TILES = 8;          // n8 output tiles per warp: lkv <= 512
constexpr float NEG = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive elements of a row as a bf16 pair (int8 converts exactly)
__device__ __forceinline__ uint32_t pair(const int8_t* p) {
  const uint16_t v = __ldg(reinterpret_cast<const uint16_t*>(p));
  return pack_bf16((float)(int8_t)(v & 0xff), (float)(int8_t)(v >> 8));
}
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// 16 bytes of a row -> bf16 in shared memory (16 int8 or 8 bf16 elements)
__device__ __forceinline__ void stage(const int8_t* src, __nv_bfloat16* dst) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(src));
  const int8_t* e = reinterpret_cast<const int8_t*>(&v);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack_bf16((float)e[2 * i], (float)e[2 * i + 1]);
  reinterpret_cast<int4*>(dst)[0] = make_int4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<int4*>(dst)[1] = make_int4(w[4], w[5], w[6], w[7]);
}
__device__ __forceinline__ void stage(const __nv_bfloat16* src, __nv_bfloat16* dst) {
  *reinterpret_cast<int4*>(dst) = __ldg(reinterpret_cast<const int4*>(src));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const __nv_bfloat16* q;      // [B, H, C]
  const __nv_bfloat16* nl;     // [B, C]
  const void* cache;           // [L, P, ps, C]
  const float* scales;         // [L, P, 1, ps] or null (bf16 cache)
  const int* cached;           // [B]
  const int* bt;               // [B, MP]
  __nv_bfloat16* out;          // [B, H, lkv]
  int C, lkv, P, ps, MP, cp, li;
  float sm_scale;
};

// shared-memory layout of one block, in bytes from the start
struct Layout {
  int qs, sc, p3, vt, rsc, ridx, total;
  int qstride, pstride, vstride;   // row strides in elements
  __host__ __device__ Layout(int C, int lkv, int tc) {
    qstride = C + 8;
    pstride = tc + 8;
    vstride = lkv + 8;
    qs = 0;
    sc = qs + H * qstride * 2;
    p3 = sc + H * tc * 4;
    vt = p3 + H * pstride * 2;
    rsc = vt + 16 * vstride * 2;
    ridx = rsc + tc * 4;
    total = ridx + tc * 4;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) decode_mla_c_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[H], l_s[H], alpha_s[H], pnew_s[H];
  const int C = a.C, lkv = a.lkv, ps = a.ps, tc = a.cp * ps;
  const Layout lay(C, lkv, tc);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.qs);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  __nv_bfloat16* p3 = reinterpret_cast<__nv_bfloat16*>(smem + lay.p3);
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(smem + lay.vt);
  float* rsc = reinterpret_cast<float*>(smem + lay.rsc);
  int* ridx = reinterpret_cast<int*>(smem + lay.ridx);
  const uint16_t* vtu = reinterpret_cast<const uint16_t*>(vt);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const T* cache = static_cast<const T*>(a.cache);
  // a block table maps at most MP*ps tokens: never read past it
  const int clen = min(max(a.cached[b], 0), a.MP * ps);
  const int ntiles = lkv / 8;
  constexpr int EPV = 16 / sizeof(T);          // elements per 16-byte vector

  // q rows into shared memory
  const __nv_bfloat16* qb = a.q + (size_t)b * H * C;
  for (int i = tid; i < H * (C / 8); i += THREADS) {
    const int h = i / (C / 8), c = (i % (C / 8)) * 8;
    *reinterpret_cast<int4*>(qs + h * lay.qstride + c) =
        __ldg(reinterpret_cast<const int4*>(qb + (size_t)h * C + c));
  }
  if (tid < H) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  float acc[MAX_TILES][4];
#pragma unroll
  for (int j = 0; j < MAX_TILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int c0 = 0; c0 < clen; c0 += tc) {          // one chunk of cp pages
    const int live = min(tc, clen - c0);
    __syncthreads();                               // the last chunk's readers are done
    for (int t = tid; t < live; t += THREADS) {
      const int pos = c0 + t;
      const int page = a.bt[(size_t)b * a.MP + pos / ps];
      const int row = (a.li * a.P + page) * ps + pos % ps;
      ridx[t] = row;
      rsc[t] = a.scales != nullptr ? a.scales[row] : 1.f;
    }
    __syncthreads();

    // scores: warp w takes tokens 8*(w + WARPS*i) .. +7
    for (int n0 = warp * 8; n0 < live; n0 += WARPS * 8) {
      const int tok = n0 + g;
      const T* row = tok < live ? cache + (size_t)ridx[tok] * C : nullptr;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t af[4], bf[2];
        const __nv_bfloat16* qa = qs + g * lay.qstride + k0 + t2;
        af[0] = *reinterpret_cast<const uint32_t*>(qa);
        af[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * lay.qstride);
        af[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * lay.qstride + 8);
        bf[0] = row != nullptr ? pair(row + k0 + t2) : 0u;
        bf[1] = row != nullptr ? pair(row + k0 + t2 + 8) : 0u;
        mma_bf16(c, af, bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = g + (e >> 1) * 8, t = n0 + t2 + (e & 1);
        if (t < live) {
          const float s = a.scales != nullptr ? c[e] * rsc[t] : c[e];
          sc[h * tc + t] = s * a.sm_scale;
        }
      }
    }
    __syncthreads();

    // online softmax of the chunk: warp w takes heads 2w and 2w+1
    const int live16 = (live + 15) & ~15;
    for (int h = warp * 2; h < warp * 2 + 2; ++h) {
      float mt = NEG;
      for (int t = lane; t < live; t += 32) mt = fmaxf(mt, sc[h * tc + t]);
      mt = warp_max(mt);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mt);
      float psum = 0.f;
      for (int t = lane; t < live16; t += 32) {
        float w = 0.f;
        if (t < live) {
          const float p = expf(sc[h * tc + t] - m_new);
          psum += p;
          w = a.scales != nullptr ? p * rsc[t] : p;
        }
        p3[h * lay.pstride + t] = __float2bfloat16_rn(w);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + psum;
        alpha_s[h] = alpha;
      }
    }
    __syncthreads();

    // P.V over 16 tokens at a time; warp w owns output columns 64w .. 64w+63
    const float al0 = alpha_s[g], al1 = alpha_s[g + 8];
#pragma unroll
    for (int j = 0; j < MAX_TILES; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    const int vpr = lkv / EPV;                     // 16-byte vectors per staged row
    for (int kt = 0; kt < live; kt += 16) {
      __syncthreads();                             // vt is free
      for (int i = tid; i < 16 * vpr; i += THREADS) {
        const int r = i / vpr, c = (i % vpr) * EPV;
        __nv_bfloat16* dst = vt + r * lay.vstride + c;
        if (kt + r < live) {
          stage(cache + (size_t)ridx[kt + r] * C + c, dst);
        } else {
#pragma unroll
          for (int z = 0; z < EPV / 8; ++z) reinterpret_cast<int4*>(dst)[z] = make_int4(0, 0, 0, 0);
        }
      }
      __syncthreads();
      uint32_t af[4];
      const __nv_bfloat16* pa = p3 + g * lay.pstride + kt + t2;
      af[0] = *reinterpret_cast<const uint32_t*>(pa);
      af[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * lay.pstride);
      af[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
      af[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * lay.pstride + 8);
#pragma unroll
      for (int j = 0; j < MAX_TILES; ++j) {
        const int tile = warp * MAX_TILES + j;
        if (tile < ntiles) {
          const int n = tile * 8 + g;
          uint32_t bf[2];
          bf[0] = (uint32_t)vtu[t2 * lay.vstride + n]
                  | ((uint32_t)vtu[(t2 + 1) * lay.vstride + n] << 16);
          bf[1] = (uint32_t)vtu[(t2 + 8) * lay.vstride + n]
                  | ((uint32_t)vtu[(t2 + 9) * lay.vstride + n] << 16);
          mma_bf16(acc[j], af, bf);
        }
      }
    }
  }

  // fold the current token's row in, f32 (decode_mla_v2.py:389-403)
  __syncthreads();
  const __nv_bfloat16* nrow = a.nl + (size_t)b * C;
  for (int h = warp * 2; h < warp * 2 + 2; ++h) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32)
      s += __bfloat162float(qs[h * lay.qstride + c]) * __bfloat162float(nrow[c]);
    s = warp_sum(s) * a.sm_scale;
    if (lane == 0) {
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, s);
      const float alpha = expf(m_old - m_new);
      const float p = expf(s - m_new);
      l_s[h] = l_s[h] * alpha + p;
      alpha_s[h] = alpha;
      pnew_s[h] = p;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MAX_TILES; ++j) {
    const int tile = warp * MAX_TILES + j;
    if (tile < ntiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = g + (e >> 1) * 8, col = tile * 8 + t2 + (e & 1);
        const float o = acc[j][e] * alpha_s[h] + pnew_s[h] * __bfloat162float(nrow[col]);
        a.out[((size_t)b * H + h) * lkv + col] = __float2bfloat16_rn(o / fmaxf(l_s[h], 1e-37f));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  const Layout lay(a.C, a.lkv, a.cp * a.ps);
  const cudaError_t e = skt::ensure_smem(decode_mla_c_kernel<T>, (size_t)lay.total);
  if (e != cudaSuccess) return e;
  decode_mla_c_kernel<T><<<B, THREADS, lay.total, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// H = 16 heads; C % 16 == 0; lkv % 16 == 0 and lkv <= 512; ps % 16 == 0;
// int8 = 1: an int8 cache with scales, else bf16 (scales ignored).
extern "C" int skt_decode_mla_c(const void* q, const void* nl, const void* cache,
                                const void* scales, const void* cached, const void* bt,
                                void* out, int B, int C, int lkv, int P, int ps, int MP,
                                int cp, int li, float sm_scale, int int8, void* stream) {
  if (C % 16 || lkv % 16 || lkv > WARPS * MAX_TILES * 8 || lkv > C || ps % 16 || cp < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.nl = static_cast<const __nv_bfloat16*>(nl);
  a.cache = cache;
  a.scales = int8 ? static_cast<const float*>(scales) : nullptr;
  a.cached = static_cast<const int*>(cached);
  a.bt = static_cast<const int*>(bt);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.C = C;
  a.lkv = lkv;
  a.P = P;
  a.ps = ps;
  a.MP = MP;
  a.cp = cp;
  a.li = li;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int8 ? (int)launch<int8_t>(a, B, st) : (int)launch<__nv_bfloat16>(a, B, st);
}

extern "C" const char* skt_decode_mla_c_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
