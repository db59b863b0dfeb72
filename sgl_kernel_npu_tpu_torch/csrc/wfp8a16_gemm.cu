// Kernel K21: soft-FP8 W8A16 GEMM, bf16 activations times fp8 e4m3 weights
// with f32 scales per 128 x 128 block, dense or grouped over a per-m-tile
// expert map.
//
// Replaces sgl_kernel_npu_tpu/ops/matmul.py::mm_wfp8a16_pallas
// (_wfp8a16_kernel, matmul.py:287-306) and gmm_wfp8a16_pallas_aligned
// (_gmm_wfp8a16_kernel, matmul.py:356-378): x [M, K] bf16, w [G, K, N] fp8
// e4m3 (row-major over N), scales [G, ceil(K/128), ceil(N/128)] f32, row
// tile i of block_m rows reads expert eid[i] (clamped to [0, G)); the dense
// GEMM is G = 1 with no map. out [M, N] bf16.
//
//   w16[k, n] = bf16( f32(w[e, k, n]) * ws[e, k / 128, n / 128] )
//   out[m, n] = bf16( sum_k f32(x[m, k]) * f32(w16[k, n]) )
//
// e4m3 -> f32 is exact (NaN codes stay NaN), the product is rounded once in
// f32 and once to bf16, as the TPU kernel dequantises each 128 x 128 block
// in VMEM; the sum runs on bf16 tensor cores (mma.sync m16n8k16, f32
// accumulation: bf16 x bf16 products are exact in f32), so it differs from
// the TPU kernel's f32 sum of per-block partial sums only in the order of
// the f32 additions. K and N need not be multiples of 128: rows past K and
// columns past N are zero inside the tile, as _dequant_w_fp8_block pads,
// and nothing past the arrays is read.
//
// Bound on an H100: at decode widths (M 128) the fp8 weight bytes, K * N per
// expert read, over 3.35 TB/s (0.041 ms for DeepSeek-V3's gate_proj, 7168 x
// 18432); from M of about 600 up, 2 * M * K * N operations at the bf16
// tensor-core rate (1.09 ms at M 4096). Design, simple first: a block owns a
// BM x 128 output tile (BM 32 below M 96, else 128, so that a decode batch
// of 128 reads each weight panel once); 64-deep K stages of x rows and raw
// e4m3 bytes stream through a ring in shared memory by cp.async (4 stages at
// BM 32, 3 at 128); per stage the block dequantises the bytes to bf16 and
// transposes them into K-contiguous rows (the column-major B fragment), and
// the warps feed mma.sync from ldmatrix. With an expert map, a tile from row
// m_live on (the padding past the aligned groups) is written as zeros
// without reading weights. Where the output has fewer tiles than the card has
// SMs, K is split over blocks: f32 partial sums in a workspace, added in
// split order by a second kernel (a repeat gives the same bits). No TMA or
// wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;          // output columns per block
constexpr int BK = 64;           // K per stage (half a scale block)
constexpr int SBLK = 128;        // the scale block
constexpr int LDS = BK + 8;      // shared row (bf16): 144 bytes, conflict-free fragments

struct Args {
  const __nv_bfloat16* x;        // [M, K]
  const uint8_t* w;              // [G, K, N] e4m3 bytes
  const float* ws;               // [G, sk, sn]
  const int* eid;                // [M / block_m] or null
  const int* m_live;             // one int or null
  __nv_bfloat16* out;            // [M, N]
  float* part;                   // split K: [splits, M, N] f32 partial sums, else null
  int M, N, K, G, block_m, sk, sn, kchunk;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two e4m3 bytes (lo, hi) -> f32, exactly (through fp16, which holds every
// e4m3 value)
__device__ __forceinline__ float2 fp8x2_to_float2(uint16_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(v),
                                                   __NV_E4M3);
  return __half22float2(__half2(h));
}

// bf16(lo) in the low half, bf16(hi) in the high half: one cvt.rn.bf16x2.f32
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Word kw (k pair 2kw, 2kw+1) of column n in the transposed weight stage:
// the k-pair index is XORed by a multiple of 8 that changes every 16
// columns, so that the staging stores spread over the banks while a
// fragment load (8 columns of one 16-column group) stays conflict-free.
__device__ __forceinline__ int b_word(int n, int kw) {
  return n * (LDS / 2) + (kw ^ (((n >> 4) & 3) << 3));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

template <int BM>
struct Cfg {
  static constexpr int WARPS_M = BM == 32 ? 1 : 4;
  static constexpr int WARPS_N = BM == 32 ? 4 : 2;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = BM / WARPS_M / 16;          // m16 tiles per warp
  static constexpr int NT = BN / WARPS_N / 8;           // n8 tiles per warp
  static constexpr int STAGES = BM == 32 ? 4 : 3;       // K stages in flight
  static constexpr int MIN_BLOCKS = BM == 32 ? 3 : 2;   // resident blocks an SM (registers)
  static constexpr int A_PER = BM * BK / 8 / THREADS;   // 16-byte chunks of x per thread
  static constexpr int W_PER = BK * BN / 16 / THREADS;  // 16-byte chunks of w per thread
  static constexpr int B_PER = (BK / 2) * (BN / 16) / THREADS;  // (row pair, 16 columns)
  static constexpr int A_BYTES = BM * LDS * 2;          // one stage of x, rows padded
  static constexpr int W_BYTES = BK * BN;               // one stage of raw e4m3 bytes
  static constexpr int SMEM = STAGES * (A_BYTES + W_BYTES) + BN * LDS * 2;
};

template <int BM>
__global__ void __launch_bounds__(Cfg<BM>::THREADS, Cfg<BM>::MIN_BLOCKS)
    wfp8a16_kernel(const Args p) {
  using C = Cfg<BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Araw = smem;                                       // [STAGES][BM][LDS] bf16
  uint8_t* Wraw = smem + C::STAGES * C::A_BYTES;              // [STAGES][BK][BN] e4m3
  uint32_t* Bs = reinterpret_cast<uint32_t*>(Wraw + C::STAGES * C::W_BYTES);  // b_word layout

  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int e = p.eid != nullptr ? min(max(p.eid[m0 / p.block_m], 0), p.G - 1) : 0;
  float* part = p.part != nullptr ? p.part + (size_t)blockIdx.z * M * N : nullptr;

  if (p.m_live != nullptr && m0 >= __ldg(p.m_live)) {
    // padding tiles past the aligned groups: zeros, no weights read
    for (int i = tid; i < BM * BN; i += C::THREADS) {
      const int r = m0 + i / BN, c = n0 + i % BN;
      if (r >= M || c >= N) continue;
      if (part != nullptr)
        part[(size_t)r * N + c] = 0.f;
      else
        p.out[(size_t)r * N + c] = __float2bfloat16_rn(0.f);
    }
    return;
  }

  const uint8_t* w = p.w + (size_t)e * K * N;
  const float* wsc = p.ws + (size_t)e * p.sk * p.sn + n0 / SBLK;
  const bool x_vec = K % 8 == 0;
  const bool w_vec = N % 16 == 0;
  // this block's K range (split K: chunk blockIdx.z, a multiple of BK)
  const int kbeg = blockIdx.z * p.kchunk;
  const int KT = (min(K, kbeg + p.kchunk) - kbeg + BK - 1) / BK;

  // Stage kt of x and w into ring slot kt % STAGES: whole 16-byte chunks by
  // cp.async; a chunk across the edge of K or N (or rows not 16-byte
  // aligned) by plain loads, zero past the edge; nothing past the arrays.
  auto load = [&](int kt) {
    const int slot = kt % C::STAGES, k0 = kbeg + kt * BK;
    uint8_t* as = Araw + slot * C::A_BYTES;
    uint8_t* ws = Wraw + slot * C::W_BYTES;
#pragma unroll
    for (int i = 0; i < C::A_PER; ++i) {
      const int v = tid + i * C::THREADS;
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      void* dst = as + (r * LDS + c) * 2;
      const __nv_bfloat16* src = p.x + (size_t)m * K + k;
      if (m < M && x_vec && k + 8 <= K) {
        cp_async16(dst, src);
      } else {
        int4 val = make_int4(0, 0, 0, 0);
        if (m < M && k < K) {
          __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
          for (int j = 0; j < 8; ++j) d[j] = k + j < K ? src[j] : __float2bfloat16_rn(0.f);
        }
        *reinterpret_cast<int4*>(dst) = val;
      }
    }
#pragma unroll
    for (int i = 0; i < C::W_PER; ++i) {
      const int v = tid + i * C::THREADS;
      const int r = v / (BN / 16), c = (v % (BN / 16)) * 16;   // 8 lanes cover a row
      const int k = k0 + r, n = n0 + c;
      void* dst = ws + r * BN + c;
      const uint8_t* src = w + (size_t)k * N + n;
      if (k < K && w_vec && n + 16 <= N) {
        cp_async16(dst, src);
      } else {
        int4 val = make_int4(0, 0, 0, 0);
        if (k < K && n < N) {
          uint8_t* d = reinterpret_cast<uint8_t*>(&val);
#pragma unroll
          for (int j = 0; j < 16; ++j) d[j] = n + j < N ? src[j] : 0;
        }
        *reinterpret_cast<int4*>(dst) = val;
      }
    }
  };

  // The raw e4m3 bytes of slot kt % STAGES, times the stage's scale, as bf16
  // k-pairs of each column (the B fragment's layout) in Bs.
  auto dequant = [&](int kt) {
    const uint8_t* ws = Wraw + (kt % C::STAGES) * C::W_BYTES;
    const float scale = __ldg(wsc + (size_t)((kbeg + kt * BK) / SBLK) * p.sn);
#pragma unroll
    for (int i = 0; i < C::B_PER; ++i) {
      const int u = tid + i * C::THREADS;
      const int kp = u / (BN / 16), cg = u % (BN / 16);
      const int4 v0 = *reinterpret_cast<const int4*>(ws + (2 * kp) * BN + cg * 16);
      const int4 v1 = *reinterpret_cast<const int4*>(ws + (2 * kp + 1) * BN + cg * 16);
      const uint16_t* r0 = reinterpret_cast<const uint16_t*>(&v0);
      const uint16_t* r1 = reinterpret_cast<const uint16_t*>(&v1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 a = fp8x2_to_float2(r0[j]);       // row 2kp, columns 2j, 2j+1
        const float2 b = fp8x2_to_float2(r1[j]);       // row 2kp+1
        const int n = cg * 16 + 2 * j;
        Bs[b_word(n, kp)] = pack_bf16(__fmul_rn(a.x, scale), __fmul_rn(b.x, scale));
        Bs[b_word(n + 1, kp)] = pack_bf16(__fmul_rn(a.y, scale), __fmul_rn(b.y, scale));
      }
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;         // ldmatrix: this lane's row, matrix

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<C::STAGES - 2>();              // this thread's copies of stage kt landed
    __syncthreads();                       // everyone's; the last stage's MMAs are done
    if (kt + C::STAGES - 1 < KT) load(kt + C::STAGES - 1);   // into the slot just freed
    cp_commit();
    dequant(kt);
    __syncthreads();
    const uint8_t* as = Araw + (kt % C::STAGES) * C::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const int row = (wm * C::MT + mt) * 16 + (lmat & 1) * 8 + lrow;
        ldsm_x4(a[mt], as + (row * LDS + kk + (lmat >> 1) * 8) * 2);
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; nt += 2) {
        uint32_t b[4];                     // b0, b1 of n-tiles nt and nt + 1
        const int n = (wn * C::NT + nt) * 8 + (lmat >> 1) * 8 + lrow;
        ldsm_x4(b, Bs + b_word(n, kk / 2 + (lmat & 1) * 4));
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int col = n0 + (wn * C::NT + nt) * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + (wm * C::MT + mt) * 16 + g + 8 * half;
        if (r >= M) continue;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (part != nullptr) {
          if (col < N) part[(size_t)r * N + col] = v0;
          if (col + 1 < N) part[(size_t)r * N + col + 1] = v1;
          continue;
        }
        __nv_bfloat16* o = p.out + (size_t)r * N + col;
        if (col + 1 < N && N % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) o[0] = __float2bfloat16_rn(v0);
          if (col + 1 < N) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// Split K: out = bf16(sum over the splits of the f32 partial sums), in split
// order, so a repeat gives the same bits.
__global__ void wfp8a16_reduce(const float* part, __nv_bfloat16* out, size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s += part[z * mn + i];
  out[i] = __float2bfloat16_rn(s);
}

template <int BM>
cudaError_t launch(const Args& p, int splits, cudaStream_t st) {
  auto kern = wfp8a16_kernel<BM>;
  constexpr int smem = Cfg<BM>::SMEM;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, splits);
  kern<<<grid, Cfg<BM>::THREADS, smem, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = (size_t)p.M * p.N;
  wfp8a16_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(p.part, p.out, mn, splits);
  return cudaGetLastError();
}

int run(const void* x, const void* w, const void* ws, const void* eid, const void* m_live,
        void* out, void* workspace, int M, int N, int K, int G, int block_m, int bm, int splits,
        void* stream) {
  if (M < 0 || N < 0 || K <= 0 || G <= 0 || (bm != 32 && bm != 128) || splits < 1
      || (splits > 1 && workspace == nullptr)
      || (eid != nullptr && (block_m <= 0 || block_m % bm || M % block_m)))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  Args p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.ws = static_cast<const float*>(ws);
  p.eid = static_cast<const int*>(eid);
  p.m_live = static_cast<const int*>(m_live);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.G = G;
  p.block_m = block_m;
  p.sk = (K + SBLK - 1) / SBLK;
  p.sn = (N + SBLK - 1) / SBLK;
  // K chunks of whole stages; the last may be short
  p.kchunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (K + p.kchunk - 1) / p.kchunk;
  p.part = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bm == 128 ? launch<128>(p, splits, st) : launch<32>(p, splits, st));
}

}  // namespace

// Dense: x [M, K] bf16, w [K, N] e4m3, ws [ceil(K/128), ceil(N/128)] f32,
// out [M, N] bf16 (eid, m_live null, G 1; block_m unused). bm: the row tile,
// 32 or 128; splits > 1 splits K and needs workspace, [splits, M, N] f32.
extern "C" int skt_wfp8a16_gemm(const void* x, const void* w, const void* ws, const void* eid,
                                const void* m_live, void* out, void* workspace, int M, int N,
                                int K, int G, int block_m, int bm, int splits, void* stream) {
  if (eid != nullptr || m_live != nullptr || G != 1) return (int)cudaErrorInvalidValue;
  return run(x, w, ws, nullptr, nullptr, out, workspace, M, N, K, 1, block_m, bm, splits,
             stream);
}

// Grouped: w [G, K, N], ws [G, ceil(K/128), ceil(N/128)], eid [M / block_m]
// int32 (block_m a multiple of bm, M of block_m), m_live null or one int32.
extern "C" int skt_wfp8a16_gemm_grouped(const void* x, const void* w, const void* ws,
                                        const void* eid, const void* m_live, void* out,
                                        void* workspace, int M, int N, int K, int G,
                                        int block_m, int bm, int splits, void* stream) {
  if (eid == nullptr) return (int)cudaErrorInvalidValue;
  return run(x, w, ws, eid, m_live, out, workspace, M, N, K, G, block_m, bm, splits, stream);
}

extern "C" const char* skt_wfp8a16_gemm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
