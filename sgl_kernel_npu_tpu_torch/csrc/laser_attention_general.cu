// Kernel K17, general route: laser attention on the TF32 tensor cores in
// split TF32, for what the bf16 / fp16 kernel (csrc/laser_attention.cu) does
// not take: f32 inputs at any D and Dv up to 256 (Phi-3's head dim 96, the
// JAX tests' 32), and bf16 / fp16 at widths that are not multiples of 8
// (TMA's 16-byte rows; every bf16 / fp16 width that is one runs on the
// bf16 / fp16 kernel, padded where it is not one of its four tiles).
//
// Replaces sgl_kernel_npu_tpu/ops/attention/prefill.py::laser_attention_pallas
// (_flash_kernel, prefill.py:42-110) at those widths. q [B, Hq, T, D],
// k [B, Hkv, T, D], v [B, Hkv, T, Dv], out [B, Hq, T, Dv], all of one type;
// query head h reads kv head h / (Hq / Hkv). Its rounding is the TPU
// kernel's, all f32: per kv tile s = (q . k) * sm_scale, -1e30 where masked
// (causal: row < column; every column >= T), m = max(m, rowmax(s)), alpha =
// exp(m_old - m), p = exp(s - m), l = l * alpha + rowsum(p), acc = acc *
// alpha + p . v; out = acc / max(l, 1e-37) in the input type. The scores are
// taken in base 2 (exp2 of s * sm_scale * log2(e)), the same function up to
// f32 rounding. Both products run in split TF32: an f32 operand x is split
// into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and a product is
// hi . hi + hi . lo + lo . hi with f32 accumulation; the dropped lo . lo and
// lo's own rounding are about 2^-22 of each term. q, k and v are split so
// (bf16 and fp16 values are exact in TF32: their lo is 0), and so is p.
// Against the plain version (ops/attention/prefill.py::
// laser_attention_blocked_ref) that and the order of the f32 sums differ:
// within 2e-5 of max|out| for f32, one ulp of the output type plus 1e-4 of
// max|out| for bf16 and fp16 (tests/test_torch_attention_widths.py emulates
// the split on the CPU).
//
// Bound on an H100: operations, 2 * (D + Dv) per (query row, visible key)
// per head, three times over at the TF32 tensor-core rate (495 TFLOP/s): at
// Phi-3-mini's 32 heads of 96, T 4096 causal, 1.03e11 operations, 3.10e11 in
// split TF32, 0.62 ms (1.54 ms for the same 1.03e11 at the CUDA cores' f32
// rate, 67 TFLOP/s, which the route ran at before).
// Design: a block takes 64 query rows per consumer warpgroup (two, or one at
// W 256) of one head and walks the kv tiles of BN rows (causal: up to its
// last row). Widths are padded to W, the least of 32, 64, 96, 128, 256 that
// holds D and Dv (zero columns add exact zeros; columns >= Dv are not
// stored). A producer warpgroup streams raw K and V tiles through a ring of
// RS stages: by TMA (3-D maps [B*H, T, width], 32-column boxes, 128-byte
// swizzle; rows >= T and columns >= width arrive as zeros) where f32 rows are
// whole 16-byte units, else by predicated 4-byte cp.async with a zero fill
// (f32) or by loads that widen bf16 / fp16 to f32 (16-bit rows of other
// widths are not 4-byte aligned). It then splits each tile into a second
// ring of CS stages: K's hi and lo in place of TMA's layout (wgmma's K-major
// operand), V transposed (wgmma's tf32 kind takes both shared operands
// K-major: V^T rows of BN keys, 128-byte swizzle), its keys permuted within
// each group of 8 so that the accumulator of S is P's A fragment as it lies
// (a thread holds keys 2t, 2t+1; the fragment wants columns t, t + 4). The
// consumers hold Q's hi and lo as wgmma A fragments in registers (W <= 96;
// at 128 and 256 they load them by chunks for each tile) and run S = Q . K^T
// and O += P . V as register-A wgmmas over the split parts, the online
// softmax in registers with quad shuffles between them, and free the stage
// on an mbarrier. Causal grids start with the longest (last) query tiles.
// Sizes (BN, CS, RS, consumer warpgroups; shared memory): W 32 (64, 3, 2, 2;
// 128 KB), 64 (32, 3, 2, 2; 128 KB), 96 (32, 3, 2, 2; 192 KB), 128 (32, 2,
// 2, 2; 192 KB), 256 (32, 1, 1, 1; 192 KB).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_D = 256;
constexpr float NEG = -1e30f;
enum Mode { TMA = 0, CP_ASYNC = 1, WIDEN = 2 };   // how raw K and V tiles arrive

// ------------------------------------------------ split TF32

__device__ __forceinline__ float tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(x - h));
}

__device__ __forceinline__ float4 tf32x4(float4 x) {
  return make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
}

// -------------------------------------------- wgmma, tf32, A in registers

#define SKT_ACC16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SKT_OUT16(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SKT_ACC48 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
    "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
#define SKT_OUT48(d) SKT_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),  \
    "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])

// d (64 x N, f32) += A (64 x 8, tf32 in registers) . B (8 x N, tf32 in shared
// memory, K-major, 128-byte swizzle)
template <int N>
struct Tf32;
#define SKT_TF32_MMA(N, NACC, ACC, OUT, RA, RB, RC, RD, RDESC, RP)                            \
  template <>                                                                                 \
  struct Tf32<N> {                                                                            \
    static __device__ __forceinline__ void rs(float (&d)[NACC], const uint32_t (&a)[4],      \
                                              uint64_t b, int accumulate) {                   \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #RP ", 0;\n"                          \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " ACC             \
                   ", {%" #RA ", %" #RB ", %" #RC ", %" #RD "}, %" #RDESC ", p, 1, 1;\n}\n"   \
                   : OUT(d)                                                                   \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));    \
    }                                                                                         \
  };
SKT_TF32_MMA(32, 16, SKT_ACC16, SKT_OUT16, 16, 17, 18, 19, 20, 21)
SKT_TF32_MMA(64, 32, SKT_ACC32, SKT_OUT32, 32, 33, 34, 35, 36, 37)
SKT_TF32_MMA(96, 48, SKT_ACC48, SKT_OUT48, 48, 49, 50, 51, 52, 53)
SKT_TF32_MMA(128, 64, SKT_ACC64, SKT_OUT64, 64, 65, 66, 67, 68, 69)
SKT_TF32_MMA(256, 128, SKT_ACC128, SKT_OUT128, 128, 129, 130, 131, 132, 133)
#undef SKT_TF32_MMA

// ------------------------------------------------ configuration

// W: the padded width; BN kv rows a tile; CS split stages, RS raw stages;
// NWG consumer warpgroups of 64 query rows; CK 0: Q's fragments held in
// registers for the whole block, else loaded for each tile, CK k-steps at a
// time
template <int W>
struct Cfg;
template <> struct Cfg<32> { static constexpr int BN = 64, CS = 3, RS = 2, NWG = 2, CK = 0; };
template <> struct Cfg<64> { static constexpr int BN = 32, CS = 3, RS = 2, NWG = 2, CK = 0; };
template <> struct Cfg<96> { static constexpr int BN = 32, CS = 3, RS = 2, NWG = 2, CK = 0; };
template <> struct Cfg<128> { static constexpr int BN = 32, CS = 2, RS = 2, NWG = 2, CK = 4; };
template <> struct Cfg<256> { static constexpr int BN = 32, CS = 1, RS = 1, NWG = 1, CK = 4; };

template <int W>
struct alignas(1024) Smem {
  using C = Cfg<W>;
  static constexpr int A = W / 32;              // 32-column atoms of a K or V row
  static constexpr int KA = C::BN / 32;         // 32-key atoms of a V^T row
  // raw tiles, TMA's layout: [atom][row][32 columns], 16-byte units swizzled
  float kraw[C::RS][A][C::BN * 32];
  float vraw[C::RS][A][C::BN * 32];
  // split tiles: K as raw; V^T [key atom][dv column][32 keys, permuted]
  float khi[C::CS][A][C::BN * 32];
  float klo[C::CS][A][C::BN * 32];
  float vhi[C::CS][KA][W * 32];
  float vlo[C::CS][KA][W * 32];
  uint64_t raw_full[C::RS], full[C::CS], empty[C::CS];
};

// the float offset of (row, column c < 32) in a 128-byte-swizzled atom
__device__ __forceinline__ int swz(int row, int c) {
  return row * 32 + (((c >> 2) ^ (row & 7)) << 2) + (c & 3);
}

// element i of a row-major f32 / bf16 / fp16 tensor (dtype 2 / 0 / 1), in f32
__device__ __forceinline__ float ld_elem(const void* p, size_t i, int dtype) {
  if (dtype == 2) return __ldg(static_cast<const float*>(p) + i);
  const unsigned short u = __ldg(static_cast<const unsigned short*>(p) + i);
  return dtype == 0 ? __uint_as_float(static_cast<uint32_t>(u) << 16)
                    : __half2float(__ushort_as_half(u));
}

__device__ __forceinline__ void st_elem(void* p, size_t i, float x, int dtype) {
  if (dtype == 2) static_cast<float*>(p)[i] = x;
  else if (dtype == 0) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else static_cast<__half*>(p)[i] = __float2half_rn(x);
}

__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

// Q's split fragments of k-steps ks0 .. ks0 + N - 1 (columns 8 ks + t, + 4;
// rows row0, row0 + 8), zero past T and D
template <int N>
__device__ __forceinline__ void load_q(uint32_t (&qf)[N][2][4], const void* qh, int ks0, int row0,
                                       int tig, int T_, int d, int dtype) {
#pragma unroll
  for (int ks = 0; ks < N; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (e & 1) * 8, col = 8 * (ks0 + ks) + tig + (e >> 1) * 4;
      const float x = row < T_ && col < d ? ld_elem(qh, (size_t)row * d + col, dtype) : 0.f;
      split_tf32(x, qf[ks][0][e], qf[ks][1][e]);
    }
  }
}

// sc (64 x BN) += Q . K^T over k-steps ks0 .. ks0 + N - 1, three products a
// step, issued
template <int BN, int N>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], const uint32_t (&qf)[N][2][4],
                                         uint32_t khi, uint32_t klo, int ks0) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int ks = ks0 + i;
    const uint32_t off = (ks / 4) * (BN * 128) + (ks % 4) * 32;
    const uint64_t dh = sw128_desc(khi + off, 16, 1024), dl = sw128_desc(klo + off, 16, 1024);
    Tf32<BN>::rs(sc, qf[i][0], dh, ks > 0);
    Tf32<BN>::rs(sc, qf[i][0], dl, 1);
    Tf32<BN>::rs(sc, qf[i][1], dh, 1);
  }
}

template <int W>
__global__ void __launch_bounds__(128 * (1 + Cfg<W>::NWG), 1)
laser_general_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const void* __restrict__ q,
                     const void* __restrict__ k, const void* __restrict__ v,
                     void* __restrict__ out, int Hq, int Hkv, int T_, int d, int dv, int causal,
                     float scale_log2, int mode, int dtype) {
  using C = Cfg<W>;
  using S = Smem<W>;
  constexpr int BN = C::BN, BM = 64 * C::NWG, A = S::A, KA = S::KA;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                ~static_cast<uintptr_t>(1023));
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BM;
  const int nkt_all = (T_ + BN - 1) / BN;
  const int nkt = causal ? min(nkt_all, (q0 + BM + BN - 1) / BN) : nkt_all;
  const int kh = b * Hkv + h / (Hq / Hkv);
  const int lak = (d + 31) / 32, lav = (dv + 31) / 32;   // atoms inside d, dv
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < C::RS; ++r) mbar_init(&sm.raw_full[r], mode == TMA ? 1 : 128);
#pragma unroll
    for (int s = 0; s < C::CS; ++s) {
      mbar_init(&sm.full[s], 128);               // every producer thread
      mbar_init(&sm.empty[s], 4 * C::NWG);       // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // what no copy writes, zero once: atoms past d or dv, V^T rows past dv
  if (lak < A || lav < A) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = threadIdx.x; e < C::RS * A * BN * 8; e += blockDim.x) {
      const int a = (e / (BN * 8)) % A;
      if (a >= lak) reinterpret_cast<float4*>(sm.kraw)[e] = z;
      if (a >= lav) reinterpret_cast<float4*>(sm.vraw)[e] = z;
    }
    for (int e = threadIdx.x; e < C::CS * A * BN * 8; e += blockDim.x) {
      if ((e / (BN * 8)) % A >= lak) {
        reinterpret_cast<float4*>(sm.khi)[e] = z;
        reinterpret_cast<float4*>(sm.klo)[e] = z;
      }
    }
    for (int e = threadIdx.x; e < C::CS * KA * W * 8; e += blockDim.x) {
      if ((e / 8) % W >= lav * 32) {
        reinterpret_cast<float4*>(sm.vhi)[e] = z;
        reinterpret_cast<float4*>(sm.vlo)[e] = z;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    if constexpr (C::NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = threadIdx.x;
    const size_t kvoff = (size_t)kh * T_;
    const CUtensorMap* kmp = &kmap;                // the maps where the launch put them
    const CUtensorMap* vmp = &vmap;
    // raw tile j into stage r: K's lak atoms, V's lav atoms
    auto load = [&](int r, int j) {
      if (mode == TMA) {
        if (pt == 0) {
          mbar_expect_tx(&sm.raw_full[r], (lak + lav) * BN * 128);
          for (int a = 0; a < lak; ++a)
            tma_load_3d(sm.kraw[r][a], kmp, &sm.raw_full[r], a * 32, j * BN, kh);
          for (int a = 0; a < lav; ++a)
            tma_load_3d(sm.vraw[r][a], vmp, &sm.raw_full[r], a * 32, j * BN, kh);
        }
        return;
      }
      for (int x = 0; x < 2; ++x) {                // K, then V
        const int width = x ? dv : d, cols = (x ? lav : lak) * 32;
        const void* src = x ? v : k;
        float* dst = x ? sm.vraw[r][0] : sm.kraw[r][0];
        for (int e = pt; e < BN * cols; e += 128) {
          const int n = e / cols, c = e % cols, row = j * BN + n;
          const bool live = row < T_ && c < width;
          const size_t i = (kvoff + row) * width + c;
          float* to = dst + (c / 32) * (BN * 32) + swz(n, c % 32);
          if (mode == CP_ASYNC)
            cp_async4(to, live ? static_cast<const float*>(src) + i : src, live);
          else
            *to = live ? ld_elem(src, i, dtype) : 0.f;
        }
      }
      if (mode == CP_ASYNC) cp_async_arrive_noinc(&sm.raw_full[r]);
      else mbar_arrive(&sm.raw_full[r]);
    };
    for (int j = 0; j < min(C::RS, nkt); ++j) load(j, j);
    for (int j = 0; j < nkt; ++j) {
      const int r = j % C::RS, s = j % C::CS;
      if (j >= C::CS) mbar_wait(&sm.empty[s], ((j / C::CS) - 1) & 1);
      mbar_wait(&sm.raw_full[r], (j / C::RS) & 1);
      // K: hi and lo in the raw layout
      {
        const float4* src = reinterpret_cast<const float4*>(sm.kraw[r][0]);
        float4* hi = reinterpret_cast<float4*>(sm.khi[s][0]);
        float4* lo = reinterpret_cast<float4*>(sm.klo[s][0]);
        for (int e = pt; e < lak * BN * 8; e += 128) {
          const float4 x = src[e], xh = tf32x4(x);
          hi[e] = xh;
          lo[e] = tf32x4(make_float4(x.x - xh.x, x.y - xh.y, x.z - xh.z, x.w - xh.w));
        }
      }
      // V: transposed into V^T rows of keys; the keys of a group of 8 in the
      // order 0, 2, 4, 6, 1, 3, 5, 7 (P's fragment columns t, t + 4 are the
      // accumulator's keys 2t, 2t + 1). A warp takes 32 columns of 4 keys.
      {
        const int cols = lav * 32;
        for (int it = pt; it < cols * (BN / 4); it += 128) {
          const int c = it % cols, unit = it / cols;       // unit: 4 keys, BN / 4 a tile
          const int grp = unit >> 1, odd = unit & 1;
          const float* vr = sm.vraw[r][c / 32];
          float x[4], hx[4], lx[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = grp * 8 + odd + 2 * i;
            x[i] = vr[swz(n, c % 32)];
            hx[i] = tf32(x[i]);
            lx[i] = tf32(x[i] - hx[i]);
          }
          const int off = c * 32 + (((unit & 7) ^ (c & 7)) << 2);
          *reinterpret_cast<float4*>(&sm.vhi[s][unit / 8][off]) =
              make_float4(hx[0], hx[1], hx[2], hx[3]);
          *reinterpret_cast<float4*>(&sm.vlo[s][unit / 8][off]) =
              make_float4(lx[0], lx[1], lx[2], lx[3]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&sm.full[s]);
      if (j + C::RS < nkt) {
        bar_sync(1, 128);                          // every thread is done with raw stage r
        load(r, j + C::RS);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (C::NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;                         // rows q0 + 64 cw .. + 63
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int tig = lane & 3;
    const int row0 = q0 + cw * 64 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
    const void* qh = static_cast<const char*>(q) +
                     ((size_t)b * Hq + h) * T_ * d * (dtype == 2 ? 4 : 2);
    constexpr int KS = W / 8;                      // k-steps of S
    constexpr int NQ = C::CK ? C::CK : KS;
    uint32_t qf[NQ][2][4];
    if constexpr (C::CK == 0) load_q<NQ>(qf, qh, 0, row0, tig, T_, d, dtype);
    float o[W / 2], sc[BN / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};    // l: this thread's columns only
    uint32_t pf[BN / 8][2][4];                     // p's hi and lo A fragments

    for (int j = 0; j < nkt; ++j) {
      const int s = j % C::CS;
      mbar_wait(&sm.full[s], (j / C::CS) & 1);
      const uint32_t khi = smem_u32(sm.khi[s][0]), klo = smem_u32(sm.klo[s][0]);
      if constexpr (C::CK == 0) {
        wg_fence();
        issue_qk<BN, NQ>(sc, qf, khi, klo, 0);
        wg_commit();
        wg_wait<0>();
        reg_fence(sc);
      } else {
#pragma unroll
        for (int ks0 = 0; ks0 < KS; ks0 += NQ) {
          load_q<NQ>(qf, qh, ks0, row0, tig, T_, d, dtype);
          wg_fence();
          issue_qk<BN, NQ>(sc, qf, khi, klo, ks0);
          wg_commit();
          wg_wait<0>();
          reg_fence(sc);
        }
      }
      // the online softmax of the tile (base 2); masks where a column may
      // pass a row of this warpgroup or T
      const int c0 = j * BN;
      if ((causal && c0 + BN - 1 > q0 + cw * 64) || c0 + BN > T_) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int col = c0 + (i / 4) * 8 + 2 * tig + (i & 1);
          const int row = row0 + ((i >> 1) & 1) * 8;
          const bool keep = col < T_ && (!causal || row >= col);
          sc[i] = keep ? sc[i] * scale_log2 : NEG;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] *= scale_log2;
      }
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - mn);
        m[r] = mn;
      }
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        // keys 2t, 2t + 1 of rows g, g + 8 -> fragment (g, t), (g + 8, t),
        // (g, t + 4), (g + 8, t + 4)
        const float p0 = ex2(sc[4 * kk] - m[0]), p1 = ex2(sc[4 * kk + 1] - m[0]);
        const float p2 = ex2(sc[4 * kk + 2] - m[1]), p3 = ex2(sc[4 * kk + 3] - m[1]);
        ps[0] += p0 + p1;
        ps[1] += p2 + p3;
        split_tf32(p0, pf[kk][0][0], pf[kk][1][0]);
        split_tf32(p2, pf[kk][0][1], pf[kk][1][1]);
        split_tf32(p1, pf[kk][0][2], pf[kk][1][2]);
        split_tf32(p3, pf[kk][0][3], pf[kk][1][3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
      // O += P . V^T's split parts
      const uint32_t vhi = smem_u32(sm.vhi[s][0]), vlo = smem_u32(sm.vlo[s][0]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const uint32_t off = (kk / 4) * (W * 128) + (kk % 4) * 32;
        const uint64_t dh = sw128_desc(vhi + off, 16, 1024), dl = sw128_desc(vlo + off, 16, 1024);
        Tf32<W>::rs(o, pf[kk][0], dh, 1);
        Tf32<W>::rs(o, pf[kk][0], dl, 1);
        Tf32<W>::rs(o, pf[kk][1], dh, 1);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / fmaxf(l[0], 1e-37f), inv1 = 1.f / fmaxf(l[1], 1e-37f);
    const size_t ob = ((size_t)b * Hq + h) * T_ * dv;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      if (n * 8 >= dv) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * tig + e;
        if (col >= dv) continue;
        if (row0 < T_) st_elem(out, ob + (size_t)row0 * dv + col, o[4 * n + e] * inv0, dtype);
        if (row0 + 8 < T_)
          st_elem(out, ob + (size_t)(row0 + 8) * dv + col, o[4 * n + 2 + e] * inv1, dtype);
      }
    }
  }
}

// [heads, T, width] f32 as a 3-D map: boxes of 32 columns x `rows` rows of
// one head, 128-byte swizzle
bool encode(EncodeTiled f, CUtensorMap* map, const void* base, int heads, int T, int width,
            int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 4,
                                 static_cast<cuuint64_t>(T) * width * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return f(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box,
           elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int W>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int T_, int d, int dv, int causal, int dtype, float sm_scale, cudaStream_t st) {
  using C = Cfg<W>;
  CUtensorMap kmap = {}, vmap = {};
  // TMA where every row is whole 16-byte units (f32 at D, Dv % 4 == 0)
  int mode = dtype != 2 ? WIDEN : d % 4 == 0 && dv % 4 == 0 ? TMA : CP_ASYNC;
  if (mode == TMA) {
    const EncodeTiled f = encode_fn();
    if (f == nullptr) return (int)cudaErrorSymbolNotFound;
    if (!encode(f, &kmap, k, B * Hkv, T_, d, C::BN) || !encode(f, &vmap, v, B * Hkv, T_, dv, C::BN))
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(Smem<W>) + 1024;     // + the base's alignment to 1 KB
  const cudaError_t e = skt::ensure_smem(laser_general_kernel<W>, smem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = static_cast<float>(static_cast<double>(sm_scale) * 1.4426950408889634);
  constexpr int BM = 64 * C::NWG;
  const dim3 grid(Hq, B, (T_ + BM - 1) / BM);
  laser_general_kernel<W><<<grid, 128 * (1 + C::NWG), smem, st>>>(
      kmap, vmap, q, k, v, out, Hq, Hkv, T_, d, dv, causal, scale_log2, mode, dtype);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, T, D], k [B, Hkv, T, D], v [B, Hkv, T, Dv], out [B, Hq, T, Dv];
// dtype 0 bf16, 1 fp16, 2 f32 (all four the same); 1 <= D, Dv <= 256;
// causal 0 / 1. The padded width W is the least of 32, 64, 96, 128, 256 that
// holds D and Dv.
extern "C" int skt_laser_attention_general(const void* q, const void* k, const void* v,
                                           void* out, int B, int Hq, int Hkv, int T, int d,
                                           int dv, int causal, int dtype, float sm_scale,
                                           void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || d < 1 || d > MAX_D ||
      dv < 1 || dv > MAX_D || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w = d > dv ? d : dv;
  if (w <= 32) return launch<32>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal, dtype, sm_scale, st);
  if (w <= 64) return launch<64>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal, dtype, sm_scale, st);
  if (w <= 96) return launch<96>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal, dtype, sm_scale, st);
  if (w <= 128)
    return launch<128>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal, dtype, sm_scale, st);
  return launch<256>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal, dtype, sm_scale, st);
}

extern "C" const char* skt_laser_attention_general_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
