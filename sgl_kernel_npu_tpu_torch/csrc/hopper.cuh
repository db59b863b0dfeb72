// Device helpers that the Hopper-shaped kernels share: cp.async, ldmatrix
// and mma.sync (B, K15's int8 path), int8 widened to bf16 by byte permutes
// (C, K3, K5, K14), mbarriers, TMA and wgmma (K15's bf16
// path, K17, K21), cuTensorMapEncodeTiled reached through the runtime (no
// -lcuda), and the flash-attention step K15 and K17 share on wgmma (S = Q .
// K^T from shared memory, the base-2 online softmax with p split into bf16
// parts, P . V with P from registers). The kernels keep their own loops.

#pragma once

#include <cuda.h>              // CUtensorMap and its enums; libcuda is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes into shared memory; with !full none are read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// ---------------------------------------------------- ldmatrix, mma.sync

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lo) in the low half, bf16(hi) in the high half: one cvt.rn.bf16x2.f32
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------ int8 -> bf16

// int8 -> bf16 without the conversion pipe (I2F and F2F run at a quarter of
// the ALU rate, and a cast takes two of them a value): a word is read
// biased, w ^ 0x80808080, so that byte k holds x + 128; 2^23 + (x + 128) is
// built by a byte permute into the f32 0x4B0000xx and 2^23 + 128
// subtracted, exactly; |x| <= 128 has at most 8 significant bits, so the
// f32's high half is bf16(x) exactly.
__device__ __forceinline__ uint32_t i8f(uint32_t biased, int shift) {
  return __float_as_uint(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | (shift >> 3)))
                         - 8388736.f);
}

// bf16x2 of two int8 values (exact) at bit offsets sa, sb of biased words,
// the first in the low half
__device__ __forceinline__ uint32_t i8x2(uint32_t a, int sa, uint32_t b, int sb) {
  return __byte_perm(i8f(a, sa), i8f(b, sb), 0x7632);
}

constexpr uint32_t BIAS = 0x80808080u;    // x + 128 in every byte

// ------------------------------------------------------------- softmax

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// NP bf16 parts of two f32 values, each pair packed as an A-fragment
// register: part i is bf16 of what parts 0 .. i-1 leave. Two parts (hi, lo)
// hold 16 of an f32's 24 significant bits (|x - hi - lo| <= 2^-17 |x|);
// three hold them all (hi + mid + lo = x exactly, for |x| >= 2^-110).
template <int NP>
__device__ __forceinline__ void split(float x, float y, uint32_t (&part)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    part[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    x -= hf.x;
    y -= hf.y;
  }
}

// ---------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_u32(b);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ----------------------------------------------------------------- TMA

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte aligned)
// from global into shared memory by one bulk copy, completed on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// named barrier `id` over the first `threads` threads to reach it
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// one box of a 2-D / 3-D tensor map into shared memory, completed on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime has loaded (no -lcuda)
EncodeTiled encode_fn() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    f = reinterpret_cast<EncodeTiled>(p);
    fn.store(f);
  }
  return f;
}

// --------------------------------------------------------------- wgmma

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets lbo / sbo
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across an
// asynchronous wgmma (it sees only the asm statement that issued it)
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
template <int NP, int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[NP][N][4]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) reg_fence(r[i]);
}

// the accumulator operand lists of wgmma m64nNk16 with f32 accumulators
#define SKT_ACC32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SKT_OUT32(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
    "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
    "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31])
#define SKT_ACC64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
    "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
    "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define SKT_OUT64(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
    "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
    "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
    "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
    "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
    "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
    "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SKT_ACC128 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
    "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
    "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
    "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
    "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
    "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
    "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
    "%125, %126, %127}"
#define SKT_OUT128(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
    "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
    "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
    "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
    "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
    "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
    "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), \
    "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), \
    "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), \
    "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
    "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
    "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), \
    "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), \
    "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), \
    "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
    "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), \
    "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), \
    "+f"(d[127])


// d (64 x 128, f32) = or += A (64 x 16, shared, K-major) . B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SKT_ACC64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SKT_OUT64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) = or += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SKT_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SKT_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// named barriers 1 and 2 order the two consumer warpgroups' MMA turns
__device__ __forceinline__ void turn_wait(int bar) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void turn_pass(int bar) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(bar) : "memory");
}

// s (64 x 128) = Q (this warpgroup's 64 rows) . K^T of one stage, issued;
// Q and K tiles of QROWS and KROWS rows of 128 bf16 as two 64-column
// halves of 128-byte swizzled rows
template <int QROWS, int KROWS>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < 128 / 16; ++kk)
    wgmma_ss(sc, sw128_desc(qa + (kk / 4) * (QROWS * 128) + (kk % 4) * 32, 16, 1024),
             sw128_desc(kb + (kk / 4) * (KROWS * 128) + (kk % 4) * 32, 16, 1024), kk > 0);
}

// o += P . V of one stage (128 keys), P as its NP bf16 parts, issued. V
// is the MN-major B operand: 64-column halves VROWS rows apart, 8-row groups
// 1 KB apart.
template <int VROWS, int NP>
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&pf)[NP][8][4],
                                         uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < 128 / 16; ++kk) {
    const uint64_t vd = sw128_desc(vb + kk * 16 * 128, VROWS * 128, 1024);
#pragma unroll
    for (int i = 0; i < NP; ++i) wgmma_rs(o, pf[i][kk], vd);
  }
}

// The online softmax of one 64 x 128 tile of scores, already scaled to base 2
// and masked, held as wgmma m64n128 accumulators: update m and this thread's
// part of l, rescale o, and hand p to emit(kk, p[8]) 16 keys at a time: for
// keys 16 kk .., (row g, keys 2t, 2t+1), (row g+8, 2t, 2t+1), (g, 2t+8, 2t+9),
// (g+8, 2t+8, 2t+9), the order of wgmma's A fragments.
template <class Emit>
__device__ __forceinline__ void softmax_core(float (&sc)[64], float (&o)[64], float (&m)[2],
                                             float (&l)[2], Emit&& emit) {
  float mx[2] = {-1e30f, -1e30f};
#pragma unroll
  for (int n = 0; n < 16; ++n) {
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
  for (int kk = 0; kk < 8; ++kk) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = ex2(sc[8 * kk + e] - m[(e >> 1) & 1]);
    ps[0] += p[0] + p[1] + p[4] + p[5];
    ps[1] += p[2] + p[3] + p[6] + p[7];
    emit(kk, p);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    o[4 * n] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
}

// softmax_core leaving p as the A fragments of its NP bf16 parts (split)
template <int NP>
__device__ __forceinline__ void softmax_step(float (&sc)[64], float (&o)[64], float (&m)[2],
                                             float (&l)[2], uint32_t (&pf)[NP][8][4]) {
  softmax_core(sc, o, m, l, [&](int kk, const float (&p)[8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t part[NP];
      split<NP>(p[2 * j], p[2 * j + 1], part);
#pragma unroll
      for (int i = 0; i < NP; ++i) pf[i][kk][j] = part[i];
    }
  });
}

// softmax_core leaving p (f32) in sc, in place
__device__ __forceinline__ void softmax_step(float (&sc)[64], float (&o)[64], float (&m)[2],
                                             float (&l)[2]) {
  softmax_core(sc, o, m, l, [&](int kk, const float (&p)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[8 * kk + e] = p[e];
  });
}

}  // namespace
