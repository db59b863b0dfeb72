// Kernel K17: laser attention, a flash forward over dense [B, H, T, 128]
// tensors, causal or not, GQA read in place.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/prefill.py::laser_attention_pallas
// (_flash_kernel, prefill.py:42-110; the wrapper prefill.py:113 repeats K and
// V to Hq heads first, K17 reads kv head h / G where it is). q [B, Hq, T, D],
// k / v [B, Hkv, T, D], out [B, Hq, T, D], all bf16, D = 128.
//
// Rounding, as the TPU kernel takes it (its dots and p are f32): per kv tile,
// s = (q . k) * sm_scale, -1e30 where masked (causal: row < column; and every
// column >= T, which the TPU kernel leaves in and reads past the end:
// prefill.py's fault at a T that is not a multiple of its block);
// m = max(m, rowmax(s)), alpha = exp(m_old - m), p = exp(s - m),
// l = l * alpha + rowsum(p) over the f32 p, acc = acc * alpha + p . v;
// out = acc / max(l, 1e-37) in bf16.
// The score dot runs on bf16 tensor cores (mma.sync m16n8k16, f32
// accumulation): bf16 x bf16 products are exact in f32, so it differs from an
// f32 dot only in the order of the sums. P . V keeps p in f32 to 16 bits: p
// is split into hi = bf16(p) and lo = bf16(p - hi), and P . V = hi . V +
// lo . V, two MMAs with f32 accumulation (|p - hi - lo| <= 2^-16 p). Against
// the plain version (ops/attention/prefill.py::laser_attention_blocked_ref,
// all f32 in blocks of 256) the output differs by that and the order of f32
// sums: within one bf16 ulp plus 1e-4 of max|out|.
//
// Bound on an H100: operations, 4 * D per (query row, visible key) per head:
// 5.50e11 at T = 8192 causal with 32 query heads, 0.556 ms at the bf16
// tensor-core rate (8.2 ms at the f32 rate); K17 spends 1.5 times that in
// MMAs (the split P . V). Design: FlashAttention-2's; a block of 4 warps takes
// 64 query rows of one head (16 a warp, q fragments in registers), walks the
// kv tiles of 64 up to the causal diagonal, K and V double-buffered in shared
// memory by cp.async (rows past T zero-filled); S and the P fragments stay in
// registers (the S accumulator layout is the A-fragment layout of P . V).
// Causal grids start with the longest (last) query tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // kv columns per tile
constexpr int THREADS = 128;           // 4 warps x 16 rows
constexpr int LDS = D + 8;             // shared row stride (bf16): 272 bytes
constexpr float NEG = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;         // 0: read nothing, fill zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const unsigned*>(&v);
}

// the hi and lo bf16 parts of two f32 values, packed as an A-fragment register
__device__ __forceinline__ void split(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack(x - hf.x, y - hf.y);
}

// rows r0 .. r0 + 63 of a [T, D] matrix into shared [64][LDS]; rows >= T zero
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, int r0,
                                          int T) {
  for (int e = threadIdx.x; e < 64 * (D / 8); e += THREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const bool in = r0 + r < T;
    cp_async16(s + r * LDS + c, in ? g + (size_t)(r0 + r) * D + c : g, in);
  }
}

__global__ void __launch_bounds__(THREADS)
laser_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Hq,
             int Hkv, int T, int causal, float sm_scale) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* qs = smem;                       // [BQ][LDS]
  __nv_bfloat16* ks = qs + BQ * LDS;              // [2][BK][LDS]
  __nv_bfloat16* vs = ks + 2 * BK * LDS;          // [2][BK][LDS]
  const int nqt = gridDim.x;
  const int qt = causal ? nqt - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const __nv_bfloat16* qg = q + ((size_t)b * Hq + h) * T * D;
  const __nv_bfloat16* kg = k + ((size_t)b * Hkv + hk) * T * D;
  const __nv_bfloat16* vg = v + ((size_t)b * Hkv + hk) * T * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int nkt_all = (T + BK - 1) / BK;
  const int nkt = causal ? min(nkt_all, (q0 + BQ - 1) / BK + 1) : nkt_all;

  load_tile(qs, qg, q0, T);
  load_tile(ks, kg, 0, T);
  load_tile(vs, vg, 0, T);
  cp_commit();

  unsigned qa[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;            // this thread's rows: row0, row0 + 8

  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      const int nb = (j + 1) & 1;
      load_tile(ks + nb * BK * LDS, kg, (j + 1) * BK, T);
      load_tile(vs + nb * BK * LDS, vg, (j + 1) * BK, T);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int mi = lane / 8;
        ldsm_x4(qa[kk], qs + (warp * 16 + (mi & 1) * 8 + lane % 8) * LDS + kk * 16 +
                            (mi >> 1) * 8);
      }
    }
    const __nv_bfloat16* kt = ks + (j & 1) * BK * LDS;
    const __nv_bfloat16* vt = vs + (j & 1) * BK * LDS;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        unsigned r[4];
        ldsm_x4(r, kt + (n * 8 + lane % 8) * LDS + kk * 16 + (lane / 8) * 8);
        mma(s[n], qa[kk], r[0], r[1]);
        mma(s[n], qa[kk + 1], r[2], r[3]);
      }
    }

    // mask, scale, online softmax over this tile
    const int c0 = j * BK;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + (i / 2) * 8;
        const int col = c0 + n * 8 + tig * 2 + (i & 1);
        const bool keep = col < T && (!causal || row >= col);
        s[n][i] = keep ? s[n][i] * sm_scale : NEG;
        mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i / 2]);
        ps[i / 2] += s[n][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      l[r] = l[r] * alpha[r] + ps[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P . V, P split into bf16 hi and lo parts
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        unsigned r[4];
        const int mi = lane / 8;
        ldsm_x4_t(r, vt + (kk * 16 + (mi & 1) * 8 + lane % 8) * LDS + n * 8 + (mi >> 1) * 8);
        mma(o[n], ph, r[0], r[1]);
        mma(o[n], pl, r[0], r[1]);
        mma(o[n + 1], ph, r[2], r[3]);
        mma(o[n + 1], pl, r[2], r[3]);
      }
    }
    __syncthreads();                              // the buffer is refilled next
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-37f), inv1 = 1.f / fmaxf(l[1], 1e-37f);
  __nv_bfloat16* og = out + ((size_t)b * Hq + h) * T * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + tig * 2;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row0 * D + c) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row0 + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)(row0 + 8) * D + c) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

// q [B, Hq, T, D], k, v [B, Hkv, T, D], out [B, Hq, T, D], bf16, D = 128;
// causal 0 / 1.
extern "C" int skt_laser_attention(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int T, int d, int causal,
                                   float sm_scale, void* stream) {
  if (d != D || B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(BQ + 4 * BK) * LDS * sizeof(__nv_bfloat16);
  static bool set = false;
  if (!set) {
    const cudaError_t e = cudaFuncSetAttribute(
        laser_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    set = true;
  }
  const dim3 grid((T + BQ - 1) / BQ, Hq, B);
  laser_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Hq, Hkv, T,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_laser_attention_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
