// Kernel K17, general route: laser attention on the CUDA cores in f32, for
// the widths and types the tensor-core kernel (csrc/laser_attention.cu) does
// not take: any D and Dv up to 256, and f32, bf16 or fp16 inputs (Phi-3's
// head dim 96, the JAX tests' f32 at D 32).
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
// f32 rounding; against the plain version
// (ops/attention/prefill.py::laser_attention_blocked_ref) only that and the
// order of the f32 sums differ: within 2e-5 of max|out| for f32, one ulp of
// the output type plus 1e-4 of max|out| for bf16 and fp16.
//
// Bound on an H100: operations, 2 * (D + Dv) per (query row, visible key)
// per head, at the f32 rate of the CUDA cores (67 TFLOP/s): at Phi-3-mini's
// 32 heads of 96, T 4096 causal, 1.03e11 operations, 1.54 ms.
// Design, a simple flash loop (this route is chosen by width and type, not
// as a fallback; making it fast is later work): a block of 256 threads takes
// 64 query rows of one head and walks the kv tiles of 64 rows (causal: up to
// the diagonal). Q (once), K and V (each tile) are converted to f32 into
// shared memory (K's rows padded to an odd stride, so 16 threads reading 16
// rows at one column hit 16 banks); a thread (ty, tx) of a 16 x 16 grid
// computes the 4 x 4 scores of rows 4 ty .. 4 ty + 3 and columns tx + 16 j,
// the row max and sum by shuffles over the 16 threads of its rows, writes p
// to shared memory, and adds p . v for its rows and the columns tx + 16 c of
// O (16 NC columns, NC a template parameter: Dv <= 16 NC). Causal grids
// start with the longest (last) query tiles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_once.cuh"

namespace {

constexpr int BM = 64;                 // query rows per block
constexpr int BN = 64;                 // kv rows per tile
constexpr int THREADS = 256;           // a 16 x 16 grid
constexpr int MAX_D = 256;
constexpr int LDP = BN + 1;            // p's row stride (floats)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, __half>::value) return __float2half_rn(x);
  else if constexpr (std::is_same<T, __nv_bfloat16>::value) return __float2bfloat16_rn(x);
  else return x;
}

// rows [r0, r0 + 64) of a [T, width] head into shared memory as f32 rows of
// stride ld; rows >= T as zeros. A warp takes a row, its lanes consecutive
// columns.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int T_,
                                      int width, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < 64; r += THREADS / 32) {
    const bool live = r0 + r < T_;
    const T* row = src + (size_t)(r0 + r) * width;
    for (int c = lane; c < width; c += 32) dst[r * ld + c] = live ? to_f(row[c]) : 0.f;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
laser_general_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int Hq, int Hkv, int T_, int D, int DV, int causal,
                     float scale_log2) {
  extern __shared__ float sm[];
  const int ldq = D | 1;                          // odd strides: conflict-free column reads
  const int ldv = 16 * NC;
  float* qs = sm;                                 // [BM][ldq]
  float* ks = qs + BM * ldq;                      // [BN][ldq]
  float* vs = ks + BN * ldq;                      // [BN][ldv]
  float* ps = vs + BN * ldv;                      // [BM][LDP]
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BM;
  const int kh = b * Hkv + h / (Hq / Hkv);
  const int nkt_all = (T_ + BN - 1) / BN;
  const int nkt = causal ? min(nkt_all, qt + 1) : nkt_all;    // BM == BN
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  stage(qs, q + ((size_t)b * Hq + h) * T_ * D, q0, T_, D, ldq);
  // V's columns past Dv stay 0 (their sums are never written out)
  for (int e = tid; e < BN * ldv; e += THREADS) vs[e] = 0.f;

  float o[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;                                   // this thread's columns only
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }
  const T* kb = k + (size_t)kh * T_ * D;
  const T* vb = v + (size_t)kh * T_ * DV;
  for (int j = 0; j < nkt; ++j) {
    const int c0 = j * BN;
    __syncthreads();                              // the last tile's K, V and p are read
    stage(ks, kb, c0, T_, D, ldq);
    stage(vs, vb, c0, T_, DV, ldv);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    const float* qr = qs + (4 * ty) * ldq;
    const float* kr = ks + tx * ldq;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qr[i * ldq + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bb[jj] = kr[16 * jj * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], bb[jj], s[i][jj]);
    }
    const bool edge = (causal && j == qt) || c0 + BN > T_;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = c0 + tx + 16 * jj;
        const bool keep = !edge || (col < T_ && (!causal || row >= col));
        s[i][jj] = keep ? s[i][jj] * scale_log2 : NEG;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int w = 1; w < 16; w *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = exp2f(s[i][jj] - mn);
        sum += p;
        ps[(4 * ty + i) * LDP + tx + 16 * jj] = p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();
    const float* pr = ps + (4 * ty) * LDP;
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pn[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pn[i] = pr[i * LDP + n];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[n * ldv + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) o[i][c] = fmaf(pn[i], vv[c], o[i][c]);
    }
  }
  T* ob = out + ((size_t)b * Hq + h) * T_ * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 1; w < 16; w *= 2) li += __shfl_xor_sync(0xffffffffu, li, w);
    const int row = q0 + 4 * ty + i;
    const float inv = 1.f / fmaxf(li, 1e-37f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (row < T_ && col < DV) ob[(size_t)row * DV + col] = from_f<T>(o[i][c] * inv);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int T_, int d, int dv, int causal, float sm_scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)(BM + BN) * (d | 1) + BN * 16 * NC + BM * LDP);
  const cudaError_t e = skt::ensure_smem(laser_general_kernel<T, NC>, smem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = static_cast<float>(static_cast<double>(sm_scale) * 1.4426950408889634);
  const dim3 grid(Hq, B, (T_ + BM - 1) / BM);
  laser_general_kernel<T, NC><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, T_, d, dv, causal, scale_log2);
  return (int)cudaGetLastError();
}

// O's columns in chunks of 16: the smallest of 2, 4, 6, 8, 12, 16 that holds Dv
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
             int T_, int d, int dv, int causal, float sm_scale, cudaStream_t st) {
  const int nc = (dv + 15) / 16;
  if (nc <= 2) return launch<T, 2>(q, k, v, out, B, Hq, Hkv, T_, d, dv, causal, sm_scale, st);
  if (nc <= 4) return launch<T, 4>(q, k, v, out, B, Hq, Hkv, T_, d, dv, causal, sm_scale, st);
  if (nc <= 6) return launch<T, 6>(q, k, v, out, B, Hq, Hkv, T_, d, dv, causal, sm_scale, st);
  if (nc <= 8) return launch<T, 8>(q, k, v, out, B, Hq, Hkv, T_, d, dv, causal, sm_scale, st);
  if (nc <= 12) return launch<T, 12>(q, k, v, out, B, Hq, Hkv, T_, d, dv, causal, sm_scale, st);
  return launch<T, 16>(q, k, v, out, B, Hq, Hkv, T_, d, dv, causal, sm_scale, st);
}

}  // namespace

// q [B, Hq, T, D], k [B, Hkv, T, D], v [B, Hkv, T, Dv], out [B, Hq, T, Dv];
// dtype 0 bf16, 1 fp16, 2 f32 (all four the same); 1 <= D, Dv <= 256;
// causal 0 / 1.
extern "C" int skt_laser_attention_general(const void* q, const void* k, const void* v,
                                           void* out, int B, int Hq, int Hkv, int T, int d,
                                           int dv, int causal, int dtype, float sm_scale,
                                           void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || d < 1 || d > MAX_D ||
      dv < 1 || dv > MAX_D || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal, sm_scale, st);
  if (dtype == 1) return dispatch<__half>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal, sm_scale, st);
  return dispatch<float>(q, k, v, out, B, Hq, Hkv, T, d, dv, causal, sm_scale, st);
}

extern "C" const char* skt_laser_attention_general_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
