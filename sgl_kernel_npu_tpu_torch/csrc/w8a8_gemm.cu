// Kernel A: W8A8 GEMM out of a stacked [L, K, N] int8 weight bank at layer li.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/matmul.py::
// grouped_matmul_int8_pallas (_gmm_int8_kernel) as reached through
// quant_matmul_int8_stacked's 3-D bank branch (matmul.py:243-260).
//
//   out[m, n] = bf16( float(sum_k x[m, k] * w[li, k, n]) * x_scale[m] * w_scale[li, n] )
//
// Bound on an H100: at decode (M = 8) the call moves K*N weight bytes and does
// 2*M*K*N int8 operations, far below the 1,979 TOP/s line, so 3.35 TB/s of
// device memory bounds it; at prefill widths (M in the hundreds) the int8
// tensor-core rate comes close. Design for that:
//   * int8 tensor-core mma.sync m16n8k32 with s32 accumulation: the sum is
//     exact, and the epilogue multiplies in the plain version's order
//     ((acc * x_scale) * w_scale in f32, then bf16), so the output equals the
//     plain PyTorch version bit for bit;
//   * the layer index is a kernel argument: the kernel reads only layer li's
//     [K, N] slice of the bank, with no copy of the layer;
//   * weight tiles are read as 16-byte rows along N (full 32-byte sectors),
//     byte-transposed in registers into K-contiguous shared-memory rows, which
//     is the column-major B fragment mma.sync wants;
//   * when the output has too few tiles to keep 132 SMs streaming (decode),
//     K is split over blocks and the int32 partial sums meet in a workspace
//     through atomicAdd (exact in any order), followed by a small epilogue pass.
// Simple first: one register-prefetched stage, no TMA / wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;      // output columns per block
constexpr int BK = 64;       // K bytes per stage
constexpr int SROW = 80;     // padded shared-memory row: conflict-free fragment loads
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 rows (k..k+3) of 4 bytes (n..n+3) -> 4 words, word c = k..k+3 of column n+c.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2,
                                             uint32_t r3, uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wbank,
            const float* __restrict__ xs, const float* __restrict__ wsbank,
            __nv_bfloat16* __restrict__ out, int32_t* __restrict__ accum,
            int M, int N, int K, int li, int k_chunk) {
  constexpr int WARPS_M = BM == 16 ? 1 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int MT = BM / WARPS_M / 16;        // m16 tiles per warp
  constexpr int NT = BN / WARPS_N / 8;         // n8 tiles per warp
  constexpr int A_VECS = BM * BK / 16;         // 16-byte loads per A stage
  constexpr int A_PER_THREAD = (A_VECS + THREADS - 1) / THREADS;

  __shared__ __align__(16) int8_t As[BM * SROW];
  __shared__ __align__(16) int8_t Bs[BN * SROW];

  const int8_t* w = wbank + (size_t)li * K * N;
  const float* wsc = wsbank + (size_t)li * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);

  // weight loader: rows kq*4 .. kq*4+3 of the stage, 16 bytes at column nc
  const int kq = lane & 15;
  const int nc = (warp * 2 + (lane >> 4)) * 16;
  const bool n_ok = n0 + nc < N;               // N % 16 == 0: whole group in range

  int4 areg[A_PER_THREAD];
  int4 breg[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int v = tid + i * THREADS;
      areg[i] = make_int4(0, 0, 0, 0);
      if (v < A_VECS) {
        const int r = v >> 2, c = (v & 3) * 16;
        if (m0 + r < M)
          areg[i] = *reinterpret_cast<const int4*>(x + (size_t)(m0 + r) * K + k0 + c);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      breg[j] = make_int4(0, 0, 0, 0);
      if (n_ok)
        breg[j] = __ldg(reinterpret_cast<const int4*>(
            w + (size_t)(k0 + kq * 4 + j) * N + n0 + nc));
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int v = tid + i * THREADS;
      if (v < A_VECS) {
        const int r = v >> 2, c = (v & 3) * 16;
        *reinterpret_cast<int4*>(As + r * SROW + c) = areg[i];
      }
    }
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(&breg[0]);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(&breg[1]);
    const uint32_t* r2 = reinterpret_cast<const uint32_t*>(&breg[2]);
    const uint32_t* r3 = reinterpret_cast<const uint32_t*>(&breg[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t o[4];
      transpose4x4(r0[q], r1[q], r2[q], r3[q], o);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(Bs + (nc + q * 4 + c) * SROW + kq * 4) = o[c];
    }
  };

  int32_t acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t4 = (lane & 3) * 4;

  if (kbeg < kend) load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();                 // the previous stage's fragments are read
    store();
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);   // next stage in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = (wm * MT + mt) * 16 + g;
        const int8_t* p = As + row * SROW + kk + t4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SROW);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SROW + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* p = Bs + ((wn * NT + nt) * 8 + g) * SROW + kk + t4;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int row = m0 + (wm * MT + mt) * 16 + g;
      const int col = n0 + (wn * NT + nt) * 8 + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e >> 1) * 8, c = col + (e & 1);
        if (r < M && c < N) {
          const int32_t v = acc[mt][nt][e];
          if (accum != nullptr)
            atomicAdd(accum + (size_t)r * N + c, v);
          else
            out[(size_t)r * N + c] = __float2bfloat16_rn((float)v * xs[r] * wsc[c]);
        }
      }
    }
  }
}

__global__ void w8a8_epilogue(const int32_t* __restrict__ accum,
                              const float* __restrict__ xs,
                              const float* __restrict__ wsbank,
                              __nv_bfloat16* __restrict__ out, int M, int N, int li) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int r = (int)(i / N), c = (int)(i % N);
  out[i] = __float2bfloat16_rn((float)accum[i] * xs[r] * wsbank[(size_t)li * N + c]);
}

}  // namespace

// x [M, K] int8, w [L, K, N] int8, xs [M] f32, ws [L, N] f32, out [M, N] bf16.
// splits > 1 needs workspace: M*N int32, zeroed here on the stream.
// Needs K % 64 == 0, N % 16 == 0 and 16-byte aligned x and w.
extern "C" int skt_w8a8_gemm(const void* x, const void* w, const void* xs,
                             const void* ws, void* out, void* workspace, int M,
                             int N, int K, int li, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1) splits = 1;
  const int k_chunk = max(BK, ((K / splits + BK - 1) / BK) * BK);
  int32_t* accum = nullptr;
  if (splits > 1) {
    accum = static_cast<int32_t*>(workspace);
    cudaError_t e = cudaMemsetAsync(accum, 0, (size_t)M * N * sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  const int nz = (K + k_chunk - 1) / k_chunk;
  const dim3 block(THREADS);
  if (M <= 16) {
    const dim3 grid((N + BN - 1) / BN, (M + 15) / 16, nz);
    w8a8_kernel<16><<<grid, block, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(xs), static_cast<const float*>(ws),
        static_cast<__nv_bfloat16*>(out), accum, M, N, K, li, k_chunk);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + 63) / 64, nz);
    w8a8_kernel<64><<<grid, block, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(xs), static_cast<const float*>(ws),
        static_cast<__nv_bfloat16*>(out), accum, M, N, K, li, k_chunk);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits <= 1) return (int)e;
  const size_t total = (size_t)M * N;
  w8a8_epilogue<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      accum, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), M, N, li);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_w8a8_gemm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
