// Device code of the grouped W8A8 GEMM, kernel K8 (w8a8_gemm.cu); K11
// (fused_moe.cu) takes its tile sizes, byte transpose and mma.
//
//   out[m, n] = bf16|f32( float(sum_k xq[m, k] * w[li, k, n]) * x_scale[m] * w_scale[li, n] )
//
// li is one layer for the whole of M or, for the grouped GEMM K8,
// the expert of each block_m-row tile of x (eid[m / block_m], clamped to
// [0, groups)); K8 then runs 32-row M tiles, so that no tile straddles two
// experts, and a tile whose rows all have x_scale 0 (the padding of the
// aligned compaction) writes zeros without streaming its expert's weights.
//
// The weight bank is a stack of column panels: [L, NB, K, bn] int8, panel j of
// layer li a contiguous [K, bn] block at ((li*NB + j)*K)*bn with rows of bn
// bytes. A plain [L, K, N] bank is the case bn = N (one panel per layer); the
// pretiled banks of ops/matmul.py::pretile_weight_bank have bn a multiple of
// the block width BN, so a block's 128 columns never straddle two panels.
//
// The A operand is int8 rows, ldx bytes apart. The epilogue multiplies as the
// plain versions do: (acc * x_scale[m]) * w_scale[li, n].
//
// int8 tensor-core mma.sync m16n8k32 with s32 accumulation makes the sum
// exact, so each kernel equals its plain version bit for bit. Weight tiles are
// read as 16-byte rows along N and byte-transposed in registers into
// K-contiguous shared-memory rows, the column-major B fragment mma.sync wants.
// When the output has too few tiles to keep every SM streaming weights, K is
// split over blocks and the int32 partial sums meet in a workspace through
// atomicAdd (exact in any order), followed by a small epilogue pass.
// Simple first: one register-prefetched stage, no TMA / wgmma yet. (K1 and
// K2 run the int8 wgmma stage of w8a8_wgmma.cuh instead.)

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace skt_w8a8 {

constexpr int BN = 128;      // output columns per block
constexpr int BK = 64;       // K elements per stage
constexpr int SROW = 80;     // padded shared-memory row: conflict-free fragment loads
constexpr int THREADS = 128;

struct Gemm {
  const int8_t* x;       // [M, ldx]
  const int8_t* w;       // [L, N/bn, K, bn] int8
  const float* xs;       // [M] epilogue row scale
  const float* ws;       // [L, N] per-column scale
  void* out;             // [M, N] bf16, or f32 when out_f32
  int32_t* accum;        // [M, N] split-K workspace, or null
  const int32_t* eid;    // K8: [M / block_m] expert of each row tile, or null
  int M, N, K, ldx, li, bn, k_chunk, out_f32, block_m, groups;
};

// The layer, or the expert of row m (K8).
__device__ __forceinline__ int layer_of(const Gemm& p, int m) {
  return p.eid != nullptr ? min(max(p.eid[m / p.block_m], 0), p.groups - 1) : p.li;
}

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

__device__ __forceinline__ float dequant(int32_t acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn((float)acc, xs), ws);
}

__device__ __forceinline__ void store_out(const Gemm& p, size_t i, float v) {
  if (p.out_f32)
    static_cast<float*>(p.out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(v);
}

// GROUPED: K8's instantiation (32-row tiles, an expert per tile); the others
// compile without its branches.
template <int BM, bool GROUPED>
__global__ void __launch_bounds__(THREADS) w8a8_kernel(const Gemm p) {
  constexpr int WARPS_M = BM == 16 ? 1 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int MT = BM / WARPS_M / 16;        // m16 tiles per warp
  constexpr int NT = BN / WARPS_N / 8;         // n8 tiles per warp
  constexpr int VPR = BK / 16;                 // 16-byte vectors per row and stage
  constexpr int A_VECS = BM * VPR;
  constexpr int A_PER_THREAD = (A_VECS + THREADS - 1) / THREADS;

  __shared__ __align__(16) int8_t As[BM * SROW];
  __shared__ __align__(16) int8_t Bs[BN * SROW];

  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(K, kbeg + p.k_chunk);
  const int li = GROUPED ? layer_of(p, m0) : p.li;

  if constexpr (GROUPED) {
    // K8: a tile of padding rows (x_scale 0 throughout) is zero whatever the
    // weights; the split-K workspace is zeroed already
    const bool live = tid < BM && m0 + tid < M && p.xs[m0 + tid] != 0.f;
    if (!__syncthreads_or(live)) {
      if (p.accum == nullptr && blockIdx.z == 0)
        for (int i = tid; i < BM * BN; i += THREADS) {
          const int r = m0 + i / BN, c = n0 + i % BN;
          if (r < M && c < N) store_out(p, (size_t)r * N + c, 0.f);
        }
      return;
    }
  }

  // the block's columns lie in one panel of layer li; rows are bn bytes apart
  const int panel = n0 / p.bn;
  const int8_t* w = p.w + ((size_t)li * (N / p.bn) + panel) * (size_t)K * p.bn
                    + (n0 - panel * p.bn);
  const size_t ldw = p.bn;
  const float* wsc = p.ws + (size_t)li * N;
  const int8_t* x = p.x;

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
        const int r = v / VPR, c = (v % VPR) * 16;
        if (m0 + r < M)
          areg[i] = *reinterpret_cast<const int4*>(x + (size_t)(m0 + r) * p.ldx + k0 + c);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      breg[j] = make_int4(0, 0, 0, 0);
      if (n_ok)
        breg[j] = __ldg(reinterpret_cast<const int4*>(
            w + (size_t)(k0 + kq * 4 + j) * ldw + nc));
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int v = tid + i * THREADS;
      if (v < A_VECS) {
        const int r = v / VPR, c = (v % VPR) * 16;
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
        const int8_t* ap = As + row * SROW + kk + t4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * SROW);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * SROW + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* bp = Bs + ((wn * NT + nt) * 8 + g) * SROW + kk + t4;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(bp);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
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
          if (p.accum != nullptr)
            atomicAdd(p.accum + (size_t)r * N + c, v);
          else
            store_out(p, (size_t)r * N + c, dequant(v, p.xs[r], wsc[c]));
        }
      }
    }
  }
}

template <bool GROUPED>
__global__ void w8a8_epilogue(const Gemm p) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)p.M * p.N) return;
  const int r = (int)(i / p.N), c = (int)(i % p.N);
  const int li = GROUPED ? layer_of(p, r) : p.li;
  store_out(p, i, dequant(p.accum[i], p.xs[r], p.ws[(size_t)li * p.N + c]));
}

// Launch on `st`. p.accum must be an [M, N] int32 workspace when splits > 1
// (zeroed here); it is ignored otherwise. Needs K % 64 == 0, N % 16 == 0,
// bn % 128 == 0 or bn == N, 16-byte aligned w and x rows (ldx a multiple
// of 16); with p.eid (K8), block_m % 32 == 0.
inline cudaError_t launch(Gemm p, int splits, cudaStream_t st) {
  if (splits < 1) splits = 1;
  p.k_chunk = max(BK, ((p.K / splits + BK - 1) / BK) * BK);
  if (splits > 1) {
    cudaError_t e = cudaMemsetAsync(p.accum, 0, (size_t)p.M * p.N * sizeof(int32_t), st);
    if (e != cudaSuccess) return e;
  } else {
    p.accum = nullptr;
  }
  const int nz = (p.K + p.k_chunk - 1) / p.k_chunk;
  const bool grouped = p.eid != nullptr;
  if (grouped) {
    const dim3 grid((p.N + BN - 1) / BN, (p.M + 31) / 32, nz);
    w8a8_kernel<32, true><<<grid, THREADS, 0, st>>>(p);
  } else if (p.M <= 16) {
    const dim3 grid((p.N + BN - 1) / BN, (p.M + 15) / 16, nz);
    w8a8_kernel<16, false><<<grid, THREADS, 0, st>>>(p);
  } else {
    const dim3 grid((p.N + BN - 1) / BN, (p.M + 63) / 64, nz);
    w8a8_kernel<64, false><<<grid, THREADS, 0, st>>>(p);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.accum == nullptr) return e;
  const unsigned blocks = (unsigned)(((size_t)p.M * p.N + 255) / 256);
  if (grouped)
    w8a8_epilogue<true><<<blocks, 256, 0, st>>>(p);
  else
    w8a8_epilogue<false><<<blocks, 256, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace skt_w8a8
