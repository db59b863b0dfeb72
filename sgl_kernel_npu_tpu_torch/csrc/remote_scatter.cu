// Kernel K12: the chunked ragged scatter of the "pallas" EP strategy.
//
// Replaces sgl_kernel_npu_tpu/parallel/strategies/pallas_ll.py::
// _remote_scatter (_scatter_kernel, pallas_ll.py:67-188), which streams each
// slice into a peer's window in CHUNK-row remote DMAs and waits on
// semaphores. Slice i (destination rank i / spr) moves the chunks
// c < ceil(send_cnt[i] / CHUNK) of rows
//   src0 = (src_off[i] / CHUNK) * CHUNK + c * CHUNK   (CHUNK rows of x)
// to rows dst0 = (dst_off[i] / CHUNK) * CHUNK + c * CHUNK of the destination
// window (rows past either end are skipped). Without quantisation a row is
// copied as bytes and its scale, when given, rides along. With it (x bf16 or
// f32) each row is quantised on the way, as the TPU kernel does between its
// stage copy and its remote DMA:
//   scale = max(absmax, 1e-7) * f32(1/127),  q = clamp(rint(x / scale), -128, 127)
// The wrapper zeroes the outputs first (the JAX kernel's interpreted outputs
// start as zeros; the combine weighs padding rows by 0, and a NaN there would
// poison the sum).
//
// The destination windows are addressed through a per-rank pointer table
// (Peers, by value). One rank fills one entry, and the receive wait is the
// end of the launch; several ranks need the table's entries to be peer
// windows (CUDA IPC or symmetric memory) and an arrival flag per slice, so
// the launcher refuses R > 1.
//
// Bound on an H100: bytes (each moved row read once and written once, plus
// its scale). Design: one block per (chunk, slice), a warp per row; blocks
// past a slice's last chunk return at once. A quantised row is read twice
// (absmax, then quantise), the second time from L1/L2. Simple first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 8;
constexpr int THREADS = 128;          // 4 warps, 2 rows each
constexpr int MAX_RANKS = 8;
constexpr float INV127 = (float)(1.0 / 127.0);

struct Peers {                        // entry r: rank r's window
  void* out[MAX_RANKS];
  float* sout[MAX_RANKS];
};

struct Args {
  const void* x;                      // [src_rows, H]
  const float* scales;                // [src_rows] or null
  const int* send_cnt;
  const int* src_off;
  const int* dst_off;
  Peers peers;
  int spr, src_rows, out_rows, H, row_bytes;
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(b[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One warp quantises one row of H elements (H % 8 == 0) into dst / *sdst.
template <typename T>
__device__ __forceinline__ void quant_row(const T* src, int8_t* dst, float* sdst, int H,
                                          int lane) {
  float amax = 0.f;
  for (int c = lane * 8; c < H; c += 256) {
    float v[8];
    load8(src + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = __fmul_rn(fmaxf(amax, 1e-7f), INV127);
  for (int c = lane * 8; c < H; c += 256) {
    float v[8];
    load8(src + c, v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = max(-128, min(127, __float2int_rn(__fdiv_rn(v[i], scale))));
      w[i >> 2] |= (uint32_t)(uint8_t)q << ((i & 3) * 8);
    }
    *reinterpret_cast<uint2*>(dst + c) = make_uint2(w[0], w[1]);
  }
  if (lane == 0) *sdst = scale;
}

// KIND 0: copy row bytes (+ scales); 1: quantise bf16 rows; 2: quantise f32 rows
template <int KIND>
__global__ void __launch_bounds__(THREADS) remote_scatter_kernel(const Args a) {
  const int i = blockIdx.y, c = blockIdx.x;
  if (c * CHUNK >= a.send_cnt[i]) return;
  const int dst = i / a.spr;
  const int src0 = a.src_off[i] / CHUNK * CHUNK + c * CHUNK;
  const int dst0 = a.dst_off[i] / CHUNK * CHUNK + c * CHUNK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  char* out = static_cast<char*>(a.peers.out[dst]);
  float* sout = a.peers.sout[dst];
  for (int j = warp; j < CHUNK; j += THREADS / 32) {
    const int sr = src0 + j, dr = dst0 + j;
    if (sr >= a.src_rows || dr >= a.out_rows) continue;
    if constexpr (KIND == 0) {
      const int4* s = reinterpret_cast<const int4*>(static_cast<const char*>(a.x) +
                                                    (size_t)sr * a.row_bytes);
      int4* d = reinterpret_cast<int4*>(out + (size_t)dr * a.row_bytes);
      for (int v = lane; v < a.row_bytes / 16; v += 32) d[v] = __ldg(s + v);
      if (a.scales != nullptr && lane == 0) sout[dr] = a.scales[sr];
    } else {
      using T = typename std::conditional<KIND == 1, __nv_bfloat16, float>::type;
      quant_row(static_cast<const T*>(a.x) + (size_t)sr * a.H,
                reinterpret_cast<int8_t*>(out) + (size_t)dr * a.H, sout + dr, a.H, lane);
    }
  }
}

}  // namespace

// x [src_rows, H] (row_bytes = H * element size, a multiple of 16), scales
// [src_rows] f32 or null, send_cnt / src_off / dst_off [R * spr] int32, out
// [out_rows, H] (int8 when quantising) and s_out [out_rows] f32 (or null
// without scales), both zeroed by the caller. kind: 0 copy, 1 quantise bf16,
// 2 quantise f32 (H % 8 == 0). One rank only (R == 1).
extern "C" int skt_remote_scatter(const void* x, const void* scales, const void* send_cnt,
                                  const void* src_off, const void* dst_off, void* out,
                                  void* s_out, int R, int spr, int src_rows, int out_rows,
                                  int H, int row_bytes, int kind, void* stream) {
  if (R != 1) return (int)cudaErrorNotSupported;
  if (spr <= 0 || src_rows < 0 || row_bytes % 16 || (kind != 0 && (H % 8 || s_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (src_rows == 0) return (int)cudaSuccess;
  Args a{};
  a.x = x;
  a.scales = static_cast<const float*>(scales);
  a.send_cnt = static_cast<const int*>(send_cnt);
  a.src_off = static_cast<const int*>(src_off);
  a.dst_off = static_cast<const int*>(dst_off);
  a.peers.out[0] = out;
  a.peers.sout[0] = static_cast<float*>(s_out);
  a.spr = spr;
  a.src_rows = src_rows;
  a.out_rows = out_rows;
  a.H = H;
  a.row_bytes = row_bytes;
  const dim3 grid((src_rows + CHUNK - 1) / CHUNK, R * spr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    remote_scatter_kernel<0><<<grid, THREADS, 0, st>>>(a);
  else if (kind == 1)
    remote_scatter_kernel<1><<<grid, THREADS, 0, st>>>(a);
  else
    remote_scatter_kernel<2><<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_remote_scatter_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
