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
// (IEEE division, so that the rows are bit-equal to the plain version's).
// Every row that no chunk covers is zero with scale 0, as the JAX kernel's
// interpreted outputs start as zeros (the combine weighs padding rows by 0,
// and a NaN there would poison the sum); the kernel writes those zeros
// itself, so the caller hands it uninitialised windows.
//
// The kernel walks the receiver's window: block d takes window row d, finds
// on the card which slice's chunk covers it (the lowest such slice) and the
// source row it takes, or none, and writes the row: data, or zeros. That is
// the row map of parallel/strategies/pallas_ll.py::scatter_row_map, which the
// CPU tests hold against the plain version. No host sync, no memset, and
// every window row is written exactly once.
//
// The destination windows are addressed through a per-rank pointer table
// (Peers, by value). One rank fills one entry, and the receive wait is the
// end of the launch, so the launcher refuses R > 1. With peer windows (CUDA
// IPC or symmetric memory) and an arrival flag per slice, the work splits so:
// each sender's blocks take the live chunks of its own slices (the row map
// restricted to them, found from a prefix over send_cnt) and write them into
// the peers' windows; each receiver zeroes its own uncovered rows, those its
// receive layout (wait_cnt and its dst offsets) leaves out, before it raises
// its arrival flags. No rank writes another rank's zeros.
//
// Bound on an H100: bytes (each live row read once and written once, plus
// its scale; the zero rows' writes besides). Design: one block of 128
// threads a window row, a single wave at the bench layout (1,024-1,088 rows,
// up to 16 blocks an SM). A thread holds up to NV 16-byte vectors of its
// row in registers, all loaded before any is used: a bf16 row of 7,168 is 7
// vectors a thread, read once, its absmax taken across the block, then
// quantised from the registers. Longer rows take the part past NV * 128
// vectors from global memory twice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 8;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NV = 8;                 // 16-byte vectors a thread holds in registers
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
  int slices, src_rows, H, row_bytes;
};

// The source row that window row d takes (the lowest slice whose chunks
// cover it, with the source row inside x), or -1. Every warp finds it on its
// own: lanes test 32 slices at a time.
__device__ __forceinline__ int source_row(const Args& a, int d, int lane) {
  for (int i0 = 0; i0 < a.slices; i0 += 32) {
    const int i = i0 + lane;
    int src = -1;
    if (i < a.slices) {
      const int cnt = (a.send_cnt[i] + CHUNK - 1) / CHUNK * CHUNK;
      const int rel = d - a.dst_off[i] / CHUNK * CHUNK;
      const int s = a.src_off[i] / CHUNK * CHUNK + rel;
      if (rel >= 0 && rel < cnt && s < a.src_rows) src = s;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, src >= 0);
    if (hit) return __shfl_sync(0xffffffffu, src, __ffs(hit) - 1);
  }
  return -1;
}

template <typename T>
struct Vec;                           // a 16-byte vector of T as floats
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const int4& raw, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const int4& raw, float (&v)[4]) {
    v[0] = __int_as_float(raw.x);
    v[1] = __int_as_float(raw.y);
    v[2] = __int_as_float(raw.z);
    v[3] = __int_as_float(raw.w);
  }
};

template <typename T>
__device__ __forceinline__ float absmax(const int4& raw) {
  float v[Vec<T>::N];
  Vec<T>::unpack(raw, v);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) m = fmaxf(m, fabsf(v[i]));
  return m;
}

// the N int8 codes of one vector, stored at dst (N bytes)
template <typename T>
__device__ __forceinline__ void quant_store(const int4& raw, float scale, int8_t* dst) {
  constexpr int N = Vec<T>::N;
  float v[N];
  Vec<T>::unpack(raw, v);
  uint32_t w[N / 4];
#pragma unroll
  for (int j = 0; j < N / 4; ++j) w[j] = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int q = max(-128, min(127, __float2int_rn(__fdiv_rn(v[i], scale))));
    w[i >> 2] |= (uint32_t)(uint8_t)q << ((i & 3) * 8);
  }
  if constexpr (N == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// KIND 0: copy row bytes (+ scales); 1: quantise bf16 rows; 2: quantise f32 rows
template <int KIND>
__global__ void __launch_bounds__(THREADS) remote_scatter_kernel(const Args a) {
  const int d = blockIdx.x, tid = threadIdx.x;
  const int sr = source_row(a, d, tid % 32);
  const int nvec = a.row_bytes / 16;
  char* out = static_cast<char*>(a.peers.out[0]);
  float* sout = a.peers.sout[0];
  const int4* src = reinterpret_cast<const int4*>(static_cast<const char*>(a.x) +
                                                  (size_t)(sr < 0 ? 0 : sr) * a.row_bytes);
  if constexpr (KIND == 0) {
    int4* dst = reinterpret_cast<int4*>(out + (size_t)d * a.row_bytes);
    if (sr < 0) {
      for (int v = tid; v < nvec; v += THREADS) dst[v] = make_int4(0, 0, 0, 0);
    } else {
      for (int v0 = 0; v0 < nvec; v0 += NV * THREADS) {
        int4 buf[NV];
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const int v = v0 + u * THREADS + tid;
          if (v < nvec) buf[u] = __ldcs(src + v);
        }
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const int v = v0 + u * THREADS + tid;
          if (v < nvec) dst[v] = buf[u];
        }
      }
    }
    if (sout != nullptr && tid == 0) sout[d] = sr < 0 ? 0.f : a.scales[sr];
  } else {
    using T = typename std::conditional<KIND == 1, __nv_bfloat16, float>::type;
    constexpr int N = Vec<T>::N;      // elements (and int8 bytes out) a vector
    int8_t* dst = reinterpret_cast<int8_t*>(out) + (size_t)d * a.H;
    if (sr < 0) {
      for (int v = tid; v < nvec; v += THREADS) {
        if constexpr (N == 8)
          *reinterpret_cast<uint2*>(dst + v * N) = make_uint2(0u, 0u);
        else
          *reinterpret_cast<uint32_t*>(dst + v * N) = 0u;
      }
      if (tid == 0) sout[d] = 0.f;
      return;
    }
    int4 buf[NV];
    float amax = 0.f;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int v = u * THREADS + tid;
      if (v < nvec) buf[u] = __ldcs(src + v);
    }
#pragma unroll
    for (int u = 0; u < NV; ++u)
      if (u * THREADS + tid < nvec) amax = fmaxf(amax, absmax<T>(buf[u]));
    for (int v = NV * THREADS + tid; v < nvec; v += THREADS)
      amax = fmaxf(amax, absmax<T>(src[v]));
    __shared__ float red[WARPS];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (tid % 32 == 0) red[tid / 32] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) amax = fmaxf(amax, red[w]);
    const float scale = __fmul_rn(fmaxf(amax, 1e-7f), INV127);
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int v = u * THREADS + tid;
      if (v < nvec) quant_store<T>(buf[u], scale, dst + v * N);
    }
    for (int v = NV * THREADS + tid; v < nvec; v += THREADS)
      quant_store<T>(src[v], scale, dst + v * N);
    if (tid == 0) sout[d] = scale;
  }
}

}  // namespace

// x [src_rows, H] (row_bytes = H * element size, a multiple of 16), scales
// [src_rows] f32 or null, send_cnt / src_off / dst_off [R * spr] int32, out
// [out_rows, H] (int8 when quantising) and s_out [out_rows] f32 (or null
// without scales), uninitialised: every row is written. kind: 0 copy, 1
// quantise bf16, 2 quantise f32 (H % 8 == 0). One rank only (R == 1).
extern "C" int skt_remote_scatter(const void* x, const void* scales, const void* send_cnt,
                                  const void* src_off, const void* dst_off, void* out,
                                  void* s_out, int R, int spr, int src_rows, int out_rows,
                                  int H, int row_bytes, int kind, void* stream) {
  if (R != 1) return (int)cudaErrorNotSupported;
  if (spr <= 0 || src_rows < 0 || out_rows < 0 || row_bytes % 16 ||
      (kind != 0 && (H % 8 || s_out == nullptr)) ||
      (kind == 0 && (scales == nullptr) != (s_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (out_rows == 0) return (int)cudaSuccess;
  Args a{};
  a.x = x;
  a.scales = static_cast<const float*>(scales);
  a.send_cnt = static_cast<const int*>(send_cnt);
  a.src_off = static_cast<const int*>(src_off);
  a.dst_off = static_cast<const int*>(dst_off);
  a.peers.out[0] = out;
  a.peers.sout[0] = static_cast<float*>(s_out);
  a.slices = R * spr;
  a.src_rows = src_rows;
  a.H = H;
  a.row_bytes = row_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    remote_scatter_kernel<0><<<out_rows, THREADS, 0, st>>>(a);
  else if (kind == 1)
    remote_scatter_kernel<1><<<out_rows, THREADS, 0, st>>>(a);
  else
    remote_scatter_kernel<2><<<out_rows, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_remote_scatter_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
