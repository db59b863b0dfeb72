// Kernel K22: helloworld, a bf16 elementwise add, out = x + y.
//
// Replaces sgl_kernel_npu_tpu/ops/helloworld.py::helloworld_pallas (_kernel,
// helloworld.py:32-33: the whole arrays in VMEM, one add). Each sum is taken
// in f32 and rounded once to bf16, as PyTorch's bf16 add does, so the result
// equals x + y bit for bit.
//
// Bound on an H100: bytes, 3 * 2 * n over 3.35 TB/s (0.053 ms at [4096,
// 7168]). Design: one block per THREADS * U 16-byte vectors (8 values
// each), no loop: each thread issues its U loads of x and U of y before its
// first add, and the card's block scheduler keeps the memory busy as blocks
// retire. A grid-stride loop over one wave of resident blocks measured 3%
// slower at [4096, 7168], with or without streaming cache hints, and the
// hints gained nothing on this shape (scripts/probe_helloworld.py). The
// last n % 8 values take a scalar tail. Needs 16-byte aligned x, y and out.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;              // 16-byte vectors of each operand a thread loads

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  const __nv_bfloat162 s = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
  return *reinterpret_cast<const uint32_t*>(&s);
}

__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  return make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z), add2(a.w, b.w));
}

__global__ void __launch_bounds__(THREADS)
    helloworld_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                      __nv_bfloat16* __restrict__ out, long long n) {
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const long long nv = n / 8;
  const long long base = (long long)blockIdx.x * THREADS * U + threadIdx.x;
  uint4 a[U], b[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (base + u * THREADS < nv) a[u] = xv[base + u * THREADS];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (base + u * THREADS < nv) b[u] = yv[base + u * THREADS];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (base + u * THREADS < nv) ov[base + u * THREADS] = add8(a[u], b[u]);
  // the last block's first n % 8 threads take the tail
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n % 8) {
    const long long j = nv * 8 + threadIdx.x;
    out[j] = __float2bfloat16_rn(__bfloat162float(x[j]) + __bfloat162float(y[j]));
  }
}

}  // namespace

// x, y, out [n] bf16 (any shape, contiguous), n, stream.
extern "C" int skt_helloworld(const void* x, const void* y, void* out, long long n,
                              void* stream) {
  if (n <= 0) return 0;
  const long long per_block = (long long)THREADS * U;
  const long long blocks = (n / 8 + per_block - 1) / per_block;
  helloworld_kernel<<<(unsigned)(blocks < 1 ? 1 : blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_helloworld_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
