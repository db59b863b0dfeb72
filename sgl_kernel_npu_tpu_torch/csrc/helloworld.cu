// Kernel K22: helloworld, a bf16 elementwise add, out = x + y.
//
// Replaces sgl_kernel_npu_tpu/ops/helloworld.py::helloworld_pallas (_kernel,
// helloworld.py:32-33: the whole arrays in VMEM, one add). Each sum is taken
// in f32 and rounded once to bf16, as PyTorch's bf16 add does, so the result
// equals x + y bit for bit.
//
// Bound on an H100: bytes, 3 * 2 * n over 3.35 TB/s (0.053 ms at [4096,
// 7168]). Design: a grid-stride loop over 16-byte vectors (8 values) with
// read-only loads, a few blocks per SM, then a scalar tail for the last
// n % 8 values. Needs 16-byte aligned x, y and out.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ __nv_bfloat162 add2(__nv_bfloat162 a, __nv_bfloat162 b) {
  const float2 x = __bfloat1622float2(a), y = __bfloat1622float2(b);
  return __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
}

__global__ void __launch_bounds__(THREADS)
    helloworld_kernel(const __nv_bfloat16* x, const __nv_bfloat16* y, __nv_bfloat16* out,
                      long long n) {
  const long long nv = n / 8;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long i = first; i < nv; i += stride) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(x) + i);
    const int4 b = __ldg(reinterpret_cast<const int4*>(y) + i);
    int4 c;
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
    __nv_bfloat162* pc = reinterpret_cast<__nv_bfloat162*>(&c);
#pragma unroll
    for (int j = 0; j < 4; ++j) pc[j] = add2(pa[j], pb[j]);
    reinterpret_cast<int4*>(out)[i] = c;
  }
  for (long long i = nv * 8 + first; i < n; i += stride)
    out[i] = __float2bfloat16_rn(__bfloat162float(x[i]) + __bfloat162float(y[i]));
}

}  // namespace

// x, y, out [n] bf16 (any shape, contiguous), n, stream.
extern "C" int skt_helloworld(const void* x, const void* y, void* out, long long n,
                              void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 132;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long want = (n / 8 + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 1 ? 1 : want < 8LL * sms ? want : 8LL * sms);
  helloworld_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_helloworld_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
