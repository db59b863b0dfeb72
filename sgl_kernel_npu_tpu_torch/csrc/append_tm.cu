// Kernel D: append one quantized token per (layer, row) into token-major pages,
// in place.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/decode_v8.py::
// append_tm_int8_pallas (_kernel_append_tm), which issues strided HBM->HBM
// DMAs into aliased cache outputs. Here the cache tensors are written in place.
//
// For every layer l and row b with pages[b] < P (the sentinel P, and any
// negative page, skips the row):
//   kc[l, pages[b], offs[b]*hkv : offs[b]*hkv + hkv, :] = kq[l, b]   (same for v)
// kq/vq [L, B, hkv, D] int8, kc/vc [L, P, ps*hkv, D] int8.
//
// Bound on an H100: bytes only, 2 * L * B * hkv * D read and as many written,
// over 3.35 TB/s. One block per (row, layer) copies its two contiguous
// hkv*D-byte runs with 16-byte loads and stores. Byte for byte a copy, so the
// result equals the plain version exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void append_tm_kernel(const int8_t* __restrict__ kq,
                                 const int8_t* __restrict__ vq,
                                 int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                                 const int* __restrict__ pages,
                                 const int* __restrict__ offs, int B, int P, int ps,
                                 int run_bytes) {
  const int b = blockIdx.x, l = blockIdx.y;
  const int page = pages[b];
  if (page < 0 || page >= P) return;
  const size_t src = ((size_t)l * B + b) * run_bytes;
  const size_t dst = ((size_t)l * P + page) * ps * (size_t)run_bytes
                     + (size_t)offs[b] * run_bytes;
  for (int i = threadIdx.x * 16; i < run_bytes; i += blockDim.x * 16) {
    *reinterpret_cast<int4*>(kc + dst + i) = *reinterpret_cast<const int4*>(kq + src + i);
    *reinterpret_cast<int4*>(vc + dst + i) = *reinterpret_cast<const int4*>(vq + src + i);
  }
}

}  // namespace

// run_bytes = hkv * D, a multiple of 16.
extern "C" int skt_append_tm(const void* kq, const void* vq, void* kc, void* vc,
                             const void* pages, const void* offs, int L, int B,
                             int P, int ps, int run_bytes, void* stream) {
  if (run_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  if (L == 0 || B == 0) return 0;
  int threads = run_bytes / 16;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  const dim3 grid(B, L);
  append_tm_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
      static_cast<int8_t*>(kc), static_cast<int8_t*>(vc),
      static_cast<const int*>(pages), static_cast<const int*>(offs), B, P, ps,
      run_bytes);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_append_tm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
