// Kernel K6: append one latent row per (layer, sequence) into the combined
// latent pages, in place.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_mla_v2.py::
// append_mla_pallas, which stages an 8-row aligned window of every layer per
// sequence, merges the new row in and writes the window back (Mosaic's 8-row
// slice alignment). Here nothing needs aligning: each row is written straight
// to its place, with no read-merge-write.
//
// For every layer l and row b with 0 <= pages[b] < P (the sentinel P drops
// the row):
//   cache[l, pages[b], offs[b], :] = rows[l, b, :]
// rows [L, B, C] and cache [L, P, ps, C], both int8 or both bf16 (the kernel
// copies bytes: `row_bytes` = C * element size).
//
// Bound on an H100: bytes only, L * B * row_bytes read and as many written,
// over 3.35 TB/s. One block per (row, layer); a thread copies 16 bytes. Byte
// for byte a copy, so the result equals the plain version exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void append_mla_kernel(const int8_t* __restrict__ rows, int8_t* __restrict__ cache,
                                  const int* __restrict__ pages,
                                  const int* __restrict__ offs, int B, int P, int ps,
                                  int row_bytes) {
  const int b = blockIdx.x, l = blockIdx.y;
  const int page = pages[b];
  if (page < 0 || page >= P) return;
  const size_t src = ((size_t)l * B + b) * row_bytes;
  const size_t dst = (((size_t)l * P + page) * ps + offs[b]) * (size_t)row_bytes;
  for (int c = threadIdx.x * 16; c < row_bytes; c += blockDim.x * 16)
    *reinterpret_cast<int4*>(cache + dst + c) = *reinterpret_cast<const int4*>(rows + src + c);
}

}  // namespace

// row_bytes a multiple of 16.
extern "C" int skt_append_mla(const void* rows, void* cache, const void* pages,
                              const void* offs, int L, int B, int P, int ps, int row_bytes,
                              void* stream) {
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  if (L == 0 || B == 0) return 0;
  int threads = row_bytes / 16;
  threads = threads > 128 ? 128 : (threads < 32 ? 32 : threads);
  const dim3 grid(B, L);
  append_mla_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rows), static_cast<int8_t*>(cache),
      static_cast<const int*>(pages), static_cast<const int*>(offs), B, P, ps, row_bytes);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_append_mla_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
