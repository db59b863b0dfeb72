// Kernel K4: append one quantized token per (layer, sequence) into
// head-major-within-page ("tm2") pages, in place.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_v11.py::
// append_tm2_int8_pallas, which stages an 8-row aligned window of every head
// per sequence, merges the new row in and writes the window back (Mosaic's
// 8-row slice alignment). Here nothing needs aligning: each head's row is
// written straight to its place, with no read-merge-write.
//
// For every layer l and row b with 0 <= pages[b] < P (the sentinel P skips
// the row), and every head h:
//   kc[l, pages[b], h, offs[b], :] = kq[l, b, h, :]        (same for v)
// kq/vq [L, B, hkv, D] int8, kc/vc [L, P, hkv, ps, D] int8.
//
// Bound on an H100: bytes only, 2 * L * B * hkv * D read and as many written,
// over 3.35 TB/s. One block per (row, layer); a thread copies 16 bytes of a
// head's row of k and of v. Byte for byte a copy, so the result equals the
// plain version exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void append_tm2_kernel(const int8_t* __restrict__ kq,
                                  const int8_t* __restrict__ vq,
                                  int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                                  const int* __restrict__ pages,
                                  const int* __restrict__ offs, int B, int P, int hkv,
                                  int ps, int D) {
  const int b = blockIdx.x, l = blockIdx.y;
  const int page = pages[b];
  if (page < 0 || page >= P) return;
  const int off = offs[b];
  const int vecs = D / 16;                       // 16-byte pieces of a row
  for (int i = threadIdx.x; i < hkv * vecs; i += blockDim.x) {
    const int h = i / vecs, c = (i % vecs) * 16;
    const size_t src = (((size_t)l * B + b) * hkv + h) * D + c;
    const size_t dst = ((((size_t)l * P + page) * hkv + h) * ps + off) * (size_t)D + c;
    *reinterpret_cast<int4*>(kc + dst) = *reinterpret_cast<const int4*>(kq + src);
    *reinterpret_cast<int4*>(vc + dst) = *reinterpret_cast<const int4*>(vq + src);
  }
}

}  // namespace

// D a multiple of 16.
extern "C" int skt_append_tm2(const void* kq, const void* vq, void* kc, void* vc,
                              const void* pages, const void* offs, int L, int B, int P,
                              int hkv, int ps, int D, void* stream) {
  if (D % 16 != 0) return (int)cudaErrorInvalidValue;
  if (L == 0 || B == 0) return 0;
  int threads = hkv * (D / 16);
  threads = threads > 256 ? 256 : (threads < 32 ? 32 : threads);
  const dim3 grid(B, L);
  append_tm2_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
      static_cast<int8_t*>(kc), static_cast<int8_t*>(vc),
      static_cast<const int*>(pages), static_cast<const int*>(offs), B, P, hkv, ps, D);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_append_tm2_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
