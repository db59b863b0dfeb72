// Kernel K6: append one latent row per (layer, sequence) into the combined
// latent pages, in place.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_mla_v2.py::
// append_mla_pallas, which stages an 8-row aligned window of every layer per
// sequence, merges the new row in and writes the window back (Mosaic's 8-row
// slice alignment). Here nothing needs aligning: each row is written straight
// to its place, with no read-merge-write.
//
// For every layer l and row b with 0 <= pages[b] < P (a page < 0 or >= P
// drops the row):
//   cache[l, pages[b], offs[b], :] = rows[l, b, :]
// rows [L, B, C] and cache [L, P, ps, C], both int8 or both bf16 (the kernel
// copies bytes: `row_bytes` = C * element size).
//
// Bound on an H100: bytes only, L * B * row_bytes read and as many written,
// over 3.35 TB/s. Byte for byte a copy, so the result equals the plain
// version exactly.
//
// Design. A row is a few hundred bytes, so the copy is a chain of latencies,
// not a stream: a sequence's page and slot, its source rows, the stores. A
// block takes one sequence over a group of its layers (layers g, g + G, ..),
// a thread one 16-byte column c of every lpp-th of them (lpp = the rows the
// block spans at once), and every thread issues its source loads (up to VPT
// in flight, each address its own: no chain of steps between them) together
// with the page and slot lookup, which the loads do not wait for; the stores
// follow once both have arrived. G is the least number of layer groups that
// gives every SM a block (1 where the batch alone does), so a block copies
// many rows and the card schedules few blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_once.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VPT = 4;                 // 16-byte vectors a thread has in flight

// a 16-byte load that the compiler keeps where it is written: before the
// page lookup resolves
__device__ __forceinline__ int4 ld16(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(THREADS)
append_mla_kernel(const int4* __restrict__ rows, int4* __restrict__ cache,
                  const int* __restrict__ pages, const int* __restrict__ offs, int L, int B,
                  int P, int ps, int vpr, int G) {
  const int b = blockIdx.x, g = blockIdx.y;
  const int page = __ldg(pages + b), off = __ldg(offs + b);
  const int nl = (L - g + G - 1) / G;          // this block's layers: g, g + G, ..
  const int nt = blockDim.x;
  // rows the block spans at once, this thread's among them and its column
  // (a row wider than the block: every thread in row 0, columns nt apart)
  const int lpp = nt >= vpr ? nt / vpr : 1;
  const int j = nt >= vpr ? threadIdx.x / vpr : 0;
  if (j >= lpp) return;
  for (int c = threadIdx.x - j * vpr; c < vpr; c += nt) {
    for (int k = j; k < nl; k += lpp * VPT) {
      int4 v[VPT];
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        const int l = g + (k + u * lpp) * G;
        if (k + u * lpp < nl) v[u] = ld16(rows + ((size_t)l * B + b) * vpr + c);
      }
      if (page < 0 || page >= P) return;
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        const int l = g + (k + u * lpp) * G;
        if (k + u * lpp < nl) cache[(((size_t)l * P + page) * ps + off) * vpr + c] = v[u];
      }
    }
  }
}

}  // namespace

// row_bytes a multiple of 16.
extern "C" int skt_append_mla(const void* rows, void* cache, const void* pages,
                              const void* offs, int L, int B, int P, int ps, int row_bytes,
                              void* stream) {
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const int vpr = row_bytes / 16;
  if (L == 0 || B == 0 || vpr == 0) return 0;
  int sms = 0;
  const cudaError_t e = skt::sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const int G = B >= sms ? 1 : (sms + B - 1) / B < L ? (sms + B - 1) / B : L;
  const int per = ((L + G - 1) / G) * vpr;     // vectors of the largest block
  const int threads = per >= THREADS ? THREADS : (per + 31) / 32 * 32;
  append_mla_kernel<<<dim3(B, G), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rows), static_cast<int4*>(cache), static_cast<const int*>(pages),
      static_cast<const int*>(offs), L, B, P, ps, vpr, G);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_append_mla_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
