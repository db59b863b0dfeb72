// Kernels K6 and D: append one row per (layer, sequence) into paged caches,
// in place, on one copy loop.
//
// K6 replaces sgl_kernel_npu_tpu/ops/attention/decode_mla_v2.py::
// append_mla_pallas, which stages an 8-row aligned window of every layer per
// sequence, merges the new row in and writes the window back (Mosaic's 8-row
// slice alignment). D replaces sgl_kernel_npu_tpu/ops/attention/decode_v8.py::
// append_tm_int8_pallas (_kernel_append_tm), which issues strided HBM->HBM
// DMAs into aliased cache outputs. Here nothing needs aligning: each row is
// written straight to its place, with no read-merge-write.
//
// For every layer l and row b with 0 <= pages[b] < P (a page < 0 or >= P
// drops the row), and every (source, cache) pair:
//   cache[l, pages[b], offs[b], :] = rows[l, b, :]
// rows [L, B, C] and cache [L, P, ps, C], copied as bytes (`row_bytes` = C
// times the element size). K6 has one pair: the latent rows, int8 or bf16.
// D has two, K and V: int8 rows [L, B, hkv, D] into token-major pages
// [L, P, ps*hkv, D], which is the same layout with C = hkv*D.
//
// Bound on an H100: bytes only, every pair's L * B' * row_bytes read and as
// many written (B' the rows kept), over 3.35 TB/s. Byte for byte a copy, so
// the result equals the plain version exactly.
//
// Design. Each kernel has one form, fixed at compile time.
//
// K6 (a decode batch; the MLA model appends one row per decode sequence):
// a row is a few hundred bytes to a few KB, so the copy is a chain of
// latencies, not a stream: a sequence's page and slot, its source rows,
// the stores. A block takes one sequence over a group of its layers
// (layers g, g + G, ..), a thread one 16-byte column c of every lpp-th of
// them (lpp = the rows the block spans at once), and every thread issues
// its source loads (up to VPT in flight, each address its own: no chain of
// steps between them) together with the page and slot lookup, which the
// loads do not wait for; the stores follow once both have arrived. G is
// the least number of layer groups that gives every SM a block (1 where
// the batch alone does), so a block copies many rows and the card
// schedules few blocks.
//
// D (the decode step's rows, and a prefill chunk's: thousands of rows,
// many of them padding): a block a (row, layer) that looks the page up
// first (LOOKUP_FIRST), so that a dropped row's block reads nothing, then
// issues both pairs' loads before their stores. At a prefill chunk the
// other blocks hide a block's lookup and the copy is a stream; its fine
// grain balances the last wave (a block a row over every layer took D's
// prefill chunk 1.8% longer, K6's loop with the loads beside the lookup
// 23% longer, the padding read). At the decode step the call sits on the
// card's launch floor in either form.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_once.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VPT = 4;                 // 16-byte vectors a thread has in flight per pair

// the (source, cache) pairs of one launch
template <int NP>
struct Pairs {
  const int4* rows[NP];
  int4* cache[NP];
};

// a 16-byte load that the compiler keeps where it is written: before the
// page lookup resolves
__device__ __forceinline__ int4 ld16(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <int NP, bool LOOKUP_FIRST>
__device__ __forceinline__ void copy_rows(const Pairs<NP>& io, const int* __restrict__ pages,
                                          const int* __restrict__ offs, int L, int B, int P,
                                          int ps, int vpr, int G) {
  const int b = blockIdx.x, g = blockIdx.y;
  if (LOOKUP_FIRST) {                            // D's form: row b of layer g
    const int page = pages[b];
    if (page >= P || page < 0) return;
    const size_t src = ((size_t)g * B + b) * vpr;
    const size_t dst = (((size_t)g * P + page) * ps + offs[b]) * vpr;
    for (int c = threadIdx.x; c < vpr; c += blockDim.x) {
      int4 v[NP];                                // every pair's load in flight at once
#pragma unroll
      for (int p = 0; p < NP; ++p) v[p] = ld16(io.rows[p] + src + c);
#pragma unroll
      for (int p = 0; p < NP; ++p) io.cache[p][dst + c] = v[p];
    }
    return;
  }
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
      int4 v[NP][VPT];
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        const int l = g + (k + u * lpp) * G;
        if (k + u * lpp < nl)
#pragma unroll
          for (int p = 0; p < NP; ++p)
            v[p][u] = ld16(io.rows[p] + ((size_t)l * B + b) * vpr + c);
      }
      if (page < 0 || page >= P) return;
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        const int l = g + (k + u * lpp) * G;
        if (k + u * lpp < nl)
#pragma unroll
          for (int p = 0; p < NP; ++p)
            io.cache[p][(((size_t)l * P + page) * ps + off) * vpr + c] = v[p][u];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
append_mla_kernel(Pairs<1> io, const int* __restrict__ pages, const int* __restrict__ offs,
                  int L, int B, int P, int ps, int vpr, int G) {
  copy_rows<1, false>(io, pages, offs, L, B, P, ps, vpr, G);
}

__global__ void __launch_bounds__(THREADS)
append_tm_kernel(Pairs<2> io, const int* __restrict__ pages, const int* __restrict__ offs,
                 int L, int B, int P, int ps, int vpr) {
  copy_rows<2, true>(io, pages, offs, L, B, P, ps, vpr, L);
}

// 16-byte vectors of a row of row_bytes (a multiple of 16), or -1
int row_vectors(int row_bytes) { return row_bytes % 16 == 0 ? row_bytes / 16 : -1; }

// threads of a block that copies `per` vectors: whole warps, at most THREADS
int block_threads(int per) { return per >= THREADS ? THREADS : (per + 31) / 32 * 32; }

}  // namespace

// K6: rows [L, B, C] into cache [L, P, ps, C]; row_bytes a multiple of 16.
extern "C" int skt_append_mla(const void* rows, void* cache, const void* pages,
                              const void* offs, int L, int B, int P, int ps, int row_bytes,
                              void* stream) {
  const int vpr = row_vectors(row_bytes);
  if (vpr < 0) return (int)cudaErrorInvalidValue;
  if (L == 0 || B == 0 || vpr == 0) return 0;
  int sms = 0;
  const cudaError_t e = skt::sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const int G = B >= sms ? 1 : (sms + B - 1) / B < L ? (sms + B - 1) / B : L;
  const Pairs<1> io{{static_cast<const int4*>(rows)}, {static_cast<int4*>(cache)}};
  append_mla_kernel<<<dim3(B, G), block_threads(((L + G - 1) / G) * vpr), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      io, static_cast<const int*>(pages), static_cast<const int*>(offs), L, B, P, ps, vpr, G);
  return (int)cudaGetLastError();
}

// D: kq, vq [L, B, hkv, D] into kc, vc [L, P, ps*hkv, D]; run_bytes = hkv*D,
// a multiple of 16.
extern "C" int skt_append_tm(const void* kq, const void* vq, void* kc, void* vc,
                             const void* pages, const void* offs, int L, int B, int P, int ps,
                             int run_bytes, void* stream) {
  const int vpr = row_vectors(run_bytes);
  if (vpr < 0) return (int)cudaErrorInvalidValue;
  if (L == 0 || B == 0 || vpr == 0) return 0;
  const Pairs<2> io{{static_cast<const int4*>(kq), static_cast<const int4*>(vq)},
                    {static_cast<int4*>(kc), static_cast<int4*>(vc)}};
  append_tm_kernel<<<dim3(B, L), block_threads(vpr), 0, static_cast<cudaStream_t>(stream)>>>(
      io, static_cast<const int*>(pages), static_cast<const int*>(offs), L, B, P, ps, vpr);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_append_mla_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
