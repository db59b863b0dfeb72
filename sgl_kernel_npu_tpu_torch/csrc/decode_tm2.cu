// Kernel K3: paged GQA decode over the read-only int8 head-major-page ("tm2")
// cache, with the current token folded in (deferred write).
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_v13.py::
// decode_gqa_pallas_v13_int8_defer (_kernel_v13_int8) and decode_v11.py::
// decode_gqa_pallas_v11_int8_defer (_kernel_v11_int8), which share one
// contract and take one page per online-softmax step, and their finalization
// decode_v6.py::_finalize_rows.
//
// Cache: k/v int8 [L, P, hkv, ps, D], head h's tokens of a page one
// contiguous [ps, D] block; scales f32 [L, P, hkv, ps]. Only tokens t <
// cached are read.
//
// Bound on an H100: the bytes of the cached rows it must read,
// cached*hkv*(2*D + 8) per sequence and layer, over 3.35 TB/s; its
// operations are a few per byte, far below the tensor-core line. The kernel
// is kernel C's loop, csrc/decode_tm_core.cuh, on head-major pages with
// KEEP on: a step is one page, so the page's scores (G x (ps + 4) f32, 8 KB
// at G 4, ps 512) stay in shared memory from its score rounds (128 K rows
// each) to its p . v rounds (128 V rows each), and every cached row leaves
// device memory once; a round of a page is one contiguous 16 KB block per
// (head, K or V), copied by coalesced 16-byte cp.async through the 3-stage
// ring, which runs from a page's K rounds into its V rounds without
// draining. S^T and O^T run on
// bf16 mma.sync with exact products. K3 does not split a (sequence, kv
// head): one block walks all its pages (a split inside a page would re-scan
// the page's keys for its maximum, and the bench path's 1,024 rows fill
// the card without splits: PERF.md).

#include "decode_tm_core.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 3) decode_tm2_kernel(const Args a) {
  decode_body<HeadMajor, true>(a);
}

}  // namespace

// q [B, hq, D] bf16, k_new / v_new [B, hkv, D] bf16, caches int8 [L, P, hkv,
// ps, D], scales f32 [L, P, hkv, ps], cached [B], block table [B, MP] int32,
// out [B, hq, D]; one page per online-softmax step; G = hq / hkv <= 8; one
// block per (sequence, kv head).
extern "C" int skt_decode_tm2(const void* q, const void* kn, const void* vn,
                              const void* kc, const void* vc, const void* ksc,
                              const void* vsc, const void* cached, const void* bt,
                              void* out, int B, int hkv, int G, int P, int ps, int MP,
                              int li, float sm_scale, void* stream) {
  if (B == 0) return 0;
  return launch<true>(decode_tm2_kernel, q, kn, vn, kc, vc, ksc, vsc, cached, bt, out,
                      nullptr, nullptr, B, hkv, G, P, ps, MP, li, 1, 1, sm_scale, stream);
}

extern "C" const char* skt_decode_tm2_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
