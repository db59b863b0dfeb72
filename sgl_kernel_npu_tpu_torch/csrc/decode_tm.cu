// Kernel C: paged GQA decode over the read-only int8 token-major cache, with
// the current token folded in (deferred write).
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/decode_v9.py::
// decode_gqa_pallas_v9_int8_defer (_kernel_v9_int8) and its finalization
// decode_v6.py::_finalize_rows.
//
// Cache: k/v int8 [L, P, ps*hkv, D], row r = t*hkv + h; scales f32
// [L, P, 1, ps*hkv] with the same row order. Only rows t < cached are read.
// The online softmax steps through the TPU kernel's CHUNK_PAGES pages at a
// time (or one page for decode_v8's contract).
//
// Bound on an H100: the bytes of the cached rows it must read,
// cached*hkv*(2*D + 8) per sequence per layer, over 3.35 TB/s; at decode
// batch 8 that is a few MB, so what limits it is the latency of the walk.
// The kernel is csrc/decode_tm_core.cuh on token-major pages with KEEP off:
// a row split over S blocks where the card has room, merged in split
// order; rounds of 64 tokens (p . v, K and V) or 128 (scores) through a
// 3-stage cp.async ring; S^T and O^T on bf16 mma.sync; a step's p recomputed from its scores (a
// step of several pages keeps no scores in shared memory).

#include "decode_tm_core.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 3) decode_tm_kernel(const Args a) {
  decode_body<TokenMajor, false>(a);
}

}  // namespace

// The number of splits S of each (sequence, kv head) that skt_decode_tm
// takes on the current device (from its co-resident blocks and the block
// table's width), or minus a CUDA error. The workspace holds B * hkv * S *
// (2 * 8 + 8 * 128) floats (none for S = 1), the arrival counters B * hkv
// ints, zero before the first call.
extern "C" int skt_decode_tm_splits(int B, int hkv, int MP, int ps) {
  if (MP <= 0 || ps <= 0) return -(int)cudaErrorInvalidValue;
  return splits_for(decode_tm_kernel, smem_bytes(false, MAXG, 0), B, hkv,
                    ((long long)MP * ps + 15) / 16);
}

// q [B, hq, D] bf16, k_new / v_new [B, hkv, D] bf16, caches int8 [L, P,
// ps*hkv, D], scales f32 [L, P, 1, ps*hkv], cached [B], block table [B, MP]
// int32, out [B, hq, D]; step_pages pages per online-softmax step; S from
// skt_decode_tm_splits, ws and arrivals as it says.
extern "C" int skt_decode_tm(const void* q, const void* kn, const void* vn,
                             const void* kc, const void* vc, const void* ksc,
                             const void* vsc, const void* cached, const void* bt,
                             void* out, void* ws, void* arrivals, int B, int hkv, int G, int P,
                             int ps, int MP, int li, int step_pages, int S, float sm_scale,
                             void* stream) {
  return launch<false>(decode_tm_kernel, q, kn, vn, kc, vc, ksc, vsc, cached, bt,
                                   out, ws, arrivals, B, hkv, G, P, ps, MP, li, step_pages, S,
                                   sm_scale, stream);
}

extern "C" const char* skt_decode_tm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
