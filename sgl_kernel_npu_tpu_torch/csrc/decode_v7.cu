// Kernel K24: two-tier paged GQA decode, int8 pages plus a bf16 sidecar
// window.
//
// Replaces attic/ops_attention/decode_v7.py::decode_gqa_pallas_v7_int8
// (_kernel_v7_int8, decode_v7.py:65-205). The cache holds cached[b] tokens
// (the current one excluded): the first flushed = cached / W * W in int8
// page-major pages [P, Hkv, ps, 128] with per-token f32 scales [P, Hkv, 1,
// ps], the last cached - flushed (< W) in row side_rows[b] of a bf16
// token-major sidecar [S, W, Hkv*128] (head h in columns h*128 ..); the
// current token's k / v [B, Hkv, 128] bf16 fold in last. W is 64 in the
// reference (WINDOW), any value here.
//
// Rounding, as the TPU kernel takes it: the int8 pages as K14's int8
// contract (bf16 products, the K scale on the score, p times the V scale
// rounded to bf16), one online-softmax step per page; then the sidecar rows
// as one more step with bf16 products and p rounded to bf16; then the current
// token with its p rounded to bf16 (decode_hm.cuh, TWO_TIER). The TPU kernel
// builds the per-head sidecar scores from a block-diagonal q (a workaround
// for the MXU); the per-head dots are the same sums.
//
// Bound on an H100: the bytes of the flushed int8 rows (2 * 128 + 8 per token
// and kv head), the sidecar's bf16 rows (2 * 2 * 128 per token and kv head),
// q, the new rows and the output, over 3.35 TB/s. Design: decode_hm.cuh's
// CUDA-core loop (its int8 rows and its TWO_TIER mode are K24's alone; K10
// is its other user), one block per (kv head, sequence), where the TPU
// kernel runs one program over the whole batch (grid 1) with a ring of page
// copies.

#include "decode_hm.cuh"

using namespace skt_hm;

// q, k cache, v cache (int8), k scales, v scales, k_new, v_new, k sidecar,
// v sidecar, side_rows [B], cached [B], block table, out, B, Hq, Hkv, D, P,
// ps, MP, W, sm_scale, stream.
extern "C" int skt_decode_v7_int8(const void* q, const void* kc, const void* vc,
                                  const void* ks, const void* vs, const void* knew,
                                  const void* vnew, const void* kside, const void* vside,
                                  const void* side_rows, const void* cached, const void* bt,
                                  void* out, int B, int Hq, int Hkv, int d, int P, int ps,
                                  int MP, int window, float sm_scale, void* stream) {
  Operands a = operands(PAGE_MAJOR, q, kc, vc, ks, vs, knew, vnew, cached, bt, out, Hkv, P, ps,
                        MP, sm_scale);
  a.kside = static_cast<const __nv_bfloat16*>(kside);
  a.vside = static_cast<const __nv_bfloat16*>(vside);
  a.side_rows = static_cast<const int*>(side_rows);
  a.window = window;
  return run<int8_t, TWO_TIER, true>(a, B, Hq, d, stream);
}

extern "C" const char* skt_decode_v7_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
