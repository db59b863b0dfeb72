// Kernel K24: two-tier paged GQA decode, int8 pages plus a bf16 sidecar
// window, on C's tensor-core loop (decode_tm_core.cuh, TWO_TIER).
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
// rounded to bf16; P_BF16), one online-softmax step per page; then the
// sidecar rows as one more step with bf16 products and p rounded to bf16
// (fold_sidecar); then the current token with its p rounded to bf16. The TPU
// kernel builds the per-head sidecar scores from a block-diagonal q (a
// workaround for the MXU); the per-head dots are the same sums.
//
// Bound on an H100: the bytes of the flushed int8 rows (2 * 128 + 8 per token
// and kv head), the sidecar's bf16 rows (2 * 2 * 128 per token and kv head),
// q, the new rows and the output, over 3.35 TB/s.
// Design: K14's int8 loop (a block a (sequence, kv head, group of at most 8
// query heads; G 16 as two), a page a step, the step's scores kept in shared
// memory, 128 int8 rows a round) on a ring of NST = 2 stages, so that 4
// blocks an SM fit and phase 13's 512 blocks run in one wave (a 3-stage ring
// held 3 an SM: two waves, 1.3x slower); each round reads the block table
// once (PAGE_ONCE). Where the card has room for more blocks than rows, a
// row splits on page boundaries, each split taking the scores from token 0
// for the running maximum at its first step (p is rounded where the TPU
// kernel rounds it), merged in split order through integer arrival
// counters; the merging block then folds in the sidecar and the current
// token.

#include "decode_tm_core.cuh"

namespace {

constexpr int NST = 2;           // the ring's stages

__global__ void __launch_bounds__(THREADS, 4) decode_v7_kernel(const Args a) {
  decode_body<HeadMajor, true, int8_t, false, P_BF16, TWO_TIER, NST, true>(a);
}

size_t smem_of(int G, int ps, int window) {
  return smem_bytes<int8_t>(true, G, std::max(ps, side_step(window)), 1, NST);
}

}  // namespace

// The splits S of each (sequence, kv head, group of G heads) on the current
// device: co-resident blocks over the B * hkv * ng rows, at most MP (a split
// holds whole pages) and 8; or minus a CUDA error. The workspace holds B *
// hkv * ng * S * (2 * 8 + 8 * 128) floats (none for S = 1), the arrival
// counters B * hkv * ng ints, zero before the first call.
extern "C" int skt_decode_v7_int8_splits(int B, int hkv, int G, int ng, int MP, int ps,
                                         int window) {
  if (G <= 0 || G > MAXG || ng <= 0 || MP <= 0 || ps <= 0 || window <= 0)
    return -(int)cudaErrorInvalidValue;
  return splits_for(decode_v7_kernel, smem_of(G, ps, window), B, hkv * ng, MP);
}

// q, k cache, v cache (int8), k scales, v scales, k_new, v_new, k sidecar,
// v sidecar, side_rows [B], cached [B], block table, out, ws, arrivals, B,
// Hq, Hkv, D, P, ps, MP, W, ng, S, sm_scale, stream; Hq / Hkv query heads a
// kv head as ng blocks of at most 8, S, ws and arrivals as the splits
// function says.
extern "C" int skt_decode_v7_int8(const void* q, const void* kc, const void* vc,
                                  const void* ks, const void* vs, const void* knew,
                                  const void* vnew, const void* kside, const void* vside,
                                  const void* side_rows, const void* cached, const void* bt,
                                  void* out, void* ws, void* arrivals, int B, int hq, int hkv,
                                  int d, int P, int ps, int MP, int window, int ng, int S,
                                  float sm_scale, void* stream) {
  if (d != D || hkv <= 0 || ng <= 0 || hq <= 0 || hq % (hkv * ng) || ps <= 0 || P <= 0 ||
      window <= 0 || knew == nullptr || vnew == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch<true, int8_t, P_BF16, NST>(decode_v7_kernel, q, knew, vnew, kc, vc, ks, vs,
                                           cached, bt, out, ws, arrivals, B, hkv,
                                           hq / (hkv * ng), P, ps, MP, 0, 1, S, sm_scale, stream,
                                           ng, nullptr, nullptr, 1, nullptr, 0, kside, vside,
                                           side_rows, window);
}

extern "C" const char* skt_decode_v7_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
