// Kernels K16 and K23: paged GQA decode over page-major ("hm") pages in f32
// arithmetic (p not rounded), on C's tensor-core loop (decode_tm_core.cuh,
// P_F32), each contract its own C entry point and launch counter.
//
// K16, over page-major pages [P, Hkv, ps, 128] (bf16, or int8 with per-token
// f32 scales [P, Hkv, 1, ps]), replaces sgl_kernel_npu_tpu/ops/attention/
//   decode_v3             decode_v3.py:94  decode_gqa_pallas_v3: bf16, the
//                         current token already in the cache (IN_CACHE);
//   decode_v3_int8        decode_v3.py:217 decode_gqa_pallas_v3_int8;
//   decode_v3_defer       decode_v3.py:492 decode_gqa_pallas_v3_defer: bf16,
//                         the cache holds `cached` tokens, the current
//                         token's k / v [B, Hkv, 128] bf16 fold in last
//                         (DEFER);
//   decode_v3_int8_defer  decode_v3.py:368 decode_gqa_pallas_v3_int8_defer;
//   decode_int8kv         decode.py:366 decode_gqa_int8kv_pallas: int8
//                         kv-head-major pages [Hkv, P, ps, 128], scales
//                         [Hkv, P, 1, ps], the current token in the cache.
// K23 serves the retired decodes of attic/ops_attention/, K16's arithmetic:
//   decode_v5_defer       decode_v5.py:225 decode_gqa_pallas_v5_defer, and
//   decode_v5_int8_defer  decode_v5.py:134 decode_gqa_pallas_v5_int8_defer:
//                         K16's deferred contracts;
//   decode_v4b_int8       decode_v4.py:536 decode_v4b_int8: K16's int8
//                         contract over stacked caches [L, P, Hkv, ps, 128]
//                         at a layer (a device int32, or an int);
//   decode_fused_v4_int8  decode_v4.py:188 decode_fused_v4_int8 and
//   decode_fused_v4       decode_v4.py:377 decode_fused_v4 (bf16): the
//                         stacked caches; the launch writes the current token
//                         (int8: quantised) at slot_mapping[b], reads the
//                         pages before it and folds it in from shared memory
//                         (int8: its dequantised row), as the TPU kernel does
//                         (FUSED). The slot is the token's position, cached -
//                         1 of the sequence's own pages, which no block of
//                         the launch reads: the last split of the row (the
//                         one whose pages lead up to it), first group of
//                         heads, writes it.
//
// Rounding, as the TPU kernels take it (decode_v3.py:181-202): int8 rows are
// dequantised as f32(row * scale) before each dot, the score is an f32 dot
// times sm_scale, p = exp(s - m) stays f32 and meets V unrounded, l sums it,
// a deferred token folds in last as one more step of one column, out = acc /
// max(l, 1e-37). Here the score is (q . k) on bf16 mma.sync with exact
// products, times the k scale, times sm_scale; p * v_scale is rounded once
// in f32 and meets V as three bf16 parts that sum to it exactly (P_F32 in
// decode_tm_core.cuh). The sums differ from the TPU's only in their order.
//
// Bound on an H100: the bytes of the cached rows, cached * Hkv * 2 * 128 *
// elt (+ 8 bytes of scales for int8) per sequence and layer, over 3.35 TB/s.
// Design: K14's (decode_v6.cu): a block a (sequence, kv head, group of at
// most 8 query heads; G 16 as two), one page per online-softmax step (steps
// of STEP_MAX tokens within a longer page), the step's scores kept in shared
// memory between its K rounds and its V rounds, a 3-stage cp.async ring of
// 16 KB rounds (128 int8 rows or 64 bf16 ones), both products on mma.sync;
// where B * Hkv leaves the card idle, a row's steps split over up to 8
// blocks merged in split order through integer arrival counters (no split
// scans the keys before it: p is not rounded, so its own running maximum
// serves).

#include "decode_tm_core.cuh"

namespace {

constexpr int STEP_MAX = 4096;   // tokens of a softmax step: the page, or STEP_MAX of a longer one

template <class Layout, typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 3) decode_v3_kernel(const Args a) {
  decode_body<Layout, true, T, false, P_F32, MODE>(a);
}

// a block's softmax step: a page, at most STEP_MAX tokens (so that its G <=
// 8 heads' kept scores fit in shared memory beside the ring at any page size)
int step_of(int ps) { return std::min(ps, STEP_MAX); }

template <class Layout, typename T, int MODE>
int splits(int B, int hkv, int G, int ng, int MP, int ps) {
  if (G <= 0 || G > MAXG || ng <= 0 || MP <= 0 || ps <= 0) return -(int)cudaErrorInvalidValue;
  const int step = step_of(ps);
  return splits_for(decode_v3_kernel<Layout, T, MODE>, smem_bytes<T>(true, G, step, 3), B,
                    hkv * ng, ((long long)MP * ps + step - 1) / step);
}

template <class Layout, typename T, int MODE>
int run(const void* q, const void* kn, const void* vn, const void* kc, const void* vc,
        const void* ksc, const void* vsc, const void* lens, const void* bt, void* out, void* ws,
        void* arrivals, const void* layer, const void* slots, int B, int hq, int hkv, int L,
        int P, int ps, int MP, int li, int ng, int S, float sm_scale, void* stream) {
  if (hkv <= 0 || ng <= 0 || hq <= 0 || hq % (hkv * ng) || ps <= 0 || P <= 0 || L <= 0 ||
      (layer == nullptr && (li < 0 || li >= L)) ||
      (MODE != IN_CACHE && (kn == nullptr || vn == nullptr)) ||
      (MODE == FUSED && slots == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch<true, T, P_F32>(decode_v3_kernel<Layout, T, MODE>, q, kn, vn, kc, vc, ksc, vsc,
                                lens, bt, out, ws, arrivals, B, hkv, hq / (hkv * ng), P, ps, MP,
                                li, 1, S, sm_scale, stream, ng, nullptr, layer, L, slots,
                                step_of(ps));
}

}  // namespace

// Every contract: q [B, hq, 128] bf16; k_new / v_new [B, hkv, 128] bf16
// (DEFER, FUSED; else null); the caches and their f32 scales (int8; else
// null) in the contract's layout; lens [B] (seq_lens, or the cached lengths
// of a deferred contract); block table [B, MP] int32; out [B, hq, 128] bf16;
// ws and arrivals as the contract's splits function says; a stacked cache's
// layer (a device int32, or null for li; L 1 and li 0 unstacked) and the
// fused contracts' slot_mapping [B] (else null); hq / hkv query heads a kv
// head as ng blocks of at most 8; S splits a row.
#define V3_PARAMS                                                                           \
  const void *q, const void *kn, const void *vn, const void *kc, const void *vc,            \
      const void *ksc, const void *vsc, const void *lens, const void *bt, void *out,        \
      void *ws, void *arrivals, const void *layer, const void *slots, int B, int hq,        \
      int hkv, int L, int P, int ps, int MP, int li, int ng, int S, float sm_scale,         \
      void *stream
#define V3_ARGS                                                                             \
  q, kn, vn, kc, vc, ksc, vsc, lens, bt, out, ws, arrivals, layer, slots, B, hq, hkv, L, P, \
      ps, MP, li, ng, S, sm_scale, stream

// The splits S of each (sequence, kv head, group of G heads) that a
// contract takes on the current device: co-resident blocks over the B * hkv
// * ng rows, at most the block table's steps and 8; or minus a CUDA error.
// The workspace holds B * hkv * ng * S * (2 * 8 + 8 * 128) floats (none for
// S = 1), the arrival counters B * hkv * ng ints, zero before the first
// call.
#define V3_SPLITS int B, int hkv, int G, int ng, int MP, int ps
#define V3_SPLIT_ARGS B, hkv, G, ng, MP, ps

// K16
extern "C" int skt_decode_v3(V3_PARAMS) {
  return run<HeadMajor, __nv_bfloat16, IN_CACHE>(V3_ARGS);
}
extern "C" int skt_decode_v3_int8(V3_PARAMS) {
  return run<HeadMajor, int8_t, IN_CACHE>(V3_ARGS);
}
extern "C" int skt_decode_v3_defer(V3_PARAMS) {
  return run<HeadMajor, __nv_bfloat16, DEFER>(V3_ARGS);
}
extern "C" int skt_decode_v3_int8_defer(V3_PARAMS) {
  return run<HeadMajor, int8_t, DEFER>(V3_ARGS);
}
extern "C" int skt_decode_int8kv(V3_PARAMS) {
  return run<KvHeadMajor, int8_t, IN_CACHE>(V3_ARGS);
}
// K23
extern "C" int skt_decode_v5_defer(V3_PARAMS) {
  return run<HeadMajor, __nv_bfloat16, DEFER>(V3_ARGS);
}
extern "C" int skt_decode_v5_int8_defer(V3_PARAMS) {
  return run<HeadMajor, int8_t, DEFER>(V3_ARGS);
}
extern "C" int skt_decode_v4b_int8(V3_PARAMS) {
  return run<HeadMajor, int8_t, IN_CACHE>(V3_ARGS);
}
extern "C" int skt_decode_fused_v4_int8(V3_PARAMS) {
  return run<HeadMajor, int8_t, FUSED>(V3_ARGS);
}
extern "C" int skt_decode_fused_v4(V3_PARAMS) {
  return run<HeadMajor, __nv_bfloat16, FUSED>(V3_ARGS);
}

extern "C" int skt_decode_v3_splits(V3_SPLITS) {
  return splits<HeadMajor, __nv_bfloat16, IN_CACHE>(V3_SPLIT_ARGS);
}
extern "C" int skt_decode_v3_int8_splits(V3_SPLITS) {
  return splits<HeadMajor, int8_t, IN_CACHE>(V3_SPLIT_ARGS);
}
extern "C" int skt_decode_v3_defer_splits(V3_SPLITS) {
  return splits<HeadMajor, __nv_bfloat16, DEFER>(V3_SPLIT_ARGS);
}
extern "C" int skt_decode_v3_int8_defer_splits(V3_SPLITS) {
  return splits<HeadMajor, int8_t, DEFER>(V3_SPLIT_ARGS);
}
extern "C" int skt_decode_int8kv_splits(V3_SPLITS) {
  return splits<KvHeadMajor, int8_t, IN_CACHE>(V3_SPLIT_ARGS);
}
extern "C" int skt_decode_v5_defer_splits(V3_SPLITS) {
  return splits<HeadMajor, __nv_bfloat16, DEFER>(V3_SPLIT_ARGS);
}
extern "C" int skt_decode_v5_int8_defer_splits(V3_SPLITS) {
  return splits<HeadMajor, int8_t, DEFER>(V3_SPLIT_ARGS);
}
extern "C" int skt_decode_v4b_int8_splits(V3_SPLITS) {
  return splits<HeadMajor, int8_t, IN_CACHE>(V3_SPLIT_ARGS);
}
extern "C" int skt_decode_fused_v4_int8_splits(V3_SPLITS) {
  return splits<HeadMajor, int8_t, FUSED>(V3_SPLIT_ARGS);
}
extern "C" int skt_decode_fused_v4_splits(V3_SPLITS) {
  return splits<HeadMajor, __nv_bfloat16, FUSED>(V3_SPLIT_ARGS);
}

extern "C" const char* skt_decode_v3_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
