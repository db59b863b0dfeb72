// Kernels K10, K16 and K23: paged GQA decode over bf16 or int8 pages,
// one loop for every contract (decode_hm.cuh), each contract its own C entry
// point and launch counter.
//
// K10 replaces sgl_kernel_npu_tpu/ops/attention/decode_v2.py::
// decode_gqa_pallas_v2 (_kernel, decode_v2.py:34-94), the kernel that
// decode.py::decode_gqa runs for head dims that are multiples of 128 (the
// Qwen3-Next attention layers), and decode.py::decode_gqa_pallas
// (_gqa_decode_kernel, decode.py:101-189), the same function one page per
// grid step: head-major bf16 pages [Hkv, P, ps, 128], the current token
// already in the cache. Entry point skt_decode_hm.
//
// K16 is K10's rounding (ROUND_P false) on the page-major ("hm") pages of
// the Llama path, [P, Hkv, ps, 128]:
//   decode_v3             decode_v3.py:94  decode_gqa_pallas_v3: bf16, the
//                         current token already in the cache;
//   decode_v3_int8        decode_v3.py:217 decode_gqa_pallas_v3_int8: int8
//                         rows with per-token f32 scales [P, Hkv, 1, ps];
//   decode_v3_defer       decode_v3.py:492 decode_gqa_pallas_v3_defer: bf16,
//                         the cache holds `cached` tokens, the current token's
//                         k / v [B, Hkv, 128] bf16 fold in last;
//   decode_v3_int8_defer  decode_v3.py:368 decode_gqa_pallas_v3_int8_defer;
//   decode_int8kv         decode.py:366 decode_gqa_int8kv_pallas: int8
//                         head-major pages [Hkv, P, ps, 128], scales
//                         [Hkv, P, 1, ps], the current token in the cache.
//
// K14, the deferred contract of decode_v6.py with bf16 products, runs K3's
// loop (csrc/decode_v6.cu).
//
// K23 serves the retired decodes of attic/ops_attention/ with K16's rounding
// (their TPU kernels take f32 products and an unrounded p):
//   decode_v5_defer       decode_v5.py:225 decode_gqa_pallas_v5_defer, and
//   decode_v5_int8_defer  decode_v5.py:134 decode_gqa_pallas_v5_int8_defer:
//                         K16's deferred contracts (one page per grid step
//                         on the TPU, the same arithmetic);
//   decode_v4b_int8       decode_v4.py:536 decode_v4b_int8: K16's int8
//                         contract with the current token in the cache, over
//                         stacked caches [L, P, Hkv, ps, 128] at a layer;
//   decode_fused_v4_int8  decode_v4.py:188 decode_fused_v4_int8 and
//   decode_fused_v4       decode_v4.py:377 decode_fused_v4 (bf16): the
//                         stacked caches, and the block first writes the
//                         current token (int8: quantised) at its slot, then
//                         attends with that position masked out of the pages
//                         and the token folded in from registers (int8: its
//                         dequantised row), as the TPU kernel does. Block
//                         tables give every sequence its own pages, and a
//                         block writes only its own head's row, so no block
//                         reads a row being written.
//
// Bound on an H100: the bytes of the cached rows, seq_len * 2 * 128 * elt
// (+ 8 bytes of scales for int8) per (sequence, kv head), over 3.35 TB/s
// (about 0.01 ms at the Qwen bench shape: 128 sequences of about 270 tokens,
// 2 kv heads; about 0.05 ms at the Llama bench shape, 8 kv heads).

#include "decode_hm.cuh"

using namespace skt_hm;

// The unstacked contracts: q, k cache, v cache, k scales, v scales (int8;
// else null), k_new, v_new (deferred; else null), seq_lens, block table, out,
// B, Hq, Hkv, D, P, ps, MP, sm_scale, stream.
#define SKT_HM(name, T, MODE, ROUND_P, LAYOUT)                                                 \
  extern "C" int name(const void* q, const void* kc, const void* vc, const void* ks,          \
                      const void* vs, const void* knew, const void* vnew, const void* sl,     \
                      const void* bt, void* out, int B, int Hq, int Hkv, int d, int P, int ps, \
                      int MP, float sm_scale, void* stream) {                                  \
    return run<T, MODE, ROUND_P>(operands(LAYOUT, q, kc, vc, ks, vs, knew, vnew, sl, bt, out,  \
                                          Hkv, P, ps, MP, sm_scale),                           \
                                 B, Hq, d, stream);                                            \
  }

SKT_HM(skt_decode_hm, __nv_bfloat16, IN_CACHE, false, HEAD_MAJOR)           // K10
SKT_HM(skt_decode_v3, __nv_bfloat16, IN_CACHE, false, PAGE_MAJOR)           // K16
SKT_HM(skt_decode_v3_int8, int8_t, IN_CACHE, false, PAGE_MAJOR)
SKT_HM(skt_decode_v3_defer, __nv_bfloat16, DEFER, false, PAGE_MAJOR)
SKT_HM(skt_decode_v3_int8_defer, int8_t, DEFER, false, PAGE_MAJOR)
SKT_HM(skt_decode_int8kv, int8_t, IN_CACHE, false, HEAD_MAJOR)
SKT_HM(skt_decode_v5_defer, __nv_bfloat16, DEFER, false, PAGE_MAJOR)        // K23
SKT_HM(skt_decode_v5_int8_defer, int8_t, DEFER, false, PAGE_MAJOR)

// The stacked contracts (K23): as above over [L, P, Hkv, ps, D] caches and
// [L, P, Hkv, 1, ps] scales, plus the layer (a device int32, or null for
// `li`) and, for the fused write, slot_mapping [B] (else null).
#define SKT_HM_STACKED(name, T, MODE)                                                           \
  extern "C" int name(const void* q, const void* kc, const void* vc, const void* ks,           \
                      const void* vs, const void* knew, const void* vnew, const void* sl,      \
                      const void* bt, void* out, const void* layer, const void* slots, int B,  \
                      int Hq, int Hkv, int d, int L, int P, int ps, int MP, int li,            \
                      float sm_scale, void* stream) {                                           \
    if (L <= 0 || (layer == nullptr && (li < 0 || li >= L))) return (int)cudaErrorInvalidValue; \
    Operands a = operands(PAGE_MAJOR, q, kc, vc, ks, vs, knew, vnew, sl, bt, out, Hkv, P, ps,  \
                          MP, sm_scale);                                                        \
    a.layer = static_cast<const int*>(layer);                                                  \
    a.li = li;                                                                                  \
    a.layers = L;                                                                               \
    a.slots = static_cast<const int*>(slots);                                                  \
    a.layer_stride = (long long)P * Hkv * ps * D;                                               \
    a.slayer_stride = (long long)P * Hkv * ps;                                                  \
    return run<T, MODE, false>(a, B, Hq, d, stream);                                           \
  }

SKT_HM_STACKED(skt_decode_v4b_int8, int8_t, IN_CACHE)
SKT_HM_STACKED(skt_decode_fused_v4_int8, int8_t, FUSED)
SKT_HM_STACKED(skt_decode_fused_v4, __nv_bfloat16, FUSED)

extern "C" const char* skt_decode_hm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
