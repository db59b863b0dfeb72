// Kernel K10: paged GQA decode over head-major bf16 pages (decode_hm.cuh).
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_v2.py::
// decode_gqa_pallas_v2 (_kernel, decode_v2.py:34-94), the kernel that
// decode.py::decode_gqa runs for head dims that are multiples of 128 (the
// Qwen3-Next attention layers), and decode.py::decode_gqa_pallas
// (_gqa_decode_kernel, decode.py:101-189), the same function one page per
// grid step: head-major bf16 pages [Hkv, P, ps, 128], the current token
// already in the cache. Entry point skt_decode_hm.
//
// The page-major contracts that shared this loop (K16's v3 and
// decode_int8kv, K23's attic decodes) run C's tensor-core loop in
// decode_v3.cu.
//
// Bound on an H100: the bytes of the cached rows, seq_len * 2 * 128 * 2 per
// (sequence, kv head), over 3.35 TB/s (about 0.01 ms at the Qwen bench
// shape: 128 sequences of about 270 tokens, 2 kv heads).

#include "decode_hm.cuh"

using namespace skt_hm;

// q [B, Hq, 128] bf16, k cache, v cache [Hkv, P, ps, 128] bf16, seq_lens [B],
// block table [B, MP] int32, out [B, Hq, 128] bf16; the scale and new-token
// pointers are unused (null); B, Hq, Hkv, D, P, ps, MP, sm_scale, stream.
extern "C" int skt_decode_hm(const void* q, const void* kc, const void* vc, const void* ks,
                             const void* vs, const void* knew, const void* vnew, const void* sl,
                             const void* bt, void* out, int B, int Hq, int Hkv, int d, int P,
                             int ps, int MP, float sm_scale, void* stream) {
  return run<__nv_bfloat16, IN_CACHE, false>(operands(HEAD_MAJOR, q, kc, vc, ks, vs, knew, vnew,
                                                      sl, bt, out, Hkv, P, ps, MP, sm_scale),
                                             B, Hq, d, stream);
}

extern "C" const char* skt_decode_hm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
