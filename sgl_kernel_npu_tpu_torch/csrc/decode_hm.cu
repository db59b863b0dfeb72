// Kernel K10: paged GQA decode over kv-head-major ("head-major" in the JAX
// package) bf16 pages, on C's tensor-core loop (decode_tm_core.cuh).
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_v2.py::
// decode_gqa_pallas_v2 (_kernel, decode_v2.py:34-94), the kernel that
// decode.py::decode_gqa runs for head dims that are multiples of 128 (the
// Qwen3-Next attention layers), and decode.py::decode_gqa_pallas
// (_gqa_decode_kernel, decode.py:101-189), the same function one page per
// grid step: bf16 pages [Hkv, P, ps, 128], the current token already in the
// cache. Entry point skt_decode_hm.
//
// Rounding, as the TPU kernels take it: one page per online-softmax step
// (steps of STEP_MAX tokens within a longer page), the score an f32 dot
// times sm_scale, p = exp(s - m) unrounded, l the sum of it, out = acc /
// max(l, 1e-37). Here K16's decode_int8kv contract with bf16 rows: bf16
// mma.sync with exact products for q . k, p meets V as three bf16 parts that
// sum to it exactly (P_F32); only the order of the f32 sums differs.
//
// Bound on an H100: the bytes of the cached rows, seq_len * 2 * 128 * 2 per
// (sequence, kv head), over 3.35 TB/s (about 0.01 ms at the Qwen bench
// shape: 128 sequences of about 270 tokens, 2 kv heads).
// Design: K16's (decode_v3.cu): a block a (sequence, kv head, group of at
// most 8 query heads; G 16 as two), the step's scores kept in shared memory
// between its K rounds and its V rounds, 64 bf16 rows a round through a ring
// of NST = 3 stages, 3 blocks an SM (the bench shape's 256 blocks run in one
// wave of 396, unsplit); each round reads the block table once (PAGE_ONCE:
// with a lookup for every copy, starting a round's copies took about 9 of
// a block's 23 us; scripts/probe_decode_trace.py). Where the card has room
// for more blocks than rows, a row's steps split over them, merged in split
// order through integer arrival counters; no split scans the keys before
// it: p is not rounded, so its own running maximum serves. (A 2-stage ring
// at 4 blocks an SM, S 2 at the bench shape, was 1.37x slower: each split
// waits on its copies and pays the merge.)
//
// Head dim 256 (Qwen3-Next-80B-A3B's full-attention layers: 16 query heads,
// 2 kv heads, G 8) is a second instantiation of the same loop, skt_decode_hm256
// (decode_body's HD 256: 128 rows of 512 bytes a stage, twice the q
// fragments and sums a thread, two output columns a thread). A stage holds
// 32 KB, so three of them leave room for 2 blocks an SM (not 3) at pages of
// up to about 256 tokens; the q rows are not copied to shared memory (the
// IN_CACHE contract never reads them), without which 2 blocks do not fit.
// Steps of at most 2048 tokens, so that the kept scores fit beside the ring.

#include "decode_tm_core.cuh"

namespace {

constexpr int NST = 3;           // the ring's stages
constexpr int STEP_MAX = 4096;   // tokens of a softmax step: the page, or STEP_MAX of a longer one

constexpr int D2 = 2 * D;        // the second head dim
constexpr int STEP_MAX2 = 2048;  // STEP_MAX at D2

__global__ void __launch_bounds__(THREADS, 3) decode_hm_kernel(const Args a) {
  decode_body<KvHeadMajor, true, __nv_bfloat16, false, P_F32, IN_CACHE, NST, true>(a);
}

__global__ void __launch_bounds__(THREADS, 2) decode_hm256_kernel(const Args a) {
  decode_body<KvHeadMajor, true, __nv_bfloat16, false, P_F32, IN_CACHE, NST, true, D2>(a);
}

// a block's softmax step: a page, at most STEP_MAX tokens (so that its G <=
// 8 heads' kept scores fit in shared memory beside the ring at any page size)
int step_of(int ps, int hd = D) { return std::min(ps, hd == D ? STEP_MAX : STEP_MAX2); }

size_t smem_of(int G, int ps, int hd = D) {
  return hd == D ? smem_bytes<__nv_bfloat16>(true, G, step_of(ps), 3, NST)
                 : smem_bytes<__nv_bfloat16, D2>(true, G, step_of(ps, hd), 3, NST);
}

}  // namespace

// The splits S of each (sequence, kv head, group of G heads) on the current
// device: co-resident blocks over the B * hkv * ng rows, at most the block
// table's steps and 8; or minus a CUDA error. The workspace holds B * hkv *
// ng * S * (2 * 8 + 8 * 128) floats (none for S = 1), the arrival counters
// B * hkv * ng ints, zero before the first call.
extern "C" int skt_decode_hm_splits(int B, int hkv, int G, int ng, int MP, int ps) {
  if (G <= 0 || G > MAXG || ng <= 0 || MP <= 0 || ps <= 0) return -(int)cudaErrorInvalidValue;
  const int step = step_of(ps);
  return splits_for(decode_hm_kernel, smem_of(G, ps), B, hkv * ng,
                    ((long long)MP * ps + step - 1) / step);
}

// decode_v3.cu's contract arguments (launch_v3 calls both): q [B, hq, 128]
// bf16; k / v caches [hkv, P, ps, 128] bf16; seq_lens [B] (the current
// token included); block table [B, MP] int32; out [B, hq, 128] bf16; ws and
// arrivals as the splits function says; hq / hkv query heads a kv head as
// ng blocks of at most 8; S splits a row. The new-token, scale, layer and
// slot pointers are null, L 1 and li 0.
extern "C" int skt_decode_hm(const void* q, const void* kn, const void* vn, const void* kc,
                             const void* vc, const void* ksc, const void* vsc, const void* lens,
                             const void* bt, void* out, void* ws, void* arrivals,
                             const void* layer, const void* slots, int B, int hq, int hkv, int L,
                             int P, int ps, int MP, int li, int ng, int S, float sm_scale,
                             void* stream) {
  if (hkv <= 0 || ng <= 0 || hq <= 0 || hq % (hkv * ng) || ps <= 0 || P <= 0 || L != 1 ||
      li != 0 || kn != nullptr || vn != nullptr || ksc != nullptr || vsc != nullptr ||
      layer != nullptr || slots != nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch<true, __nv_bfloat16, P_F32, NST>(decode_hm_kernel, q, nullptr, nullptr, kc, vc,
                                                 nullptr, nullptr, lens, bt, out, ws, arrivals,
                                                 B, hkv, hq / (hkv * ng), P, ps, MP, 0, 1, S,
                                                 sm_scale, stream, ng, nullptr, nullptr, 1,
                                                 nullptr, step_of(ps));
}

// K10 at head dim 256: the same arguments on q, caches and out of 256 columns
// (the workspace B * hkv * ng * S * (2 * 8 + 8 * 256) floats).
extern "C" int skt_decode_hm256_splits(int B, int hkv, int G, int ng, int MP, int ps) {
  if (G <= 0 || G > MAXG || ng <= 0 || MP <= 0 || ps <= 0) return -(int)cudaErrorInvalidValue;
  const int step = step_of(ps, D2);
  return splits_for(decode_hm256_kernel, smem_of(G, ps, D2), B, hkv * ng,
                    ((long long)MP * ps + step - 1) / step);
}

extern "C" int skt_decode_hm256(const void* q, const void* kn, const void* vn, const void* kc,
                                const void* vc, const void* ksc, const void* vsc,
                                const void* lens, const void* bt, void* out, void* ws,
                                void* arrivals, const void* layer, const void* slots, int B,
                                int hq, int hkv, int L, int P, int ps, int MP, int li, int ng,
                                int S, float sm_scale, void* stream) {
  if (hkv <= 0 || ng <= 0 || hq <= 0 || hq % (hkv * ng) || ps <= 0 || P <= 0 || L != 1 ||
      li != 0 || kn != nullptr || vn != nullptr || ksc != nullptr || vsc != nullptr ||
      layer != nullptr || slots != nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch<true, __nv_bfloat16, P_F32, NST, D2>(
      decode_hm256_kernel, q, nullptr, nullptr, kc, vc, nullptr, nullptr, lens, bt, out, ws,
      arrivals, B, hkv, hq / (hkv * ng), P, ps, MP, 0, 1, S, sm_scale, stream, ng, nullptr,
      nullptr, 1, nullptr, step_of(ps, D2));
}

extern "C" const char* skt_decode_hm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
