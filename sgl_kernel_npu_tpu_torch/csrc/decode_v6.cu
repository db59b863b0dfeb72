// Kernel K14: deferred paged GQA decode over page-major ("hm") pages, bf16
// or int8, with bf16 products and p rounded to bf16 before P.V.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_v6.py::
// decode_gqa_pallas_v6_defer (_kernel_v6, decode_v6.py:232-306; bf16 pages,
// the default attention of `bench.py --bf16-kv` and of the engine on a bf16
// cache) and decode_gqa_pallas_v6_int8_defer (_kernel_v6_int8,
// decode_v6.py:81-165), and their finalisation decode_v6.py::_finalize_rows.
//
// Cache: k/v [P, Hkv, ps, 128] bf16, or int8 with per-token f32 scales [P,
// Hkv, 1, ps]; the cache holds cached[b] tokens (clamped at 0), the current
// token's k / v [B, Hkv, 128] bf16 fold in last. One page per online-softmax
// step: p = exp(s - m) against the running maximum at the end of the page,
// rounded to bf16 (int8: p times the row's V scale) before it meets V; the
// K scale multiplies the score.
//
// Bound on an H100: the bytes of the cached rows, cached * Hkv * 4 * 128
// (bf16) or * (2 * 128 + 8) (int8) per sequence and layer, over 3.35 TB/s.
// The page-major pages are the head-major pages of csrc/decode_tm_core.cuh
// at L = 1, and the rounding is K3's, so both contracts run K3's loop: a
// block a (sequence, kv head), a page's scores kept in shared memory between
// its K rounds and its V rounds (each row leaves device memory once), a
// 3-stage cp.async ring of 16 KB rounds (128 int8 rows or 64 bf16 ones), S^T
// and O^T on bf16 mma.sync with exact products, int8 widened by byte
// permutes. Where the rows leave the card idle (the engine's batch of 8),
// a row's pages are split over up to 8 blocks, merged in split order (each
// split first scans the earlier pages' keys for the running maximum). More
// than 8 query heads a kv head (G 16) run as two blocks of 8 heads over the
// same rows. A page too long for its kept scores in shared memory (some 43K
// tokens) keeps them in device memory that the wrapper allocates.

#include "decode_tm_core.cuh"

namespace {

// KG: the kept scores in device memory
template <bool KG>
__global__ void __launch_bounds__(THREADS, 3) decode_v6_kernel(const Args a) {
  decode_body<HeadMajor, true, __nv_bfloat16, KG>(a);
}

template <bool KG>
__global__ void __launch_bounds__(THREADS, 3) decode_v6_int8_kernel(const Args a) {
  decode_body<HeadMajor, true, int8_t, KG>(a);
}

constexpr size_t SMEM_LIMIT = 232448;   // a block's shared memory on Hopper (227 KB)

// the kept scores of a block of G heads over pages of ps tokens fit in its
// shared memory (else they go to device memory)
template <typename T>
bool kept_in_smem(int G, int ps) {
  return smem_bytes<T>(true, G, ps) <= SMEM_LIMIT;
}

// floats of device memory that a block's kept scores take: 0 where they fit
// in its shared memory
template <typename T>
int kept_floats(int G, int ps) {
  if (G <= 0 || G > MAXG || ps <= 0) return -(int)cudaErrorInvalidValue;
  return kept_in_smem<T>(G, ps) ? 0 : G * (ps + SPAD);
}

// the kernel of element type T for G heads over pages of ps tokens
template <typename T>
auto kernel_for(int G, int ps) {
  const bool kg = !kept_in_smem<T>(G, ps);
  if constexpr (sizeof(T) == 1)
    return kg ? decode_v6_int8_kernel<true> : decode_v6_int8_kernel<false>;
  else
    return kg ? decode_v6_kernel<true> : decode_v6_kernel<false>;
}

// launch: G heads a block, ng blocks a kv head, S splits a row, the kept
// scores in `kept` where they do not fit in shared memory
template <typename T>
int run(const void* q, const void* kn, const void* vn, const void* kc, const void* vc,
        const void* ksc, const void* vsc, const void* cached, const void* bt,
        void* out, void* ws, void* arrivals, void* kept, int B, int hq, int hkv, int P, int ps,
        int MP, int ng, int S, float sm_scale, void* stream) {
  if (hkv <= 0 || ng <= 0 || hq <= 0 || hq % (hkv * ng) || ps <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = hq / (hkv * ng);
  if (!kept_in_smem<T>(G, ps) && kept == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch<true, T>(kernel_for<T>(G, ps), q, kn, vn, kc, vc, ksc, vsc, cached, bt, out,
                         ws, arrivals, B, hkv, G, P, ps, MP, 0, 1, S, sm_scale, stream, ng,
                         kept_in_smem<T>(G, ps) ? nullptr : kept);
}

template <typename T>
int splits(int B, int hkv, int G, int ng, int MP, int ps) {
  if (G <= 0 || G > MAXG || ng <= 0 || MP <= 0 || ps <= 0) return -(int)cudaErrorInvalidValue;
  return splits_for(kernel_for<T>(G, ps), smem_bytes<T>(kept_in_smem<T>(G, ps), G, ps), B,
                    hkv * ng, MP);
}

}  // namespace

// The splits S of each (sequence, kv head, group of G heads) that the
// launcher below takes on the current device: co-resident blocks over the B
// * hkv * ng rows, at most MP (a split holds whole pages) and 8; or minus a
// CUDA error. The workspace holds B * hkv * ng * S * (2 * 8 + 8 * 128)
// floats (none for S = 1), the arrival counters B * hkv * ng ints, zero
// before the first call; `kept` B * hkv * ng * S times the floats that the
// kept function below gives (none where they are 0).
extern "C" int skt_decode_v6_defer_splits(int B, int hkv, int G, int ng, int MP, int ps) {
  return splits<__nv_bfloat16>(B, hkv, G, ng, MP, ps);
}

extern "C" int skt_decode_v6_int8_defer_splits(int B, int hkv, int G, int ng, int MP, int ps) {
  return splits<int8_t>(B, hkv, G, ng, MP, ps);
}

// The floats of device memory that each block's kept scores take (G heads
// over pages of ps tokens), 0 where they fit in its shared memory beside the
// ring (pages up to some 43K tokens at G 1); or minus a CUDA error.
extern "C" int skt_decode_v6_defer_kept(int G, int ps) {
  return kept_floats<__nv_bfloat16>(G, ps);
}

extern "C" int skt_decode_v6_int8_defer_kept(int G, int ps) {
  return kept_floats<int8_t>(G, ps);
}

// q [B, hq, 128] bf16, k_new / v_new [B, hkv, 128] bf16, caches [P, hkv, ps,
// 128] (bf16; int8 with scales f32 [P, hkv, 1, ps]), cached [B], block
// table [B, MP] int32, out [B, hq, 128] bf16; hq / hkv query heads a kv head
// as ng blocks of at most 8; S, ws, arrivals and kept as the splits function
// says.
extern "C" int skt_decode_v6_defer(const void* q, const void* kn, const void* vn,
                                   const void* kc, const void* vc, const void* cached,
                                   const void* bt, void* out, void* ws, void* arrivals,
                                   void* kept, int B, int hq, int hkv, int P, int ps, int MP,
                                   int ng, int S, float sm_scale, void* stream) {
  return run<__nv_bfloat16>(q, kn, vn, kc, vc, nullptr, nullptr, cached, bt,
                            out, ws, arrivals, kept, B, hq, hkv, P, ps, MP, ng, S, sm_scale,
                            stream);
}

extern "C" int skt_decode_v6_int8_defer(const void* q, const void* kn, const void* vn,
                                        const void* kc, const void* vc, const void* ksc,
                                        const void* vsc, const void* cached, const void* bt,
                                        void* out, void* ws, void* arrivals, void* kept, int B,
                                        int hq, int hkv, int P, int ps, int MP, int ng, int S,
                                        float sm_scale, void* stream) {
  return run<int8_t>(q, kn, vn, kc, vc, ksc, vsc, cached, bt, out, ws,
                     arrivals, kept, B, hq, hkv, P, ps, MP, ng, S, sm_scale, stream);
}

extern "C" const char* skt_decode_v6_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
