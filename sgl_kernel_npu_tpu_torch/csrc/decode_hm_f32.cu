// Kernel K10 on f32 pages: paged GQA decode over kv-head-major f32 pages,
// a CUDA-core loop.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/decode_v2.py::
// decode_gqa_pallas_v2 (and decode.py::decode_gqa_pallas, the same function
// one page per grid step) where its caches are f32: models/moe.py calls
// decode.py::decode_gqa with f32 q and f32 head-major caches [Hkv, P, ps,
// 128] at head dim 128, and the TPU kernel loads pages in the cache's dtype
// and does all its math in f32. The bf16 form is decode_hm.cu. Entry point
// skt_decode_hm_f32.
//
// Contract, the plain version's (ops/attention/decode.py::
// decode_gqa_hm_ref): q [B, Hq, 128] f32, G = Hq / Hkv in 1, 2, 4, 8, 16;
// seq_lens [B] include the current token, which is already in the cache;
// pages past seq_len are skipped (their block-table entries are not read);
// one page per online-softmax step (steps of STEP_MAX tokens within a longer
// page), s = (q . k) * sm_scale, p = exp(s - m), l the sum of p, out = acc /
// max(l, 1e-37), all f32; out [B, Hq, 128] f32. Only the order of the f32
// sums differs from the plain version.
//
// Bound on an H100: the bytes of the live rows, seq_len * 2 * 128 * 4 per
// (sequence, kv head), over 3.35 TB/s; at G <= 16 the arithmetic is below
// one flop a byte, far below what the tensor cores are for.
// Design: a block of four warps a (sequence, kv head), all G query heads
// (q and the warp's partial output, G float4s each, in registers: a lane
// holds 4 of the 128 columns). The live rows stream through a ring of NST
// tiles of TT rows (16-byte cp.async copies, a row 512 contiguous bytes), a
// step's K tiles, then its V tiles. For a K tile each warp takes every
// fourth row, dots it with the G heads and sums over the warp by shuffles;
// the step's scores stay in shared memory. At the step's end one warp a head
// takes the step maximum, p and l; for a V tile each warp adds p * v of its
// rows to its partial (scaled by the step's alpha first), and the four
// partials are summed in warp order at the end. Where the card holds more
// blocks than rows, a row's steps split over blocks, merged in split order
// through a workspace and an integer arrival counter (the last block to
// arrive merges and resets it): no float atomics, so a second call is
// bit-identical.

#include <math_constants.h>

#include <algorithm>

#include "device_once.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 128;           // head dim
constexpr int THREADS = 128;     // four warps
constexpr int NW = THREADS / 32;
constexpr int TT = 16;           // rows a ring tile
constexpr int NST = 4;           // ring stages
constexpr int STEP_MAX = 512;    // tokens of a softmax step within a longer page
constexpr int MAX_SPLITS = 8;
constexpr float NEG = -1e30f;    // the plain version's minus infinity
constexpr int PART = 4 + D;      // a split's partial of one head: m, l, 2 pad, acc

struct Args {
  const float* q;
  const float* kc;               // [hkv, P, ps, 128]
  const float* vc;
  const int* lens;               // [B]
  const int* bt;                 // [B, MP]
  float* out;                    // [B, hq, 128]
  float* ws;                     // [B * hkv * S * G * PART] where S > 1
  int* arrivals;                 // [B * hkv]
  int hkv, P, ps, MP, S, step;
  float sm_scale;
};

int step_of(int ps) { return std::min(ps, STEP_MAX); }

size_t smem_of(int G, int step) {
  return sizeof(float) * ((size_t)NST * TT * D + (size_t)G * step + 3 * G);
}

template <int G>
__global__ void __launch_bounds__(THREADS) decode_hm_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                        // NST x TT x D
  float* sc = ring + NST * TT * D;           // G x step: scores, then p
  float* m_s = sc + G * a.step;              // G running maxima
  float* l_s = m_s + G;                      // G sums
  float* alpha_s = l_s + G;                  // G rescales of the step
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x, split = blockIdx.y;
  const int b = row / a.hkv, h = row % a.hkv;
  const int hq = a.hkv * G;
  const int len = min(max(a.lens[b], 0), a.MP * a.ps);
  const int step = a.step;
  const int nsteps = (len + step - 1) / step;
  const int s0 = (int)((long long)nsteps * split / a.S);
  const int s1 = (int)((long long)nsteps * (split + 1) / a.S);

  float4 qv[G], acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qv[g] = reinterpret_cast<const float4*>(a.q + ((size_t)b * hq + h * G + g) * D)[lane];
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  auto live_of = [&](int s) { return min(step, len - s * step); };
  auto tiles_of = [&](int s) { return (live_of(s) + TT - 1) / TT; };
  // an item: (step, K or V, tile); the ring walks the split's items in order
  struct Cur {
    int s, kind, tile;
  };
  auto advance = [&](Cur& c) {
    if (++c.tile == tiles_of(c.s)) {
      c.tile = 0;
      if (++c.kind == 2) {
        c.kind = 0;
        ++c.s;
      }
    }
  };
  int total = 0;
  for (int s = s0; s < s1; ++s) total += 2 * tiles_of(s);

  Cur ld{s0, 0, 0};
  auto load_item = [&](int i) {
    if (i < total) {
      const int t0 = ld.s * step + ld.tile * TT;
      const int rows = min(TT, live_of(ld.s) - ld.tile * TT);
      const float* cache = ld.kind == 0 ? a.kc : a.vc;
      float* dst = ring + (i % NST) * TT * D;
#pragma unroll
      for (int j = 0; j < TT * D / 4 / THREADS; ++j) {
        const int c = tid + j * THREADS;
        const int r = c >> 5, col = (c & 31) * 4;
        if (r < rows) {
          const int tok = t0 + r;
          const int page = min(max(a.bt[(size_t)b * a.MP + tok / a.ps], 0), a.P - 1);
          const float* src = cache + (((size_t)h * a.P + page) * a.ps + tok % a.ps) * D + col;
          cp_async16(dst + r * D + col, src, true);
        }
      }
      advance(ld);
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) load_item(i);

  Cur cc{s0, 0, 0};
  for (int i = 0; i < total; ++i) {
    cp_wait<NST - 2>();
    __syncthreads();
    load_item(i + NST - 1);
    const float* tile = ring + (i % NST) * TT * D;
    const int live = live_of(cc.s);
    const int t0 = cc.tile * TT;
    const int rows = min(TT, live - t0);
    if (cc.kind == 0) {
      for (int r = warp; r < rows; r += NW) {
        const float4 kv = reinterpret_cast<const float4*>(tile + r * D)[lane];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = qv[g].x * kv.x;
          d = fmaf(qv[g].y, kv.y, d);
          d = fmaf(qv[g].z, kv.z, d);
          d = fmaf(qv[g].w, kv.w, d);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          if (lane == 0) sc[g * step + t0 + r] = d * a.sm_scale;
        }
      }
      if (cc.tile == tiles_of(cc.s) - 1) {       // the step's scores are complete
        __syncthreads();
        for (int g = warp; g < G; g += NW) {
          float* sg = sc + g * step;
          float mx = NEG;
          for (int t = lane; t < live; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m_s[g], mx);
          float sum = 0.f;
          for (int t = lane; t < live; t += 32) {
            const float p = expf(sg[t] - m_new);
            sg[t] = p;
            sum += p;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (lane == 0) {
            const float alpha = expf(m_s[g] - m_new);
            alpha_s[g] = alpha;
            l_s[g] = l_s[g] * alpha + sum;
            m_s[g] = m_new;
          }
        }
        __syncthreads();
      }
    } else {
      if (cc.tile == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float al = alpha_s[g];
          acc[g].x *= al;
          acc[g].y *= al;
          acc[g].z *= al;
          acc[g].w *= al;
        }
      }
      for (int r = warp; r < rows; r += NW) {
        const float4 vv = reinterpret_cast<const float4*>(tile + r * D)[lane];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sc[g * step + t0 + r];
          acc[g].x = fmaf(p, vv.x, acc[g].x);
          acc[g].y = fmaf(p, vv.y, acc[g].y);
          acc[g].z = fmaf(p, vv.z, acc[g].z);
          acc[g].w = fmaf(p, vv.w, acc[g].w);
        }
      }
    }
    advance(cc);
  }
  cp_wait<0>();
  __syncthreads();

  // the four warps' partials, summed in warp order (the ring is free now)
  float4* part = reinterpret_cast<float4*>(ring);          // [NW][G][32]
#pragma unroll
  for (int g = 0; g < G; ++g) part[(warp * G + g) * 32 + lane] = acc[g];
  __syncthreads();
  const size_t rs = (size_t)row * a.S;
  for (int u = tid; u < G * 32; u += THREADS) {
    const int g = u >> 5;
    float4 o = part[u];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      const float4 x = part[w * G * 32 + u];
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
    }
    if (a.S == 1) {
      const float inv = 1.f / fmaxf(l_s[g], 1e-37f);
      float4* dst = reinterpret_cast<float4*>(a.out + ((size_t)b * hq + h * G + g) * D);
      dst[u & 31] = make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
    } else {
      float* p = a.ws + ((rs + split) * G + g) * PART;
      reinterpret_cast<float4*>(p + 4)[u & 31] = o;
      if ((u & 31) == 0) {
        p[0] = m_s[g];
        p[1] = l_s[g];
      }
    }
  }
  if (a.S == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.arrivals + row, 1) == a.S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int u = tid; u < G * 32; u += THREADS) {
    const int g = u >> 5;
    float mx = NEG;
    for (int s = 0; s < a.S; ++s) mx = fmaxf(mx, __ldcg(a.ws + ((rs + s) * G + g) * PART));
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < a.S; ++s) {
      const float* p = a.ws + ((rs + s) * G + g) * PART;
      const float f = expf(__ldcg(p) - mx);
      l = fmaf(__ldcg(p + 1), f, l);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p + 4) + (u & 31));
      o.x = fmaf(x.x, f, o.x);
      o.y = fmaf(x.y, f, o.y);
      o.z = fmaf(x.z, f, o.z);
      o.w = fmaf(x.w, f, o.w);
    }
    const float inv = 1.f / fmaxf(l, 1e-37f);
    float4* dst = reinterpret_cast<float4*>(a.out + ((size_t)b * hq + h * G + g) * D);
    dst[u & 31] = make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  }
  if (tid == 0) a.arrivals[row] = 0;     // ready for the next call
}

template <int G>
int splits_of(int B, int hkv, int MP, int ps) {
  const int step = step_of(ps);
  const size_t smem = smem_of(G, step);
  cudaError_t e = skt::ensure_smem(decode_hm_f32_kernel<G>, smem);
  if (e != cudaSuccess) return -(int)e;
  int resident = 0;
  if ((e = skt::resident_blocks(decode_hm_f32_kernel<G>, THREADS, smem, resident)) !=
      cudaSuccess)
    return -(int)e;
  const long long steps = ((long long)MP * ps + step - 1) / step;
  return (int)std::max(1LL, std::min({(long long)resident / ((long long)B * hkv), steps,
                                      (long long)MAX_SPLITS}));
}

template <int G>
int launch(const Args& a, int B, void* stream) {
  const size_t smem = smem_of(G, a.step);
  cudaError_t e = skt::ensure_smem(decode_hm_f32_kernel<G>, smem);
  if (e != cudaSuccess) return (int)e;
  decode_hm_f32_kernel<G><<<dim3(B * a.hkv, a.S), THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

bool ps_ok(int ps) { return ps > 0 && (ps <= STEP_MAX || ps % STEP_MAX == 0); }

}  // namespace

// The splits S of each (sequence, kv head) on the current device: the
// co-resident blocks over the B * hkv rows, at most the block table's steps
// and 8; or minus a CUDA error. The workspace holds B * hkv * S * G * (4 +
// 128) floats (none for S = 1), the arrival counters B * hkv ints, zero
// before the first call.
extern "C" int skt_decode_hm_f32_splits(int B, int hkv, int G, int MP, int ps) {
  if (B <= 0 || hkv <= 0 || MP <= 0 || !ps_ok(ps)) return -(int)cudaErrorInvalidValue;
  switch (G) {
    case 1: return splits_of<1>(B, hkv, MP, ps);
    case 2: return splits_of<2>(B, hkv, MP, ps);
    case 4: return splits_of<4>(B, hkv, MP, ps);
    case 8: return splits_of<8>(B, hkv, MP, ps);
    case 16: return splits_of<16>(B, hkv, MP, ps);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// q [B, hq, 128] f32; k / v caches [hkv, P, ps, 128] f32; seq_lens [B] (the
// current token included); block table [B, MP] int32; out [B, hq, 128] f32;
// ws and arrivals as the splits function says; S splits a row.
extern "C" int skt_decode_hm_f32(const void* q, const void* kc, const void* vc,
                                 const void* lens, const void* bt, void* out, void* ws,
                                 void* arrivals, int B, int hq, int hkv, int P, int ps, int MP,
                                 int S, float sm_scale, void* stream) {
  if (hkv <= 0 || hq <= 0 || hq % hkv || P <= 0 || MP <= 0 || !ps_ok(ps) || S < 1 ||
      S > MAX_SPLITS || (S > 1 && (ws == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.q = static_cast<const float*>(q);
  a.kc = static_cast<const float*>(kc);
  a.vc = static_cast<const float*>(vc);
  a.lens = static_cast<const int*>(lens);
  a.bt = static_cast<const int*>(bt);
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.arrivals = static_cast<int*>(arrivals);
  a.hkv = hkv;
  a.P = P;
  a.ps = ps;
  a.MP = MP;
  a.S = S;
  a.step = step_of(ps);
  a.sm_scale = sm_scale;
  switch (hq / hkv) {
    case 1: return launch<1>(a, B, stream);
    case 2: return launch<2>(a, B, stream);
    case 4: return launch<4>(a, B, stream);
    case 8: return launch<8>(a, B, stream);
    case 16: return launch<16>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* skt_decode_hm_f32_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
