// Kernel K15: flash prefill of a chunk off the page-major ("hm") paged cache,
// bf16 or int8 pages, all math in f32.
//
// Replaces sgl_kernel_npu_tpu/ops/attention/paged_prefill.py::
// paged_prefill_attention (_kernel, paged_prefill.py:41-131): a grid of
// (kv head, query tile of block_q tokens), each walking its page list with an
// online softmax, one page per step. The list is the dense causal schedule
// (pages 0 .. ceil((prefix + min((qi+1) * block_q, T)) / ps) - 1, at most
// MP) or a selection: page_sel [NQ, NS] with page_cnt [NQ], or per kv head
// page_sel [Hkv, NQ, NS] with page_cnt [Hkv, NQ] (logical page numbers).
//
// q [S, T, Hq, 128] bf16 (S sequences' chunks, each already written to the
// cache at positions prefix .. prefix + T - 1); caches [P, Hkv, ps, 128] bf16,
// or int8 with per-token f32 scales [P, Hkv, 1, ps]; block tables [S, MP]
// int32 (logical -> physical page); prefix [S] int32; out [S, T, Hq, 128]
// bf16. Tile row r of tile qi is token qi * block_q + r / G, head h*G + r % G.
//
// Rounding, as the TPU kernel takes it: per page, s = (q . k) * sm_scale in
// f32 over all ps columns, an int8 row dequantised element by element as
// f32(k * scale) first; columns with logical position > prefix + token get
// -1e30; m = max(m, rowmax(s)), alpha = exp(m_old - m), p = exp(s - m) for
// every column (a row with nothing visible yet takes p = 1, as the TPU kernel
// does), l = l * alpha + rowsum(p), acc = acc * alpha + p . v with v
// dequantised as k is; out = acc / max(l, 1e-37) in bf16 (0 for an empty
// list).
//
// Bound on an H100: the f32 operations, 4 * 128 per (query row, visible key)
// over 67 TFLOP/s (CUDA cores), or the bytes of the visited pages, whichever
// is larger. Design: a block takes 64 rows of one tile (a tile's rows share
// its page list, so any split of them gives the TPU's numbers), 256 threads;
// per page it stages K transposed and then V in shared memory as f32, and
// each thread computes a 4 x ps/16 tile of scores and a 4 x 8 tile of P.V,
// from q transposed in shared memory and P in shared memory. CUDA cores in
// f32, as the TPU kernel's f32 dots; no tensor cores, no double buffering.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int D = 128;
constexpr int R = 64;                 // tile rows per block
constexpr int PSTR = R + 4;           // row stride of P^T in shared memory
constexpr float NEG = -1e30f;

// 8 consecutive elements of a row as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = (float)e[i];
}

struct Args {
  const __nv_bfloat16* q;
  const void* kc;
  const void* vc;
  const float* ks;
  const float* vs;
  const int* bt;                      // [S, MP]
  const int* prefix;                  // [S]
  const int* sel;                     // null: dense causal
  const int* cnt;
  __nv_bfloat16* out;
  int T, Hq, Hkv, MP, block_q, NQ, NB, NS, sel_per_head;
  float sm_scale;
};

template <int PS, typename T>
__global__ void __launch_bounds__(THREADS) prefill_hm_kernel(const Args a) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int CPT = PS / 16;        // score columns per thread: cg + 16 j
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                   // [D][R]
  float* kv = qT + D * R;             // K^T [D][PS], then V [PS][D]
  float* pT = kv + D * PS;            // [PS][PSTR]: scores, then p
  __shared__ float m_s[R], l_s[R], alpha_s[R];
  const int h = blockIdx.x, qi = blockIdx.y / a.NB, rb = blockIdx.y % a.NB, s = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = a.Hq / a.Hkv;
  const int tile_rows = a.block_q * G;
  const int prefix = a.prefix[s];
  const T* kc = static_cast<const T*>(a.kc);
  const T* vc = static_cast<const T*>(a.vc);

  // this block's q rows, transposed; rows past the tile or the chunk are 0
  for (int e = tid; e < R * (D / 8); e += THREADS) {
    const int r = e % R, d0 = (e / R) * 8;
    const int rr = rb * R + r, tok = qi * a.block_q + rr / G;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (rr < tile_rows && tok < a.T)
      load8(a.q + (((size_t)s * a.T + tok) * a.Hq + h * G + rr % G) * D + d0, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) qT[(d0 + i) * R + r] = x[i];
  }
  if (tid < R) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  int count;
  const int* sel = nullptr;
  if (a.sel == nullptr) {
    const int need = prefix + min((qi + 1) * a.block_q, a.T);
    count = min((need + PS - 1) / PS, a.MP);
  } else {
    const int idx = a.sel_per_head ? h * a.NQ + qi : qi;
    count = a.cnt[idx];
    sel = a.sel + (size_t)idx * a.NS;
  }

  const int rg = tid / 16, cg = tid % 16;             // rows 4 rg .. 4 rg + 3
  float acc[4][8];                                    // columns cg + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < count; ++j) {
    const int lp = sel ? sel[j] : j;
    const size_t page = (size_t)a.bt[(size_t)s * a.MP + lp] * a.Hkv + h;
    const T* kp = kc + page * PS * D;
    const T* vp = vc + page * PS * D;
    const float* ksp = INT8 ? a.ks + page * PS : nullptr;
    const float* vsp = INT8 ? a.vs + page * PS : nullptr;
    __syncthreads();                                  // the last page's P.V is done
    for (int e = tid; e < PS * (D / 8); e += THREADS) {
      const int c = e % PS, d0 = (e / PS) * 8;
      float x[8];
      load8(kp + (size_t)c * D + d0, x);
      const float sc = INT8 ? ksp[c] : 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) kv[(d0 + i) * PS + c] = INT8 ? __fmul_rn(x[i], sc) : x[i];
    }
    __syncthreads();
    {
      float sacc[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) sacc[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 qv = *reinterpret_cast<const float4*>(qT + d * R + rg * 4);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float kvv = kv[d * PS + cg + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) sacc[i][c] = fmaf(qa[i], kvv, sacc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        const int tok = qi * a.block_q + (rb * R + r) / G;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = lp * PS + cg + 16 * c;
          pT[(cg + 16 * c) * PSTR + r] = col <= prefix + tok ? sacc[i][c] * a.sm_scale : NEG;
        }
      }
    }
    __syncthreads();
    // V, dequantised, into the K buffer; the online softmax, 4 threads a row
    for (int e = tid; e < PS * (D / 8); e += THREADS) {
      const int c = e / (D / 8), d0 = (e % (D / 8)) * 8;
      float x[8];
      load8(vp + (size_t)c * D + d0, x);
      const float sc = INT8 ? vsp[c] : 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) kv[c * D + d0 + i] = INT8 ? __fmul_rn(x[i], sc) : x[i];
    }
    {
      const int r = tid / 4, part = tid % 4;
      float mt = NEG;
      for (int c = part; c < PS; c += 4) mt = fmaxf(mt, pT[c * PSTR + r]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);
      float psum = 0.f;
      for (int c = part; c < PS; c += 4) {
        const float p = expf(pT[c * PSTR + r] - m_new);
        pT[c * PSTR + r] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();
    {
      float o[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
#pragma unroll 4
      for (int c = 0; c < PS; ++c) {
        const float4 pv = *reinterpret_cast<const float4*>(pT + c * PSTR + rg * 4);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float vv = kv[c * D + cg + 16 * k];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][k] = fmaf(pa[i], vv, o[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = alpha_s[rg * 4 + i];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = acc[i][k] * al + o[i][k];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i, rr = rb * R + r;
    const int tok = qi * a.block_q + rr / G;
    if (rr >= tile_rows || tok >= a.T) continue;
    const float l = fmaxf(l_s[r], 1e-37f);
    __nv_bfloat16* o = a.out + (((size_t)s * a.T + tok) * a.Hq + h * G + rr % G) * D;
#pragma unroll
    for (int k = 0; k < 8; ++k) o[cg + 16 * k] = __float2bfloat16_rn(acc[i][k] / l);
  }
}

template <int PS, typename T>
cudaError_t launch(const Args& a, int S, cudaStream_t st) {
  auto kern = prefill_hm_kernel<PS, T>;
  const size_t smem = ((size_t)D * R + (size_t)D * PS + (size_t)PS * PSTR) * sizeof(float);
  static bool set = false;
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    set = true;
  }
  kern<<<dim3(a.Hkv, a.NQ * a.NB, S), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int S, int ps, cudaStream_t st) {
  switch (ps) {
    case 16: return (int)launch<16, T>(a, S, st);
    case 32: return (int)launch<32, T>(a, S, st);
    case 64: return (int)launch<64, T>(a, S, st);
    case 128: return (int)launch<128, T>(a, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k cache, v cache, k scales, v scales (null for bf16), block tables,
// prefix, page_sel, page_cnt (null for the dense schedule), out, int8 flag,
// S, T, Hq, Hkv, D, ps, MP, block_q, NS (page_sel's last dim), sel_per_head,
// sm_scale, stream. D must be 128, ps one of 16, 32, 64, 128.
extern "C" int skt_prefill_hm(const void* q, const void* kc, const void* vc, const void* ks,
                              const void* vs, const void* bt, const void* prefix,
                              const void* sel, const void* cnt, void* out, int int8, int S,
                              int T, int Hq, int Hkv, int d, int ps, int MP, int block_q, int NS,
                              int sel_per_head, float sm_scale, void* stream) {
  if (d != D || Hkv <= 0 || Hq % Hkv != 0 || block_q <= 0 || MP <= 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0) return 0;
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kc = kc;
  a.vc = vc;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.bt = static_cast<const int*>(bt);
  a.prefix = static_cast<const int*>(prefix);
  a.sel = static_cast<const int*>(sel);
  a.cnt = static_cast<const int*>(cnt);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.MP = MP;
  a.block_q = block_q;
  a.NQ = (T + block_q - 1) / block_q;
  a.NB = (block_q * (Hq / Hkv) + R - 1) / R;
  a.NS = NS;
  a.sel_per_head = sel_per_head;
  a.sm_scale = sm_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int8 ? dispatch<int8_t>(a, S, ps, st) : dispatch<__nv_bfloat16>(a, S, ps, st);
}

extern "C" const char* skt_prefill_hm_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
