// Kernel K11: the MoE layer of the EP low-latency path in one launch:
// dispatch with int8 quantisation -> GMM1 -> SwiGLU -> requantisation ->
// GMM2 -> return of the rows to their sources.
//
// Replaces sgl_kernel_npu_tpu/parallel/strategies/fused_moe_pallas.py::
// fused_deep_moe_pallas_shard (_fused_kernel, fused_moe_pallas.py:64-340),
// one Pallas call whose phases overlap remote DMAs with the expert GEMMs.
// What it computes (R ranks, El local experts, maxT slots per source rank,
// rows = El * R * maxT, CHUNK = 8):
//   phase S  for slice i = (dst, e) and chunk c < ceil(send_cnt[i] / CHUNK):
//            the CHUNK bf16 rows at (src_off[i] / CHUNK) * CHUNK + c * CHUNK of
//            x_send, each quantised (scale = max(absmax, 1e-7) * f32(1/127),
//            q = rint(x / scale)), into rows (dst_off[i] / CHUNK) * CHUNK +
//            c * CHUNK of dst's recv [rows, H] int8 and rs [rows] f32;
//   experts  for every row of expert e's window, all in f32:
//              ug  = (acc1 * rs[row]) * w13s[e]            acc1 = recv . w13[e], int32
//              act = (g * (1 / (1 + exp(-g)))) * u        g = ug[:, :F], u = ug[:, F:]
//              asc = max(absmax(act), 1e-7) * f32(1/127), aq = rint(act / asc)
//              y   = bf16((acc2 * asc) * w2s[e])           acc2 = aq . w2[e], int32
//   phase C  row j of expert e (source src = j / maxT, within = j % maxT) goes
//            to row ((back_off[src*El+e] + within0) / CHUNK) * CHUNK + j % CHUNK of
//            src's back [sbuf, H] bf16, within0 = within rounded down to a chunk,
//            if within0 < recv_cnt[src*El+e] (whole chunks, as the TPU kernel
//            sends them).
// recv, rs and back are zeroed by the wrapper. Every step is rounded on its
// own (__fmul_rn, __fdiv_rn, __fadd_rn; the sigmoid as PyTorch's CUDA sigmoid),
// so the plain version (fused_moe_pallas.py::fused_moe_layer_ref) on the card
// gives the same numbers; the int32 sums are exact.
//
// One launch, a persistent grid. The work is a list of items in dependency
// order: the phase-S chunks, then the GMM1 tiles (TM rows x 128 columns of
// ug, expert-major, the m-tiles of a column panel next to each other
// so that the second reads the panel from L2), then one requantisation item
// per (expert, m-tile), then the GMM2 tiles, whose epilogue is phase C. A
// block claims the next item from a global counter; an item waits only on
// items before it in the list:
//   GMM1 (e, *)   until arrive[e] counts the chunks recv_cnt announces for e,
//                 bumped by each phase-S chunk (release: __threadfence, then
//                 atomicAdd; acquire: ld.acquire.gpu, then __syncthreads);
//   requant (e,m) until g1_done[e, m] counts all GMM1 column tiles of (e, m);
//   GMM2 (e, m)   until rq_done[e, m] is set.
// The grid never exceeds the number of blocks that fit on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), and items are
// claimed in order, so the oldest unfinished item always has its inputs and
// no wait deadlocks (tested with every copy on one expert and with experts
// of no rows). An m-tile with no live chunk is skipped by all its items.
// Data written inside the launch is read through L2 (ld.global.cg): L1 is
// not coherent across SMs.
//
// The windows (recv, rs, arrival counters, back) are addressed through a
// per-rank pointer table (Peers). One rank fills one entry and phase W, the
// wait for the returned rows, is the end of the launch; the 4-card EP slice
// fills the table with peer windows, so the launcher refuses R > 1.
//
// Bound on an H100: the expert weights (El * 3 * H * F bytes, 352 MB at the
// bench shape: 0.105 ms at 3.35 TB/s) plus the token traffic; the int8
// operations (2 * rows * 3 * H * F) are under half of that time at the
// tensor-core rate. The GEMM tiles are the int8 mma.sync loop of
// w8a8_core.cuh (one register-prefetched stage, byte-transposed weight rows)
// with TM = 64-row tiles (a window's last m-tile may hold fewer rows: rows
// past R * maxT read as zeros and are not written); the f32 GMM1 output and the requantised activation
// go through device memory (ug, act). Simple first: no TMA, no wgmma.

#include "device_once.cuh"
#include "w8a8_core.cuh"

namespace {

using skt_w8a8::BK;
using skt_w8a8::BN;
using skt_w8a8::SROW;

constexpr int CHUNK = 8;
constexpr int TM = 64;                // rows per GEMM tile
constexpr int THREADS = 128;          // 4 warps
constexpr int MAX_RANKS = 8;
constexpr float INV127 = (float)(1.0 / 127.0);

struct Peers {                        // entry r: rank r's windows
  int8_t* recv[MAX_RANKS];
  float* rs[MAX_RANKS];
  int* arrive[MAX_RANKS];
  __nv_bfloat16* back[MAX_RANKS];
};

struct Args {
  const __nv_bfloat16* x_send;        // [sbuf, H]
  const int8_t* w13;                  // [El, H, 2F]
  const float* w13s;                  // [El, 2F]
  const int8_t* w2;                   // [El, F, H]
  const float* w2s;                   // [El, H]
  const int* send_cnt;                // [R*El] each
  const int* src_off;
  const int* dst_off;
  const int* recv_cnt;
  const int* back_off;
  float* ug;                          // [rows, 2F] scratch
  int8_t* act;                        // [rows, F] scratch
  float* asc;                         // [rows] scratch
  int* work;                          // the item counter
  int* g1_done;                       // [El * MT]
  int* rq_done;                       // [El * MT]
  Peers peers;
  int R, me, El, maxT, H, F, sbuf, MT, NT1, NT2;
  int erows;                          // rows of an expert's window, R * maxT
  int n_s, n_g1, n_rq, n_g2;          // items per phase
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Block-wide: wait until *p >= target. A wait of seconds (the inputs of an
// item never come) traps, so that a fault ends the launch with an error
// instead of holding the card.
__device__ __forceinline__ void wait_for(const int* p, int target) {
  if (threadIdx.x == 0) {
    long long spins = 0;
    while (ld_acquire(p) < target) {
      __nanosleep(64);
      if (++spins > (1LL << 26)) __trap();
    }
  }
  __syncthreads();
}

// Block-wide: make this block's writes visible, then add one to *p.
__device__ __forceinline__ void signal(int* p) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p, 1);
}

__device__ __forceinline__ float sigmoid_mul(float g, float u) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
  return __fmul_rn(__fmul_rn(g, s), u);
}

// rows e * R * maxT + [m0, m0 + TM) of expert e hold a chunk someone sends
// (the last m-tile of a window may hold fewer than TM rows)
__device__ bool tile_live(const Args& a, int e, int mt) {
  for (int r = mt * TM; r < min((mt + 1) * TM, a.erows); r += CHUNK) {
    const int src = r / a.maxT, within = r % a.maxT;
    if (within < a.recv_cnt[src * a.El + e]) return true;
  }
  return false;
}

// Phase S, send-buffer chunk q: find its slice, quantise its rows into the
// destination window, count the chunk at the destination expert.
__device__ void send_chunk(const Args& a, int q) {
  const int row0 = q * CHUNK;
  for (int i = 0; i < a.R * a.El; ++i) {
    const int base = a.src_off[i] / CHUNK * CHUNK;
    const int nch = (a.send_cnt[i] + CHUNK - 1) / CHUNK;
    if (row0 < base || row0 >= base + nch * CHUNK) continue;
    const int dst = i / a.El, e = i % a.El;
    const int dst0 = a.dst_off[i] / CHUNK * CHUNK + (row0 - base);
    const int rows = a.El * a.R * a.maxT;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int j = warp; j < CHUNK; j += THREADS / 32) {
      const int sr = row0 + j, dr = dst0 + j;
      if (sr >= a.sbuf || dr >= rows) continue;
      const __nv_bfloat16* src = a.x_send + (size_t)sr * a.H;
      float amax = 0.f;
      for (int c = lane * 8; c < a.H; c += 256) {
        const int4 raw = __ldg(reinterpret_cast<const int4*>(src + c));
        const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(__bfloat162float(b[t])));
      }
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float scale = __fmul_rn(fmaxf(amax, 1e-7f), INV127);
      int8_t* out = a.peers.recv[dst] + (size_t)dr * a.H;
      for (int c = lane * 8; c < a.H; c += 256) {
        const int4 raw = __ldg(reinterpret_cast<const int4*>(src + c));
        const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int v = max(-128, min(127, __float2int_rn(__fdiv_rn(__bfloat162float(b[t]), scale))));
          w[t >> 2] |= (uint32_t)(uint8_t)v << ((t & 3) * 8);
        }
        *reinterpret_cast<uint2*>(out + c) = make_uint2(w[0], w[1]);
      }
      if (lane == 0) a.peers.rs[dst][dr] = scale;
    }
    signal(a.peers.arrive[dst] + e);
    return;
  }
}

// One TM x 128 tile of A [TM, K] (int8 rows lda apart, read through L2) times
// B (int8, K rows ldw apart, 128 columns), int32 sums, then epi(row, col,
// acc) for every element of the first `mrows` rows; rows from mrows on read
// as zeros (a window's partial last m-tile). The loop of w8a8_core.cuh.
template <class Epi>
__device__ __forceinline__ void gemm_tile(const int8_t* __restrict__ A, int lda,
                                          const int8_t* __restrict__ B, int ldw, int K,
                                          int mrows, int8_t* As, int8_t* Bs, Epi epi) {
  constexpr int VPR = BK / 16;                 // 16-byte vectors per row and stage
  constexpr int APT = TM * VPR / THREADS;      // A vectors per thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kq = lane & 15;
  const int nc = (warp * 2 + (lane >> 4)) * 16;
  const int8_t* bcol = B + nc;                 // this thread's 16 columns
  int4 areg[APT], breg[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int v = tid + i * THREADS, r = v / VPR, c = (v % VPR) * 16;
      areg[i] = r < mrows ? __ldcg(reinterpret_cast<const int4*>(A + (size_t)r * lda + k0 + c))
                          : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      breg[j] = __ldg(reinterpret_cast<const int4*>(bcol + (size_t)(k0 + kq * 4 + j) * ldw));
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int v = tid + i * THREADS, r = v / VPR, c = (v % VPR) * 16;
      *reinterpret_cast<int4*>(As + r * SROW + c) = areg[i];
    }
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(&breg[0]);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(&breg[1]);
    const uint32_t* r2 = reinterpret_cast<const uint32_t*>(&breg[2]);
    const uint32_t* r3 = reinterpret_cast<const uint32_t*>(&breg[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t o[4];
      skt_w8a8::transpose4x4(r0[q], r1[q], r2[q], r3[q], o);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(Bs + (nc + q * 4 + c) * SROW + kq * 4) = o[c];
    }
  };

  constexpr int MTL = 2, NTL = 8;              // m16 / n8 tiles per warp (2 x 2 warps)
  int32_t acc[MTL][NTL][4];
#pragma unroll
  for (int m = 0; m < MTL; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane >> 2, t4 = (lane & 3) * 4;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();                           // the previous stage's fragments are read
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MTL][4], bf[NTL][2];
#pragma unroll
      for (int m = 0; m < MTL; ++m) {
        const int8_t* ap = As + ((wm * MTL + m) * 16 + g) * SROW + kk + t4;
        af[m][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[m][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * SROW);
        af[m][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        af[m][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * SROW + 16);
      }
#pragma unroll
      for (int n = 0; n < NTL; ++n) {
        const int8_t* bp = Bs + ((wn * NTL + n) * 8 + g) * SROW + kk + t4;
        bf[n][0] = *reinterpret_cast<const uint32_t*>(bp);
        bf[n][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int m = 0; m < MTL; ++m)
#pragma unroll
        for (int n = 0; n < NTL; ++n) skt_w8a8::mma_s8(acc[m][n], af[m], bf[n]);
    }
  }
#pragma unroll
  for (int m = 0; m < MTL; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (wm * MTL + m) * 16 + g + (e >> 1) * 8;
        if (r < mrows) epi(r, (wn * NTL + n) * 8 + (lane & 3) * 2 + (e & 1), acc[m][n][e]);
      }
}

// GMM1 tile (e, column tile nt, m-tile mt): 128 columns of ug = [gate | up].
__device__ void gmm1(const Args& a, int e, int nt, int mt, int8_t* As, int8_t* Bs) {
  const int f2 = 2 * a.F;
  const int row0 = e * a.R * a.maxT + mt * TM;
  int chunks = 0;                              // chunks announced for expert e
  for (int src = 0; src < a.R; ++src)
    chunks += (a.recv_cnt[src * a.El + e] + CHUNK - 1) / CHUNK;
  wait_for(a.peers.arrive[a.me] + e, chunks);
  const int8_t* A = a.peers.recv[a.me] + (size_t)row0 * a.H;
  const int8_t* B = a.w13 + (size_t)e * a.H * f2 + nt * BN;
  const float* rs = a.peers.rs[a.me] + row0;
  const float* ws = a.w13s + (size_t)e * f2 + nt * BN;
  float* ug = a.ug + (size_t)row0 * f2 + nt * BN;
  gemm_tile(A, a.H, B, f2, a.H, min(TM, a.erows - mt * TM), As, Bs,
            [&](int r, int c, int32_t v) {
              ug[(size_t)r * f2 + c] = __fmul_rn(__fmul_rn((float)v, __ldcg(rs + r)), ws[c]);
            });
  signal(a.g1_done + e * a.MT + mt);
}

// Requantisation item (e, mt): act = SwiGLU(ug) per row, int8 by row.
__device__ void requant(const Args& a, int e, int mt) {
  wait_for(a.g1_done + e * a.MT + mt, a.NT1);
  const int f2 = 2 * a.F;
  const int row0 = e * a.R * a.maxT + mt * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row1 = row0 + min(TM, a.erows - mt * TM);
  for (int r = row0 + warp; r < row1; r += THREADS / 32) {
    const float* ug = a.ug + (size_t)r * f2;
    float amax = 0.f;
    for (int j = lane * 4; j < a.F; j += 128) {
      const float4 g = __ldcg(reinterpret_cast<const float4*>(ug + j));
      const float4 u = __ldcg(reinterpret_cast<const float4*>(ug + a.F + j));
      amax = fmaxf(amax, fabsf(sigmoid_mul(g.x, u.x)));
      amax = fmaxf(amax, fabsf(sigmoid_mul(g.y, u.y)));
      amax = fmaxf(amax, fabsf(sigmoid_mul(g.z, u.z)));
      amax = fmaxf(amax, fabsf(sigmoid_mul(g.w, u.w)));
    }
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sc = __fmul_rn(fmaxf(amax, 1e-7f), INV127);
    for (int j = lane * 4; j < a.F; j += 128) {
      const float4 g = __ldcg(reinterpret_cast<const float4*>(ug + j));
      const float4 u = __ldcg(reinterpret_cast<const float4*>(ug + a.F + j));
      const float v[4] = {sigmoid_mul(g.x, u.x), sigmoid_mul(g.y, u.y), sigmoid_mul(g.z, u.z),
                          sigmoid_mul(g.w, u.w)};
      uint32_t w = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int q = max(-128, min(127, __float2int_rn(__fdiv_rn(v[t], sc))));
        w |= (uint32_t)(uint8_t)q << (t * 8);
      }
      *reinterpret_cast<uint32_t*>(a.act + (size_t)r * a.F + j) = w;
    }
    if (lane == 0) a.asc[r] = sc;
  }
  signal(a.rq_done + e * a.MT + mt);
}

// GMM2 tile (e, column tile nt, m-tile mt) and phase C of its rows.
__device__ void gmm2(const Args& a, int e, int nt, int mt, int8_t* As, int8_t* Bs) {
  wait_for(a.rq_done + e * a.MT + mt, 1);
  const int row0 = e * a.R * a.maxT + mt * TM;
  const int8_t* A = a.act + (size_t)row0 * a.F;
  const int8_t* B = a.w2 + (size_t)e * a.F * a.H + nt * BN;
  const float* asc = a.asc + row0;
  const float* ws = a.w2s + (size_t)e * a.H + nt * BN;
  gemm_tile(A, a.F, B, a.H, a.F, min(TM, a.erows - mt * TM), As, Bs,
            [&](int r, int c, int32_t v) {
              const int j = mt * TM + r;       // row of expert e
              const int src = j / a.maxT, within = j % a.maxT;
              const int w0 = within / CHUNK * CHUNK;
              const int slice = src * a.El + e;
              if (w0 >= a.recv_cnt[slice]) return;
              const int brow = (a.back_off[slice] + w0) / CHUNK * CHUNK + within % CHUNK;
              if (brow >= a.sbuf) return;
              const float y = __fmul_rn(__fmul_rn((float)v, __ldcg(asc + r)), ws[c]);
              a.peers.back[src][(size_t)brow * a.H + nt * BN + c] = __float2bfloat16_rn(y);
            });
}

__global__ void __launch_bounds__(THREADS) fused_moe_kernel(const Args a) {
  __shared__ __align__(16) int8_t As[TM * SROW];
  __shared__ __align__(16) int8_t Bs[BN * SROW];
  __shared__ int s_item;
  const int total = a.n_s + a.n_g1 + a.n_rq + a.n_g2;
  for (;;) {
    __syncthreads();                           // the previous item is done with s_item
    if (threadIdx.x == 0) s_item = atomicAdd(a.work, 1);
    __syncthreads();
    int item = s_item;
    if (item >= total) return;
    if (item < a.n_s) {
      send_chunk(a, item);
      continue;
    }
    item -= a.n_s;
    if (item < a.n_g1) {                       // (e, nt, mt), mt fastest
      const int e = item / (a.NT1 * a.MT), rem = item % (a.NT1 * a.MT);
      if (tile_live(a, e, rem % a.MT)) gmm1(a, e, rem / a.MT, rem % a.MT, As, Bs);
      continue;
    }
    item -= a.n_g1;
    if (item < a.n_rq) {                       // (e, mt)
      if (tile_live(a, item / a.MT, item % a.MT)) requant(a, item / a.MT, item % a.MT);
      continue;
    }
    item -= a.n_rq;                            // (e, nt, mt), mt fastest
    const int e = item / (a.NT2 * a.MT), rem = item % (a.NT2 * a.MT);
    if (tile_live(a, e, rem % a.MT)) gmm2(a, e, rem / a.MT, rem % a.MT, As, Bs);
  }
}

}  // namespace

// x_send [sbuf, H] bf16, w13 [El, H, 2F] int8, w13s [El, 2F] f32, w2 [El, F, H]
// int8, w2s [El, H] f32, the five tables [R*El] int32; outputs recv
// [El*R*maxT, H] int8, rs [El*R*maxT] f32, back [sbuf, H] bf16, zeroed by the
// caller; scratch ug [El*R*maxT, 2F] f32, act [El*R*maxT, F] int8, asc
// [El*R*maxT] f32, ctr [1 + El + 2*El*ceil(R*maxT/64)] int32 (zeroed here).
// Needs H % 128 == 0, F % 64 == 0, maxT % 8 == 0; one rank only (R == 1).
extern "C" int skt_fused_moe(const void* x_send, const void* w13, const void* w13s,
                             const void* w2, const void* w2s, const void* send_cnt,
                             const void* src_off, const void* dst_off, const void* recv_cnt,
                             const void* back_off, void* recv, void* rs, void* back, void* ug,
                             void* act, void* asc, void* ctr, int R, int El, int maxT, int H,
                             int F, int sbuf, void* stream) {
  if (R != 1) return (int)cudaErrorNotSupported;
  if (El <= 0 || H % 128 || F % 64 || F <= 0 || maxT <= 0 || maxT % CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.x_send = static_cast<const __nv_bfloat16*>(x_send);
  a.w13 = static_cast<const int8_t*>(w13);
  a.w13s = static_cast<const float*>(w13s);
  a.w2 = static_cast<const int8_t*>(w2);
  a.w2s = static_cast<const float*>(w2s);
  a.send_cnt = static_cast<const int*>(send_cnt);
  a.src_off = static_cast<const int*>(src_off);
  a.dst_off = static_cast<const int*>(dst_off);
  a.recv_cnt = static_cast<const int*>(recv_cnt);
  a.back_off = static_cast<const int*>(back_off);
  a.ug = static_cast<float*>(ug);
  a.act = static_cast<int8_t*>(act);
  a.asc = static_cast<float*>(asc);
  a.R = R;
  a.me = 0;
  a.El = El;
  a.maxT = maxT;
  a.H = H;
  a.F = F;
  a.sbuf = sbuf;
  a.erows = R * maxT;
  a.MT = (a.erows + TM - 1) / TM;
  a.NT1 = 2 * F / BN;
  a.NT2 = H / BN;
  int* c = static_cast<int*>(ctr);
  // ctr: [work][arrive El][g1_done El*MT][rq_done El*MT]
  a.work = c;
  a.g1_done = c + 1 + El;
  a.rq_done = a.g1_done + El * a.MT;
  a.peers.recv[0] = static_cast<int8_t*>(recv);
  a.peers.rs[0] = static_cast<float*>(rs);
  a.peers.arrive[0] = c + 1;
  a.peers.back[0] = static_cast<__nv_bfloat16*>(back);
  a.n_s = (sbuf + CHUNK - 1) / CHUNK;
  a.n_g1 = El * a.NT1 * a.MT;
  a.n_rq = El * a.MT;
  a.n_g2 = El * a.NT2 * a.MT;
  cudaError_t err = cudaMemsetAsync(ctr, 0, sizeof(int) * (1 + El + 2 * El * a.MT), st);
  if (err != cudaSuccess) return (int)err;
  // the co-resident block count, taken once per device (the first call on a
  // card is not inside a CUDA graph capture)
  int resident = 0;
  if ((err = skt::resident_blocks(fused_moe_kernel, THREADS, 0, resident)) != cudaSuccess)
    return (int)err;
  const int total = a.n_s + a.n_g1 + a.n_rq + a.n_g2;
  const int grid = total < resident ? total : resident;
  fused_moe_kernel<<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_fused_moe_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
