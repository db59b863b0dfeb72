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
// One launch, a persistent grid of one block an SM. The work is a list of
// items in dependency order: the phase-S chunks, then the GMM1 tiles (TM =
// 128 rows x 256 columns of ug, expert-major, the m-tiles of a column panel
// next to each other so that the second reads the panel from L2), then the
// requantisation items (RQ = 16 rows of an m-tile each), then the GMM2
// tiles, whose epilogue is phase C. A block claims the next item from a
// global counter; an item waits only on items before it in the list:
//   GMM1 (e, *)   until arrive[e] counts the chunks recv_cnt announces for e,
//                 bumped by each phase-S chunk (release: __threadfence, then
//                 atomicAdd; acquire: ld.acquire.gpu, then a barrier or,
//                 before TMA reads, fence.proxy.async.global);
//   requant (e,m) until g1_done[e, m] counts all GMM1 column tiles of (e, m);
//   GMM2 (e, m)   until rq_done[e, m] counts all requant items of (e, m).
// The grid never exceeds the number of blocks that fit on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, asked with the
// block's threads and shared memory), and items are claimed in order, so
// the oldest unfinished item always has its inputs and no wait deadlocks
// (tested with every copy on one expert and with experts of no rows). An
// m-tile with no live chunk is skipped by all its items. Data written
// inside the launch is read through L2 (ld.global.cg, or TMA): L1 is not
// coherent across SMs.
//
// The windows (recv, rs, arrival counters, back) are addressed through a
// per-rank pointer table (Peers). One rank fills one entry and phase W, the
// wait for the returned rows, is the end of the launch; the 4-card EP slice
// fills the table with peer windows, so the launcher refuses R > 1.
//
// Bound on an H100: the expert weights (El * 3 * H * F bytes, 352 MB at the
// bench shape: 0.105 ms at 3.35 TB/s) plus the token traffic; the int8
// operations (2 * rows * 3 * H * F) are under half of that time at the
// tensor-core rate. The GEMM tiles run the int8 stage of w8a8_wgmma.cuh,
// each block its warp-specialised 384 threads: one producer thread streams
// a tile's weights by TMA into the raw ring (a 4-D map over the expert
// bank, the expert a panel coordinate), another its x rows (recv for GMM1,
// act for GMM2) through a 3-D map [El][R * maxT][K] whose rows past a
// window read as zeros, so a window's partial last m-tile (maxT 8, 72)
// needs no mask; the two consumer warpgroups transpose the weights on chip
// and run int8 wgmma (consume_tile), then stage the tile in shared memory
// and store it through a functor (store_tile): GMM1 writes ug rows below
// the window's end, GMM2 scatters its rows into back. The rings' positions
// carry over from item to item. recv and act are written inside the launch
// by generic stores on other SMs and read here by TMA, through the async
// proxy: the x loader waits (acquire), then fences the proxies
// (fence.proxy.async.global) before its first load. At the bench shape
// (R * maxT = 128) an expert's window is one m-tile, so each weight panel
// streams once. The consumers also run the phase-S chunks and the requant
// items; the f32 GMM1 output and the requantised activation go through
// device memory (ug, act): SwiGLU inside GMM1's epilogue would need a row
// maximum across its 16 column tiles.

#include "w8a8_wgmma.cuh"

namespace {

constexpr int CHUNK = 8;
constexpr int TM = W_BM;              // rows of a GEMM tile
constexpr int THREADS = W_THREADS;    // a producer warpgroup, two consumer warpgroups
constexpr int CONSUMERS = 256;        // the threads of phase S, requant and the GEMM loop
constexpr int CWARPS = CONSUMERS / 32;
constexpr int RQ = 16;                // rows of a requantisation item
constexpr int RQT = TM / RQ;          // requantisation items of an m-tile
constexpr int MAX_RANKS = 8;
constexpr float INV127 = (float)(1.0 / 127.0);

struct Peers {                        // entry r: rank r's windows
  int8_t* recv[MAX_RANKS];
  float* rs[MAX_RANKS];
  int* arrive[MAX_RANKS];
  __nv_bfloat16* back[MAX_RANKS];
};

struct MoeArgs {
  const __nv_bfloat16* x_send;        // [sbuf, H]
  const float* w13s;                  // [El, 2F]
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

// One thread: wait until *p >= target. A wait of seconds (the inputs of an
// item never come) traps, so that a fault ends the launch with an error
// instead of holding the card.
__device__ __forceinline__ void spin_until(const int* p, int target) {
  long long spins = 0;
  while (ld_acquire(p) < target) {
    __nanosleep(64);
    if (++spins > (1LL << 26)) __trap();
  }
}

// The consumers (ct 0 .. 255): wait until *p >= target.
__device__ __forceinline__ void wait_for(const int* p, int target, int ct) {
  if (ct == 0) spin_until(p, target);
  bar_sync(1, CONSUMERS);
}

// The consumers: make their writes visible, to other SMs' loads and to
// their TMA reads (the async proxy), then add one to *p.
__device__ __forceinline__ void signal(int* p, int ct) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __threadfence();
  bar_sync(1, CONSUMERS);
  if (ct == 0) atomicAdd(p, 1);
}

__device__ __forceinline__ float sigmoid_mul(float g, float u) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
  return __fmul_rn(__fmul_rn(g, s), u);
}

// rows e * R * maxT + [m0, m0 + TM) of expert e hold a chunk someone sends
// (the last m-tile of a window may hold fewer than TM rows)
__device__ bool tile_live(const MoeArgs& a, int e, int mt) {
  for (int r = mt * TM; r < min((mt + 1) * TM, a.erows); r += CHUNK) {
    const int src = r / a.maxT, within = r % a.maxT;
    if (within < __ldg(a.recv_cnt + src * a.El + e)) return true;
  }
  return false;
}

// the chunks recv_cnt announces for expert e
__device__ int chunks_for(const MoeArgs& a, int e) {
  int chunks = 0;
  for (int src = 0; src < a.R; ++src)
    chunks += (__ldg(a.recv_cnt + src * a.El + e) + CHUNK - 1) / CHUNK;
  return chunks;
}

// the requant items of m-tile mt (those holding a row of the window)
__device__ __forceinline__ int rq_items(const MoeArgs& a, int mt) {
  return (min(TM, a.erows - mt * TM) + RQ - 1) / RQ;
}

// Phase S, send-buffer chunk q (the consumers): find its slice, quantise
// its rows into the destination window, count the chunk at the destination
// expert.
__device__ void send_chunk(const MoeArgs& a, int q, int ct) {
  const int row0 = q * CHUNK;
  for (int i = 0; i < a.R * a.El; ++i) {
    const int base = a.src_off[i] / CHUNK * CHUNK;
    const int nch = (a.send_cnt[i] + CHUNK - 1) / CHUNK;
    if (row0 < base || row0 >= base + nch * CHUNK) continue;
    const int dst = i / a.El, e = i % a.El;
    const int dst0 = a.dst_off[i] / CHUNK * CHUNK + (row0 - base);
    const int rows = a.El * a.R * a.maxT;
    const int lane = ct & 31, warp = ct >> 5;
    for (int j = warp; j < CHUNK; j += CWARPS) {
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
    signal(a.peers.arrive[dst] + e, ct);
    return;
  }
}

// Requantisation item (e, mt, sub) (the consumers): act = SwiGLU(ug) per
// row, int8 by row, for rows mt * TM + sub * RQ .. + RQ - 1 of the window.
__device__ void requant(const MoeArgs& a, int e, int mt, int sub, int ct) {
  wait_for(a.g1_done + e * a.MT + mt, a.NT1, ct);
  const int f2 = 2 * a.F;
  const int win0 = e * a.erows + mt * TM + sub * RQ;
  const int lane = ct & 31, warp = ct >> 5;
  const int row1 = e * a.erows + min(mt * TM + (sub + 1) * RQ, a.erows);
  for (int r = win0 + warp; r < row1; r += CWARPS) {
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
  signal(a.rq_done + e * a.MT + mt, ct);
}

// An item of the list, decoded
enum Kind { SEND, GMM1, REQUANT, GMM2, DONE };
struct Item {
  Kind kind;
  int q, e, nt, mt, sub;              // q: SEND's chunk
};

__device__ Item decode(const MoeArgs& a, int item) {
  Item it{DONE, 0, 0, 0, 0, 0};
  if (item < a.n_s) {
    it.kind = SEND;
    it.q = item;
    return it;
  }
  item -= a.n_s;
  if (item < a.n_g1) {                         // (e, nt, mt), mt fastest
    it.kind = GMM1;
    it.e = item / (a.NT1 * a.MT);
    const int rem = item % (a.NT1 * a.MT);
    it.nt = rem / a.MT;
    it.mt = rem % a.MT;
    return it;
  }
  item -= a.n_g1;
  if (item < a.n_rq) {                         // (e, mt, sub)
    it.kind = REQUANT;
    it.e = item / (a.MT * RQT);
    const int rem = item % (a.MT * RQT);
    it.mt = rem / RQT;
    it.sub = rem % RQT;
    return it;
  }
  item -= a.n_rq;
  if (item < a.n_g2) {                         // (e, nt, mt), mt fastest
    it.kind = GMM2;
    it.e = item / (a.NT2 * a.MT);
    const int rem = item % (a.NT2 * a.MT);
    it.nt = rem / a.MT;
    it.mt = rem % a.MT;
  }
  return it;
}

// Every thread of the block: the next item. Barrier 3 over all 384 threads
// (the producers' lanes converge first: bar.sync is warp-aligned).
__device__ __forceinline__ Item claim(const MoeArgs& a, int* s_item) {
  __syncwarp();
  bar_sync(3, THREADS);                        // the last item is done with s_item
  if (threadIdx.x == 0) *s_item = atomicAdd(a.work, 1);
  bar_sync(3, THREADS);
  return decode(a, *s_item);
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_moe_kernel(const __grid_constant__ CUtensorMap w13map,
                     const __grid_constant__ CUtensorMap w2map,
                     const __grid_constant__ CUtensorMap recvmap,
                     const __grid_constant__ CUtensorMap actmap, const MoeArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_item;
  WgSmem& sm = *reinterpret_cast<WgSmem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) init_rings(sm);
  __syncthreads();
  // the stages that have gone through the weight and x rings so far, the
  // same count in the producers and the consumers
  uint32_t w0 = 0, x0 = 0;

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    for (;;) {
      const Item it = claim(a, &s_item);
      if (it.kind == DONE) return;
      if (it.kind == SEND || it.kind == REQUANT || !tile_live(a, it.e, it.mt)) continue;
      const bool g1 = it.kind == GMM1;
      const int nk = ((g1 ? a.H : a.F) + W_BK - 1) / W_BK;
      if (threadIdx.x == 0) {
        const int n = g1 ? 2 * a.F : a.H;
        produce_weights(sm, g1 ? &w13map : &w2map, w0, nk, 0, it.nt * BN, n, n, it.e);
      } else if (threadIdx.x == 32) {
        // the x rows were written in this launch by generic stores on other
        // SMs: acquire them, then order this thread's TMA reads (the async
        // proxy) after them
        if (g1)
          spin_until(a.peers.arrive[a.me] + it.e, chunks_for(a, it.e));
        else
          spin_until(a.rq_done + it.e * a.MT + it.mt, rq_items(a, it.mt));
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        for (int j = 0; j < nk; ++j) {
          const uint32_t s = x0 + j;
          const int st = s % W_X;
          if (s >= W_X) mbar_wait(&sm.xempty[st], ((s / W_X) - 1) & 1);
          mbar_expect_tx(&sm.xfull[st], W_BM * W_BK);
          tma_load_3d(sm.x[st], g1 ? &recvmap : &actmap, &sm.xfull[st], j * W_BK, it.mt * TM,
                      it.e);
        }
      }
      w0 += nk;
      x0 += nk;
    }
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int ct = threadIdx.x - 128;              // consumer thread 0 .. 255
  const int lane = ct % 32;
  const int lr = 64 * (ct / 128) + 16 * ((ct / 32) % 4) + (lane >> 2);   // rows lr, lr + 8
  for (;;) {
    const Item it = claim(a, &s_item);
    if (it.kind == DONE) return;
    if (it.kind == SEND) {
      send_chunk(a, it.q, ct);
      continue;
    }
    if (!tile_live(a, it.e, it.mt)) continue;
    if (it.kind == REQUANT) {
      if (it.sub < rq_items(a, it.mt)) requant(a, it.e, it.mt, it.sub, ct);
      continue;
    }
    const bool g1 = it.kind == GMM1;
    const int nk = ((g1 ? a.H : a.F) + W_BK - 1) / W_BK;
    int32_t d[128];
    consume_tile(sm, w0, x0, nk, ct, d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.xempty[(x0 + nk - 1) % W_X]);   // the tile's last x stage
    w0 += nk;
    x0 += nk;
    // the epilogue, (acc * x scale) * column scale as the plain version
    // rounds it; the x scales were written in this launch (read from L2
    // after the x rows, which came after the acquire)
    const int n = g1 ? 2 * a.F : a.H, n0 = it.nt * BN;
    const int row0 = it.e * a.erows + it.mt * TM;   // the tile's first row
    const int rows = min(TM, a.erows - it.mt * TM);
    const float* xsc = (g1 ? a.peers.rs[a.me] : a.asc) + row0;
    const float* wsc = (g1 ? a.w13s : a.w2s) + (size_t)it.e * n;
    const float my_ws = n0 + ct < n ? __ldg(wsc + n0 + ct) : 0.f;
    const float xs0 = lr < rows ? __ldcg(xsc + lr) : 0.f;
    const float xs1 = lr + 8 < rows ? __ldcg(xsc + lr + 8) : 0.f;
    if (g1) {
      float* ug = a.ug + (size_t)row0 * n + n0;
      store_tile<EpiTiled>(sm, ct, d, my_ws, 0, xs0, xs1, true, rows, min(BN, n - n0),
                           [&](int r) { return reinterpret_cast<unsigned char*>(ug + (size_t)r * n); });
      signal(a.g1_done + it.e * a.MT + it.mt, ct);
    } else {
      // phase C: row j of expert e's window (source src = j / maxT, within =
      // j % maxT) lands at row (back_off + within0) / CHUNK * CHUNK + within
      // % CHUNK of src's back if its chunk was received
      store_tile<EpiTiled>(sm, ct, d, my_ws, 0, xs0, xs1, false, rows, min(BN, n - n0),
                           [&](int r) -> unsigned char* {
                             const int j = it.mt * TM + r;
                             const int src = j / a.maxT, within = j % a.maxT;
                             const int w0c = within / CHUNK * CHUNK;
                             const int slice = src * a.El + it.e;
                             if (w0c >= __ldg(a.recv_cnt + slice)) return nullptr;
                             const int brow = (__ldg(a.back_off + slice) + w0c) / CHUNK * CHUNK +
                                              within % CHUNK;
                             if (brow >= a.sbuf) return nullptr;
                             return reinterpret_cast<unsigned char*>(
                                 a.peers.back[src] + (size_t)brow * a.H + n0);
                           });
    }
    // the staged tile went through shared memory by generic loads and
    // stores; the next item's TMA loads write there through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

// K11's x maps: a window buffer [El * R * maxT, K] int8 as [El][R * maxT][K]
// with boxes of 128 bytes x 128 rows x 1 expert, 128-byte swizzle, the
// layout the stage's wgmma reads; rows past a window come as zeros.
bool encode_rows_map(CUtensorMap* map, const int8_t* rows, int K, int erows, int El) {
  const EncodeTiled f = encode_fn();
  if (f == nullptr) return false;
  const cuuint32_t one[3] = {1, 1, 1};
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)erows, (cuuint64_t)El};
  const cuuint64_t str[2] = {(cuuint64_t)K, (cuuint64_t)K * erows};
  const cuuint32_t box[3] = {W_BK, W_BM, 1};
  return f(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(rows), dims, str, box, one,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x_send [sbuf, H] bf16, w13 [El, H, 2F] int8, w13s [El, 2F] f32, w2 [El, F, H]
// int8, w2s [El, H] f32, the five tables [R*El] int32; outputs recv
// [El*R*maxT, H] int8, rs [El*R*maxT] f32, back [sbuf, H] bf16, zeroed by the
// caller; scratch ug [El*R*maxT, 2F] f32, act [El*R*maxT, F] int8, asc
// [El*R*maxT] f32, ctr [1 + El + 2*El*ceil(R*maxT/128)] int32 (zeroed here).
// Needs H % 128 == 0, F % 64 == 0, maxT % 8 == 0, 16-byte aligned operands;
// one rank only (R == 1).
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
  MoeArgs a{};
  a.x_send = static_cast<const __nv_bfloat16*>(x_send);
  a.w13s = static_cast<const float*>(w13s);
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
  a.NT1 = (2 * F + BN - 1) / BN;
  a.NT2 = (H + BN - 1) / BN;
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
  a.n_rq = El * a.MT * RQT;
  a.n_g2 = El * a.NT2 * a.MT;
  CUtensorMap w13map{}, w2map{}, recvmap{}, actmap{};
  if (!encode_wmap(&w13map, static_cast<const int8_t*>(w13), H, 2 * F, El) ||
      !encode_wmap(&w2map, static_cast<const int8_t*>(w2), F, H, El) ||
      !encode_rows_map(&recvmap, static_cast<const int8_t*>(recv), H, a.erows, El) ||
      !encode_rows_map(&actmap, static_cast<const int8_t*>(act), F, a.erows, El))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(ctr, 0, sizeof(int) * (1 + El + 2 * El * a.MT), st);
  if (err != cudaSuccess) return (int)err;
  // the co-resident block count at this block's threads and shared memory,
  // taken once per device (the first call on a card is not inside a CUDA
  // graph capture)
  if ((err = skt::ensure_smem(fused_moe_kernel, W_SMEM)) != cudaSuccess) return (int)err;
  int resident = 0;
  if ((err = skt::resident_blocks(fused_moe_kernel, THREADS, W_SMEM, resident)) != cudaSuccess)
    return (int)err;
  const int total = a.n_s + a.n_g1 + a.n_rq + a.n_g2;
  const int grid = total < resident ? total : resident;
  fused_moe_kernel<<<grid, THREADS, W_SMEM, st>>>(w13map, w2map, recvmap, actmap, a);
  return (int)cudaGetLastError();
}

extern "C" const char* skt_fused_moe_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
