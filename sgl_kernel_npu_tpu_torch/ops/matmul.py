"""W8A8 INT8 GEMMs (counterpart of the JAX package's ops/matmul.py):
`quant_matmul_int8` on a plain [K, N] weight, `quant_matmul_int8_stacked` on a
stacked per-layer bank, either [L, K, N] or pretiled to [L, N/bn, K, bn]
(`pretile_weight_bank`), `quant_matmul_int8_stacked_tiled` on the latter, and
the grouped expert GEMM `grouped_matmul_int8`, the contract of the JAX
package's `grouped_matmul_int8_pallas`: each block_m-row tile of x reads the
weights of its own expert. (The JAX package's `grouped_matmul_int8` is its
ragged reference over group sizes; the port has that as
`grouped_matmul_int8_ref`.)

On a CUDA tensor a wrapper launches a kernel: kernel A for an [L, K, N] bank
and for a plain weight (a one-layer view of it, no copy), kernel K1 for a
pretiled bank (both csrc/w8a8_gemm_tiled.cu), kernel K8 (csrc/w8a8_gemm.cu)
for the grouped GEMM. On a CPU tensor it runs the plain version,
`quant_matmul_int8_ref` on the layer's (or the tile's expert's) [K, N]
weight. A, K1, K8 and K2 (ops/rmsq_gemm.py) share the int8 stage of
csrc/w8a8_wgmma.cuh and its plan, `gemm_plan` (A's bank is the pretiled
layout with one panel, bn = N; K8's row tiles follow its block_m).

The soft-FP8 W8A16 GEMMs (bf16 activations times fp8 e4m3 weights with f32
scales per 128 x 128 block, what the reference's softfp8_w8a16_matmul and
softfp8_w8a16_grouped_matmul compute) run on kernel K21
(csrc/wfp8a16_gemm.cu). Names against the JAX package's:
  mm_wfp8a16_ref           mm_wfp8a16_ref (the port's follows the Pallas
                           kernel's K-block order)
  mm_wfp8a16               mm_wfp8a16 and mm_wfp8a16_pallas (K21 dense)
  gmm_wfp8a16_ref          gmm_wfp8a16_ref (ragged, over group sizes)
  gmm_wfp8a16_aligned      gmm_wfp8a16_pallas_aligned (K21 grouped)
  gmm_wfp8a16_aligned_ref  its plain version, per m-tile expert
  gmm_wfp8a16              gmm_wfp8a16 (the aligned compaction around K21)
  _dequant_w_fp8_block     _dequant_w_fp8_block

`batch_matmul_transpose` ([m, b, k] x [b, k, n] -> [m, b, n], the
reference's batch_matmul_transpose and catlass_matmul_basic) is a plain
batched product with f32 sums, as the JAX package's is an XLA einsum.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..utils import cdiv, index_copy_kept_, use_kernel

_BK, _BN = 64, 128       # the K granule every W8A8 kernel takes; a pretiled panel's
# width granule (the 128-column TMA box of csrc/w8a8_wgmma.cuh's 128-row tiles)
# A: x, w, x_scale, w_scale, out, partials, arrivals, M, N, K, li, bm, splits,
# out_f32, stream; K1: x, w, x_scale, w_scale, out, partials, arrivals, M, N,
# K, li, bn, bm, splits, out_f32, stream; K8: x, w, x_scale, w_scale, out,
# partials, arrivals, eid, M, N, K, G, bn, block_m, bm, splits, out_f32, stream
_ARGTYPES = {
    "w8a8_gemm": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "w8a8_gemm_tiled": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "w8a8_gemm_grouped": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
}
# The int8 stage of csrc/w8a8_wgmma.cuh (A, K1, K8, and K2 after its row
# pass): 256-column tiles of 128 rows (wgmma; 16 rows and mma.sync for M <=
# 32 and K8's block_m not a multiple of 128), K in stages of 128 bytes (64
# at 16 rows), split at most 16 ways and into no less than 256 of K a split
GEMM_BN = 256
GEMM_MIN_SPLIT_K = 256
GEMM_MAX_SPLITS = 16


def gemm_kstep(bm: int) -> int:
    """The K bytes of one stage of the int8 stage with row tiles of bm."""
    return 64 if bm == 16 else 128


def gemm_plan(m: int, n: int, k: int, sms: int, block_m: int = 0):
    """(bm, tiles_m, tiles_n, splits) of the int8 stage (A, K1, K2; K8 given
    its block_m) on a card of `sms` SMs: output tiles of bm x 256, and K
    split over blocks where the tiles alone leave SMs idle, each split at
    least GEMM_MIN_SPLIT_K of K. The last split of a tile reads the others'
    partials into one SM: 16 KB each for 16-row tiles, so those split to
    fill one wave of the card; 128 KB for 128-row tiles (about 1.1 us each
    on an H100), so those split to fill half of it (K1's wo and w2 and K2's
    per_tensor shapes 11-25% faster than a whole wave on an H100: PERF.md).
    Up to M 32 the rows take 16-row tiles, two past M 16: a 128-row tile
    there computes rows it drops and merges 128 KB partials (PERF.md).
    K8's row tiles must not straddle two experts: a block_m that is a
    multiple of 128 (the MoE layer's aligned compaction) takes 128-row
    tiles, any other (Qwen's 32) 16-row ones. The plan depends on the shape
    alone, never on which tiles are padding."""
    if block_m:
        bm = 128 if block_m % 128 == 0 else 16
    else:
        bm = 16 if m <= 32 else 128
    tiles_m, tiles_n = cdiv(m, bm), cdiv(n, GEMM_BN)
    kstep = gemm_kstep(bm)
    ksteps = cdiv(k, kstep)
    fill = sms if bm == 16 else sms // 2
    splits = max(1, min(GEMM_MAX_SPLITS, fill // (tiles_m * tiles_n),
                        ksteps // (GEMM_MIN_SPLIT_K // kstep)))
    return bm, tiles_m, tiles_n, splits


def gemm_scratch(bm: int, tiles_m: int, tiles_n: int, splits: int):
    """(int32 partials, arrival counters) that a plan of the int8 stage
    needs: none unsplit; split, every split's bm x 256 sums of every tile
    and one counter a tile."""
    if splits == 1:
        return 0, 0
    return tiles_m * tiles_n * splits * bm * GEMM_BN, tiles_m * tiles_n


def gemm_split_bounds(ksteps: int, splits: int):
    """[(k0, k1), ...]: the K stages that each split of a tile sums, in
    order, as the kernel takes them."""
    return [(ksteps * s // splits, ksteps * (s + 1) // splits) for s in range(splits)]


def quant_matmul_int8_ref(x_q, w_q, x_scale, w_scale, out_dtype=torch.bfloat16):
    """out = (x_q @ w_q) * x_scale * w_scale.

    x_q [M, K] int8, w_q [K, N] int8, x_scale [M, 1] f32, w_scale [N] f32.
    The product runs in float64: every partial sum is an integer below 2**53,
    so it is exact in any order (an int8 product would wrap, and CUDA has no
    int32 matmul); the f64 -> f32 step rounds as int32 -> f32 does."""
    acc = (x_q.double() @ w_q.double()).float()
    return (acc * x_scale.float() * w_scale.float()[None, :]).to(out_dtype)


def quant_matmul_int8(x_q, w_q, x_scale, w_scale, out_dtype=torch.bfloat16):
    """W8A8 GEMM on a plain weight: x_q [M, K] int8, w_q [K, N] int8, x_scale
    [M, 1] f32, w_scale [N] f32 -> [M, N] (the JAX package's
    quant_matmul_int8 without its bias, which no caller of the port passes).

    The JAX package takes its Pallas kernel (quant_matmul_int8_pallas) for
    M >= 8, its reference otherwise. On the card the port launches kernel A
    for every M, on the weight viewed as a one-layer bank, counted under
    "w8a8_gemm_l1": the int32 sum is exact, so both give the same numbers."""
    if use_kernel(x_q):
        return _w8a8_gemm(x_q, w_q[None], 0, x_scale, w_scale.reshape(1, -1),
                          out_dtype, counter="w8a8_gemm_l1")
    return quant_matmul_int8_ref(x_q, w_q, x_scale, w_scale, out_dtype)


def pretile_weight_bank(w_q_stacked, block_n: int = 512):
    """[L, K, N] -> a contiguous [L, N/bn, K, bn] copy: panel j of layer li,
    the columns j*bn .. (j+1)*bn, is one contiguous [K, bn] block, so a block
    of output columns streams its weights from one contiguous range."""
    l, k, n = w_q_stacked.shape
    if n % block_n:
        raise ValueError(f"pretile_weight_bank: N={n} is not a multiple of {block_n}")
    return w_q_stacked.reshape(l, k, n // block_n, block_n).permute(0, 2, 1, 3).contiguous()


def untile_weight_bank(w_tiled):
    """[L, NB, K, bn] -> [L, K, N] (inverse of pretile_weight_bank)."""
    l, nb, k, bn = w_tiled.shape
    return w_tiled.permute(0, 2, 1, 3).reshape(l, k, nb * bn)


def quant_matmul_int8_stacked(x_q, w_q_stacked, li: int, x_scale,
                              w_scale_stacked, out_dtype=torch.bfloat16):
    """Layer li of a stacked bank: x_q [M, K] int8, w_q_stacked [L, K, N] int8
    or pretiled [L, N/bn, K, bn] int8, x_scale [M, 1] f32, w_scale_stacked
    [L, N] f32 -> [M, N]."""
    if w_q_stacked.dim() == 4:
        return quant_matmul_int8_stacked_tiled(x_q, w_q_stacked, li, x_scale,
                                               w_scale_stacked, out_dtype)
    if use_kernel(x_q):
        return _w8a8_gemm(x_q, w_q_stacked, li, x_scale, w_scale_stacked,
                          out_dtype)
    return quant_matmul_int8_ref(x_q, w_q_stacked[li], x_scale,
                                 w_scale_stacked[li], out_dtype=out_dtype)


def quant_matmul_int8_stacked_tiled_ref(x_q, w_tiled, li: int, x_scale,
                                        w_scale_stacked, out_dtype=torch.bfloat16):
    """Plain version of kernel K1: layer li untiled, then quant_matmul_int8_ref."""
    w = untile_weight_bank(w_tiled[li:li + 1])[0]
    return quant_matmul_int8_ref(x_q, w, x_scale, w_scale_stacked[li],
                                 out_dtype=out_dtype)


def quant_matmul_int8_stacked_tiled(x_q, w_tiled, li: int, x_scale,
                                    w_scale_stacked, out_dtype=torch.bfloat16):
    """W8A8 GEMM over a pretiled [L, N/bn, K, bn] bank at layer li.

    The JAX package takes its Pallas kernel for M >= 8 and, below, slices
    layer li, untiles it and takes its reference dot (matmul.py:233-242). On
    the card the port launches kernel K1 for every M: the product is exact
    in int32 and the epilogue multiplies in the same order, so the result is
    the same."""
    if use_kernel(x_q):
        return _w8a8_gemm(x_q, w_tiled, li, x_scale, w_scale_stacked, out_dtype)
    return quant_matmul_int8_stacked_tiled_ref(x_q, w_tiled, li, x_scale,
                                               w_scale_stacked, out_dtype)


def _w8a8_gemm(x_q, w, li, x_scale, w_scale, out_dtype, counter=None, eid=None,
               block_m=0):
    """Launch kernel A (bank [L, K, N]: one panel, bn = N) or K1 (pretiled
    bank [L, NB, K, bn]) at layer li or, given the expert map `eid` of each
    block_m-row tile, K8 (either bank), all on the int8 stage of
    csrc/w8a8_wgmma.cuh with `gemm_plan`'s tiles and split. Adds one to the
    launch count `counter` (default: the kernel's)."""
    tiled = w.dim() == 4
    grouped = eid is not None
    name = ("w8a8_gemm_grouped" if grouped else "w8a8_gemm_tiled" if tiled
            else "w8a8_gemm")
    m, k = x_q.shape
    if tiled:
        l, nb, k2, bn = w.shape
        n = nb * bn
    else:
        l, k2, n = w.shape
        bn = n
    dev = x_q.device
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} writes bf16 or f32, not {out_dtype}")
    if (x_q.dtype, w.dtype) != (torch.int8, torch.int8):
        raise TypeError(f"{name} takes int8 operands, got {x_q.dtype}, {w.dtype}")
    if (k2 != k or k % _BK or n % 16 or not 0 <= li < l
            or (tiled and bn % _BN) or (grouped and (block_m <= 0 or block_m % 32))):
        raise ValueError(f"{name}: x {tuple(x_q.shape)}, bank {tuple(w.shape)}, "
                         f"li={li}: needs K % {_BK} == 0, N % 16 == 0"
                         + (f", bn % {_BN} == 0" if tiled else "")
                         + (", block_m % 32 == 0" if grouped else ""))
    xs = x_scale.reshape(m).float().contiguous()
    ws = w_scale.float().contiguous()
    _build.check_operands(name, dev, x_q, w, xs, ws, *((eid,) if grouped else ()))
    if ws.shape != (l, n):
        raise ValueError(f"{name}: weight scales {tuple(ws.shape)} != {(l, n)}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    fn = _build.launcher(name, _ARGTYPES[name])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x_q.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(), out.data_ptr())
    out_f32 = int(out_dtype == torch.float32)
    bm, tiles_m, tiles_n, splits = gemm_plan(
        m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count, block_m)
    n_part, n_arrivals = gemm_scratch(bm, tiles_m, tiles_n, splits)
    part = arrivals = None
    if splits > 1:
        part = torch.empty(n_part, dtype=torch.int32, device=dev)
        arrivals = _build.arrival_counters(name, dev, n_arrivals)
    if grouped:
        code = fn(*ptrs, _ptr(part), _ptr(arrivals), eid.data_ptr(), m, n, k, l, bn, block_m,
                  bm, splits, out_f32, stream)
    else:
        panel = (bn,) if tiled else ()
        code = fn(*ptrs, _ptr(part), _ptr(arrivals), m, n, k, li, *panel, bm, splits,
                  out_f32, stream)
    _build.check(name, code)
    _build.launches[counter or name] += 1
    return out


def _ptr(t):
    return t.data_ptr() if t is not None else None


# ------------------------------------------------------------ grouped W8A8 (K8)


def _bank_kn(w_q, g):
    """Expert g (an int or a 0-d tensor) of a [G, K, N] or pretiled
    [G, N/bn, K, bn] bank as [K, N] (a copy)."""
    one = w_q.index_select(0, torch.as_tensor(g, device=w_q.device).reshape(1))
    return untile_weight_bank(one)[0] if w_q.dim() == 4 else one[0]


def grouped_matmul_int8_ref(x_q, w_q, x_scale, w_scale, group_list,
                            out_dtype=torch.bfloat16):
    """The JAX package's ragged reference (matmul.py:457): rows are grouped
    tightly, group g's group_list[g] rows after the rows of groups < g, and
    take expert g's weights; rows past the last group give zeros (their
    expert id is clipped to G - 1, as there). x_q [S, K] int8, w_q [G, K, N]
    or pretiled, x_scale [S, 1] f32, w_scale [G, N] f32, group_list [G]
    counts. Plain PyTorch; it reads the counts on the host."""
    s = x_q.shape[0]
    g_count = w_scale.shape[0]
    ends = torch.cumsum(group_list.long(), 0)
    acc = torch.zeros((s, w_scale.shape[1]), dtype=torch.float64, device=x_q.device)
    start = 0
    for g, end in enumerate(ends.tolist()):
        end = min(end, s)
        if end > start:
            acc[start:end] = x_q[start:end].double() @ _bank_kn(w_q, g).double()
        start = max(start, end)
    row_e = torch.searchsorted(ends, torch.arange(s, device=x_q.device), right=True)
    row_ws = w_scale.float()[row_e.clamp(0, g_count - 1)]
    return (acc.float() * x_scale.float() * row_ws).to(out_dtype)


def grouped_matmul_int8_tiles_ref(x_q, w_q, x_scale, w_scale, expert_per_mtile,
                                  block_m: int, out_dtype=torch.bfloat16):
    """Plain version of kernel K8: row tile i (block_m rows) times expert
    expert_per_mtile[i] (clamped to [0, G), as the kernel clamps it), through
    quant_matmul_int8_ref. One product per tile: no yardstick of speed."""
    m = x_q.shape[0]
    g_count = w_scale.shape[0]
    out = torch.empty((m, w_scale.shape[1]), dtype=out_dtype, device=x_q.device)
    eid = expert_per_mtile.long().clamp(0, g_count - 1)
    for i in range(m // block_m):
        rows = slice(i * block_m, (i + 1) * block_m)
        out[rows] = quant_matmul_int8_ref(x_q[rows], _bank_kn(w_q, eid[i]), x_scale[rows],
                                          w_scale[eid[i]], out_dtype)
    return out


def grouped_matmul_int8(x_q, w_q, x_scale, w_scale, expert_per_mtile, block_m: int = 32,
                        out_dtype=torch.bfloat16):
    """Grouped W8A8 GEMM with a per-m-tile expert map (the contract of the
    JAX package's grouped_matmul_int8_pallas, matmul.py:475-563):

      out[rows of tile i] = (x_q[tile i] @ w_q[e]) * x_scale * w_scale[e],
      e = expert_per_mtile[i]

    x_q [M, K] int8 with M % block_m == 0 (the aligned compaction pads each
    expert's rows to block_m), w_q [G, K, N] or pretiled [G, N/bn, K, bn]
    int8, x_scale [M, 1] f32 (0 on padding rows, which then give zeros),
    w_scale [G, N] f32, expert_per_mtile [M / block_m] int32 -> [M, N].

    On the card: kernel K8 (block_m a multiple of 32; 128-row wgmma tiles
    where it is a multiple of 128, 16-row mma.sync tiles otherwise), counted
    under "w8a8_gemm_grouped". On the CPU: grouped_matmul_int8_tiles_ref."""
    m = x_q.shape[0]
    if block_m <= 0 or m % block_m or expert_per_mtile.shape != (m // block_m,):
        raise ValueError(f"grouped_matmul_int8: M={m} needs block_m={block_m} tiles and "
                         f"one expert id each, got {tuple(expert_per_mtile.shape)}")
    if not use_kernel(x_q):
        return grouped_matmul_int8_tiles_ref(x_q, w_q, x_scale, w_scale, expert_per_mtile,
                                             block_m, out_dtype)
    return _w8a8_gemm(x_q, w_q, 0, x_scale, w_scale, out_dtype,
                      eid=expert_per_mtile.to(torch.int32).contiguous(), block_m=block_m)


# ------------------------------------------------ soft-FP8 W8A16 (K21)

FP8_BLOCK = 128          # the weights' scale block, 128 x 128
# x, w, w_scale, eid, m_live, out, workspace, M, N, K, G, block_m, bm, splits,
# stream
_FP8_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _dequant_w_fp8_block(w_fp8, w_scale, block: int = FP8_BLOCK):
    """[K, N] fp8 + [ceil(K/b), ceil(N/b)] f32 -> bf16 [K, N]: each value
    times its block's scale in f32, rounded once to bf16 (zero-padded to
    block multiples, as the JAX package pads)."""
    k, n = w_fp8.shape
    sk, sn = w_scale.shape
    w = torch.zeros((sk * block, sn * block), dtype=torch.float32, device=w_fp8.device)
    w[:k, :n] = w_fp8.float()
    w = w.reshape(sk, block, sn, block) * w_scale.float()[:, None, :, None]
    return w.reshape(sk * block, sn * block)[:k, :n].to(torch.bfloat16)


def mm_wfp8a16_ref(x, w_fp8, w_scale, block: int = FP8_BLOCK):
    """Plain version of K21: bf16 x [M, K] times fp8 w [K, N] with f32
    scales [ceil(K/128), ceil(N/128)] -> bf16 [M, N], in the TPU kernel's
    block order: the bf16 weights of each 128-row K block, an f32 product
    per block, the partial sums added in f32 across K blocks."""
    w = _dequant_w_fp8_block(w_fp8, w_scale, block).float()
    xf = x.to(torch.bfloat16).float()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, w.shape[0], block):
        acc += xf[:, k0:k0 + block] @ w[k0:k0 + block]
    return acc.to(torch.bfloat16)


def mm_wfp8a16(x, w_fp8, w_scale, block: int = FP8_BLOCK):
    """Soft-FP8 GEMM: bf16 x [M, K] times fp8 e4m3 w [K, N] with f32 scales
    per 128 x 128 block [ceil(K/128), ceil(N/128)] -> bf16 [M, N].

    The JAX package takes its Pallas kernel (mm_wfp8a16_pallas) for K and N
    multiples of 128, its reference otherwise. On the card the port launches
    K21 for every shape (it zero-pads a ragged K or N inside the tile, as
    _dequant_w_fp8_block pads), counted under "wfp8a16_gemm"; on the CPU,
    mm_wfp8a16_ref."""
    if use_kernel(x):
        return _wfp8a16_gemm(x, w_fp8[None], w_scale[None], None, 0, block)
    return mm_wfp8a16_ref(x, w_fp8, w_scale, block)


def gmm_wfp8a16_ref(x, w_fp8, w_scale, group_list, block: int = FP8_BLOCK):
    """Grouped soft-FP8 GEMM over group sizes (the JAX package's ragged
    reference): x [S, K], w [G, K, N] fp8, scales [G, K/128, N/128],
    group_list [G] row counts; group g's rows follow those of groups < g
    and take w[g]; rows past sum(group_list) give zeros. mm_wfp8a16_ref per
    group; it reads the counts on the host."""
    s = x.shape[0]
    out = torch.zeros((s, w_fp8.shape[2]), dtype=torch.bfloat16, device=x.device)
    start = 0
    for g, end in enumerate(torch.cumsum(group_list.long(), 0).tolist()):
        end = min(end, s)
        if end > start:
            out[start:end] = mm_wfp8a16_ref(x[start:end], w_fp8[g], w_scale[g], block)
        start = max(start, end)
    return out


def gmm_wfp8a16_aligned_ref(x, w_fp8, w_scale, expert_per_mtile, block: int = FP8_BLOCK,
                            block_m: int = 128):
    """Plain version of K21's grouped contract: row tile i (block_m rows)
    times expert expert_per_mtile[i] (clamped to [0, G), as the kernel
    clamps it), through mm_wfp8a16_ref, one product per expert."""
    g_count, _, n = w_fp8.shape
    eid = expert_per_mtile.long().clamp(0, g_count - 1)
    out = torch.empty((x.shape[0], n), dtype=torch.bfloat16, device=x.device)
    lanes = torch.arange(block_m, device=x.device)
    for e in torch.unique(eid).tolist():
        rows = ((eid == e).nonzero()[:, 0, None] * block_m + lanes).reshape(-1)
        out[rows] = mm_wfp8a16_ref(x[rows], w_fp8[e], w_scale[e], block)
    return out


def gmm_wfp8a16_aligned(x, w_fp8, w_scale, expert_per_mtile, block: int = FP8_BLOCK,
                        block_m: int = 128):
    """The contract of the JAX package's gmm_wfp8a16_pallas_aligned: every
    block_m-row tile of x [M, K] bf16 (M % block_m == 0) takes the weights
    of expert expert_per_mtile[i] of w [G, K, N] fp8 with scales [G,
    ceil(K/128), ceil(N/128)] f32 -> bf16 [M, N]. K21 on the card (block_m
    a multiple of 32; any K and N), counted under "wfp8a16_gemm_grouped";
    gmm_wfp8a16_aligned_ref on the CPU."""
    m = x.shape[0]
    if block_m <= 0 or m % block_m or expert_per_mtile.shape != (m // block_m,):
        raise ValueError(f"gmm_wfp8a16_aligned: M={m} needs block_m={block_m} tiles and "
                         f"one expert id each, got {tuple(expert_per_mtile.shape)}")
    if use_kernel(x):
        return _wfp8a16_gemm(x, w_fp8, w_scale, expert_per_mtile, block_m, block)
    return gmm_wfp8a16_aligned_ref(x, w_fp8, w_scale, expert_per_mtile, block, block_m)


def gmm_wfp8a16(x, w_fp8, w_scale, group_list, block: int = FP8_BLOCK, block_m: int = 128):
    """Grouped soft-FP8 GEMM over group sizes, as gmm_wfp8a16_ref, through
    the aligned compaction of the JAX package's gmm_wfp8a16 with no host
    sync: each group's rows move to a block_m-aligned run of a zeroed
    [mpad, K] buffer (mpad the static bound G*block_m + ceil(S/block_m)*
    block_m), gmm_wfp8a16_aligned runs on the per-tile expert map, and the
    rows are gathered back. Rows past sum(group_list) are dropped from the
    buffer and give zeros, as gmm_wfp8a16_ref gives (the JAX Pallas tier
    gives them expert G-1's product). The tiles past the last group's are
    written as zeros on the card without reading weights."""
    s, k = x.shape
    g_count = w_fp8.shape[0]
    dev = x.device
    sizes = group_list.to(device=dev, dtype=torch.long)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    offsets = torch.cat([zero, torch.cumsum(sizes, 0)])
    aligned = torch.div(sizes + block_m - 1, block_m, rounding_mode="floor") * block_m
    a_off = torch.cat([zero, torch.cumsum(aligned, 0)])
    mpad = g_count * block_m + cdiv(s, block_m) * block_m
    r = torch.arange(s, device=dev)
    row_e = torch.searchsorted(offsets[1:], r, right=True).clamp(0, g_count - 1)
    keep = r < offsets[-1]
    slot = (a_off[row_e] + r - offsets[row_e]).clamp(0, mpad - 1)
    xp = torch.zeros((mpad, k), dtype=torch.bfloat16, device=dev)
    index_copy_kept_(xp, slot, x.to(torch.bfloat16), keep)
    starts = torch.arange(mpad // block_m, device=dev) * block_m
    tile_e = torch.searchsorted(a_off[1:], starts, right=True).clamp(0, g_count - 1)
    tile_e = tile_e.to(torch.int32)
    if use_kernel(x):
        live = a_off[-1:].to(torch.int32)
        yp = _wfp8a16_gemm(xp, w_fp8, w_scale, tile_e, block_m, block, m_live=live)
    else:
        yp = gmm_wfp8a16_aligned_ref(xp, w_fp8, w_scale, tile_e, block, block_m)
    return torch.where(keep[:, None], yp[slot], 0.0).to(torch.bfloat16)


def _wfp8a16_tiling(m, n, k, block_m, device):
    """K21's row tile and its split of K. The tile: 256 rows from M 512 up,
    128 from M 65, else 64, where it divides the expert map's block_m (a
    grouped tile steps by gcd(block_m, tile) rows, so that it never spans two
    experts). The split: the tiles that fill whole waves of the card's SMs
    run unsplit; the rest (every tile, where there are fewer than the SMs)
    split K over as many blocks as one wave holds, at least 256 of K each
    (f32 partial sums added in a fixed order). Returns (tile, tail tiles,
    splits); the kernel derives the same tail from the same SM count."""
    bm = 64
    if m >= 512 and block_m % 256 == 0:
        bm = 256
    elif m > 64 and block_m % 128 == 0:
        bm = 128
    tiles = cdiv(m, math.gcd(block_m, bm)) * cdiv(n, 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tail = tiles % sms if tiles >= sms else tiles
    return bm, tail, max(1, min(sms // tail, cdiv(k, 256))) if tail else 1


def _wfp8a16_gemm(x, w, ws, eid, block_m, block, m_live=None):
    """Launch K21: x [M, K] bf16 times bank w [G, K, N] fp8 e4m3 with scales
    ws [G, ceil(K/128), ceil(N/128)] f32; row tile i of block_m rows takes
    expert eid[i] (eid None: expert 0 for every row, the dense export).
    m_live: an optional 1-element int32 tensor; tiles from that row on are
    written as zeros. Counted under "wfp8a16_gemm" (dense) or
    "wfp8a16_gemm_grouped"."""
    name = "wfp8a16_gemm" if eid is None else "wfp8a16_gemm_grouped"
    m, k = x.shape
    g_count, k2, n = w.shape
    if block != FP8_BLOCK:
        raise ValueError(f"{name}: scale blocks of {FP8_BLOCK} only, not {block}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.float8_e4m3fn:
        raise TypeError(f"{name} takes bf16 x and float8_e4m3fn w, got {x.dtype}, {w.dtype}")
    if ws.dtype != torch.float32:
        raise TypeError(f"{name}: f32 scales expected, got {ws.dtype}")
    if k2 != k or ws.shape != (g_count, cdiv(k, block), cdiv(n, block)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, scales "
                         f"{tuple(ws.shape)} do not match")
    if eid is not None and (block_m % 32 or eid.dtype != torch.int32):
        raise ValueError(f"{name}: needs block_m % 32 == 0 and an int32 expert map")
    dev = x.device
    extra = [t for t in (eid, m_live) if t is not None]
    _build.check_operands(name, dev, x, w, ws, *extra)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0 or n == 0:
        return out
    bm, tail, splits = _wfp8a16_tiling(m, n, k, block_m if eid is not None else 256, dev)
    work = (torch.empty((splits, tail, bm, 128), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    fn = _build.launcher(name, _FP8_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(x.data_ptr(), w.data_ptr(), ws.data_ptr(),
              None if eid is None else eid.data_ptr(),
              None if m_live is None else m_live.data_ptr(), out.data_ptr(),
              None if work is None else work.data_ptr(),
              m, n, k, g_count, block_m if eid is not None else m, bm, splits, stream)
    _build.check(name, code)
    _build.launches[name] += 1
    return out


# --------------------------------------------------------- batch_matmul_transpose


def batch_matmul_transpose(x, w, out_dtype=None):
    """[m, b, k] x [b, k, n] -> [m, b, n] (einsum 'mbk,bkn->mbn'), the
    products and sums in f32 (TF32 off on the card, PyTorch's default), the
    result in `out_dtype` (default x's dtype)."""
    out = torch.einsum("mbk,bkn->mbn", x.float(), w.float())
    return out.to(out_dtype or x.dtype)
