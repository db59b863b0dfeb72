"""The single-launch fused MoE layer (counterpart of the JAX package's
parallel/strategies/fused_moe_pallas.py, one Pallas call per shard).

`fused_moe_layer` takes the chunk-aligned bf16 send buffer and the five
int32 tables, each [R*El]:
  send_cnt   rows I send per (dst, e) slice
  src_off    chunk-aligned offsets of my slices in x_send
  dst_off    slot offsets in the receiver's window
  recv_cnt   rows I receive per (src, e) (layout_range)
  back_off   where my returned rows land in each source's back buffer
and computes, as the TPU kernel does:
  phase S  every chunk of CHUNK rows of my slices is quantised to int8
           (scale = max(absmax, 1e-7) * f32(1/127), rint) into its
           destination's receive window recv [El*R*maxT, H] with one f32
           scale per row in rs [El*R*maxT] (the JAX kernel's 128-lane scale
           tile carries the same value in every lane);
  experts  every row of expert e's window: GMM1 with int32 sums, dequantised
           as (acc * rs[row]) * w13_scale[e] in f32, then g * sigmoid(g) * u,
           a per-row int8 requantisation by the same rule, GMM2 dequantised
           as (acc * scale) * w2_scale[e] to bf16;
  phase C  the output rows go back, chunk by chunk, to back [sbuf, H] bf16 of
           their source rank, only chunks whose first row is below recv_cnt.
recv, rs and back start as zeros. The weighted sum over the top-k copies
(`combine_copies`) stays PyTorch, as it is XLA in the JAX package.

On a CUDA tensor it launches kernel K11 (csrc/fused_moe.cu) once, for one
rank (more ranks raise: its pointer table holds no peer windows on other
cards yet). On a CPU tensor it runs `fused_moe_layer_ref`: the scatter's
plain version for phases S and C (through the EPGroup, so any number of
ranks) around `expert_rows_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...ops.matmul import quant_matmul_int8_ref
from ...ops.quant import per_token_quant_int8
from ...utils import cdiv, use_kernel
from .low_latency import _window_offsets
from .pallas_ll import (
    CHUNK,
    _send_layout,
    check_chunk_aligned,
    combine_copies,
    remote_scatter_ref,
    send_buffer,
)

# K11's tiles (csrc/fused_moe.cu): the int8 stage's 128 x 256 wgmma tile (a
# window's last m-tile may be partial), and the rows of a requantisation item
TILE_M, TILE_N, RQ_ROWS = 128, 256, 16
# x_send, w13, w13s, w2, w2s, send_cnt, src_off, dst_off, recv_cnt, back_off,
# recv, rs, back, ug, act, asc, ctr, R, El, maxT, H, F, sbuf, stream
_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def expert_rows_ref(recv, rs, w13_q, w13_scale, w2_q, w2_scale):
    """The expert phase on every row of the receive windows: recv
    [El*rows, H] int8 with rs [El*rows] f32, expert e's rows the e-th block.
    Returns (y [El*rows, H] bf16, act_q [El*rows, F] int8, act_scale
    [El*rows] f32), the requantised activation being what GMM2 reads."""
    el, h, f2 = w13_q.shape
    rows = recv.shape[0] // el
    ys, qs, ss = [], [], []
    for e in range(el):
        blk = slice(e * rows, (e + 1) * rows)
        ug = quant_matmul_int8_ref(recv[blk], w13_q[e], rs[blk, None], w13_scale[e],
                                   out_dtype=torch.float32)
        g, u = ug[:, : f2 // 2], ug[:, f2 // 2:]
        aq, asc = per_token_quant_int8(g * torch.sigmoid(g) * u)
        ys.append(quant_matmul_int8_ref(aq, w2_q[e], asc, w2_scale[e]))
        qs.append(aq)
        ss.append(asc[:, 0])
    return torch.cat(ys), torch.cat(qs), torch.cat(ss)


def fused_moe_layer_ref(x_send, w13_q, w13_scale, w2_q, w2_scale, send_cnt, src_off,
                        dst_off, recv_cnt, back_off, *, group, maxt):
    """Plain version of K11 (module docstring). Returns (recv, rs, back)."""
    el = w13_q.shape[0]
    rows = el * group.num_ranks * maxt
    recv, rs = remote_scatter_ref(x_send, None, send_cnt, src_off, dst_off, recv_cnt,
                                  group=group, slices_per_rank=el, out_rows=rows,
                                  quantize=True)
    y = expert_rows_ref(recv, rs, w13_q, w13_scale, w2_q, w2_scale)[0]
    back, _ = remote_scatter_ref(y, None, recv_cnt,
                                 _window_offsets(group.num_ranks, el, maxt, y.device), back_off, send_cnt, group=group, slices_per_rank=el,
                                 out_rows=x_send.shape[0])
    return recv, rs, back


def k11_items(el, maxt, h, f, sbuf, ranks=1):
    """K11's work list at these widths (csrc/fused_moe.cu, in its order):
    ({phase: items}, the int32 counters it keeps: the item counter, one
    arrival count per expert, then per (expert, m-tile) its GMM1 tiles done
    and its requant items done)."""
    mt = cdiv(ranks * maxt, TILE_M)
    items = {"send": cdiv(sbuf, CHUNK), "gmm1": el * cdiv(2 * f, TILE_N) * mt,
             "requant": el * mt * (TILE_M // RQ_ROWS), "gmm2": el * cdiv(h, TILE_N) * mt}
    return items, 1 + el + 2 * el * mt


def _fused_moe_cuda(x_send, w13_q, w13_scale, w2_q, w2_scale, tables, *, maxt):
    sbuf, h = x_send.shape
    el, _, f2 = w13_q.shape
    f = f2 // 2
    dev = x_send.device
    if x_send.dtype != torch.bfloat16 or (w13_q.dtype, w2_q.dtype) != (torch.int8, torch.int8):
        raise TypeError("fused_moe takes a bf16 send buffer and int8 expert weights")
    if w13_q.shape[1] != h or tuple(w2_q.shape) != (el, f, h) or h % 128 or f % 64:
        raise ValueError(f"fused_moe: H={h}, F={f}, w13 {tuple(w13_q.shape)}, "
                         f"w2 {tuple(w2_q.shape)}: needs H % 128 and F % 64")
    check_chunk_aligned(maxt)
    rows = el * maxt
    w13s = w13_scale.float().contiguous()
    w2s = w2_scale.float().contiguous()
    tables = [t.reshape(-1).to(torch.int32).contiguous() for t in tables]
    recv = torch.zeros((rows, h), dtype=torch.int8, device=dev)
    rs = torch.zeros((rows,), dtype=torch.float32, device=dev)
    back = torch.zeros((sbuf, h), dtype=torch.bfloat16, device=dev)
    # scratch: the f32 GMM1 output, the requantised activation and its
    # scales, the work and dependency counters (zeroed in the launch)
    ug = torch.empty((rows, f2), dtype=torch.float32, device=dev)
    act = torch.empty((rows, f), dtype=torch.int8, device=dev)
    asc = torch.empty((rows,), dtype=torch.float32, device=dev)
    ctr = torch.empty((k11_items(el, maxt, h, f, sbuf)[1],), dtype=torch.int32, device=dev)
    ops = (x_send, w13_q, w13s, w2_q, w2s, *tables, recv, rs, back, ug, act, asc, ctr)
    _build.check_operands("fused_moe", dev, *ops)
    fn = _build.launcher("fused_moe", _ARGTYPES)
    code = fn(*(t.data_ptr() for t in ops), 1, el, maxt, h, f, sbuf,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_moe", code)
    _build.launches["fused_moe"] += 1
    return recv, rs, back


def fused_moe_layer(x_send, w13_q, w13_scale, w2_q, w2_scale, send_cnt, src_off, dst_off,
                    recv_cnt, back_off, *, group, maxt):
    """One launch of the fused MoE layer (module docstring): -> (recv [El*R*maxT,
    H] int8, rs [El*R*maxT] f32, back [sbuf, H] bf16)."""
    if use_kernel(x_send):
        if group.num_ranks > 1:
            raise NotImplementedError(
                "fused_moe on the card runs one rank: its pointer table holds no peer "
                "windows on other cards yet")
        return _fused_moe_cuda(x_send, w13_q, w13_scale, w2_q, w2_scale,
                               (send_cnt, src_off, dst_off, recv_cnt, back_off), maxt=maxt)
    return fused_moe_layer_ref(x_send, w13_q, w13_scale, w2_q, w2_scale, send_cnt, src_off,
                               dst_off, recv_cnt, back_off, group=group, maxt=maxt)


def fused_deep_moe_pallas_shard(x, topk_idx, topk_weights, w13_q, w13_scale, w2_q, w2_scale,
                                *, group, num_experts, num_max_dispatch_tokens_per_rank):
    """This rank's fused MoE layer through one launch: x [T, H] bf16,
    w13_q [El, H, 2F] int8 (+[El, 2F] scales), w2_q [El, F, H] int8
    (+[El, H] scales) -> [T, H] bf16. The routing and the chunk-aligned send
    layout are those of the "pallas" strategy."""
    t, h = x.shape
    k = topk_idx.shape[1]
    r = group.num_ranks
    el = num_experts // r
    maxt = num_max_dispatch_tokens_per_rank
    assert t <= maxt
    check_chunk_aligned(maxt)
    tok, copy_slot, counts, _, aligned_offsets, aligned_pos, sbuf = _send_layout(
        topk_idx, r, el, maxt)
    x_send = send_buffer(x[tok], aligned_pos, sbuf)

    # the count exchange and the reverse landing offsets
    recv_counts = group.all_to_all(counts.reshape(r, el)).reshape(-1)
    their_aligned = group.all_to_all(aligned_offsets.reshape(r, el)).reshape(-1)
    dst_off = _window_offsets(r, el, maxt, x.device, group.rank)
    _, _, back = fused_moe_layer(x_send, w13_q, w13_scale, w2_q, w2_scale, counts,
                                 aligned_offsets, dst_off, recv_counts, their_aligned,
                                 group=group, maxt=maxt)
    return combine_copies(back, copy_slot, aligned_pos, sbuf, topk_idx, topk_weights,
                          t, k, x.dtype)
