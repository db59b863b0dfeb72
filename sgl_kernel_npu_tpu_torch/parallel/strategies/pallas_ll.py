"""The "pallas" low-latency strategy: dispatch and combine through one
chunked ragged scatter kernel (counterpart of the JAX package's
parallel/strategies/pallas_ll.py, whose Pallas kernel writes into peer
windows by remote DMA and waits on semaphores).

`_remote_scatter`: slice i (dst rank i // slices_per_rank) moves send_cnt[i]
rows from x[src_off[i]:] into the dst rank's out[dst_off[i]:], in CHUNK-row
pieces (a slice's last chunk carries the rows after it up to the chunk's
end). The destination rows start as zeros, as in the JAX kernel
(interpreted with uninitialized_memory="zero"): the combine multiplies
padding rows by weight 0, and a NaN there would poison the sum. Scales, when
given, ride along. quantize=True quantises each moved row to int8 in the
kernel: scale = max(absmax, 1e-7) * f32(1/127), q = rint(x / scale)
clipped to [-128, 127] (so a zero padding row of a live chunk has scale
1e-7/127, a row never written scale 0). The JAX kernel keeps a 128-lane f32
scale tile per row; the port keeps one f32 per row.

On a CUDA tensor it launches kernel K12 (csrc/remote_scatter.cu) for one
rank, where the receive wait is the end of the launch; the kernel
addresses its destination through a per-rank pointer table with one entry.
It walks the window by `scatter_row_map`: each window row takes one
source row (data, quantised or not) or is zero, so the wrapper hands it
uninitialised outputs.
More ranks on the card raise until the table holds peer windows on the other
cards. On a CPU tensor it runs `remote_scatter_ref`, which moves the chunks
through the EPGroup's ragged all_to_all, so it serves any number of ranks
(gloo).

Dispatch launches it once (quantising in int8 mode), combine once (bf16,
no scales).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...ops.quant import per_token_quant_int8
from ...utils import use_kernel
from ..strategy import register_low_latency_strategy
from .low_latency import (
    DefaultLowLatencyCommStrategy,
    LowLatencyDispatchResult,
    LowLatencyHandle,
    _exclusive_cumsum,
    _route_copies,
    _sorted_copies,
    _token_of_slot,
    _weighted_sum,
    _window_offsets,
)

CHUNK = 8  # rows per piece
# x, scales, send_cnt, src_off, dst_off, out, s_out, R, spr, src_rows,
# out_rows, H, row_bytes, kind, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def check_chunk_aligned(maxt: int) -> None:
    """The port needs maxT % CHUNK == 0, so that no slice's last chunk
    reaches the next slot region. The JAX package also takes maxT < CHUNK;
    its regions then overlap and rows are lost
    (tests/test_torch_moe.py::test_jax_pallas_tier_below_chunk_loses_rows)."""
    if maxt % CHUNK:
        raise ValueError(f"num_max_dispatch_tokens_per_rank={maxt} must be a "
                         f"multiple of CHUNK={CHUNK}")


def quant_rows_ref(x):
    """Per-row int8 of the scatter: (q [n, H] int8, scale [n] f32); the
    rule of ops/quant.py::per_token_quant_int8, whose scale is
    max(absmax, 1e-7) * f32(1/127), as the JAX kernel computes it."""
    q, s = per_token_quant_int8(x)
    return q, s[:, 0]


def _chunked(t):
    return (t.long() + CHUNK - 1) // CHUNK * CHUNK


def remote_scatter_ref(x, scales, send_cnt, src_off, dst_off, wait_cnt, *, group,
                       slices_per_rank, out_rows, quantize=False):
    """Plain version of K12 (module docstring): the chunk-rounded slices go
    through group.ragged_all_to_all into zeroed outputs. Returns (out
    [out_rows, H], s_out [out_rows] f32 or None)."""
    assert not (quantize and scales is not None)
    del slices_per_rank       # the group's rank count fixes the layout
    if quantize:
        x, scales = quant_rows_ref(x)
    src0 = src_off.long() // CHUNK * CHUNK
    dst0 = dst_off.long() // CHUNK * CHUNK
    sizes, recv = _chunked(send_cnt.reshape(-1)), _chunked(wait_cnt.reshape(-1))
    dev, h = x.device, x.shape[1]
    out = group.ragged_all_to_all(
        x, torch.zeros((out_rows, h), dtype=x.dtype, device=dev),
        src0.reshape(-1), sizes, dst0.reshape(-1), recv)
    s_out = None
    if scales is not None:
        s_out = group.ragged_all_to_all(
            scales.float().reshape(-1), torch.zeros((out_rows,), dtype=torch.float32, device=dev),
            src0.reshape(-1), sizes, dst0.reshape(-1), recv)
    return out, s_out


def scatter_row_map(send_cnt, src_off, dst_off, src_rows: int, out_rows: int):
    """K12's row map at one rank, which the kernel mirrors: for each of the
    out_rows window rows, (slice, source row) of the lowest slice whose
    chunk-rounded rows cover it, with the source row below src_rows; (-1,
    -1) for a row that no chunk covers (zero, scale 0). Slice i covers the
    rows dst0 .. dst0 + ceil(send_cnt[i] / CHUNK) * CHUNK - 1 from dst0 =
    dst_off[i] // CHUNK * CHUNK, each taking the source row src_off[i] //
    CHUNK * CHUNK + its place. Returns two int64 tensors [out_rows]."""
    cnt = _chunked(send_cnt.reshape(-1))
    src0 = src_off.reshape(-1).long() // CHUNK * CHUNK
    dst0 = dst_off.reshape(-1).long() // CHUNK * CHUNK
    rel = torch.arange(out_rows, device=cnt.device)[None, :] - dst0[:, None]   # [S, out_rows]
    src = src0[:, None] + rel
    inside = (rel >= 0) & (rel < cnt[:, None]) & (src < src_rows)
    first = inside.long().argmax(dim=0)
    hit = inside.any(dim=0)
    return (torch.where(hit, first, -1),
            torch.where(hit, src.gather(0, first[None])[0], -1))


def _remote_scatter_cuda(x, scales, send_cnt, src_off, dst_off, *, slices_per_rank,
                         out_rows, quantize):
    src_rows, h = x.shape
    dev = x.device
    if quantize and x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"remote_scatter: quantize takes bf16 or f32 rows, not {x.dtype}")
    row_bytes = h * x.element_size()
    if row_bytes % 16 or (quantize and h % 8):
        raise ValueError(f"remote_scatter: rows of {h} x {x.element_size()} bytes must be "
                         "a multiple of 16 bytes (and of 8 elements to quantise)")
    tables = [t.reshape(-1).to(torch.int32).contiguous() for t in (send_cnt, src_off, dst_off)]
    # no zeroing: the kernel writes every row of both windows
    out = torch.empty((out_rows, h), dtype=torch.int8 if quantize else x.dtype, device=dev)
    with_scales = quantize or scales is not None
    s_out = torch.empty((out_rows,), dtype=torch.float32, device=dev) if with_scales else None
    s_in = scales.reshape(-1).float().contiguous() if scales is not None else None
    _build.check_operands("remote_scatter", dev, x, *tables, out,
                          *(t for t in (s_in, s_out) if t is not None))
    kind = (1 if x.dtype == torch.bfloat16 else 2) if quantize else 0
    fn = _build.launcher("remote_scatter", _ARGTYPES)
    code = fn(x.data_ptr(), s_in.data_ptr() if s_in is not None else None,
              *(t.data_ptr() for t in tables), out.data_ptr(),
              s_out.data_ptr() if s_out is not None else None,
              1, slices_per_rank, src_rows, out_rows, h, row_bytes, kind,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check("remote_scatter", code)
    if out_rows > 0:
        _build.launches["remote_scatter"] += 1
    return out, s_out


def _remote_scatter(x, scales, send_cnt, src_off, dst_off, wait_cnt, *, group,
                    slices_per_rank, out_rows, quantize=False):
    """One launch of the chunked ragged scatter (module docstring). scales
    may be None; with quantize, x is bf16 or f32 and scales must be None.
    Returns (out [out_rows, H] (int8 with quantize, else x.dtype),
    s_out [out_rows] f32, or None without scales)."""
    assert not (quantize and scales is not None)
    if use_kernel(x):
        if group.num_ranks > 1:
            raise NotImplementedError(
                "remote_scatter on the card runs one rank: its pointer table holds no "
                "peer windows on other cards yet")
        return _remote_scatter_cuda(x.contiguous(), scales, send_cnt, src_off, dst_off,
                                    slices_per_rank=slices_per_rank, out_rows=out_rows,
                                    quantize=quantize)
    return remote_scatter_ref(x, scales, send_cnt, src_off, dst_off, wait_cnt, group=group,
                              slices_per_rank=slices_per_rank, out_rows=out_rows,
                              quantize=quantize)


def _aligned_layout(counts_flat, input_offsets, tk, r, el, maxt):
    """Chunk-aligned send-buffer layout, a function of the count matrix
    alone (so combine rebuilds it from the handle).

    Returns (aligned_offsets [R*El], aligned_pos [tk] slot -> row (sbuf =
    invalid), sbuf)."""
    counts = counts_flat.long()
    aligned_sizes = _chunked(counts)
    sbuf = tk + r * el * (CHUNK - 1) + CHUNK
    aligned_offsets = _exclusive_cumsum(aligned_sizes)
    slot_ids = torch.arange(tk, device=counts.device)
    slice_c = torch.searchsorted(torch.cumsum(counts, 0), slot_ids, right=True).clamp(0, r * el - 1)
    aligned_pos = torch.where(
        slot_ids < counts.sum(),
        aligned_offsets[slice_c] + (slot_ids - input_offsets.long()[slice_c]), sbuf)
    return aligned_offsets, aligned_pos, sbuf


def _send_layout(topk_idx, r, el, maxt, elastic_info=None, shared=0):
    """The chunk-aligned send layout of this rank's copies: (tok [tk], the
    token of each send slot; copy_slot; counts [R*El]; input_offsets;
    aligned_offsets; aligned_pos; sbuf)."""
    t, k = topk_idx.shape
    tk = t * k + (t if shared > 0 else 0)
    key, _ = _route_copies(topk_idx, r, el, elastic_info, shared)
    copy_of_slot, copy_slot, counts = _sorted_copies(key, tk, r * el)
    input_offsets = _exclusive_cumsum(counts)
    aligned_offsets, aligned_pos, sbuf = _aligned_layout(counts, input_offsets, tk, r, el, maxt)
    return (_token_of_slot(copy_of_slot, t, k, tk), copy_slot, counts, input_offsets,
            aligned_offsets, aligned_pos, sbuf)


def send_buffer(payload, aligned_pos, sbuf):
    """The chunk-aligned send buffer [sbuf, ...]: slot i's row at
    aligned_pos[i], zeros elsewhere (an invalid slot aims past the end)."""
    buf = torch.zeros((sbuf + 1, *payload.shape[1:]), dtype=payload.dtype,
                      device=payload.device)
    buf[aligned_pos] = payload
    return buf[:sbuf]


@register_low_latency_strategy("pallas")
class PallasLowLatencyCommStrategy(DefaultLowLatencyCommStrategy):
    """Kernel tier: the routing and sorting stay PyTorch; the scatter
    kernel owns the wire in both directions."""

    def low_latency_dispatch(self, x, topk_idx, *, group, num_experts,
                             num_max_dispatch_tokens_per_rank,
                             quant_mode="bf16", elastic_info=None,
                             shared_expert_rank_num=0):
        t, h = x.shape
        k = topk_idx.shape[1]
        r = group.num_ranks
        s = shared_expert_rank_num
        el = (num_experts // (r - s)) if s > 0 else num_experts // r
        maxt = num_max_dispatch_tokens_per_rank
        assert t <= maxt
        check_chunk_aligned(maxt)
        tok, copy_slot, counts, input_offsets, aligned_offsets, aligned_pos, sbuf = \
            _send_layout(topk_idx, r, el, maxt, elastic_info, s)
        # int8 is quantised in the scatter kernel; every other mode moves
        # the rows as they are, as in the JAX package
        x_send = send_buffer(x[tok], aligned_pos, sbuf)
        recv_counts = group.all_to_all(counts.reshape(r, el))
        dst_off = _window_offsets(r, el, maxt, x.device, group.rank)
        recv_flat, s_flat = _remote_scatter(
            x_send, None, counts, aligned_offsets, dst_off, recv_counts, group=group,
            slices_per_rank=el, out_rows=el * r * maxt, quantize=quant_mode == "int8")
        handle = LowLatencyHandle(
            copy_slot=copy_slot, send_counts=counts.reshape(r, el),
            input_offsets=input_offsets, recv_counts=recv_counts, num_tokens=t, topk=k,
            max_tokens=maxt, num_local_experts=el, num_ranks=r)
        return LowLatencyDispatchResult(
            recv_x=recv_flat.reshape(el, r * maxt, h),
            recv_x_scales=s_flat.reshape(el, r * maxt) if s_flat is not None else None,
            packed_recv_count=recv_counts.sum(0, dtype=torch.int32),
            layout_range=recv_counts, handle=handle)

    def low_latency_combine(self, x, topk_idx, topk_weights, handle, *, group):
        """Reverse scatter, then the weighted sum at the source."""
        hd: LowLatencyHandle = handle
        el, _, h = x.shape
        r, maxt, t, k = hd.num_ranks, hd.max_tokens, hd.num_tokens, hd.topk
        tk = hd.copy_slot.shape[0]   # t*k, or t*k + t with shared-expert ranks
        aligned_offsets, aligned_pos, sbuf = _aligned_layout(
            hd.send_counts.reshape(-1), hd.input_offsets, tk, r, el, maxt)
        # slice (src, e) of my expert rows goes back to rank src, into its
        # chunk-aligned send region for (me, e)
        their_aligned = group.all_to_all(aligned_offsets.reshape(r, el)).reshape(-1)
        back, _ = _remote_scatter(
            x.reshape(el * r * maxt, h), None, hd.recv_counts,
            _window_offsets(r, el, maxt, x.device), their_aligned,
            hd.send_counts, group=group, slices_per_rank=el, out_rows=sbuf)
        return combine_copies(back, hd.copy_slot, aligned_pos, sbuf, topk_idx, topk_weights,
                              t, k, x.dtype)


def combine_copies(back, copy_slot, aligned_pos, sbuf, topk_idx, topk_weights, t, k, dtype):
    """The weighted sum over each token's returned copies: copy c's row is
    aligned_pos[copy_slot[c]] of the back buffer; a dropped copy, or one
    that lands nowhere, weighs 0; a shared-expert copy (after the T*K
    routed ones) weighs 1."""
    tk = copy_slot.shape[0]
    cs = copy_slot.long()
    row = torch.where(cs < tk, aligned_pos[cs.clamp(0, tk - 1)], sbuf)
    copies = back[row.clamp(0, sbuf - 1)]
    w = torch.where(topk_idx.reshape(-1) >= 0, topk_weights.reshape(-1), 0.0)
    if tk > t * k:
        w = torch.cat([w, torch.ones((t,), dtype=w.dtype, device=w.device)])
    w = torch.where((cs < tk) & (row < sbuf), w, 0.0)
    return _weighted_sum(copies, w, t, k, tk > t * k, dtype)
