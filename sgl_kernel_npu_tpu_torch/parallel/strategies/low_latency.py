"""Low-latency (decode-path) EP dispatch/combine (counterpart of the JAX
package's parallel/strategies/low_latency.py): the "default" strategy over
a ragged all_to_all and the dense "alltoall" oracle.

Output contract: dispatch returns a max-token-padded buffer
    recv_x [num_local_experts, num_ranks * num_max_dispatch_tokens_per_rank, H]
where source rank r's tokens for local expert e occupy
    recv_x[e, r*maxT : r*maxT + layout_range[r, e]]
and validity is given by counts, never by a host sync. Comm quant modes:
"bf16" (none), "int8" (per-token absmax, ops/quant.py; scales [El, R*maxT]
f32), "fp8" (per-token float8_e4m3fn, ops/mxquant.py::
quantize_fp8_per_token; scales as int8's) and "mxfp8" / "mxfp4" (OCP MX
blocks of 32, ops/mxquant.py; payload float8_e4m3fn [.., H] or packed
uint8 [.., H / 2], scales [El, R*maxT, H / 32] uint8 E8M0). As in the JAX
package, the dense oracle sends fp8 mode's rows unquantised (bf16, no
scales). fp8 rows move as uint8 views of their bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ...ops import mxquant
from ...ops.quant import per_token_quant_int8
from ..strategy import LowLatencyEPCommStrategy, register_low_latency_strategy

_QUANTISED = ("int8", "fp8", "mxfp8", "mxfp4")


def check_quant_mode(quant_mode: str) -> None:
    if quant_mode not in ("bf16",) + _QUANTISED:
        raise ValueError(f"unknown quant_mode {quant_mode!r}")


def quantise_rows(x, quant_mode: str, modes=_QUANTISED):
    """(payload [T, Hp], scales [T] f32, [T, H / 32] uint8 or None) of x in
    `quant_mode` (bf16 for a mode not in `modes`); fp8 payloads as uint8
    views."""
    if quant_mode not in modes or quant_mode == "bf16":
        return x, None
    if quant_mode == "int8":
        q, s = per_token_quant_int8(x)
        return q, s[:, 0]
    if quant_mode == "fp8":
        q, s = mxquant.quantize_fp8_per_token(x)
        return q.view(torch.uint8), s[:, 0]
    q, s = (mxquant.quantize_mxfp8(x) if quant_mode == "mxfp8" else mxquant.quantize_mxfp4(x))
    return (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q), s


def payload_view(recv, quant_mode: str):
    """The received uint8 bytes of an fp8 payload as float8_e4m3fn."""
    if quant_mode in ("fp8", "mxfp8") and recv.dtype == torch.uint8:
        return recv.view(torch.float8_e4m3fn)
    return recv


def _exclusive_cumsum(x):
    return torch.cumsum(x, 0) - x


def _route_copies(topk_idx, num_ranks, num_local_experts, elastic_info=None,
                  shared_expert_rank_num=0):
    """(token, k) copy -> (dst rank, local expert slot) group key, with the
    elastic remap and shared-expert ranks: with S shared ranks, routed
    experts live on ranks [S, R) and every token sends one extra copy to
    shared rank (token % S), into that rank's expert-0 slot region.

    Returns (key [T*K(+T)] int64 in [0, R*El], R*El = drop, valid mask)."""
    r, el = num_ranks, num_local_experts
    s = shared_expert_rank_num
    t, _ = topk_idx.shape
    dev = topk_idx.device
    flat = topk_idx.reshape(-1).long()
    valid = flat >= 0
    g = torch.where(valid, flat, 0)
    if elastic_info is not None:
        ei = elastic_info
        el_eff = torch.where(
            ei.flag > 0,
            torch.clamp(ei.moe_expert_num, min=1)
            // torch.clamp(ei.new_world_size - ei.shared_expert_rank_num, min=1),
            el).clamp(min=1).long()
    else:
        el_eff = el
    dst_log = g // el_eff
    le = g % el_eff
    if s > 0:
        dst_log = dst_log + s
    if elastic_info is not None:
        from ..elastic import remap_dst_rank
        dst = remap_dst_rank(dst_log, elastic_info, r).long()
    else:
        dst = dst_log
    ok = valid & (le < el) & (dst < r)
    key = torch.where(ok, dst * el + le, r * el)
    if s > 0:
        shared_dst = torch.arange(t, device=dev) % s
        if elastic_info is not None:
            from ..elastic import remap_dst_rank
            shared_dst = remap_dst_rank(shared_dst, elastic_info, r).long()
        shared_key = torch.where(shared_dst < r, shared_dst * el, r * el)
        key = torch.cat([key, shared_key])
        ok = torch.cat([ok, shared_dst < r])
    return key, ok


def _sorted_copies(key, tk: int, slots: int):
    """The send layout of the copies: stable sort by key. Returns
    (copy_of_slot [tk] (tk = empty slot), copy_slot [tk] int32 (the slot
    of each copy, tk = dropped), counts [slots] int32 of the keys below
    `slots`)."""
    dev = key.device
    order = torch.argsort(key, stable=True)
    live = key[order] < slots
    copy_of_slot = torch.where(live, order, tk)
    copy_slot = torch.full((tk + 1,), tk, dtype=torch.int32, device=dev)
    copy_slot[copy_of_slot] = torch.arange(tk, dtype=torch.int32, device=dev)
    counts = torch.zeros(slots + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, key.clamp(0, slots), torch.ones_like(key, dtype=torch.int32))[:slots]
    return copy_of_slot, copy_slot[:tk], counts


def _token_of_slot(copy_of_slot, t: int, k: int, tk: int):
    """The token each send slot carries (a shared copy after the T*K routed
    ones carries its own token; an empty slot token 0)."""
    tok = torch.where(copy_of_slot < t * k, copy_of_slot // k, copy_of_slot - t * k)
    return torch.where(copy_of_slot < tk, tok.clamp(0, t - 1), 0)


def _weighted_sum(copies, w, t: int, k: int, has_shared: bool, dtype):
    """sum over the k routed copies of each token, in top-k order, of
    copy * weight in f32 (+ the shared copy at weight 1), cast to dtype."""
    prod = (copies.float() * w[:, None])
    rows = prod[: t * k].reshape(t, k, -1)
    out = rows[:, 0]
    for i in range(1, k):
        out = out + rows[:, i]
    if has_shared:
        out = out + prod[t * k:]
    return out.to(dtype)


def _window_offsets(r: int, el: int, maxt: int, device, rank=None):
    """[R*El] offsets e*R*maxT + src*maxT of slice (src, e) in an
    [El, R*maxT] window: with `rank`, src = rank for every slice (where my
    slices land in their destinations' windows); without, each slice's own
    source rank (where rank src's slices sit in my window)."""
    src = torch.arange(r, device=device)[:, None] if rank is None else rank
    ee = torch.arange(el, device=device)[None, :]
    return (ee * (r * maxt) + src * maxt).expand(r, el).reshape(-1)


@dataclass
class LowLatencyHandle:
    copy_slot: Any        # [T*K] send-buffer slot of each (token, k) copy (TK = invalid)
    send_counts: Any      # [R, El] my per-(dst, expert) copy counts
    input_offsets: Any    # [R*El]
    recv_counts: Any      # [R, El] per-(src, local expert) received counts (layout_range)
    num_tokens: int
    topk: int
    max_tokens: int       # maxT
    num_local_experts: int
    num_ranks: int


@dataclass
class LowLatencyDispatchResult:
    recv_x: Any                  # [El, R*maxT, Hp] bf16 | int8 | fp8 | packed fp4
    recv_x_scales: Optional[Any] # [El, R*maxT] f32 (int8, fp8), [.., H/32] uint8 (mx)
    packed_recv_count: Any       # [El] valid tokens per local expert
    layout_range: Any            # [R, El] per-(src, expert) counts
    handle: LowLatencyHandle


@register_low_latency_strategy("default")
class DefaultLowLatencyCommStrategy(LowLatencyEPCommStrategy):
    def low_latency_dispatch(self, x, topk_idx, *, group, num_experts,
                             num_max_dispatch_tokens_per_rank,
                             quant_mode="bf16", elastic_info=None,
                             shared_expert_rank_num=0):
        check_quant_mode(quant_mode)
        t = x.shape[0]
        k = topk_idx.shape[1]
        r = group.num_ranks
        s = shared_expert_rank_num
        el = (num_experts // (r - s)) if s > 0 else num_experts // r
        maxt = num_max_dispatch_tokens_per_rank
        assert t <= maxt, f"T={t} exceeds num_max_dispatch_tokens_per_rank={maxt}"
        tk = t * k + (t if s > 0 else 0)
        dev = x.device

        key, _ = _route_copies(topk_idx, r, el, elastic_info, s)
        copy_of_slot, copy_slot, counts = _sorted_copies(key, tk, r * el)
        input_offsets = _exclusive_cumsum(counts)
        tok = _token_of_slot(copy_of_slot, t, k, tk)
        rows, scales = quantise_rows(x, quant_mode)
        send_x = rows[tok]

        # slice (dst, e) lands at [e, me*maxT] of dst's [El, R*maxT, H] output
        output_offsets = _window_offsets(r, el, maxt, dev, group.rank)
        recv_counts = group.all_to_all(counts.reshape(r, el))            # [R, El]
        recv_sizes = recv_counts.reshape(-1)

        def ra2a(payload):
            out = torch.zeros((el * r * maxt, *payload.shape[1:]), dtype=payload.dtype,
                              device=dev)
            return group.ragged_all_to_all(payload, out, input_offsets, counts,
                                           output_offsets, recv_sizes).reshape(
                                               el, r * maxt, *payload.shape[1:])

        recv_x = payload_view(ra2a(send_x), quant_mode)
        recv_scales = ra2a(scales[tok]) if scales is not None else None
        handle = LowLatencyHandle(
            copy_slot=copy_slot, send_counts=counts.reshape(r, el),
            input_offsets=input_offsets, recv_counts=recv_counts, num_tokens=t, topk=k,
            max_tokens=maxt, num_local_experts=el, num_ranks=r)
        return LowLatencyDispatchResult(
            recv_x=recv_x, recv_x_scales=recv_scales,
            packed_recv_count=recv_counts.sum(0, dtype=torch.int32),
            layout_range=recv_counts, handle=handle)

    def low_latency_combine(self, x, topk_idx, topk_weights, handle, *, group):
        hd: LowLatencyHandle = handle
        el, _, h = x.shape
        r, maxt, t, k = hd.num_ranks, hd.max_tokens, hd.num_tokens, hd.topk
        tk = hd.copy_slot.shape[0]   # t*k, or t*k + t with shared-expert ranks
        dev = x.device
        # slice (src, e) of my buffer goes back to rank src, landing at its
        # original send-slot offsets
        my_slice_offsets = _window_offsets(r, el, maxt, dev)
        their_input_offsets = group.all_to_all(hd.input_offsets.reshape(r, el)).reshape(-1)
        out = torch.zeros((tk, h), dtype=x.dtype, device=dev)
        back = group.ragged_all_to_all(
            x.reshape(el * r * maxt, h), out, my_slice_offsets,
            hd.recv_counts.reshape(-1), their_input_offsets, hd.send_counts.reshape(-1))
        copies = back[hd.copy_slot.long().clamp(0, tk - 1)]
        w = torch.where(topk_idx.reshape(-1) >= 0, topk_weights.reshape(-1), 0.0)
        if tk > t * k:
            w = torch.cat([w, torch.ones((t,), dtype=w.dtype, device=dev)])
        return _weighted_sum(copies, w, t, k, tk > t * k, x.dtype)


@register_low_latency_strategy("alltoall")
class AllToAllLowLatencyCommStrategy(DefaultLowLatencyCommStrategy):
    """Dense all_to_all oracle: moves the fully padded [R, El, maxT, H]
    blocks. Same output contract as the default strategy."""

    def low_latency_dispatch(self, x, topk_idx, *, group, num_experts,
                             num_max_dispatch_tokens_per_rank,
                             quant_mode="bf16", elastic_info=None,
                             shared_expert_rank_num=0):
        assert elastic_info is None and shared_expert_rank_num == 0, \
            "the alltoall oracle covers the base contract only"
        check_quant_mode(quant_mode)
        t = x.shape[0]
        k = topk_idx.shape[1]
        r = group.num_ranks
        el = num_experts // r
        maxt = num_max_dispatch_tokens_per_rank
        assert t <= maxt
        tk = t * k
        dev = x.device

        key = _dense_key(topk_idx, r, el)
        copy_of_slot, copy_slot, counts = _sorted_copies(key, tk, r * el)
        offsets = _exclusive_cumsum(counts)
        sorted_key = torch.sort(key, stable=True).values
        within = torch.arange(tk, device=dev) - offsets[sorted_key.clamp(0, r * el - 1)]
        tok = _token_of_slot(copy_of_slot, t, k, tk)
        # the JAX oracle quantises int8 and the MX modes; fp8 goes as bf16
        rows, scales = quantise_rows(x, quant_mode, ("int8", "mxfp8", "mxfp4"))
        slots = r * el * maxt
        pos = torch.where(sorted_key < r * el, sorted_key * maxt + within, slots).clamp(0, slots)

        def dense(values):
            width = tuple(values.shape[1:])
            buf = torch.zeros((slots + 1, *width), dtype=values.dtype, device=dev)
            buf[pos] = values
            recv = group.all_to_all(buf[:slots].reshape(r, -1))
            return recv.reshape(r, el, maxt, *width).transpose(0, 1).reshape(el, r * maxt,
                                                                             *width)

        recv_x = payload_view(dense(rows[tok]), quant_mode)
        recv_scales = dense(scales[tok]) if scales is not None else None
        recv_counts = group.all_to_all(counts.reshape(r, el))
        handle = LowLatencyHandle(
            copy_slot=copy_slot, send_counts=counts.reshape(r, el), input_offsets=offsets,
            recv_counts=recv_counts, num_tokens=t, topk=k, max_tokens=maxt,
            num_local_experts=el, num_ranks=r)
        return LowLatencyDispatchResult(
            recv_x=recv_x, recv_x_scales=recv_scales,
            packed_recv_count=recv_counts.sum(0, dtype=torch.int32),
            layout_range=recv_counts, handle=handle)

    def low_latency_combine(self, x, topk_idx, topk_weights, handle, *, group):
        hd: LowLatencyHandle = handle
        el, _, h = x.shape
        r, maxt, t, k = hd.num_ranks, hd.max_tokens, hd.num_tokens, hd.topk
        tk = t * k
        y = x.reshape(el, r, maxt, h).transpose(0, 1)
        back = group.all_to_all(y.reshape(r, el * maxt * h)).reshape(r * el * maxt, h)
        key = _dense_key(topk_idx, r, el)
        slot = hd.copy_slot.long().clamp(0, tk - 1)
        within = slot - hd.input_offsets.long()[key.clamp(0, r * el - 1)]
        pos = (key * maxt + within).clamp(0, r * el * maxt - 1)
        w = torch.where(topk_idx.reshape(-1) >= 0, topk_weights.reshape(-1), 0.0)
        return _weighted_sum(back[pos], w, t, k, False, x.dtype)


def _dense_key(topk_idx, r: int, el: int):
    flat = topk_idx.reshape(-1).long()
    valid = flat >= 0
    g = torch.where(valid, flat, 0)
    return torch.where(valid, (g // el) * el + g % el, r * el)
