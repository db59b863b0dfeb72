"""Normal-mode (prefill) EP dispatch / combine (counterpart of the JAX
package's parallel/strategies/normal.py): the "default" strategy over a
ragged all_to_all and the dense "alltoall" oracle, per rank over an EPGroup.

The contract is the JAX package's:
  * static capacities: a rank sends at most sbuf = T * min(K, R) rows (a
    token goes once to each rank that holds one of its experts) and
    receives into rbuf = min(max(sbuf * capacity_factor, sbuf), R * T)
    rows; counts travel as tensors, never through a host sync;
  * the send buffer is destination-major and stable (rank, then token);
  * offsets and sizes are capped at rbuf, and `overflow` says that rows
    arriving past it were dropped;
  * the receiver masks the copies of experts it does not hold (index -1,
    weight 0) and counts each local expert's copies.

The combine scales each received row by the sum of its received weights,
sends the rows back to their send slots, and adds a token's copies in slot
order (destination rank order) from a [T, min(K, R)] table of its slots:
no float atomics, so the sum is the same in every call and is the order
of the JAX package's segment_sum on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ...ops.quant import per_token_quant_int8
from ..layout import get_dispatch_layout
from ..strategy import NormalEPCommStrategy, register_normal_strategy

BIG = 2 ** 30


@dataclass
class DispatchHandle:
    """What combine needs to reverse a dispatch."""

    send_slot_token: Any      # [SBUF] source token of each send slot (T = empty)
    send_valid: Any           # [SBUF] bool
    send_counts: Any          # [R] rows sent to each rank (capped)
    input_offsets: Any        # [R] where each rank's block starts in my send buffer
    output_offsets: Any       # [R] where my block starts in each receiver (capped)
    recv_sizes: Any           # [R] rows received from each rank (capped)
    recv_offsets: Any         # [R] where each rank's block starts in my receive buffer
    num_tokens: int           # T
    topk: int                 # K
    sbuf: int                 # send capacity
    rbuf: int                 # receive capacity
    overflow: Any = None      # [1] bool, attached by Buffer.dispatch


@dataclass
class DispatchResult:
    recv_x: Any                    # [RBUF, H] bf16, or int8 when quantised
    recv_x_scales: Optional[Any]   # [RBUF, 1] f32 when int8
    recv_topk_idx: Any             # [RBUF, K] global ids, non-local -> -1
    recv_topk_weights: Any         # [RBUF, K] f32, non-local -> 0
    recv_count: Any                # [] valid rows
    recv_tokens_per_expert: Any    # [E/R] copies per local expert
    handle: DispatchHandle
    overflow: Any = False          # [] bool: arrivals exceeded rbuf (rows dropped)


def excl_cumsum(x, dim: int = 0):
    """Exclusive prefix sum in int32."""
    return torch.cumsum(x, dim, dtype=torch.int32) - x


def recv_capacity(sbuf: int, capacity_factor: float, r: int, t: int) -> int:
    return min(max(int(sbuf * capacity_factor), sbuf), r * t)


def dest_major_slots(in_rank, sbuf: int):
    """The send buffer's slots from is_token_in_rank [T, R]: the (rank,
    token) pairs in rank-major, token order. Returns (send_token [SBUF] (T
    for an empty slot), send_valid [SBUF])."""
    t, r = in_rank.shape
    dev = in_rank.device
    pair = (torch.arange(r, device=dev)[:, None] * t + torch.arange(t, device=dev)[None, :])
    prio = torch.where(in_rank.T, pair, BIG).reshape(-1)
    order = torch.argsort(prio, stable=True)[:sbuf]
    sorted_prio = prio[order]
    valid = sorted_prio < BIG
    return torch.where(valid, order % t, t).to(torch.int32), valid


def send_payload(x, topk_idx, topk_weights, tok, quant_mode: str, valid=None):
    """(rows, scales [.., 1] or None, topk ids, weights) of the tokens `tok`
    (clamped into range); ids of slots that are not `valid` become -1."""
    t = x.shape[0]
    g = tok.long().clamp(0, t - 1)
    if quant_mode == "int8":
        xq, xs = per_token_quant_int8(x)
        rows, scales = xq[g], xs[g]
    else:
        rows, scales = x[g], None
    idx = topk_idx[g]
    if valid is not None:
        idx = torch.where(valid[..., None], idx, -1)
    return rows, scales, idx, topk_weights[g]


def mask_local(recv_idx, recv_w, rank: int, el: int, row_valid=None):
    """Receiver-side masking: (recv_topk_idx, recv_topk_weights,
    recv_tokens_per_expert [El] int32)."""
    lo = rank * el
    keep = (recv_idx >= lo) & (recv_idx < lo + el)
    if row_valid is not None:
        keep = keep & row_valid[:, None]
    idx = torch.where(keep, recv_idx, -1)
    w = torch.where(idx >= 0, recv_w, 0.0)
    local = torch.where(idx >= 0, idx - lo, el).reshape(-1).long()
    per_expert = torch.zeros(el + 1, dtype=torch.int32, device=idx.device).scatter_add_(
        0, local, torch.ones_like(local, dtype=torch.int32))[:el]
    return idx, w, per_expert


def capped_layout(m, rank: int, cap: int, send_counts):
    """The capped offsets and sizes of the count matrix m [R, R] (m[i, j]:
    rows rank i sends rank j) for this rank: (send sizes, output offsets,
    receive sizes, receive offsets, overflow)."""
    col_cum = excl_cumsum(m, 0)
    out_off = col_cum[rank].clamp(max=cap)
    send_sizes = torch.minimum(send_counts, cap - out_off)
    recv_sizes = m[:, rank]
    arrive = col_cum[:, rank].clamp(max=cap)
    recv_capped = torch.minimum(recv_sizes, cap - arrive)
    return send_sizes, out_off, recv_capped, arrive, recv_sizes.sum() > cap


def slot_table(send_slot_token, send_valid, t: int, width: int):
    """[T, width] the send slots of each token in slot order (SBUF where a
    token has fewer copies)."""
    sbuf = send_slot_token.shape[0]
    dev = send_slot_token.device
    seg = torch.where(send_valid, send_slot_token.long(), t)
    order = torch.argsort(seg, stable=True)
    seg_sorted = seg[order]
    counts = torch.zeros(t + 1, dtype=torch.long, device=dev).scatter_add_(
        0, seg, torch.ones_like(seg))
    first = torch.cumsum(counts, 0) - counts
    within = torch.arange(sbuf, device=dev) - first[seg_sorted]
    sink = t * width
    pos = torch.where(seg_sorted < t, seg_sorted * width + within, sink)
    table = torch.full((sink + 1,), sbuf, dtype=torch.long, device=dev)
    table[pos] = order
    return table[:sink].reshape(t, width)


def sum_copies(rows, table):
    """sum over each token's copies rows[table[t, j]] in column order, in f32
    (rows [SBUF, ...]; an SBUF entry adds nothing)."""
    ext = torch.cat([rows.float(), rows.new_zeros((1, *rows.shape[1:]), dtype=torch.float32)])
    out = torch.zeros((table.shape[0], *rows.shape[1:]), dtype=torch.float32,
                      device=rows.device)
    for j in range(table.shape[1]):
        out = out + ext[table[:, j]]
    return out


@register_normal_strategy("default")
class DefaultNormalCommStrategy(NormalEPCommStrategy):
    """The ragged all_to_all dispatch / combine."""

    def dispatch(self, x, topk_idx, topk_weights, *, group, num_experts,
                 quant_mode="bf16", capacity_factor=2.0, config=None):
        t, _ = x.shape
        k = topk_idx.shape[1]
        r, me = group.num_ranks, group.rank
        el = num_experts // r
        _, _, in_rank = get_dispatch_layout(topk_idx, num_experts, r)
        send_counts = in_rank.sum(0, dtype=torch.int32)
        sbuf = t * min(k, r)
        send_token, send_valid = dest_major_slots(in_rank, sbuf)
        send_x, send_scales, send_idx, send_w = send_payload(
            x, topk_idx, topk_weights, send_token, quant_mode)

        m = group.all_gather(send_counts)                          # [R, R]
        input_offsets = excl_cumsum(send_counts)
        rbuf = recv_capacity(sbuf, capacity_factor, r, t)
        sizes, out_off, recv_sizes, arrive, overflow = capped_layout(m, me, rbuf,
                                                                     send_counts)

        def ra2a(payload, fill=0):
            out = torch.full((rbuf, *payload.shape[1:]), fill, dtype=payload.dtype,
                             device=payload.device)
            return group.ragged_all_to_all(payload, out, input_offsets, sizes, out_off,
                                           recv_sizes)

        recv_x = ra2a(send_x)
        recv_scales = ra2a(send_scales) if send_scales is not None else None
        recv_idx = ra2a(send_idx, fill=-1)
        recv_w = ra2a(send_w)
        recv_count = recv_sizes.sum(dtype=torch.int32)
        row_valid = torch.arange(rbuf, device=x.device) < recv_count
        idx, w, per_expert = mask_local(recv_idx, recv_w, me, el, row_valid)
        handle = DispatchHandle(
            send_slot_token=send_token, send_valid=send_valid, send_counts=sizes,
            input_offsets=input_offsets, output_offsets=out_off, recv_sizes=recv_sizes,
            recv_offsets=arrive, num_tokens=t, topk=k, sbuf=sbuf, rbuf=rbuf)
        return DispatchResult(recv_x=recv_x, recv_x_scales=recv_scales, recv_topk_idx=idx,
                              recv_topk_weights=w, recv_count=recv_count,
                              recv_tokens_per_expert=per_expert, handle=handle,
                              overflow=overflow)

    def combine(self, x, handle, topk_weights, *, group, config=None):
        hd: DispatchHandle = handle
        rbuf, h = x.shape
        assert rbuf == hd.rbuf
        w_row = topk_weights.sum(-1, keepdim=True)
        y = (x.float() * w_row).to(x.dtype)
        # my receive blocks go back to their senders' send slots
        their_in_off = group.all_to_all(hd.input_offsets)
        back = group.ragged_all_to_all(
            y, torch.zeros((hd.sbuf, h), dtype=y.dtype, device=y.device), hd.recv_offsets,
            hd.recv_sizes, their_in_off, hd.send_counts)
        back_w = group.ragged_all_to_all(
            topk_weights, torch.zeros((hd.sbuf, topk_weights.shape[1]),
                                      dtype=topk_weights.dtype, device=y.device),
            hd.recv_offsets, hd.recv_sizes, their_in_off, hd.send_counts)
        table = slot_table(hd.send_slot_token, hd.send_valid, hd.num_tokens,
                           min(hd.topk, group.num_ranks))
        return sum_copies(back, table).to(x.dtype), sum_copies(back_w, table)


@register_normal_strategy("alltoall")
class AllToAllNormalCommStrategy(DefaultNormalCommStrategy):
    """The dense oracle: moves fixed [R, T, H] blocks with a tiled
    all_to_all, then compacts them into the default strategy's contract
    (the same rows in the same order, and the same handle, so the combine
    is shared)."""

    def dispatch(self, x, topk_idx, topk_weights, *, group, num_experts,
                 quant_mode="bf16", capacity_factor=2.0, config=None):
        t, h = x.shape
        k = topk_idx.shape[1]
        r, me = group.num_ranks, group.rank
        el = num_experts // r
        dev = x.device
        _, _, in_rank = get_dispatch_layout(topk_idx, num_experts, r)
        send_counts = in_rank.sum(0, dtype=torch.int32)

        # slot i of block j: the i-th token routed to rank j
        slot = excl_cumsum(in_rank.int(), 0)                          # [T, R]
        cols = torch.where(in_rank, slot, t).T.long()                 # [R, T]
        dense_tok = torch.full((r, t + 1), t, dtype=torch.int32, device=dev)
        dense_tok.scatter_(1, cols, torch.arange(t, dtype=torch.int32, device=dev)
                           .expand(r, t).contiguous())
        dense_tok = dense_tok[:, :t]
        send_x, send_scales, send_idx, send_w = send_payload(
            x, topk_idx, topk_weights, dense_tok, quant_mode, valid=dense_tok < t)

        recv_x_d = group.all_to_all(send_x).reshape(r * t, h)
        recv_idx_d = group.all_to_all(send_idx).reshape(r * t, k)
        recv_w_d = group.all_to_all(send_w).reshape(r * t, k)
        recv_s_d = (group.all_to_all(send_scales).reshape(r * t, 1)
                    if send_scales is not None else None)
        m = group.all_gather(send_counts)
        recv_sizes = m[:, me]

        sbuf = t * min(k, r)
        rbuf = recv_capacity(sbuf, capacity_factor, r, t)
        pair = (torch.arange(r, device=dev)[:, None] * t + torch.arange(t, device=dev)[None, :])
        prio = torch.where(pair % t < recv_sizes[:, None], pair, BIG).reshape(-1)
        order = torch.argsort(prio, stable=True)[:rbuf]
        ok = (prio[order] < BIG)[:, None]
        gat = order.clamp(0, r * t - 1)
        recv_x = torch.where(ok, recv_x_d[gat], 0)
        recv_idx = torch.where(ok, recv_idx_d[gat], -1)
        recv_w = torch.where(ok, recv_w_d[gat], 0.0)
        recv_scales = torch.where(ok, recv_s_d[gat], 0.0) if recv_s_d is not None else None
        idx, w, per_expert = mask_local(recv_idx, recv_w, me, el)

        send_token, send_valid = dest_major_slots(in_rank, sbuf)
        sizes, out_off, recv_capped, arrive, _ = capped_layout(m, me, rbuf, send_counts)
        handle = DispatchHandle(
            send_slot_token=send_token, send_valid=send_valid, send_counts=sizes,
            input_offsets=excl_cumsum(send_counts), output_offsets=out_off,
            recv_sizes=recv_capped, recv_offsets=arrive, num_tokens=t, topk=k, sbuf=sbuf,
            rbuf=rbuf)
        total = recv_sizes.sum(dtype=torch.int32)
        return DispatchResult(recv_x=recv_x, recv_x_scales=recv_scales, recv_topk_idx=idx,
                              recv_topk_weights=w, recv_count=total.clamp(max=rbuf),
                              recv_tokens_per_expert=per_expert, handle=handle,
                              overflow=total > rbuf)


# ------------------------------------------------------ long-seq multi-round

def dispatch_long_seq(strategy, x, topk_idx, topk_weights, *, rounds, group, num_experts,
                      quant_mode="bf16", capacity_factor=2.0):
    """Multi-round normal dispatch: each round an independent dispatch of a
    T / rounds slice, so that the receive buffers are rounds times smaller.
    Returns the rounds' DispatchResults, in order."""
    t = x.shape[0]
    assert t % rounds == 0, f"T={t} must divide into {rounds} rounds"
    pr = t // rounds
    return [strategy.dispatch(x[i * pr:(i + 1) * pr], topk_idx[i * pr:(i + 1) * pr],
                              topk_weights[i * pr:(i + 1) * pr], group=group,
                              num_experts=num_experts, quant_mode=quant_mode,
                              capacity_factor=capacity_factor)
            for i in range(rounds)]


def combine_long_seq(strategy, xs, handles, topk_weights_list, *, group):
    """The reverse of dispatch_long_seq: a combine a round, concatenated."""
    outs = [strategy.combine(x, hd, w, group=group)
            for x, hd, w in zip(xs, handles, topk_weights_list)]
    return torch.cat([o for o, _ in outs]), torch.cat([w for _, w in outs])
