"""fused_deep_moe as a composition (counterpart of the JAX package's
parallel/fused_moe.py): low_latency_dispatch (int8 payload) -> compaction
of the valid slots -> grouped int8 GMM1 -> SwiGLU and per-token
requantisation -> grouped int8 GMM2 -> scatter back to the slotted layout
-> low_latency_combine.

The grouped GEMMs take the aligned compaction (each expert's rows start at
a multiple of 128, so that every 128-row tile has one expert) and kernel K8
(ops/matmul.py::grouped_matmul_int8, which runs each such tile as one
128-row wgmma tile, so an expert's weights stream once per 128 rows), as
the JAX package does with SKT_IMPL=pallas. With
SKT_IMPL=ref both take the tight compaction and the ragged reference
GEMM. Nothing here syncs the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.matmul import grouped_matmul_int8, grouped_matmul_int8_ref
from ..ops.quant import per_token_quant_int8
from ..utils import env
from .strategies.low_latency import LowLatencyDispatchResult

GEMM_TILE = 128      # rows per expert tile of the aligned compaction
_BIG = 2 ** 30


def _slot_priority(recv_counts, num_ranks, num_local_experts, max_tokens):
    """Valid slots of the [El, R*maxT] layout keep their flat index, the
    rest sort after them. recv_counts is [R, El]."""
    el, r, maxt = num_local_experts, num_ranks, max_tokens
    dev = recv_counts.device
    slot_pos = torch.arange(maxt, device=dev)[None, None, :]
    valid = slot_pos < recv_counts.T.long()[:, :, None]
    flat = torch.arange(el * r * maxt, device=dev).reshape(el, r, maxt)
    return torch.where(valid, flat, _BIG).reshape(-1)


def _compact_slots(recv_counts, num_ranks, num_local_experts, max_tokens, cap):
    """Expert-major compaction of the valid slots. Returns (slot_ids [cap]
    gather indices (El*R*maxT = invalid), valid [cap], group_list [El])."""
    total = num_local_experts * num_ranks * max_tokens
    prio = _slot_priority(recv_counts, num_ranks, num_local_experts, max_tokens)
    order = torch.argsort(prio, stable=True)[:cap]
    ok = prio[order] < _BIG
    return torch.where(ok, order, total), ok, recv_counts.sum(0)


def _compact_slots_aligned(recv_counts, num_ranks, num_local_experts, max_tokens, cap, tile):
    """Like _compact_slots, but each expert's rows start at a multiple of
    `tile`. Returns (slot_ids [cap_pad], valid [cap_pad], expert_per_mtile
    [cap_pad // tile]); padding rows take zero scales, hence zero output."""
    el = num_local_experts
    total = el * num_ranks * max_tokens
    dev = recv_counts.device
    order = torch.argsort(_slot_priority(recv_counts, num_ranks, el, max_tokens), stable=True)
    group_list = recv_counts.sum(0).long()
    tight_off = torch.cumsum(group_list, 0) - group_list
    al_sizes = (group_list + tile - 1) // tile * tile
    incl = torch.cumsum(al_sizes, 0)
    al_off = incl - al_sizes
    cap_pad = ((cap + tile - 1) // tile + el) * tile
    j = torch.arange(cap_pad, device=dev)
    e = torch.searchsorted(incl, j, right=True).clamp(0, el - 1)
    idx = j - al_off[e]
    ok = (idx < group_list[e]) & (tight_off[e] + idx < cap)
    pos = (tight_off[e] + idx).clamp(0, total - 1)
    slot_ids = torch.where(ok, order[pos], total)
    eid = torch.searchsorted(incl, torch.arange(cap_pad // tile, device=dev) * tile,
                             right=True).clamp(0, el - 1).to(torch.int32)
    return slot_ids, ok, eid


def _compact_rows(res: LowLatencyDispatchResult, r, el, maxt, cap, aligned):
    """The GEMM rows of a dispatch: (slot_ids, valid, xq [rows, H] int8,
    xs [rows, 1] f32, groups). The aligned compaction gives the expert of
    each 128-row tile as groups, the tight one the group list."""
    total = el * r * maxt
    h = res.recv_x.shape[-1]
    if aligned:
        slot_ids, ok, groups = _compact_slots_aligned(res.layout_range, r, el, maxt, cap,
                                                      GEMM_TILE)
    else:
        slot_ids, ok, groups = _compact_slots(res.layout_range, r, el, maxt, cap)
    gat = slot_ids.clamp(0, total - 1)
    xq = torch.where(ok[:, None], res.recv_x.reshape(total, h)[gat], 0).to(torch.int8)
    xs = torch.where(ok[:, None], res.recv_x_scales.reshape(total)[gat][:, None], 0.0)
    return slot_ids, ok, xq, xs, groups


def _swiglu_requant(up_gate):
    """GMM1's output [rows, 2F] -> x1 * sigmoid(x1) * x2 in f32, requantised
    per token: (int8 [rows, F], scale [rows, 1])."""
    f = up_gate.shape[-1] // 2
    up_gate = up_gate.float()
    x1, x2 = up_gate[:, :f], up_gate[:, f:]
    return per_token_quant_int8(x1 * torch.sigmoid(x1) * x2)


def _expert_ffn_slotted(res: LowLatencyDispatchResult, w13_q, w13_scale, w2_q, w2_scale, *,
                        num_ranks, num_local_experts, max_tokens, cap):
    """Compaction -> GMM1 -> dequant-SwiGLU-quant -> GMM2 -> scatter back to
    the slotted [El, R*maxT, H] layout."""
    r, el, maxt = num_ranks, num_local_experts, max_tokens
    total = el * r * maxt
    h = res.recv_x.shape[-1]
    aligned = env.impl_mode() != "ref"
    slot_ids, ok, xq, xs, groups = _compact_rows(res, r, el, maxt, cap, aligned)

    def gmm(a, w, a_scale, w_scale):
        if aligned:
            return grouped_matmul_int8(a, w, a_scale, w_scale, groups, GEMM_TILE)
        return grouped_matmul_int8_ref(a, w, a_scale, w_scale, groups)

    act_q, act_scale = _swiglu_requant(gmm(xq, w13_q, xs, w13_scale))
    y = gmm(act_q, w2_q, act_scale, w2_scale)
    slotted = torch.zeros((total + 1, h), dtype=y.dtype, device=y.device)
    slotted[slot_ids] = torch.where(ok[:, None], y, 0.0).to(y.dtype)
    return slotted[:total].reshape(el, r * maxt, h)


def fused_deep_moe_shard(x, topk_idx, topk_weights, w13_q, w13_scale, w2_q, w2_scale, *,
                         strategy, group, num_experts, num_max_dispatch_tokens_per_rank,
                         capacity_rows: Optional[int] = None, chunk_rounds: int = 1):
    """This rank's fused MoE layer: x [T, H] bf16, topk_idx [T, K], w13_q
    [El, H, 2F] int8 with w13_scale [El, 2F] f32, w2_q [El, F, H] int8 with
    w2_scale [El, H] f32 -> [T, H] bf16.

    chunk_rounds > 1 splits the tokens into rounds (dispatch, experts and
    combine per round, with maxT_r = min(maxT, max(T / rounds, 8)) slots);
    round i + 1's dispatch is issued before round i's expert GEMMs, the
    order the JAX package gives XLA to overlap (one stream runs them in
    order here)."""
    t = x.shape[0]
    k = topk_idx.shape[1]
    r = group.num_ranks
    el = num_experts // r
    maxt = num_max_dispatch_tokens_per_rank

    def dispatch(sl, maxt_r):
        return strategy.low_latency_dispatch(
            x[sl], topk_idx[sl], group=group, num_experts=num_experts,
            num_max_dispatch_tokens_per_rank=maxt_r, quant_mode="int8")

    def experts(res, maxt_r, cap):
        return _expert_ffn_slotted(res, w13_q, w13_scale, w2_q, w2_scale, num_ranks=r,
                                   num_local_experts=el, max_tokens=maxt_r, cap=cap)

    if chunk_rounds <= 1:
        res = dispatch(slice(None), maxt)
        slotted = experts(res, maxt, capacity_rows or r * maxt * min(k, el))
        return strategy.low_latency_combine(slotted, topk_idx, topk_weights, res.handle,
                                            group=group)

    assert t % chunk_rounds == 0, f"T={t} must divide into {chunk_rounds} rounds"
    tr = t // chunk_rounds
    maxt_r = min(maxt, max(tr, 8))
    cap = capacity_rows or r * maxt_r * min(k, el)
    outs = []
    res = dispatch(slice(0, tr), maxt_r)
    for i in range(chunk_rounds):
        sl = slice(i * tr, (i + 1) * tr)
        nxt = dispatch(slice(sl.stop, sl.stop + tr), maxt_r) if i + 1 < chunk_rounds else None
        slotted = experts(res, maxt_r, cap)
        outs.append(strategy.low_latency_combine(slotted, topk_idx[sl], topk_weights[sl],
                                                 res.handle, group=group))
        res = nxt
    return torch.cat(outs)


def scale_int64_to_float(scale_i64):
    """Decode the DISPATCH_FFN_COMBINE weight-scale convention: f32 bit
    patterns widened to int64 (the low 32 bits hold the pattern)."""
    return scale_i64.to(torch.int32).view(torch.float32)


def dispatch_ffn_combine_shard(x, topk_idx, topk_weights, w13_q, w13_scale_i64, w2_q,
                               w2_scale_i64, *, strategy, group, num_experts,
                               num_max_dispatch_tokens_per_rank,
                               capacity_rows: Optional[int] = None):
    """The DispatchFFNCombine form of the layer (FuseMode 2): int64
    bit-pattern weight scales, num_max_dispatch_tokens_per_rank counting
    RECEIVED tokens (max_bs * ranks * topk), int8 dispatch only, and a second
    output expert_token_nums [El] int32, the tokens each local expert
    received. Returns (out [T, H] bf16, expert_token_nums)."""
    r = group.num_ranks
    el = num_experts // r
    k = topk_idx.shape[1]
    maxt = max(1, num_max_dispatch_tokens_per_rank // (r * k))
    res = strategy.low_latency_dispatch(
        x, topk_idx, group=group, num_experts=num_experts,
        num_max_dispatch_tokens_per_rank=maxt, quant_mode="int8")
    slotted = _expert_ffn_slotted(
        res, w13_q, scale_int64_to_float(w13_scale_i64), w2_q,
        scale_int64_to_float(w2_scale_i64), num_ranks=r, num_local_experts=el,
        max_tokens=maxt, cap=capacity_rows or r * maxt * min(k, el))
    out = strategy.low_latency_combine(slotted, topk_idx, topk_weights, res.handle, group=group)
    return out, res.packed_recv_count.to(torch.int32)
