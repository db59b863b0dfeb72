"""Layered (two-hop) EP dispatch, low-latency and normal mode (counterpart
of the JAX package's parallel/strategies/layered.py).

The ranks form a grid of two fabrics: `group` is a pair (dcn, ici) of
EPGroups, the slow fabric between hosts and the fast one within a host;
global rank = dcn_rank * ici_size + ici_rank. A dispatch
  1. sends each copy over dcn only, to the rank with my ici index in the
     destination's dcn group (its gateway: the slow fabric is crossed once);
  2. fans the copies out over ici into the final layout, where the source
     slot is the global rank of the original sender.
The outputs are the flat strategies' own (strategies/low_latency.py,
strategies/normal.py), bit for bit, and so are the handles, which are
computed from the global counts: the combines reverse in one hop over the
pair flattened, which is the group of all ranks (`flat_group`).
"""

from __future__ import annotations

import torch

from ...ops.quant import per_token_quant_int8
from ..comm import EPGroup
from ..layout import get_dispatch_layout
from ..strategy import register_low_latency_strategy, register_normal_strategy
from .low_latency import (DefaultLowLatencyCommStrategy, LowLatencyDispatchResult,
                          LowLatencyHandle, _exclusive_cumsum, _sorted_copies,
                          check_quant_mode)
from .normal import (DefaultNormalCommStrategy, DispatchHandle, DispatchResult,
                     capped_layout, dest_major_slots, excl_cumsum, mask_local,
                     recv_capacity, send_payload)


def _pair(group):
    assert isinstance(group, (tuple, list)) and len(group) == 2, \
        "the layered strategies take group=(dcn_group, ici_group)"
    return group


def flat_group(group) -> EPGroup:
    """The group of all ranks of a (dcn, ici) pair: one rank's loopback, or
    the default process group, which must hold exactly the pair's ranks with
    global rank dcn_rank * ici_size + ici_rank."""
    dcn, ici = _pair(group)
    if dcn.num_ranks * ici.num_ranks == 1:
        return EPGroup(None)
    import torch.distributed as dist
    flat = EPGroup(dist.group.WORLD)
    if (flat.num_ranks != dcn.num_ranks * ici.num_ranks
            or flat.rank != dcn.rank * ici.num_ranks + ici.rank):
        raise ValueError("the default process group must be the (dcn, ici) grid, rank "
                         "dcn_rank * ici_size + ici_rank")
    return flat


def _counts(key, n: int):
    """int32 counts of the keys below n."""
    return torch.zeros(n + 1, dtype=torch.int32, device=key.device).scatter_add_(
        0, key.clamp(0, n).long(), torch.ones_like(key, dtype=torch.int32))[:n]


@register_low_latency_strategy("layered")
class LayeredLowLatencyCommStrategy(DefaultLowLatencyCommStrategy):
    """Two-hop low-latency dispatch over group=(dcn, ici)."""

    def low_latency_dispatch(self, x, topk_idx, *, group, num_experts,
                             num_max_dispatch_tokens_per_rank,
                             quant_mode="bf16", elastic_info=None,
                             shared_expert_rank_num=0):
        dcn, ici = _pair(group)
        assert elastic_info is None and shared_expert_rank_num == 0
        check_quant_mode(quant_mode)
        nd, ni = dcn.num_ranks, ici.num_ranks
        r = nd * ni
        t, h = x.shape
        k = topk_idx.shape[1]
        el = num_experts // r
        maxt = num_max_dispatch_tokens_per_rank
        assert t <= maxt
        tk = t * k
        dev = x.device
        me = dcn.rank * ni + ici.rank

        flat = topk_idx.reshape(-1).long()
        valid = flat >= 0
        g = torch.where(valid, flat, 0)
        dst, le = g // el, g % el
        # hop 1 key: the destination's dcn group
        key1 = torch.where(valid, dst // ni, nd)
        order1 = torch.argsort(key1, stable=True)
        copy1 = torch.where(key1[order1] < nd, order1, tk)
        counts1 = _counts(key1, nd)
        off1 = excl_cumsum(counts1)
        live1 = copy1 < tk
        tok = torch.where(live1, copy1 // k, 0)
        if quant_mode == "int8":
            xq, xs = per_token_quant_int8(x)
            payload, scales = xq[tok], xs[tok][:, 0]
        else:
            payload, scales = x[tok], None
        cs = copy1.clamp(0, tk - 1)
        # the routing hop 2 needs rides with the payload
        meta = torch.stack([torch.where(live1, (dst % ni)[cs], ni),
                            torch.where(live1, le[cs], 0),
                            torch.full((tk,), me, device=dev, dtype=torch.long),
                            copy1], 1).to(torch.int32)

        # hop 1: over dcn, one slice a dcn peer
        m1 = dcn.all_gather(counts1)
        out_off1 = excl_cumsum(m1, 0)[dcn.rank]
        recv_sizes1 = m1[:, dcn.rank]
        rbuf1 = nd * maxt * k

        def hop1(p, fill=0):
            out = torch.full((rbuf1, *p.shape[1:]), fill, dtype=p.dtype, device=dev)
            return dcn.ragged_all_to_all(p, out, off1, counts1, out_off1, recv_sizes1)

        stage_x, stage_meta = hop1(payload), hop1(meta)
        stage_scales = hop1(scales) if scales is not None else None
        stage_valid = torch.arange(rbuf1, device=dev) < recv_sizes1.sum()

        # hop 2: over ici into the slotted layout, slices (ici peer, expert,
        # original source)
        s_ici = torch.where(stage_valid, stage_meta[:, 0], ni).long()
        key2 = torch.where(s_ici < ni, s_ici * el + stage_meta[:, 1].long(), ni * el)
        order2 = torch.argsort(key2, stable=True)
        k2s = key2[order2]
        live2 = k2s < ni * el
        gat2 = order2.clamp(0, rbuf1 - 1)
        x2 = torch.where(live2[:, None], stage_x[gat2], 0)
        src2 = torch.where(live2, stage_meta[:, 2].long()[gat2], r)
        key2b = torch.where(live2, k2s * r + src2.clamp(0, r - 1), ni * el * r)
        order2b = torch.argsort(key2b, stable=True)
        x2 = x2[order2b]
        fine = key2b[order2b]
        cnt_fine = _counts(fine, ni * el * r)
        off_fine = excl_cumsum(cnt_fine)
        j = torch.arange(ni * el * r, device=dev)
        out_off2 = ((j // r) % el) * (r * maxt) + (j % r) * maxt
        recv_cnt_fine = ici.all_to_all(cnt_fine.reshape(ni, el * r)).reshape(-1)
        recv_x = ici.ragged_all_to_all(
            x2, torch.zeros((el * r * maxt, h), dtype=x2.dtype, device=dev), off_fine,
            cnt_fine, out_off2, recv_cnt_fine).reshape(el, r * maxt, h)
        recv_scales = None
        if stage_scales is not None:
            s2 = torch.where(live2, stage_scales[gat2], 0.0)[order2b]
            recv_scales = ici.ragged_all_to_all(
                s2, torch.zeros((el * r * maxt,), dtype=torch.float32, device=dev),
                off_fine, cnt_fine, out_off2, recv_cnt_fine).reshape(el, r * maxt)

        # layout_range [R, El]: a source arrives through one gateway only, so
        # the sum over the ici peers is exact
        recv_counts = recv_cnt_fine.reshape(ni, el, r).sum(0, dtype=torch.int32).T.contiguous()
        # the flat strategy's bookkeeping, for the one-hop combine
        key_flat = torch.where(valid, dst * el + le, r * el)
        _, copy_slot, counts_flat = _sorted_copies(key_flat, tk, r * el)
        handle = LowLatencyHandle(
            copy_slot=copy_slot, send_counts=counts_flat.reshape(r, el),
            input_offsets=_exclusive_cumsum(counts_flat), recv_counts=recv_counts, num_tokens=t,
            topk=k, max_tokens=maxt, num_local_experts=el, num_ranks=r)
        return LowLatencyDispatchResult(
            recv_x=recv_x, recv_x_scales=recv_scales,
            packed_recv_count=recv_counts.sum(0, dtype=torch.int32),
            layout_range=recv_counts, handle=handle)

    def low_latency_combine(self, x, topk_idx, topk_weights, handle, *, group):
        """One direct hop back over the pair flattened."""
        return super().low_latency_combine(x, topk_idx, topk_weights, handle,
                                           group=flat_group(group))


@register_normal_strategy("layered")
class LayeredNormalCommStrategy(DefaultNormalCommStrategy):
    """Two-hop normal-mode dispatch over group=(dcn, ici): hop 1 sends one
    contiguous block a dcn peer (the send buffer is destination-major and
    destination order nests (dcn, ici)) to the gateway with my ici index;
    hop 2 fans the rows out over ici, one slice a (destination ici, source
    dcn), each landing at the destination's flat per-source offset, so that
    the receive buffer is the flat strategy's, bit for bit."""

    def dispatch(self, x, topk_idx, topk_weights, *, group, num_experts,
                 quant_mode="bf16", capacity_factor=2.0, config=None):
        dcn, ici = _pair(group)
        nd, ni = dcn.num_ranks, ici.num_ranks
        r = nd * ni
        t, _ = x.shape
        k = topk_idx.shape[1]
        el = num_experts // r
        dev = x.device
        me = dcn.rank * ni + ici.rank

        _, _, in_rank = get_dispatch_layout(topk_idx, num_experts, r)
        send_counts = in_rank.sum(0, dtype=torch.int32)
        sbuf = t * min(k, r)
        send_token, send_valid = dest_major_slots(in_rank, sbuf)
        send_x, send_scales, send_idx, send_w = send_payload(
            x, topk_idx, topk_weights, send_token, quant_mode, valid=send_valid)
        m_full = flat_group(group).all_gather(send_counts)           # [R, R]

        # hop 1: one contiguous block a dcn peer
        counts_dcn = send_counts.reshape(nd, ni).sum(1, dtype=torch.int32)
        m1 = dcn.all_gather(counts_dcn)
        recv_sizes1 = m1[:, dcn.rank]
        arrive1 = excl_cumsum(recv_sizes1)
        # each dcn peer sends me at most t * min(k, ni) rows
        rbuf1 = nd * t * min(k, ni)

        def hop1(p, fill=0):
            out = torch.full((rbuf1, *p.shape[1:]), fill, dtype=p.dtype, device=dev)
            return dcn.ragged_all_to_all(p, out, excl_cumsum(counts_dcn), counts_dcn,
                                         excl_cumsum(m1, 0)[dcn.rank], recv_sizes1)

        stage = [hop1(send_x), hop1(send_idx, fill=-1), hop1(send_w)]
        if send_scales is not None:
            stage.append(hop1(send_scales))

        # hop 2: slice (d, s) carries the rows from source (s, my ici) to
        # destination (my dcn, d); it sits at arrive1[s] + the slices of the
        # destinations before d
        ar = torch.arange
        src_g = ar(nd, device=dev) * ni + ici.rank                    # [nD]
        dst_g = dcn.rank * ni + ar(ni, device=dev)                    # [nI]
        cnt2 = m_full[src_g[None, :], dst_g[:, None]]                 # [nI, nD]
        in_off2 = arrive1[None, :] + excl_cumsum(cnt2, 0)
        rbuf = recv_capacity(sbuf, capacity_factor, r, t)
        col_cum = excl_cumsum(m_full, 0)
        out_off2 = col_cum[src_g[None, :], dst_g[:, None]].clamp(max=rbuf)
        sizes2 = torch.minimum(cnt2, rbuf - out_off2)
        # what arrives here: slice (my ici, s) from gateway (my dcn, g)
        src_of = ar(nd, device=dev)[None, :] * ni + ar(ni, device=dev)[:, None]   # [g, s]
        my_off = col_cum[src_of, me].clamp(max=rbuf)
        recv2 = torch.minimum(m_full[src_of, me], rbuf - my_off)

        def hop2(p, fill=0):
            out = torch.full((rbuf, *p.shape[1:]), fill, dtype=p.dtype, device=dev)
            return ici.ragged_all_to_all(p, out, in_off2.reshape(-1), sizes2.reshape(-1),
                                         out_off2.reshape(-1), recv2.reshape(-1))

        recv_x, recv_idx, recv_w = hop2(stage[0]), hop2(stage[1], fill=-1), hop2(stage[2])
        recv_scales = hop2(stage[3]) if send_scales is not None else None

        # masking and handle: the flat strategy's, from the global counts
        sizes, out_off, recv_sizes, arrive, overflow = capped_layout(m_full, me, rbuf,
                                                                     send_counts)
        recv_count = recv_sizes.sum(dtype=torch.int32)
        idx, w, per_expert = mask_local(recv_idx, recv_w, me, el,
                                        torch.arange(rbuf, device=dev) < recv_count)
        handle = DispatchHandle(
            send_slot_token=send_token, send_valid=send_valid, send_counts=sizes,
            input_offsets=excl_cumsum(send_counts), output_offsets=out_off,
            recv_sizes=recv_sizes, recv_offsets=arrive, num_tokens=t, topk=k, sbuf=sbuf,
            rbuf=rbuf)
        return DispatchResult(recv_x=recv_x, recv_x_scales=recv_scales, recv_topk_idx=idx,
                              recv_topk_weights=w, recv_count=recv_count,
                              recv_tokens_per_expert=per_expert, handle=handle,
                              overflow=overflow)

    def combine(self, x, handle, topk_weights, *, group, config=None):
        """One direct hop back over the pair flattened (the flat handle makes
        the default combine exact)."""
        return super().combine(x, handle, topk_weights, group=flat_group(group),
                               config=config)
