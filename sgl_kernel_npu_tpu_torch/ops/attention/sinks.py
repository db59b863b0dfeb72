"""Attention with sinks, gpt-oss style: decode over head-major pages and a
varlen causal prefill (counterpart of the JAX package's
ops/attention/sinks.py; plain PyTorch there too: no kernel behind it).

A per-query-head sink logit joins the softmax denominator only (it has no
value row), damping the attention mass; an optional sliding window keeps
the last `sliding_window_size` tokens of a query's sequence (-1: off).
Everything is computed in f32 and returned in q's dtype.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _softmax_with_sinks(logits, sinks, hkv, g):
    """p = exp(l - m) / (sum exp(l - m) + exp(sink - m)), m the larger of
    the row maximum and the sink; logits [..., hkv, g, n]."""
    sink = sinks.float().reshape(hkv, g)[..., None]
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), sink)
    p = torch.exp(logits - m)
    return p / (p.sum(dim=-1, keepdim=True) + torch.exp(sink - m))


def decode_attention_with_sinks(q, k_cache, v_cache, sinks, seq_lens, block_table, sm_scale,
                                page_size, sliding_window_size: int = -1):
    """q [B, Hq, D]; caches head-major [Hkv, P, ps, D]; sinks [Hq]; seq_lens
    [B] (the current token included); block_table [B, max_pages]. Returns
    [B, Hq, Dv]."""
    b, hq, dk = q.shape
    hkv = k_cache.shape[0]
    dv = v_cache.shape[-1]
    g = hq // hkv
    n = block_table.shape[1] * page_size
    bt = block_table.long()
    k = k_cache[:, bt].transpose(0, 1).reshape(b, hkv, n, dk).float()
    v = v_cache[:, bt].transpose(0, 1).reshape(b, hkv, n, dv).float()
    logits = torch.einsum("bhgd,bhnd->bhgn", q.float().reshape(b, hkv, g, dk), k) * sm_scale
    pos = torch.arange(n, device=q.device)[None, :]
    lens = seq_lens.long()[:, None]
    valid = pos < lens
    if sliding_window_size != -1:
        valid = valid & (pos >= (lens - sliding_window_size).clamp_min(0))
    logits = torch.where(valid[:, None, None, :], logits, _NEG_INF)
    p = _softmax_with_sinks(logits, sinks, hkv, g)
    out = torch.einsum("bhgn,bhnd->bhgd", p, v)
    return out.reshape(b, hq, dv).to(q.dtype)


def prefill_attention_with_sinks(q, k, v, sinks, cu_seqlens, sm_scale,
                                 sliding_window_size: int = -1):
    """Varlen causal prefill with sinks. q [T, Hq, D]; k, v [T, Hkv, D];
    cu_seqlens [num_seqs + 1], the sequences laid end to end. A query sees
    the keys of its own sequence at its position or before (and, with a
    window, fewer than `sliding_window_size` positions back). Returns
    [T, Hq, Dv]."""
    t, hq, dk = q.shape
    hkv = k.shape[1]
    dv = v.shape[-1]
    g = hq // hkv
    cu = cu_seqlens.long()
    tok = torch.arange(t, device=q.device)
    seq_id = torch.searchsorted(cu[1:], tok, right=True)
    pos = tok - cu[seq_id.clamp_max(cu.shape[0] - 1)]
    logits = torch.einsum("thgd,nhd->thgn", q.float().reshape(t, hkv, g, dk),
                          k.float()) * sm_scale
    valid = (seq_id[:, None] == seq_id[None, :]) & (pos[:, None] >= pos[None, :])
    if sliding_window_size != -1:
        valid = valid & (pos[None, :] > pos[:, None] - sliding_window_size)
    logits = torch.where(valid[:, None, None, :], logits, _NEG_INF)
    p = _softmax_with_sinks(logits, sinks, hkv, g)
    out = torch.einsum("thgn,nhd->thgd", p, v.float())
    return out.reshape(t, hq, dv).to(q.dtype)
