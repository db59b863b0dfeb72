"""Deferred paged GQA decode over page-major ("hm") pages with bf16 products
(counterpart of the JAX package's ops/attention/decode_v6.py): the default
attention of the hm decode path (SKT_DECODE_ATTN=v6).

  decode_gqa_v6_defer(q, k_new, v_new, k_cache, v_cache, cached_lens,
                      block_table, sm_scale, page_size)
  decode_gqa_v6_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales,
                           v_scales, cached_lens, block_table, sm_scale,
                           page_size)
q [B, Hq, D]; k_new / v_new [B, Hkv, D], the current token (rounded to q's
dtype), not yet in the cache; caches [P, Hkv, ps, D] bf16, or int8 with
per-token f32 scales [P, Hkv, 1, ps]; cached_lens [B] tokens already cached
(clamped at 0: a padded row of the engine's batch has none); block_table
[B, MP]. Returns [B, Hq, D] in q's dtype.

On a CUDA tensor each launches kernel K14 (csrc/decode_hm.cu: the loop of
K10 and K16 with p rounded to bf16), counted under its own name; on a CPU
tensor it runs `decode_gqa_v6_defer_ref`, which rounds as the TPU kernel does: bf16 q and rows, f32 score sums, K scales on
the scores, p (int8: p times the V scale) rounded to bf16 before P.V, one
page per online-softmax step, the current token last.
"""

from __future__ import annotations

import torch

from ...utils import use_kernel
from .decode import _launch_hm
from .decode_v3 import _gather_pm

_NEG_INF = -1e30


def _step(qf, k, v, live, sm_scale, m, l, acc, ks=None, vs=None):
    """One online-softmax step of K14's rounding over rows k, v [B, Hkv, n,
    D] (exact bf16 or int8 values in f32) with live [B, n]: the K scales ks
    [B, Hkv, n] on the scores, p (times the V scales vs) rounded to bf16
    before P.V; a sequence with no live row keeps its state. Returns the new
    (m, l, acc)."""
    s = torch.einsum("bhgd,bhnd->bhgn", qf, k)
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = torch.where(live[:, None, None, :], s * sm_scale, _NEG_INF)
    mh = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - mh)
    pexp = torch.where(live[:, None, None, :], torch.exp(s - mh), 0.0)
    new_l = l * alpha + pexp.sum(-1, keepdim=True)
    pr = pexp * vs[:, :, None, :] if vs is not None else pexp
    vp = torch.where(live[:, None, :, None], v, 0.0)
    new_acc = acc * alpha + torch.einsum("bhgn,bhnd->bhgd", pr.to(torch.bfloat16).float(), vp)
    any_live = live.any(-1)[:, None, None, None]
    return (torch.where(any_live, mh, m), torch.where(any_live, new_l, l),
            torch.where(any_live, new_acc, acc))


def _new_token(qf, k_new, v_new, sm_scale, m, l, acc, dtype):
    """Fold the current token k_new / v_new [B, Hkv, D] (rounded to `dtype`,
    then bf16) in as one more step of one column, its p rounded to bf16;
    returns the normalised output [B, Hkv, G, D] in f32."""
    kn = k_new.to(dtype).to(torch.bfloat16).float()
    vn = v_new.to(dtype).to(torch.bfloat16).float()
    s = torch.einsum("bhgd,bhd->bhg", qf, kn)[..., None] * sm_scale
    mh = torch.maximum(m, s)
    alpha = torch.exp(m - mh)
    pexp = torch.exp(s - mh)
    l = l * alpha + pexp
    acc = acc * alpha + pexp.to(torch.bfloat16).float() * vn[:, :, None, :]
    return acc / l.clamp_min(1e-37)


def _init_state(b, hkv, g, d, device):
    return (torch.full((b, hkv, g, 1), _NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=device),
            torch.zeros((b, hkv, g, d), dtype=torch.float32, device=device))


def decode_gqa_v6_defer_ref(q, k_new, v_new, k_cache, v_cache, cached_lens, block_table,
                            sm_scale, page_size=None, k_scales=None, v_scales=None):
    """Plain version of K14 (_kernel_v6 and _kernel_v6_int8 of the JAX
    decode_v6.py), bf16 pages or int8 with scales."""
    b, hq, d = q.shape
    _, hkv, ps, _ = k_cache.shape
    g = hq // hkv
    k = _gather_pm(k_cache, None, block_table)          # exact: bf16 or int8 values
    v = _gather_pm(v_cache, None, block_table)
    ks = vs = None
    if k_scales is not None:
        ks = _gather_pm(k_scales.transpose(-1, -2), None, block_table)[..., 0]
        vs = _gather_pm(v_scales.transpose(-1, -2), None, block_table)[..., 0]
    qf = q.to(torch.bfloat16).float().reshape(b, hkv, g, d)
    clen = cached_lens.long().clamp_min(0)
    m, l, acc = _init_state(b, hkv, g, d, q.device)
    for p0 in range(0, k.shape[2], ps):
        live = torch.arange(p0, p0 + ps, device=q.device)[None, :] < clen[:, None]
        cols = slice(p0, p0 + ps)
        m, l, acc = _step(qf, k[:, :, cols], v[:, :, cols], live, sm_scale, m, l, acc,
                          None if ks is None else ks[:, :, cols],
                          None if vs is None else vs[:, :, cols])
    out = _new_token(qf, k_new, v_new, sm_scale, m, l, acc, q.dtype)
    return out.reshape(b, hq, d).to(q.dtype)


def decode_gqa_v6_defer(q, k_new, v_new, k_cache, v_cache, cached_lens, block_table,
                        sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v6_defer_ref(q, k_new, v_new, k_cache, v_cache, cached_lens,
                                       block_table, sm_scale)
    return _launch_hm("decode_v6_defer", q, k_cache, v_cache, None, (k_new, v_new),
                      cached_lens, block_table, sm_scale, page_size)


def decode_gqa_v6_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                             cached_lens, block_table, sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v6_defer_ref(q, k_new, v_new, k_cache, v_cache, cached_lens,
                                       block_table, sm_scale, k_scales=k_scales,
                                       v_scales=v_scales)
    return _launch_hm("decode_v6_int8_defer", q, k_cache, v_cache, (k_scales, v_scales),
                      (k_new, v_new), cached_lens, block_table, sm_scale, page_size)
