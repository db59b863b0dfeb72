"""Paged GQA decode over the read-only int8 token-major cache, the current
token folded in (counterpart of the JAX package's ops/attention/decode_v9.py::
decode_gqa_pallas_v9_int8_defer and decode_v6.py::_finalize_rows).

On a CUDA tensor the wrapper launches kernel C (csrc/decode_tm.cu); on a CPU
tensor it runs the plain version, `decode_gqa_v9_int8_defer_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import use_kernel

# q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, cached, block_table,
# out, workspace, arrivals, B, hkv, G, P, ps, MP, li, step_pages, splits,
# sm_scale, stream
_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])
_MAXG = 8
_NEG_INF = -1e30
CHUNK_PAGES = 4     # pages per online-softmax step of the TPU kernel (SKT_V9_CP)


# kernel C splits a (sequence, kv head)'s cached tokens over blocks
# (csrc/decode_tm_core.cuh; K3 shares that loop with one block a row): at
# most TM_MAX_SPLITS, each a share of the TM_TILE-token tiles of the cached
# ones
TM_MAX_SPLITS = 8
TM_TILE = 16


def tm_splits(resident: int, b: int, hkv: int, mp: int, ps: int) -> int:
    """S of kernel C (decode_tm_core.cuh::splits_for): the card's
    co-resident blocks over the B * hkv rows, at most the 16-token tiles of
    the block table's span and TM_MAX_SPLITS, at least 1."""
    return max(1, min(resident // (b * hkv), -(-mp * ps // TM_TILE), TM_MAX_SPLITS))


def tm_split_walk(clen: int, s: int, split: int, step: int, unit: int = TM_TILE):
    """What split `split` of S = s walks for a row of clen cached tokens, as
    decode_tm_core.cuh's Walk takes it: its tokens [ts, te) (a share of the
    `unit`-token pieces: 16-token tiles, or whole steps where the kernel
    keeps a step's scores, as K14 does) and, for each online-softmax step k
    it touches, (k, scores range, p . v range). The scores of its first step
    start at token 0 (the running maximum at the end of that step covers
    every earlier step), those of a later step at the step's first token;
    p . v covers the split's own tokens of the step."""
    nt = -(-clen // unit)
    ts = unit * (nt * split // s)
    te = min(clen, unit * (nt * (split + 1) // s))
    steps = []
    if ts < te:
        for k in range(ts // step, (te - 1) // step + 1):
            lo = 0 if not steps else k * step
            steps.append((k, (lo, min(clen, (k + 1) * step)),
                          (max(ts, k * step), min(te, (k + 1) * step))))
    return ts, te, steps


def _gather_layer(cache, scales, layer_idx, block_table, hkv):
    """Pages of `block_table` [B, MP] at layer layer_idx, head-major:
    values [B, hkv, MP*ps, D] and scales [B, hkv, MP*ps]."""
    _, num_pages, rows, d = cache.shape
    ps = rows // hkv
    b, mp = block_table.shape
    bt = block_table.long()
    vals = cache[layer_idx].view(num_pages, ps, hkv, d)[bt]
    vals = vals.permute(0, 3, 1, 2, 4).reshape(b, hkv, mp * ps, d)
    sc = scales[layer_idx].view(num_pages, ps, hkv)[bt]
    sc = sc.permute(0, 3, 1, 2).reshape(b, hkv, mp * ps)
    return vals, sc


def _flash_update(state, sc, pv_scale, vals):
    """One online-softmax step as the TPU kernels take it: f32 scores `sc`
    [..., R, n] (masked entries at _NEG_INF), new running max, probabilities
    times `pv_scale` rounded to bf16, then P.V against f32 `vals` [..., n, D]."""
    m, l_sum, acc = state
    mh = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - mh)
    p = torch.exp(sc - mh)
    l_sum = l_sum * alpha + p.sum(dim=-1, keepdim=True)
    pv = (p * pv_scale).to(torch.bfloat16).float()
    acc = acc * alpha + torch.matmul(pv, vals)
    return mh, l_sum, acc


def decode_gqa_v9_int8_defer_ref(q, k_new, v_new, k_cache, v_cache, k_scales,
                                 v_scales, cached_lens, block_table, sm_scale,
                                 page_size, layer_idx=0):
    """Plain version of kernel C (same contract as decode_gqa_v9_int8_defer):
    online-softmax steps of CHUNK_PAGES pages, as the TPU kernel takes them."""
    hkv = k_new.shape[1]
    kc, ks = _gather_layer(k_cache, k_scales, layer_idx, block_table, hkv)
    vc, vs = _gather_layer(v_cache, v_scales, layer_idx, block_table, hkv)
    mp = block_table.shape[1]
    if kc.shape[2] != mp * page_size:
        raise ValueError(f"page_size {page_size} does not match the cache")
    return attend_gathered_ref(q, k_new, v_new, kc, ks, vc, vs, cached_lens,
                               min(mp, CHUNK_PAGES) * page_size, sm_scale)


def attend_gathered_ref(q, k_new, v_new, kc, ks, vc, vs, cached_lens, span,
                        sm_scale):
    """The int8 deferred-write decode over a cache already gathered head-major:
    kc/vc [B, hkv, n, D] int8 (n = MP*ps), ks/vs [B, hkv, n] f32.

    It takes the TPU kernels' steps in their order, so it rounds where they
    round: online-softmax steps of `span` tokens (k scale on the scores, v
    scale on the probabilities, their product rounded to bf16 before it
    meets V; columns at or past cached_lens score -1e30 and have v scale 0),
    then the current token folded in with its probability rounded to bf16
    (decode_v6.py::_finalize_rows)."""
    b, hq, d = q.shape
    hkv = k_new.shape[1]
    g = hq // hkv
    n = kc.shape[2]
    cached = cached_lens.clamp_min(0)[:, None, None, None]
    qf = q.float().reshape(b, hkv, g, d)
    state = (torch.full((b, hkv, g, 1), _NEG_INF, device=q.device),
             torch.zeros((b, hkv, g, 1), device=q.device),
             torch.zeros((b, hkv, g, d), device=q.device))
    for lo in range(0, n, span):
        hi = min(lo + span, n)
        valid = torch.arange(lo, hi, device=q.device) < cached   # [B,1,1,n]
        sc = torch.matmul(qf, kc[:, :, lo:hi].float().transpose(-1, -2))
        sc = sc * ks[:, :, None, lo:hi] * sm_scale
        sc = torch.where(valid, sc, _NEG_INF)
        vsr = torch.where(valid, vs[:, :, None, lo:hi], 0.0)
        state = _flash_update(state, sc, vsr, vc[:, :, lo:hi].float())
    # the current token: one column per head, scale 1
    s_cur = (qf * k_new.float()[:, :, None, :]).sum(-1, keepdim=True) * sm_scale
    _, l_sum, acc = _flash_update(state, s_cur, 1.0,
                                  v_new.float()[:, :, None, :])
    out = acc / l_sum.clamp_min(1e-37)
    return out.reshape(b, hq, d).to(q.dtype)


def decode_gqa_v9_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales,
                             v_scales, cached_lens, block_table, sm_scale,
                             page_size, layer_idx=0):
    """Token-major int8 deferred-write decode.

    q [B, Hq, D] bf16; k_new/v_new [B, Hkv, D] bf16 (the current token, not
    yet in the cache); caches int8 [L, P, ps*Hkv, D] + scales f32
    [L, P, 1, ps*Hkv], layer picked by layer_idx; cached_lens [B] tokens
    already cached; block_table [B, MP] page ids. Returns [B, Hq, D]."""
    if not use_kernel(q):
        return decode_gqa_v9_int8_defer_ref(
            q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, cached_lens,
            block_table, sm_scale, page_size, layer_idx)
    return launch_decode_tm(q, k_new, v_new, k_cache, v_cache, k_scales,
                            v_scales, cached_lens, block_table, sm_scale,
                            page_size, layer_idx)


def launch_decode_tm(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                     cached_lens, block_table, sm_scale, page_size, layer_idx,
                     step_pages=CHUNK_PAGES):
    """Launch kernel C on CUDA tensors: the contract of decode_v9 (online
    softmax steps of CHUNK_PAGES pages) and of decode_v8's per-page decode
    (step_pages=1). Each (sequence, kv head) is split over the blocks that
    skt_decode_tm_splits sizes from the card; the splits' partials meet in a
    workspace and the last to arrive merges them."""
    b, hq, d = q.shape
    hkv = k_new.shape[1]
    l, num_pages, rows, _ = k_cache.shape
    g = hq // hkv
    if (d != 128 or hq % hkv or g > _MAXG or rows != page_size * hkv
            or not 0 <= layer_idx < l):
        raise ValueError(f"decode_tm: q {tuple(q.shape)}, kv heads {hkv}, cache "
                         f"{tuple(k_cache.shape)}: needs D == 128, G <= {_MAXG}")
    dev = q.device
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    cached = cached_lens.to(torch.int32).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    ops = (q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, cached, bt)
    _build.check_operands("decode_tm", dev, *ops)
    if q.dtype != torch.bfloat16 or k_cache.dtype != torch.int8 \
            or k_scales.dtype != torch.float32:
        raise TypeError("decode_tm: bf16 q, int8 cache, f32 scales expected")
    out = torch.empty_like(q)
    mp = bt.shape[1]
    splits = _build.splits("decode_tm", b, hkv, mp, page_size)
    ws = torch.empty(b * hkv * splits * _MAXG * (2 + d) if splits > 1 else 0,
                     dtype=torch.float32, device=dev)
    arrivals = _build.arrival_counters("decode_tm", dev, b * hkv)
    fn = _build.launcher("decode_tm", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(*(t.data_ptr() for t in ops), out.data_ptr(), ws.data_ptr(),
              arrivals.data_ptr(), b, hkv, g, num_pages, page_size, mp, layer_idx,
              step_pages, splits, float(sm_scale), stream)
    _build.check("decode_tm", code)
    _build.launches["decode_tm"] += 1
    return out
