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

On a CUDA tensor each launches kernel K14 (csrc/decode_v6.cu: K3's loop,
csrc/decode_tm_core.cuh, on the page-major pages seen as head-major pages
of one layer), counted under its own name; on a CPU tensor it runs
`decode_gqa_v6_defer_ref`, which rounds as the TPU kernel does: bf16 q and
rows, f32 score sums, K scales on the scores, p (int8: p times the V scale)
rounded to bf16 before P.V, one page per online-softmax step, the current
token last. That is K3's rounding: on int8 pages `decode_gqa_v6_defer_ref`
equals decode_v11's plain version over the same cache as [1, P, Hkv, ps,
D] (tests/test_torch_hm.py holds it).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import use_kernel
# K14's blocks are decode_tm_core.cuh's, as K16's: at most V6_MAXG query
# heads each (v6_groups of them a kv head), at most V6_MAX_SPLITS splits a
# row; a split's partials are 2 * V6_MAXG + V6_MAXG * 128 floats
from .decode_v3 import HEAD_GROUPS, _gather_pm
from .decode_v3 import V3_MAX_SPLITS as V6_MAX_SPLITS
from .decode_v3 import V3_MAXG as V6_MAXG
from .decode_v3 import v3_groups as v6_groups

_NEG_INF = -1e30
# q, k_new, v_new, k cache, v cache, [k scales, v scales,] cached, block
# table, out, workspace, arrivals, kept, B, Hq, Hkv, P, ps, MP, ng, S,
# sm_scale, stream
_ARGTYPES = {"decode_v6_defer": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p],
             "decode_v6_int8_defer": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p]}


def v6_splits(resident: int, b: int, rows: int, mp: int) -> int:
    """S of kernel K14 (decode_v6.cu's skt_*_splits, through
    decode_tm_core.cuh::splits_for): the card's co-resident blocks over the
    B * rows rows (rows = Hkv * ng), at most the block table's MP pages (a
    split holds whole pages) and V6_MAX_SPLITS, at least 1. Each split walks
    decode_v9.tm_split_walk(clen, S, split, ps, unit=ps)."""
    return max(1, min(resident // (b * rows), mp, V6_MAX_SPLITS))


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


def _launch_v6(name, q, k_new, v_new, k_cache, v_cache, scales, cached_lens, block_table,
               sm_scale, page_size):
    """One launch of kernel K14 (`name` its C entry point and launch
    counter) on CUDA tensors: caches [P, Hkv, ps, 128], scales (k, v) [P,
    Hkv, 1, ps] f32 for int8 pages, else None. Each (sequence, kv head, group
    of heads) is split over the blocks that skt_<name>_splits sizes from the
    card, on page boundaries; the splits' partials meet in a workspace and
    the last to arrive merges them. Returns [B, Hq, 128] bf16."""
    b, hq, d = q.shape
    shape = k_cache.shape
    num_pages, hkv, ps = shape[:3]
    if (v_cache.shape != shape or shape[-1] != d or d != 128 or ps != page_size
            or hq % hkv or hq // hkv not in HEAD_GROUPS
            or (scales is not None and any(s.shape != (num_pages, hkv, 1, ps)
                                           for s in scales))):
        raise ValueError(f"{name}: q {tuple(q.shape)}, caches {tuple(shape)}: needs head "
                         f"dim 128, Hq / Hkv in {HEAD_GROUPS} and scales [P, Hkv, 1, ps]")
    want = torch.int8 if scales is not None else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_cache.dtype != want or v_cache.dtype != want:
        raise TypeError(f"{name}: bf16 q and {want} caches expected")
    dev = q.device
    q = q.contiguous()
    kn, vn = (x.to(torch.bfloat16).contiguous() for x in (k_new, v_new))
    if kn.shape != (b, hkv, d) or vn.shape != (b, hkv, d):
        raise ValueError(f"{name}: k_new / v_new {tuple(kn.shape)} != {(b, hkv, d)}")
    sc = [s.float().contiguous() for s in scales] if scales is not None else []
    cl = cached_lens.to(torch.int32).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    out = torch.empty((b, hq, d), dtype=torch.bfloat16, device=dev)
    _build.check_operands(name, dev, q, kn, vn, k_cache, v_cache, *sc, cl, bt, out)
    g, mp = hq // hkv, bt.shape[1]
    ng = v6_groups(g)
    rows = b * hkv * ng
    splits = _build.splits(name, b, hkv, g // ng, ng, mp, ps)
    ws = torch.empty(rows * splits * V6_MAXG * (2 + d) if splits > 1 else 0,
                     dtype=torch.float32, device=dev)
    arrivals = _build.arrival_counters(name, dev, rows)
    # a block's kept scores where they do not fit in its shared memory
    kept_floats = _build.query(name, "kept", g // ng, ps)
    kept = (torch.empty(rows * splits * kept_floats, dtype=torch.float32, device=dev)
            if kept_floats else None)
    fn = _build.launcher(name, _ARGTYPES[name])
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), k_cache.data_ptr(),
              v_cache.data_ptr(), *(s.data_ptr() for s in sc), cl.data_ptr(), bt.data_ptr(),
              out.data_ptr(), ws.data_ptr(), arrivals.data_ptr(),
              None if kept is None else kept.data_ptr(), b, hq, hkv, num_pages, ps, mp, ng,
              splits, float(sm_scale), stream)
    _build.check(name, code)
    _build.launches[name] += 1
    return out


def decode_gqa_v6_defer(q, k_new, v_new, k_cache, v_cache, cached_lens, block_table,
                        sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v6_defer_ref(q, k_new, v_new, k_cache, v_cache, cached_lens,
                                       block_table, sm_scale)
    return _launch_v6("decode_v6_defer", q, k_new, v_new, k_cache, v_cache, None, cached_lens,
                      block_table, sm_scale, page_size)


def decode_gqa_v6_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                             cached_lens, block_table, sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v6_defer_ref(q, k_new, v_new, k_cache, v_cache, cached_lens,
                                       block_table, sm_scale, k_scales=k_scales,
                                       v_scales=v_scales)
    return _launch_v6("decode_v6_int8_defer", q, k_new, v_new, k_cache, v_cache,
                      (k_scales, v_scales), cached_lens, block_table, sm_scale, page_size)
