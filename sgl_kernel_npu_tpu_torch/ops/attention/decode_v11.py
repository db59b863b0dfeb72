"""Head-major-within-page ("tm2") int8 KV pages: the paged GQA decode with the
current token folded in, the post-step append and the scale update
(counterpart of the JAX package's ops/attention/decode_v11.py).

Pages are k/v [L, P, hkv, ps, D] int8, row h*ps + t, so head h's tokens of a
page are one contiguous [ps, D] block; scales are [L, P, hkv, ps] f32.

On a CUDA tensor `decode_gqa_v11_int8_defer` launches kernel K3
(csrc/decode_tm2.cu) and `append_tm2_int8` kernel K4 (csrc/append_tm2.cu);
on a CPU tensor each runs its plain version. The port writes the cache IN
PLACE where the JAX package returned new arrays: `append_tm2_int8` and
`scatter_scales_tm2` mutate the tensors they are given.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import use_kernel
from . import decode_v9 as _v9

# q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, cached, block_table,
# out, B, hkv, G, P, ps, MP, li, sm_scale, stream
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_void_p])
# kq, vq, k_cache, v_cache, pages, offs, L, B, P, hkv, ps, D, stream
_APPEND_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_GROUPS = (1, 2, 4, 8)


def _gather_layer_tm2(cache, scales, layer_idx, block_table):
    """Pages of `block_table` [B, MP] at layer layer_idx, head-major:
    values [B, hkv, MP*ps, D] and scales [B, hkv, MP*ps]."""
    _, _, hkv, ps, d = cache.shape
    b, mp = block_table.shape
    bt = block_table.long()
    vals = cache[layer_idx][bt].permute(0, 2, 1, 3, 4).reshape(b, hkv, mp * ps, d)
    sc = scales[layer_idx][bt].permute(0, 2, 1, 3).reshape(b, hkv, mp * ps)
    return vals, sc


def decode_gqa_v11_int8_defer_ref(q, k_new, v_new, k_cache, v_cache, k_scales,
                                  v_scales, cached_lens, block_table, sm_scale,
                                  page_size, layer_idx=0):
    """Plain version of kernel K3, shared by the v11 and v13 contracts: one
    page per online-softmax step, as both TPU kernels take them (v13 only
    batches several sequences per loop body; a page wholly past the cached
    length changes nothing, as v11 skips it)."""
    if k_cache.shape[3] != page_size:
        raise ValueError(f"page_size {page_size} does not match the cache "
                         f"{tuple(k_cache.shape)}")
    kc, ks = _gather_layer_tm2(k_cache, k_scales, layer_idx, block_table)
    vc, vs = _gather_layer_tm2(v_cache, v_scales, layer_idx, block_table)
    return _v9.attend_gathered_ref(q, k_new, v_new, kc, ks, vc, vs, cached_lens,
                                   page_size, sm_scale)


def decode_gqa_v11_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales,
                              v_scales, cached_lens, block_table, sm_scale,
                              page_size, layer_idx=0):
    """tm2 int8 deferred-write decode.

    q [B, Hq, D] bf16; k_new/v_new [B, Hkv, D] bf16 (the current token, not
    yet in the cache); caches int8 [L, P, Hkv, ps, D] + scales f32
    [L, P, Hkv, ps], layer picked by layer_idx; cached_lens [B] tokens
    already cached; block_table [B, MP] page ids. Returns [B, Hq, D]."""
    if not use_kernel(q):
        return decode_gqa_v11_int8_defer_ref(
            q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, cached_lens,
            block_table, sm_scale, page_size, layer_idx)
    return _decode_tm2(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                       cached_lens, block_table, sm_scale, page_size, layer_idx)


def _decode_tm2(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                cached_lens, block_table, sm_scale, page_size, layer_idx):
    """Launch kernel K3 on CUDA tensors (the v11 and v13 contract)."""
    b, hq, d = q.shape
    hkv = k_new.shape[1]
    l, num_pages, hkv2, ps, _ = k_cache.shape
    g = hq // hkv if hkv else 0
    if (d != 128 or hkv2 != hkv or hq != g * hkv or g not in _GROUPS
            or ps != page_size or not 0 <= layer_idx < l
            or k_scales.shape != (l, num_pages, hkv, ps)
            or k_cache.shape != v_cache.shape or k_scales.shape != v_scales.shape):
        raise ValueError(f"decode_tm2: q {tuple(q.shape)}, kv heads {hkv}, cache "
                         f"{tuple(k_cache.shape)}, scales {tuple(k_scales.shape)}: "
                         f"needs D == 128, G in {_GROUPS}")
    if q.dtype != torch.bfloat16 or k_cache.dtype != torch.int8 \
            or k_scales.dtype != torch.float32:
        raise TypeError("decode_tm2: bf16 q, int8 cache, f32 scales expected")
    dev = q.device
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    cached = cached_lens.to(torch.int32).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    ops = (q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, cached, bt)
    _build.check_operands("decode_tm2", dev, *ops)
    out = torch.empty_like(q)
    fn = _build.launcher("decode_tm2", _DECODE_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(*(t.data_ptr() for t in ops), out.data_ptr(), b, hkv, g,
              num_pages, ps, bt.shape[1], int(layer_idx), float(sm_scale), stream)
    _build.check("decode_tm2", code)
    _build.launches["decode_tm2"] += 1
    return out


def append_tm2_int8_ref(kq, vq, k_cache, v_cache, pages, offs):
    """Plain version of kernel K4 (same contract as `append_tm2_int8`)."""
    num_pages = k_cache.shape[1]
    bi = ((pages >= 0) & (pages < num_pages)).nonzero(as_tuple=True)[0]
    pg, off = pages[bi].long(), offs[bi].long()
    # [L, nb, hkv, D] -> the [nb, L, hkv, D] order of the indexed view
    k_cache.permute(1, 3, 0, 2, 4)[pg, off] = kq[:, bi].permute(1, 0, 2, 3)
    v_cache.permute(1, 3, 0, 2, 4)[pg, off] = vq[:, bi].permute(1, 0, 2, 3)
    return k_cache, v_cache


def append_tm2_int8(kq, vq, k_cache, v_cache, pages, offs):
    """Write one quantized token per (layer, row) into tm2 pages, in place.
    kq/vq [L, B, hkv, D] int8; k_cache/v_cache [L, P, hkv, ps, D] int8;
    pages [B] page index (>= P, the sentinel, or < 0 drops the row); offs [B]
    token slot within the page. Returns the (mutated) caches."""
    if not use_kernel(k_cache):
        return append_tm2_int8_ref(kq, vq, k_cache, v_cache, pages, offs)
    l, num_pages, hkv, ps, d = k_cache.shape
    if (kq.shape != vq.shape or kq.dim() != 4 or kq.shape[0] != l
            or kq.shape[2] != hkv or kq.shape[3] != d
            or k_cache.shape != v_cache.shape or d % 16):
        raise ValueError(f"append_tm2: kq {tuple(kq.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    if any(t.dtype != torch.int8 for t in (kq, vq, k_cache, v_cache)):
        raise TypeError("append_tm2: int8 rows and caches expected")
    b = kq.shape[1]
    pages = pages.to(torch.int32).contiguous()
    offs = offs.to(torch.int32).contiguous()
    _build.check_operands("append_tm2", k_cache.device, kq, vq, k_cache,
                          v_cache, pages, offs)
    fn = _build.launcher("append_tm2", _APPEND_ARGTYPES)
    stream = torch.cuda.current_stream(k_cache.device).cuda_stream
    code = fn(kq.data_ptr(), vq.data_ptr(), k_cache.data_ptr(),
              v_cache.data_ptr(), pages.data_ptr(), offs.data_ptr(),
              l, b, num_pages, hkv, ps, d, stream)
    _build.check("append_tm2", code)
    _build.launches["append_tm2"] += 1
    return k_cache, v_cache


def scatter_scales_tm2(k_scales, v_scales, ks, vs, pages, offs):
    """Decode scale update, in place. k_scales/v_scales [L, P, hkv, ps] f32;
    ks/vs [L*B, hkv] (layer-major); pages [B] (>= P, or < 0, drops the row),
    offs [B]. A direct indexed write of the slots the JAX version's dense
    masked select writes (one token per page, as a decode step gives)."""
    l, num_pages, hkv, _ = k_scales.shape
    b = pages.shape[0]
    bi = ((pages >= 0) & (pages < num_pages)).nonzero(as_tuple=True)[0]
    pg, off = pages[bi].long(), offs[bi].long()
    # [L, nb, hkv] -> the [nb, L, hkv] order of the indexed view
    k_scales.permute(1, 3, 0, 2)[pg, off] = ks.float().reshape(l, b, hkv)[:, bi].permute(1, 0, 2)
    v_scales.permute(1, 3, 0, 2)[pg, off] = vs.float().reshape(l, b, hkv)[:, bi].permute(1, 0, 2)
    return k_scales, v_scales
