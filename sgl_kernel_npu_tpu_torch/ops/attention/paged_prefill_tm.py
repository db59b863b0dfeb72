"""Chunked-prefill attention over token-major int8 pages plus the in-flight
bf16 chunk (counterpart of the JAX package's ops/attention/
paged_prefill_tm.py::paged_prefill_attention_tm).

The cache stays read-only: the prefix streams from the pages, the chunk's k/v
come as operands, and the model appends the chunk after its layer loop. One
call covers every sequence of the prefill batch ([S, T, ...] operands),
where the JAX model calls its kernel once per sequence.

On a CUDA tensor the wrapper launches kernel B (csrc/prefill_tm.cu); on a CPU
tensor it runs the plain version, `paged_prefill_attention_tm_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import cdiv, use_kernel
from .decode_v9 import _NEG_INF, _flash_update, _gather_layer

# q, chunk_k, chunk_v, k_cache, v_cache, k_scales, v_scales, block_tables,
# prefix_lens, valid_lens, out, S, T, hkv, G, P, ps, MP, li, sm_scale, stream
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
_ROWS = 64     # query rows per block: 64/G tokens x G heads


def paged_prefill_attention_tm_ref(q, chunk_k, chunk_v, k_cache, v_cache,
                                   k_scales, v_scales, block_tables,
                                   prefix_lens, valid_lens, sm_scale,
                                   page_size, layer_idx=0):
    """Plain version of kernel B (same contract as paged_prefill_attention_tm).

    It takes the TPU kernel's steps in its order, so it rounds where that
    kernel rounds: an online softmax over the prefix pages, then over the
    chunk in blocks of page_size tokens; k scale (1 for the chunk) on the
    scores, v scale on the probabilities, their product rounded to bf16
    before it meets V. A row that may see no key gets 0."""
    s, t, hq, d = q.shape
    hkv = chunk_k.shape[2]
    g = hq // hkv
    ps = page_size
    dev = q.device
    kp, ks = _gather_layer(k_cache, k_scales, layer_idx, block_tables, hkv)
    vp, vs = _gather_layer(v_cache, v_scales, layer_idx, block_tables, hkv)
    if kp.shape[2] != block_tables.shape[1] * ps:
        raise ValueError(f"page_size {page_size} does not match the cache")
    plen = prefix_lens.to(dev).clamp_min(0)[:, None, None, None]
    vlen = valid_lens.to(dev)[:, None, None, None]
    qf = q.float().reshape(s, t, hkv, g, d).permute(0, 2, 3, 1, 4)  # [S,h,g,T,D]
    ck = chunk_k.float().permute(0, 2, 1, 3)                         # [S,h,T,D]
    cv = chunk_v.float().permute(0, 2, 1, 3)
    state = (torch.full((s, hkv, g, t, 1), _NEG_INF, device=dev),
             torch.zeros((s, hkv, g, t, 1), device=dev),
             torch.zeros((s, hkv, g, t, d), device=dev))
    n_pre = int(cdiv(int(prefix_lens.max()), ps)) if s else 0
    for j in range(n_pre):                  # prefix pages: all visible
        lo, hi = j * ps, (j + 1) * ps
        vis = torch.arange(lo, hi, device=dev)[None, None, None, None, :] \
            < plen[..., None]                                        # [S,1,1,1,n]
        sc = torch.matmul(qf, kp[:, :, None, lo:hi].float().transpose(-1, -2))
        sc = sc * ks[:, :, None, None, lo:hi] * sm_scale
        sc = torch.where(vis, sc, _NEG_INF)
        vsr = torch.where(vis, vs[:, :, None, None, lo:hi], 0.0)
        state = _flash_update(state, sc, vsr, vp[:, :, None, lo:hi].float())
    qtok = torch.arange(t, device=dev)[:, None]
    for lo in range(0, t, ps):              # chunk blocks: causal, valid_len
        hi = min(lo + ps, t)
        col = torch.arange(lo, hi, device=dev)[None, :]
        vis = ((col <= qtok)[None, None, None] & (col < vlen[..., None]))
        sc = torch.matmul(qf, ck[:, :, None, lo:hi].transpose(-1, -2)) * sm_scale
        sc = torch.where(vis, sc, _NEG_INF)
        state = _flash_update(state, sc, vis.float(), cv[:, :, None, lo:hi])
    _, l_sum, acc = state      # a row that saw no key has acc == 0
    o = acc / l_sum.clamp_min(1e-37)
    return o.permute(0, 3, 1, 2, 4).reshape(s, t, hq, d).to(q.dtype)


def paged_prefill_attention_tm(q, chunk_k, chunk_v, k_cache, v_cache, k_scales,
                               v_scales, block_tables, prefix_lens, valid_lens,
                               sm_scale, page_size, layer_idx=0):
    """Deferred-write chunk prefill over token-major pages, batched.

    q [S, T, Hq, D] bf16; chunk_k/chunk_v [S, T, Hkv, D] bf16 (not yet in the
    cache); caches int8 [L, P, ps*Hkv, D] + scales f32 [L, P, 1, ps*Hkv];
    block_tables [S, MP]; prefix_lens [S] tokens already cached; valid_lens [S]
    real tokens of each chunk. Returns [S, T, Hq, D]."""
    if not use_kernel(q):
        return paged_prefill_attention_tm_ref(
            q, chunk_k, chunk_v, k_cache, v_cache, k_scales, v_scales,
            block_tables, prefix_lens, valid_lens, sm_scale, page_size,
            layer_idx)
    s, t, hq, d = q.shape
    hkv = chunk_k.shape[2]
    l, num_pages, rows, _ = k_cache.shape
    g = hq // hkv
    if (d != 128 or hq % hkv or _ROWS % g or rows != page_size * hkv
            or not 0 <= layer_idx < l or chunk_k.shape != (s, t, hkv, d)):
        raise ValueError(f"prefill_tm: q {tuple(q.shape)}, chunk "
                         f"{tuple(chunk_k.shape)}, cache {tuple(k_cache.shape)}: "
                         f"needs D == 128 and G dividing {_ROWS}")
    dev = q.device
    ck = chunk_k.to(q.dtype).contiguous()
    cv = chunk_v.to(q.dtype).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    plen = prefix_lens.to(torch.int32).contiguous()
    vlen = valid_lens.to(torch.int32).contiguous()
    ops = (q, ck, cv, k_cache, v_cache, k_scales, v_scales, bt, plen, vlen)
    _build.check_operands("prefill_tm", dev, *ops)
    if q.dtype != torch.bfloat16 or k_cache.dtype != torch.int8 \
            or k_scales.dtype != torch.float32:
        raise TypeError("prefill_tm: bf16 q, int8 cache, f32 scales expected")
    out = torch.empty_like(q)
    if s == 0 or t == 0:
        return out
    fn = _build.launcher("prefill_tm", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(*(x.data_ptr() for x in ops), out.data_ptr(), s, t, hkv, g,
              num_pages, page_size, bt.shape[1], layer_idx, float(sm_scale),
              stream)
    _build.check("prefill_tm", code)
    _build.launches["prefill_tm"] += 1
    return out
