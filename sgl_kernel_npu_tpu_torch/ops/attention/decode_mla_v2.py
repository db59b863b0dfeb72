"""MLA decode over a COMBINED latent cache with the current token folded in
(deferred write), the latent append after the layer loop, and the int8
rows' quant and scale update (counterpart of the JAX package's
ops/attention/decode_mla_v2.py).

Pages are [L, P, ps, C] with C = kv_lora_rank + qk_rope_dim (DeepSeek 512 |
64 = 576): a row is the token's ctkv | krope. bf16 pages, or int8 pages with
per-token scales [L, P, 1, ps] f32. The JAX package pads C up to a multiple
of 128 because Mosaic needs 128-lane DMA slices; the port keeps C as it is.

On a CUDA tensor `decode_mla_v3_defer` launches kernel K5
(csrc/decode_mla_c.cu) and `append_mla` kernel K6 (csrc/append_mla.cu); on a
CPU tensor each runs its plain version. The JAX package's v2 contract
(decode_mla_pallas_v2_defer, bf16 pages) is `decode_mla_v3_defer` without
scales. The JAX package returns new caches; the port writes them IN
PLACE: `append_mla` and `scatter_latent_scales` mutate the tensors they are
given.

The plain versions `decode_mla_v2_ref` / `decode_mla_v3_int8_ref` take the
TPU kernels' rounding order (_kernel_mla_v3): an online softmax over chunks
of cp = min(max_pages, CHUNK_PAGES) pages, p * scale rounded to bf16 before
P.V, the current row folded in f32 at the end. (The JAX twins of the same
names take one softmax over all columns in f32, which rounds elsewhere.)
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import use_kernel
from ..quant import INV_INT8_MAX

_NEG_INF = -1e30
CHUNK_PAGES = 4          # pages per online-softmax step (the JAX SKT_MLA_CP default)
HEADS = 16               # K5's heads per sequence: the mma M tile

# q, new, cache, scales, cached, block_table, out, B, C, lkv, P, ps, MP, cp,
# li, sm_scale, int8, stream
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# rows, cache, pages, offs, L, B, P, ps, row_bytes, stream
_APPEND_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _chunk_pages(max_pages: int, chunk_pages=None) -> int:
    return max(1, min(max_pages, chunk_pages or CHUNK_PAGES))


def _decode_chunks_ref(q, new_latent, kv_cache, kv_scales, cached_lens,
                       block_table, sm_scale, page_size, lkv, layer_idx, cp):
    """The K5 contract in plain PyTorch, chunk by chunk (module docstring)."""
    b, h, c = q.shape
    ps = kv_cache.shape[2]
    if ps != page_size or kv_cache.shape[3] != c:
        raise ValueError(f"decode_mla: q {tuple(q.shape)} vs cache "
                         f"{tuple(kv_cache.shape)}, page_size {page_size}")
    mp = block_table.shape[1]
    bt = block_table.long()
    rows = kv_cache[layer_idx][bt].reshape(b, mp * ps, c)
    svec = (kv_scales[layer_idx][bt].reshape(b, mp * ps).float()
            if kv_scales is not None else None)
    clen = cached_lens.long().clamp(0, mp * ps)
    qf = q.to(torch.bfloat16).float()
    dev = q.device
    m = torch.full((b, h, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, lkv), dtype=torch.float32, device=dev)
    tc = cp * ps
    for c0 in range(0, mp * ps, tc):
        cols = torch.arange(c0, min(c0 + tc, mp * ps), device=dev)
        live = cols[None, :] < clen[:, None]                        # [B, n]
        kv = rows[:, cols].float()
        sc = torch.einsum("bhc,bnc->bhn", qf, kv)
        if svec is not None:
            sc = sc * svec[:, None, cols]
        sc = torch.where(live[:, None, :], sc * sm_scale, _NEG_INF)
        mh = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - mh)
        pexp = torch.exp(sc - mh)
        p3 = pexp * svec[:, None, cols] if svec is not None else pexp
        p3 = torch.where(live[:, None, :], p3, 0.0).to(torch.bfloat16).float()
        vals = torch.where(live[..., None], kv[..., :lkv], 0.0)
        new_l = l * alpha + torch.where(live[:, None, :], pexp, 0.0).sum(-1, keepdim=True)
        new_acc = acc * alpha + torch.einsum("bhn,bnc->bhc", p3, vals)
        # a chunk with no live column changes nothing (the kernel skips it)
        any_live = live.any(-1)[:, None, None]
        m = torch.where(any_live, mh, m)
        l = torch.where(any_live, new_l, l)
        acc = torch.where(any_live, new_acc, acc)
    nrow = new_latent.to(torch.bfloat16).float()
    s_new = (qf * nrow[:, None, :]).sum(-1, keepdim=True) * sm_scale
    m2 = torch.maximum(m, s_new)
    alpha2 = torch.exp(m - m2)
    pexp2 = torch.exp(s_new - m2)
    l_fin = l * alpha2 + pexp2
    out = (acc * alpha2 + pexp2 * nrow[:, None, :lkv]) / l_fin.clamp_min(1e-37)
    return out.to(q.dtype)


def decode_mla_v2_ref(q, kv_cache, new_latent, cached_lens, block_table,
                      sm_scale, page_size, lkv, layer_idx=0, chunk_pages=None):
    """Plain version of kernel K5 on a bf16 cache (argument order of the JAX
    twin)."""
    cp = _chunk_pages(block_table.shape[1], chunk_pages)
    return _decode_chunks_ref(q, new_latent, kv_cache, None, cached_lens,
                              block_table, sm_scale, page_size, lkv, layer_idx, cp)


def decode_mla_v3_int8_ref(q, kv_cache, kv_scales, new_latent, cached_lens,
                           block_table, sm_scale, page_size, lkv, layer_idx=0,
                           chunk_pages=None):
    """Plain version of kernel K5 on an int8 cache with per-token scales
    [L, P, 1, ps] (argument order of the JAX twin)."""
    cp = _chunk_pages(block_table.shape[1], chunk_pages)
    return _decode_chunks_ref(q, new_latent, kv_cache, kv_scales, cached_lens,
                              block_table, sm_scale, page_size, lkv, layer_idx, cp)


def decode_mla_v3_defer(q, new_latent, kv_cache, cached_lens, block_table,
                        sm_scale, page_size, lkv, layer_idx=0, chunk_pages=None,
                        kv_scales=None):
    """Combined-cache deferred-write MLA decode (the v2 and v3 contract).

    q [B, H, C] bf16 (nope' | rope); new_latent [B, C] this step's latent
    row, not yet in the cache; kv_cache [L, P, ps, C] bf16, or int8 with
    kv_scales [L, P, 1, ps] f32; cached_lens [B] EXCLUDING the current token;
    block_table [B, max_pages]. Returns [B, H, lkv] bf16. The JAX kernel's
    `group` (sequences per TPU loop body) has no counterpart: K5 runs a
    cluster of CTAs per sequence."""
    cp = _chunk_pages(block_table.shape[1], chunk_pages)
    if not use_kernel(q):
        return _decode_chunks_ref(q, new_latent, kv_cache, kv_scales, cached_lens,
                                  block_table, sm_scale, page_size, lkv,
                                  layer_idx, cp)
    return _decode_mla_c(q, new_latent, kv_cache, kv_scales, cached_lens,
                         block_table, sm_scale, page_size, lkv, layer_idx, cp)


def _decode_mla_c(q, new_latent, kv_cache, kv_scales, cached_lens, block_table,
                  sm_scale, page_size, lkv, layer_idx, cp):
    """Launch kernel K5 on CUDA tensors."""
    b, h, c = q.shape
    l, num_pages, ps, c2 = kv_cache.shape
    int8 = kv_scales is not None
    if (h != HEADS or c2 != c or c % 16 or lkv % 16 or lkv > min(512, c)
            or ps != page_size or ps % 16 or not 0 <= layer_idx < l
            or l * num_pages * ps >= 2 ** 31
            or (int8 and kv_scales.shape != (l, num_pages, 1, ps))):
        raise ValueError(f"decode_mla_c: q {tuple(q.shape)}, cache "
                         f"{tuple(kv_cache.shape)}, lkv {lkv}: needs {HEADS} heads, "
                         "C % 16 == 0, lkv % 16 == 0, lkv <= min(512, C), ps % 16 == 0")
    want = torch.int8 if int8 else torch.bfloat16
    if (q.dtype != torch.bfloat16 or kv_cache.dtype != want
            or (int8 and kv_scales.dtype != torch.float32)):
        raise TypeError("decode_mla_c: bf16 q with an int8 cache and f32 scales, "
                        "or a bf16 cache")
    dev = q.device
    nl = new_latent.to(torch.bfloat16).contiguous()
    cached = cached_lens.to(torch.int32).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    ops = [q, nl, kv_cache, cached, bt] + ([kv_scales] if int8 else [])
    _build.check_operands("decode_mla_c", dev, *ops)
    if nl.shape != (b, c):
        raise ValueError(f"decode_mla_c: new_latent {tuple(nl.shape)} != {(b, c)}")
    out = torch.empty((b, h, lkv), dtype=torch.bfloat16, device=dev)
    fn = _build.launcher("decode_mla_c", _DECODE_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(q.data_ptr(), nl.data_ptr(), kv_cache.data_ptr(),
              kv_scales.data_ptr() if int8 else None, cached.data_ptr(),
              bt.data_ptr(), out.data_ptr(), b, c, lkv, num_pages, ps,
              bt.shape[1], cp, int(layer_idx), float(sm_scale), int(int8), stream)
    _build.check("decode_mla_c", code)
    _build.launches["decode_mla_c"] += 1
    return out


def quant_latent_rows(new):
    """Per-row symmetric int8 quant of [L, B, C] latent rows -> (int8 rows,
    f32 scales [L, B]). scale = max(amax, 1e-7) * f32(1/127), as compiled
    XLA multiplies for the JAX code's division by 127 (ops/quant.py); the
    rows are divided by it and clipped to [-127, 127]."""
    n32 = new.float()
    amax = n32.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-7) * INV_INT8_MAX
    q = torch.round(n32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def scatter_latent_scales(kv_scales, new_scales, pages, offs):
    """Scale update on [L, P, 1, ps], in place: kv_scales[:, pages[b], 0,
    offs[b]] = new_scales[:, b] for every b with 0 <= pages[b] < P. The JAX
    package's dense masked select (one owner per page, as a decode step
    gives), taken with tensor ops only, so no host sync."""
    l, num_pages, _, ps = kv_scales.shape
    b = pages.shape[0]
    dev = kv_scales.device
    pg = pages.long()
    valid = (pg >= 0) & (pg < num_pages)
    # owner of each page; index P collects the dropped rows
    owner = torch.full((num_pages + 1,), -1, dtype=torch.long, device=dev)
    owner.scatter_(0, torch.where(valid, pg, num_pages),
                   torch.arange(b, dtype=torch.long, device=dev))
    owner = owner[:num_pages]
    own = owner.clamp_min(0)
    own_off = torch.where(owner >= 0, offs.long()[own], -1)
    mask = torch.arange(ps, device=dev)[None, :] == own_off[:, None]      # [P, ps]
    vals = new_scales.float()[:, own]                                      # [L, P]
    kv_scales.copy_(torch.where(mask[None, :, None, :], vals[:, :, None, None],
                                kv_scales))
    return kv_scales


def append_mla_ref(new, kv_cache, pages, offs):
    """Plain version of kernel K6 (same contract as `append_mla`)."""
    num_pages = kv_cache.shape[1]
    bi = ((pages >= 0) & (pages < num_pages)).nonzero(as_tuple=True)[0]
    kv_cache[:, pages[bi].long(), offs[bi].long()] = new[:, bi].to(kv_cache.dtype)
    return kv_cache


def append_mla(new, kv_cache, pages, offs):
    """Write one latent row per (layer, sequence) into [L, P, ps, C] pages,
    in place. new [L, B, C] in the cache's dtype (int8 or bf16); pages [B]
    (>= P, the sentinel, or < 0 drops the row); offs [B]. Returns the
    (mutated) cache."""
    if not use_kernel(kv_cache):
        return append_mla_ref(new, kv_cache, pages, offs)
    l, num_pages, ps, c = kv_cache.shape
    if new.dim() != 3 or new.shape[0] != l or new.shape[2] != c:
        raise ValueError(f"append_mla: rows {tuple(new.shape)} vs cache "
                         f"{tuple(kv_cache.shape)}")
    if new.dtype != kv_cache.dtype or kv_cache.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError("append_mla: int8 or bf16 rows in the cache's dtype expected")
    row_bytes = c * kv_cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"append_mla: a row of {row_bytes} bytes is no multiple of 16")
    b = new.shape[1]
    new = new.contiguous()
    pages = pages.to(torch.int32).contiguous()
    offs = offs.to(torch.int32).contiguous()
    _build.check_operands("append_mla", kv_cache.device, new, kv_cache, pages, offs)
    fn = _build.launcher("append_mla", _APPEND_ARGTYPES)
    stream = torch.cuda.current_stream(kv_cache.device).cuda_stream
    code = fn(new.data_ptr(), kv_cache.data_ptr(), pages.data_ptr(), offs.data_ptr(),
              l, b, num_pages, ps, row_bytes, stream)
    _build.check("append_mla", code)
    _build.launches["append_mla"] += 1
    return kv_cache
