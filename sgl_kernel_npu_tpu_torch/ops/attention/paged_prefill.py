"""Paged flash prefill of a chunk off the page-major ("hm") cache, driven by
per-query-tile page lists (counterpart of the JAX package's
ops/attention/paged_prefill.py: `paged_prefill_attention`).

  paged_prefill_attention(q, kv_cache, block_table, prefix_len, sm_scale,
                          page_size, page_sel=None, page_cnt=None,
                          block_q=128)
q [T, Hq, D], the chunk's queries, already written to the cache at
positions prefix_len .. prefix_len + T - 1; kv_cache a (k, v) bf16 tuple of
[P, Hkv, ps, D], or the int8 dict {"k", "v", "ks", "vs"} with scales
[P, Hkv, 1, ps]; block_table [MP] (logical -> physical page); prefix_len the
tokens cached before the chunk. Query tile qi (block_q = min(block_q, T)
tokens) walks a page list: by default the dense causal one, pages 0 ..
ceil((prefix_len + min((qi + 1) * block_q, T)) / ps) - 1 (at most MP); or
page_sel [NQ, S] / page_cnt [NQ] (per kv head: [Hkv, NQ, S] / [Hkv, NQ]),
logical page numbers. Causality is by logical position: column c of logical
page lp is visible to token i iff lp * ps + c <= prefix_len + i. Returns
[T, Hq, D] in q's dtype.

`paged_prefill_attention_batch` takes S chunks of one length T at once
(q [S, T, Hq, D], block_tables [S, MP], prefix_lens [S], the dense
schedule), as the model's batched prefill stacks one call per sequence.

`block_sparse_paged_attention(q, kv_cache, block_table, block_mask,
prefix_len, sm_scale, page_size, max_sel=0)` is the compute-skipping tier
of block-sparse attention: block_mask [NQ, NK] or per kv head [Hkv, NQ, NK]
(the sparse estimator's, sparse.sparse_block_estimate*) becomes page lists
through `block_mask_to_page_lists` (plain PyTorch), and query tiles of one
page (block_q = page_size) visit only their selected pages.

On a CUDA tensor every entry point launches kernel K15 (csrc/prefill_hm.cu)
once, counted under "prefill_hm"; on a CPU tensor they run
`paged_prefill_attention_ref`, the TPU kernel's page order in f32 (int8 rows
dequantised as f32(row * scale)).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import cdiv, use_kernel

_NEG_INF = -1e30
# q, k, v, ks, vs, block_tables, prefix, page_sel, page_cnt, out, int8, S, T,
# Hq, Hkv, D, ps, MP, block_q, NS, per_head, sm_scale, stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
_PAGE_SIZES = (16, 32, 64, 128)


def _caches(kv_cache):
    if isinstance(kv_cache, dict):
        return kv_cache["k"], kv_cache["v"], kv_cache["ks"], kv_cache["vs"]
    return kv_cache[0], kv_cache[1], None, None


def paged_prefill_attention_ref(q, kv_cache, block_table, prefix_len, sm_scale, page_size,
                                page_sel=None, page_cnt=None, block_q: int = 128):
    """Plain version of K15 (_kernel of the JAX paged_prefill.py): per query
    tile, the pages of its list one online-softmax step each, all f32; a
    tile with an empty list gives 0."""
    kc, vc, ksc, vsc = _caches(kv_cache)
    t, hq, d = q.shape
    _, hkv, ps, _ = kc.shape
    dv = vc.shape[-1]
    g = hq // hkv
    mp = block_table.shape[0]
    bq = min(block_q, t)
    nq = cdiv(t, bq)
    dev = q.device
    qf = torch.zeros((nq * bq, hq, d), dtype=torch.float32, device=dev)
    qf[:t] = q.float()
    q4 = qf.reshape(nq, bq, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(nq, hkv, bq * g, d)
    plen = int(prefix_len)
    bt = block_table.long()
    heads = torch.arange(hkv, device=dev)
    cols = torch.arange(ps, device=dev)
    out = torch.empty((nq, hkv, bq * g, dv), dtype=torch.float32, device=dev)
    for qi in range(nq):
        if page_sel is None:
            need = plen + min((qi + 1) * bq, t)
            cnt = torch.full((hkv,), min(cdiv(need, ps), mp), device=dev)
            sel = torch.arange(mp, device=dev).expand(hkv, mp)
        elif page_sel.dim() == 3:
            sel, cnt = page_sel[:, qi].to(dev), page_cnt[:, qi].to(dev)
        else:
            sel = page_sel[qi].to(dev).expand(hkv, -1)
            cnt = page_cnt[qi].to(dev).expand(hkv)
        tok = qi * bq + torch.arange(bq * g, device=dev) // g
        m = torch.full((hkv, bq * g, 1), _NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((hkv, bq * g, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((hkv, bq * g, dv), dtype=torch.float32, device=dev)
        for j in range(int(cnt.max()) if cnt.numel() else 0):
            active = j < cnt
            lp = torch.where(active, sel[:, j].long(), 0)
            phys = bt[lp]
            kp = kc[phys, heads].float()                       # [Hkv, ps, D]
            vp = vc[phys, heads].float()
            if ksc is not None:
                kp = kp * ksc[phys, heads, 0].float()[..., None]
                vp = vp * vsc[phys, heads, 0].float()[..., None]
            s = torch.einsum("hrd,hcd->hrc", q4[qi], kp) * sm_scale
            col = lp[:, None, None] * ps + cols[None, None, :]
            s = torch.where(col <= plen + tok[None, :, None], s, _NEG_INF)
            mh = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - mh)
            p = torch.exp(s - mh)
            new_l = l * alpha + p.sum(-1, keepdim=True)
            new_acc = acc * alpha + torch.einsum("hrc,hcd->hrd", p, vp)
            act = active[:, None, None]
            m = torch.where(act, mh, m)
            l = torch.where(act, new_l, l)
            acc = torch.where(act, new_acc, acc)
        out[qi] = acc / l.clamp_min(1e-37)
    out = out.reshape(nq, hkv, bq, g, dv).permute(0, 2, 1, 3, 4).reshape(nq * bq, hq, dv)
    return out[:t].to(q.dtype)


def _prefill_hm(q, kv_cache, block_tables, prefix_lens, sm_scale, page_size, block_q,
                page_sel=None, page_cnt=None):
    """One launch of K15 over S chunks: q [S, T, Hq, D] -> [S, T, Hq, D]."""
    kc, vc, ksc, vsc = _caches(kv_cache)
    s, t, hq, d = q.shape
    num_pages, hkv, ps, dk = kc.shape
    int8 = ksc is not None
    if (vc.shape != kc.shape or dk != d or d != 128 or ps != page_size or hq % hkv
            or ps not in _PAGE_SIZES):
        raise ValueError(f"prefill_hm: q {tuple(q.shape)}, caches {tuple(kc.shape)}: needs "
                         f"head dim 128 and a page size in {_PAGE_SIZES}")
    want = torch.int8 if int8 else torch.bfloat16
    if q.dtype != torch.bfloat16 or kc.dtype != want or vc.dtype != want:
        raise TypeError(f"prefill_hm: bf16 q and {want} caches expected")
    dev = q.device
    q = q.contiguous()
    bts = block_tables.to(torch.int32).contiguous()
    plens = prefix_lens.to(device=dev, dtype=torch.int32).reshape(s).contiguous()
    sel = cnt = None
    if page_sel is not None:
        sel = page_sel.to(device=dev, dtype=torch.int32).contiguous()
        cnt = page_cnt.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    opt = [x for x in (ksc, vsc, sel, cnt) if x is not None]
    _build.check_operands("prefill_hm", dev, q, kc, vc, *opt, bts, plens, out)

    def ptr(x):
        return None if x is None else x.data_ptr()
    fn = _build.launcher("prefill_hm", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ptr(ksc), ptr(vsc), bts.data_ptr(),
              plens.data_ptr(), ptr(sel), ptr(cnt), out.data_ptr(), int(int8), s, t, hq, hkv,
              d, ps, bts.shape[1], min(block_q, t), 0 if sel is None else sel.shape[-1],
              int(sel is not None and sel.dim() == 3), float(sm_scale), stream)
    _build.check("prefill_hm", code)
    _build.launches["prefill_hm"] += 1
    return out


def paged_prefill_attention(q, kv_cache, block_table, prefix_len, sm_scale, page_size,
                            page_sel=None, page_cnt=None, block_q: int = 128):
    """Flash chunk prefill over the page-major cache (module docstring)."""
    if not use_kernel(q):
        return paged_prefill_attention_ref(q, kv_cache, block_table, prefix_len, sm_scale,
                                           page_size, page_sel, page_cnt, block_q)
    plen = torch.as_tensor(prefix_len, dtype=torch.int32, device=q.device).reshape(1)
    return _prefill_hm(q[None], kv_cache, block_table[None], plen, sm_scale, page_size,
                       block_q, page_sel, page_cnt)[0]


def paged_prefill_attention_batch(q, kv_cache, block_tables, prefix_lens, sm_scale,
                                  page_size, block_q: int = 128):
    """S chunks of length T under the dense causal schedule: q [S, T, Hq, D],
    block_tables [S, MP], prefix_lens [S] -> [S, T, Hq, D]; one launch of
    K15 on the card, one plain call per chunk on the CPU."""
    if not use_kernel(q):
        return torch.stack([
            paged_prefill_attention_ref(q[si], kv_cache, block_tables[si], prefix_lens[si],
                                        sm_scale, page_size, block_q=block_q)
            for si in range(q.shape[0])])
    return _prefill_hm(q, kv_cache, block_tables, prefix_lens, sm_scale, page_size, block_q)


def block_mask_to_page_lists(block_mask, max_sel: int):
    """An estimator block mask [NQ, NK] or [H, NQ, NK] (True: the query tile
    attends the kv block) as K15's page lists: (page_sel [..., NQ, max_sel]
    int32, the selected logical pages first in ascending order, the rest 0;
    page_cnt [..., NQ] int32, at most max_sel)."""
    nk = block_mask.shape[-1]
    ids = torch.arange(nk, dtype=torch.int32, device=block_mask.device).expand(block_mask.shape)
    key = torch.where(block_mask, ids, nk + ids)
    order = torch.sort(key, dim=-1).values[..., :max_sel]
    page_cnt = block_mask.sum(dim=-1).clamp(max=max_sel).to(torch.int32)
    page_sel = torch.where(order < nk, order, 0).to(torch.int32)
    return page_sel, page_cnt


def block_sparse_paged_attention(q, kv_cache, block_table, block_mask, prefix_len, sm_scale,
                                 page_size, max_sel: int = 0):
    """Block-sparse attention that skips the pages a mask leaves out (module
    docstring); q [T, Hq, D] with NQ = ceil(T / page_size) query tiles."""
    max_sel = max_sel or block_mask.shape[-1]
    page_sel, page_cnt = block_mask_to_page_lists(block_mask, max_sel)
    return paged_prefill_attention(q, kv_cache, block_table, prefix_len, sm_scale, page_size,
                                   page_sel=page_sel, page_cnt=page_cnt, block_q=page_size)
