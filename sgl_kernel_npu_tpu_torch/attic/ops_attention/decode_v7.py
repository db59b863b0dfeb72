"""Two-tier KV: write-once int8 pages plus a bf16 token-major sidecar window
(counterpart of attic/ops_attention/decode_v7.py).

  tier 1  page-major int8 pages [P, Hkv, ps, D] with per-token f32 scales
          [P, Hkv, 1, ps], written W tokens at a time (window_flush);
  tier 2  a bf16 sidecar [S, W, Hkv*D]: row side_rows[b] holds the last
          cached % W tokens of sequence b, one [Hkv*D] row per token
          (sidecar_append).

  decode_gqa_v7_int8(q, q_blockdiag, k_new, v_new, k_cache, v_cache,
                     k_scales, v_scales, k_side, v_side, side_rows,
                     cached_lens, block_table, sm_scale, page_size,
                     window=WINDOW)
      cached_lens [B] excludes the current token: tokens [0, flushed) from
      the pages (flushed = cached // W * W), [flushed, cached) from the
      sidecar, the current one from k_new / v_new [B, Hkv, D]. q [B, Hq, D]
      bf16 -> [B, Hq, D] bf16. q_blockdiag (make_q_blockdiag) is taken for
      the JAX signature; the port computes the sidecar's per-head dots from
      q, the same sums (the block-diagonal q served the TPU's MXU).
  make_q_blockdiag, sidecar_append, window_flush: plain PyTorch, the caches
      written IN PLACE (the JAX package returned new arrays), no host sync.

Rounding, as the TPU kernel takes it: the pages as K14's int8 contract (the
K scale on the score, p times the V scale rounded to bf16), one step per
page; the sidecar as one more step with p rounded to bf16; the current
token with its p rounded to bf16. On a CUDA tensor decode_gqa_v7_int8
launches kernel K24 (csrc/decode_v7.cu: C's tensor-core loop, each row
split over the card's blocks where it has room, as skt_decode_v7_int8_splits
sizes it), counted under "decode_v7_int8"; on a CPU tensor it runs
decode_gqa_v7_int8_ref in that order.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...ops.attention.decode_v3 import V3_MAXG, _gather_pm, v3_groups
from ...ops.attention.decode_v6 import _init_state, _new_token, _step
from ...ops.attention.decode_v8 import quant_rows_int8
from ...utils import index_copy_kept_, use_kernel

WINDOW = 64     # sidecar depth and flush granularity (tokens), as the reference's

# q, k cache, v cache, k scales, v scales, k_new, v_new, k sidecar, v sidecar,
# side_rows, cached, block table, out, workspace, arrivals, B, Hq, Hkv, D, P,
# ps, MP, W, ng, S, sm_scale, stream
_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]


def make_q_blockdiag(q, hkv):
    """[B, Hq, D] -> [B, Hq, Hkv*D] with query head r's q in the columns of
    its kv head r // (Hq / Hkv), zeros elsewhere (q times a 0/1 mask, as the
    JAX package builds it)."""
    b, hq, d = q.shape
    g = hq // hkv
    qh = torch.arange(hq, device=q.device)[:, None] // g
    kh = torch.arange(hkv, device=q.device)[None, :]
    mask = (qh == kh).to(q.dtype)
    return (q[:, :, None, :] * mask[None, :, :, None]).reshape(b, hq, hkv * d)


def _wrap(idx, size):
    """Indices as JAX's .at[] takes them: negatives count from the end, then
    whether each lies in [0, size)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + size, idx)
    return idx, (idx >= 0) & (idx < size)


def sidecar_append(k_side, v_side, k_new, v_new, side_rows, offs):
    """Write one token per entry into the bf16 sidecar, in place: k_new /
    v_new [R, Hkv, D] at row side_rows [R], slot offs [R] of k_side / v_side
    [S, W, Hkv*D] (out-of-range entries dropped, as the JAX mode="drop").
    Returns the (mutated) sidecars."""
    s, w, hd = k_side.shape
    rows, rok = _wrap(side_rows, s)
    offs, ook = _wrap(offs, w)
    keep = rok & ook
    index = rows * w + offs
    r = k_new.shape[0]
    index_copy_kept_(k_side.view(-1, hd), index, k_new.reshape(r, hd), keep)
    index_copy_kept_(v_side.view(-1, hd), index, v_new.reshape(r, hd), keep)
    return k_side, v_side


def window_flush(k_cache, v_cache, k_scales, v_scales, k_side, v_side, side_rows, pages,
                 page_offs, do_flush, window=WINDOW):
    """Quantise each flushing entry's sidecar window (side_rows [R]) per
    (token, head) (decode_v8.quant_rows_int8, as the JAX q8) and write it at
    page pages[r], slots page_offs[r] .. + W of the int8 pages and scales, in
    place, where do_flush[r] holds and the window lies inside the cache (an
    entry outside is dropped whole, as the JAX scatter's FILL_OR_DROP).
    Returns the (mutated) caches."""
    num_pages, hkv, ps, d = k_cache.shape
    r = side_rows.shape[0]
    win_k = k_side[side_rows.long()].reshape(r, window, hkv, d)
    win_v = v_side[side_rows.long()].reshape(r, window, hkv, d)
    kq, vq, ks, vs = quant_rows_int8(win_k, win_v)       # [R, W, hkv, D], [R, W, hkv]
    page, off = pages.long(), page_offs.long()
    keep = (do_flush.bool() & (page >= 0) & (page < num_pages) & (off >= 0)
            & (off + window <= ps))
    h = torch.arange(hkv, device=page.device)
    t = torch.arange(window, device=page.device)
    rows = (((page[:, None, None] * hkv + h[None, :, None]) * ps + off[:, None, None]
             + t[None, None, :]).reshape(-1))                # [R * hkv * W]
    keep = keep[:, None, None].expand(r, hkv, window).reshape(-1)
    index_copy_kept_(k_cache.view(-1, d), rows, kq.transpose(1, 2).reshape(-1, d), keep)
    index_copy_kept_(v_cache.view(-1, d), rows, vq.transpose(1, 2).reshape(-1, d), keep)
    index_copy_kept_(k_scales.view(-1), rows, ks.transpose(1, 2).reshape(-1), keep)
    index_copy_kept_(v_scales.view(-1), rows, vs.transpose(1, 2).reshape(-1), keep)
    return k_cache, v_cache, k_scales, v_scales


def decode_gqa_v7_int8_ref(q, q_blockdiag, k_new, v_new, k_cache, v_cache, k_scales,
                           v_scales, k_side, v_side, side_rows, cached_lens, block_table,
                           sm_scale, page_size=None, window=WINDOW):
    """Plain version of K24 (module docstring); q_blockdiag is not read."""
    b, hq, d = q.shape
    _, hkv, ps, _ = k_cache.shape
    g = hq // hkv
    cached = cached_lens.long().clamp_min(0)
    flushed = cached // window * window
    k = _gather_pm(k_cache, None, block_table)          # exact int8 values
    v = _gather_pm(v_cache, None, block_table)
    ks = _gather_pm(k_scales.transpose(-1, -2), None, block_table)[..., 0]
    vs = _gather_pm(v_scales.transpose(-1, -2), None, block_table)[..., 0]
    qf = q.to(torch.bfloat16).float().reshape(b, hkv, g, d)
    m, l, acc = _init_state(b, hkv, g, d, q.device)
    for p0 in range(0, k.shape[2], ps):
        live = torch.arange(p0, p0 + ps, device=q.device)[None, :] < flushed[:, None]
        cols = slice(p0, p0 + ps)
        m, l, acc = _step(qf, k[:, :, cols], v[:, :, cols], live, sm_scale, m, l, acc,
                          ks[:, :, cols], vs[:, :, cols])
    rows = side_rows.long()
    sk = k_side[rows].reshape(b, window, hkv, d).transpose(1, 2).float()
    sv = v_side[rows].reshape(b, window, hkv, d).transpose(1, 2).float()
    live = torch.arange(window, device=q.device)[None, :] < (cached - flushed)[:, None]
    m, l, acc = _step(qf, sk, sv, live, sm_scale, m, l, acc)
    out = _new_token(qf, k_new, v_new, sm_scale, m, l, acc, q.dtype)
    return out.reshape(b, hq, d).to(q.dtype)


def decode_gqa_v7_int8(q, q_blockdiag, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                       k_side, v_side, side_rows, cached_lens, block_table, sm_scale,
                       page_size, window=WINDOW):
    if not use_kernel(q):
        return decode_gqa_v7_int8_ref(q, q_blockdiag, k_new, v_new, k_cache, v_cache,
                                      k_scales, v_scales, k_side, v_side, side_rows,
                                      cached_lens, block_table, sm_scale, page_size, window)
    name = "decode_v7_int8"
    b, hq, d = q.shape
    num_pages, hkv, ps, d2 = k_cache.shape
    if (v_cache.shape != k_cache.shape or d2 != d or d != 128 or ps != page_size
            or hq % hkv or hq // hkv not in (1, 2, 4, 8, 16)
            or k_side.shape[1:] != (window, hkv * d) or v_side.shape != k_side.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)}, pages {tuple(k_cache.shape)}, sidecar "
                         f"{tuple(k_side.shape)}: needs head dim 128, Hq / Hkv in 1, 2, 4, 8, "
                         f"16 and a [S, {window}, Hkv*128] sidecar")
    if (q.dtype != torch.bfloat16 or k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8
            or k_side.dtype != torch.bfloat16 or v_side.dtype != torch.bfloat16
            or k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32):
        raise TypeError(f"{name}: bf16 q and sidecar, int8 pages, f32 scales expected")
    dev = q.device
    q = q.contiguous()
    kn, vn = (x.to(torch.bfloat16).contiguous() for x in (k_new, v_new))
    rows = side_rows.to(torch.int32).contiguous()
    cl = cached_lens.to(torch.int32).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    out = torch.empty((b, hq, d), dtype=torch.bfloat16, device=dev)
    _build.check_operands(name, dev, q, k_cache, v_cache, k_scales, v_scales, kn, vn, k_side,
                          v_side, rows, cl, bt, out)
    g, mp = hq // hkv, bt.shape[1]
    ng = v3_groups(g)
    nrows = b * hkv * ng
    splits = _build.splits(name, b, hkv, g // ng, ng, mp, ps, window)
    ws = torch.empty(nrows * splits * V3_MAXG * (2 + d) if splits > 1 else 0,
                     dtype=torch.float32, device=dev)
    arrivals = _build.arrival_counters(name, dev, nrows)
    fn = _build.launcher(name, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scales.data_ptr(),
              v_scales.data_ptr(), kn.data_ptr(), vn.data_ptr(), k_side.data_ptr(),
              v_side.data_ptr(), rows.data_ptr(), cl.data_ptr(), bt.data_ptr(), out.data_ptr(),
              ws.data_ptr(), arrivals.data_ptr(), b, hq, hkv, d, num_pages, ps, mp, window, ng,
              splits, float(sm_scale), stream)
    _build.check(name, code)
    _build.launches[name] += 1
    return out
