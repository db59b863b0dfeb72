"""Paged MLA decode over split latent caches (counterpart of the MLA half of
the JAX package's ops/attention/decode.py: decode_mla_ref, decode_mla_pallas,
decode_mla).

  decode_mla(q, ckv_cache, krope_cache, seq_lens, block_table, sm_scale, page_size)
    q            [B, H, Lkv + Lrope]   (nope' | rope, DeepSeek 512 + 64)
    ckv_cache    [num_pages, page_size, Lkv]    (one latent head)
    krope_cache  [num_pages, page_size, Lrope]
    -> out       [B, H, Lkv]
seq_lens includes the current token, which mla_preprocess has already
written into the caches.

On a CUDA tensor `decode_mla` launches kernel K7 (csrc/decode_mla.cu); on a
CPU tensor it runs `decode_mla_ref`, the plain version in the TPU kernel's
order (one page per online-softmax step, all f32). The kernel serves
DeepSeek's widths only: Lkv 512, Lrope even and <= 64, H a multiple of 4.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import use_kernel

_NEG_INF = -1e30

# q, ckv, krope, seq_lens, block_table, out, B, H, lkv, lrope, ps, MP,
# sm_scale, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def _gather(ckv_cache, krope_cache, block_table):
    b, mp = block_table.shape
    ps = ckv_cache.shape[1]
    bt = block_table.long()
    ckv = ckv_cache[bt].reshape(b, mp * ps, -1).float()
    krope = krope_cache[bt].reshape(b, mp * ps, -1).float()
    return ckv, krope


def decode_mla_ref(q, ckv_cache, krope_cache, seq_lens, block_table, sm_scale,
                   page_size=None):
    """Plain version of kernel K7: the TPU kernel's order, one page per
    online-softmax step, all f32 (decode.py:192-237 of the JAX package)."""
    b, h, d = q.shape
    lkv = ckv_cache.shape[-1]
    ps = ckv_cache.shape[1]
    ckv, krope = _gather(ckv_cache, krope_cache, block_table)
    qf = q.float()
    slen = seq_lens.long()
    m = torch.full((b, h, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, lkv), dtype=torch.float32, device=q.device)
    for p0 in range(0, ckv.shape[1], ps):
        cols = torch.arange(p0, p0 + ps, device=q.device)
        live = cols[None, :] < slen[:, None]
        ck, kr = ckv[:, p0:p0 + ps], krope[:, p0:p0 + ps]
        s = torch.einsum("bhd,bnd->bhn", qf[..., :lkv], ck)
        s = s + torch.einsum("bhd,bnd->bhn", qf[..., lkv:], kr)
        s = torch.where(live[:, None, :], s * sm_scale, _NEG_INF)
        mh = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mh)
        pexp = torch.where(live[:, None, :], torch.exp(s - mh), 0.0)
        new_l = l * alpha + pexp.sum(-1, keepdim=True)
        new_acc = acc * alpha + torch.einsum("bhn,bnd->bhd", pexp,
                                             torch.where(live[..., None], ck, 0.0))
        # a page past the sequence's end is skipped, as the TPU kernel skips it
        page_live = (p0 < slen)[:, None, None]
        m = torch.where(page_live, mh, m)
        l = torch.where(page_live, new_l, l)
        acc = torch.where(page_live, new_acc, acc)
    return (acc / l.clamp_min(1e-37)).to(q.dtype)


def decode_mla(q, ckv_cache, krope_cache, seq_lens, block_table, sm_scale, page_size):
    """Paged MLA decode (module docstring). Returns [B, H, Lkv] in q's dtype."""
    if not use_kernel(q):
        return decode_mla_ref(q, ckv_cache, krope_cache, seq_lens, block_table,
                                    sm_scale, page_size)
    b, h, d = q.shape
    num_pages, ps, lkv = ckv_cache.shape
    lrope = krope_cache.shape[-1]
    if (d != lkv + lrope or krope_cache.shape[:2] != (num_pages, ps) or ps != page_size
            or lkv != 512 or lrope % 2 or lrope > 64 or h % 4):
        raise ValueError(f"decode_mla: q {tuple(q.shape)}, ckv {tuple(ckv_cache.shape)}, "
                         f"krope {tuple(krope_cache.shape)}: needs Lkv 512, Lrope even "
                         "and <= 64, H a multiple of 4")
    if any(t.dtype != torch.bfloat16 for t in (q, ckv_cache, krope_cache)):
        raise TypeError("decode_mla: bf16 q and caches expected")
    dev = q.device
    sl = seq_lens.to(torch.int32).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    q = q.contiguous()
    _build.check_operands("decode_mla", dev, q, ckv_cache, krope_cache, sl, bt)
    out = torch.empty((b, h, lkv), dtype=torch.bfloat16, device=dev)
    fn = _build.launcher("decode_mla", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(q.data_ptr(), ckv_cache.data_ptr(), krope_cache.data_ptr(), sl.data_ptr(),
              bt.data_ptr(), out.data_ptr(), b, h, lkv, lrope, ps, bt.shape[1],
              float(sm_scale), stream)
    _build.check("decode_mla", code)
    _build.launches["decode_mla"] += 1
    return out
