"""Paged decode attention (counterpart of the JAX package's
ops/attention/decode.py): GQA over head-major bf16 pages (decode_gqa_ref,
decode_gqa_pallas, decode_gqa) and MLA over split latent caches
(decode_mla_ref, decode_mla_pallas, decode_mla).

  decode_gqa(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size)
    q        [B, Hq, Dk]
    k_cache  [Hkv, num_pages, page_size, Dk]   (head-major pages)
    v_cache  [Hkv, num_pages, page_size, Dv]
    -> out   [B, Hq, Dv]
As in the JAX package, `decode_gqa` takes the kernel path only when q's and
v's head dims are multiples of 128: on a CUDA tensor kernel K10 (head dim
128, or 256 with bf16 q and pages as Qwen3-Next-80B-A3B's attention has it,
counted under "decode_hm256"; bf16 q and pages: csrc/decode_hm.cu, C's
tensor-core loop with p kept
in f32, each row split over the card's blocks as decode_v3.launch_v3 sizes
it; f32 q and pages, as models/moe.py passes them: csrc/decode_hm_f32.cu, a
CUDA-core f32 loop), on a CPU tensor its plain version `decode_gqa_hm_ref`
in the TPU kernel's page order; other head dims take `decode_gqa_ref`, one
softmax over all keys.

  decode_mla(q, ckv_cache, krope_cache, seq_lens, block_table, sm_scale, page_size)
    q            [B, H, Lkv + Lrope]   (nope' | rope, DeepSeek 512 + 64)
    ckv_cache    [num_pages, page_size, Lkv]    (one latent head)
    krope_cache  [num_pages, page_size, Lrope]
    -> out       [B, H, Lkv]
seq_lens includes the current token, which mla_preprocess has already
written into the caches.

For MLA, on a CUDA tensor `decode_mla` launches kernel K7 (csrc/decode_mla.cu); on a
CPU tensor it runs `decode_mla_ref`, the plain version in the TPU kernel's
order (one page per online-softmax step, all f32). The kernel serves
DeepSeek's widths only: Lkv 512, Lrope even and <= 64, H a multiple of 4.
It splits each sequence's tokens over blocks of the card (`mla_splits`,
`mla_split_bounds`) and merges the splits in split order.

`decode_mla_int8_ref` is the plain MLA decode over the int8 latent cache of
mla_preprocess's int8_nzcache mode (no kernel behind it in either package).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import cdiv, use_kernel

_NEG_INF = -1e30

# q, ckv, krope, seq_lens, block_table, out, ws, arrivals, B, H, lkv, lrope,
# ps, MP, S, sm_scale, stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
# K7's split plan (csrc/decode_mla.cu): 16 heads a block, rounds of 32
# tokens, splits of at least 2 rounds, at most 16 splits a sequence
MLA_HEADS = 16
MLA_ROUND = 32
MLA_MIN_ROUNDS = 2
MLA_MAX_SPLITS = 16


def _gather_hm(k_cache, v_cache, block_table):
    """[Hkv, P, ps, D] pages of each row's table -> f32 [B, Hkv, MP*ps, D]."""
    b, mp = block_table.shape
    hkv, _, ps, _ = k_cache.shape
    bt = block_table.long()
    k = k_cache[:, bt].transpose(0, 1).reshape(b, hkv, mp * ps, -1).float()
    v = v_cache[:, bt].transpose(0, 1).reshape(b, hkv, mp * ps, -1).float()
    return k, v


def decode_gqa_ref(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size=None):
    """The JAX package's decode_gqa_ref: gather, one masked softmax over all
    keys, f32; the result in q's dtype."""
    b, hq, dk = q.shape
    hkv = k_cache.shape[0]
    k, v = _gather_hm(k_cache, v_cache, block_table)
    qf = q.float().reshape(b, hkv, hq // hkv, dk)
    logits = torch.einsum("bhgd,bhnd->bhgn", qf, k) * sm_scale
    mask = torch.arange(k.shape[2], device=q.device)[None, :] < seq_lens.long()[:, None]
    logits = torch.where(mask[:, None, None, :], logits, _NEG_INF)
    out = torch.einsum("bhgn,bhnd->bhgd", torch.softmax(logits, -1), v)
    return out.reshape(b, hq, -1).to(q.dtype)


def _pages_ref(q, k, v, lens, ps, sm_scale, k_new=None, v_new=None, round_new=True):
    """The TPU kernels' order over gathered f32 rows k, v [B, Hkv, MP*ps, D]
    (dequantised as f32(row * scale) where the cache is int8): one page per
    online-softmax step, pages past lens [B] (clamped at 0) skipped, all f32;
    a deferred token k_new / v_new [B, Hkv, D] (rounded to q's dtype, unless
    round_new is False) folds in last as one more step of one column
    (decode_v3.py::_new_token_update of the JAX package). The result in q's
    dtype."""
    b, hq, dk = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    dv = v.shape[-1]
    qf = q.float().reshape(b, hkv, g, dk)
    slen = lens.long().clamp_min(0)
    m = torch.full((b, hkv, g, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, dv), dtype=torch.float32, device=q.device)
    for p0 in range(0, k.shape[2], ps):
        live = torch.arange(p0, p0 + ps, device=q.device)[None, :] < slen[:, None]
        kp = k[:, :, p0:p0 + ps]
        vp = torch.where(live[:, None, :, None], v[:, :, p0:p0 + ps], 0.0)
        s = torch.einsum("bhgd,bhnd->bhgn", qf, kp) * sm_scale
        s = torch.where(live[:, None, None, :], s, _NEG_INF)
        mh = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mh)
        pexp = torch.where(live[:, None, None, :], torch.exp(s - mh), 0.0)
        new_l = l * alpha + pexp.sum(-1, keepdim=True)
        new_acc = acc * alpha + torch.einsum("bhgn,bhnd->bhgd", pexp, vp)
        page_live = (p0 < slen)[:, None, None, None]
        m = torch.where(page_live, mh, m)
        l = torch.where(page_live, new_l, l)
        acc = torch.where(page_live, new_acc, acc)
    if k_new is not None:
        kn = (k_new.to(q.dtype) if round_new else k_new).float()
        vn = (v_new.to(q.dtype) if round_new else v_new).float()
        s = torch.einsum("bhgd,bhd->bhg", qf, kn)[..., None] * sm_scale
        mh = torch.maximum(m, s)
        alpha = torch.exp(m - mh)
        pexp = torch.exp(s - mh)
        l = l * alpha + pexp
        acc = acc * alpha + pexp * vn[:, :, None, :]
    return (acc / l.clamp_min(1e-37)).reshape(b, hq, dv).to(q.dtype)


def decode_gqa_hm_ref(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size=None):
    """Plain version of kernel K10: the TPU kernel's order (decode_v2.py:34-94
    and decode.py:101-142 of the JAX package), one page per online-softmax
    step, pages past seq_len skipped, all f32; the result in q's dtype."""
    k, v = _gather_hm(k_cache, v_cache, block_table)
    return _pages_ref(q, k, v, seq_lens, k_cache.shape[2], sm_scale)


def decode_gqa_hm(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size):
    """Paged GQA decode over head-major bf16 or f32 pages (module
    docstring): kernel K10 on the card (head dim 128, or 256 for bf16 q and
    pages; Hq / Hkv in 1, 2, 4, 8, 16; launched through decode_v3.launch_v3,
    K16's contract arguments, with the workspace and arrival counters of a
    split row), counted under "decode_hm" (bf16), "decode_hm256" (bf16 at
    head dim 256) or "decode_hm_f32" (f32 q and pages);
    decode_gqa_hm_ref on the CPU. seq_lens [B] includes the current token,
    which is already in the cache. Returns [B, Hq, D] in q's dtype."""
    if not use_kernel(q):
        return decode_gqa_hm_ref(q, k_cache, v_cache, seq_lens, block_table, sm_scale,
                                 page_size)
    from .decode_v3 import launch_v3        # decode_v3 imports this module
    name = "decode_hm256" if q.shape[-1] == 256 else "decode_hm"
    return launch_v3(name, q, k_cache, v_cache, None, None, seq_lens, block_table,
                     sm_scale, page_size, layout="kv_head")


def decode_gqa(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size):
    """The JAX package's dispatcher (decode.py:289-300): the kernel path
    (decode_gqa_hm) when q's and v's head dims are multiples of 128, else
    decode_gqa_ref."""
    if q.shape[-1] % 128 == 0 and v_cache.shape[-1] % 128 == 0:
        return decode_gqa_hm(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size)
    return decode_gqa_ref(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size)


def decode_gqa_int8kv_ref(q, k_cache, v_cache, k_scales, v_scales, seq_lens, block_table,
                          sm_scale, page_size=None):
    """Plain version of K16's decode_int8kv contract: int8 head-major pages
    [Hkv, P, ps, D] dequantised at gather as f32(row * scale) (scales
    [Hkv, P, 1, ps]), then the TPU kernel's page order
    (_gqa_int8kv_kernel, decode.py:329-363 of the JAX package), all f32."""
    b, mp = block_table.shape
    hkv, _, ps, _ = k_cache.shape
    bt = block_table.long()

    def rows(cache, scales):
        vals = cache[:, bt].transpose(0, 1).reshape(b, hkv, mp * ps, -1).float()
        sc = scales[:, bt].transpose(0, 1).reshape(b, hkv, mp * ps, 1).float()
        return vals * sc
    return _pages_ref(q, rows(k_cache, k_scales), rows(v_cache, v_scales), seq_lens, ps,
                      sm_scale)


def decode_gqa_int8kv(q, k_cache, v_cache, k_scales, v_scales, seq_lens, block_table,
                      sm_scale, page_size):
    """Paged GQA decode over an int8 head-major cache: caches int8 [Hkv, P,
    ps, D], scales f32 [Hkv, P, 1, ps] (per token and head); seq_lens [B]
    includes the current token, which is already in the cache. Kernel K16
    on the card (its decode_int8kv contract in csrc/decode_v3.cu, head dim
    128), counted under "decode_int8kv"; decode_gqa_int8kv_ref on the CPU.
    Returns [B, Hq, D] bf16. No model calls it (the JAX package's
    decode.py:366 contract)."""
    if not use_kernel(q):
        return decode_gqa_int8kv_ref(q, k_cache, v_cache, k_scales, v_scales, seq_lens,
                                     block_table, sm_scale, page_size)
    from .decode_v3 import launch_v3        # decode_v3 imports this module
    return launch_v3("decode_int8kv", q, k_cache, v_cache, (k_scales, v_scales), None,
                     seq_lens, block_table, sm_scale, page_size, layout="kv_head")


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


def mla_splits(sms: int, b: int, h: int, max_len: int) -> int:
    """S, the splits of K7's grid: one wave of the card's `sms` SMs over
    the (sequence, 16-head tile) rows, at most MLA_MAX_SPLITS, and no more
    than the longest possible sequence (`max_len` tokens) fills with splits
    of MLA_MIN_ROUNDS rounds."""
    rows = b * cdiv(h, MLA_HEADS)
    return max(1, min(MLA_MAX_SPLITS, sms // max(rows, 1),
                      cdiv(max_len, MLA_ROUND) // MLA_MIN_ROUNDS))


def mla_split_bounds(n: int, s: int):
    """[(t0, t1), ...]: the splits of a sequence of n live tokens under a
    grid of s splits, in order. Its R = ceil(n / 32) rounds go to S_b =
    min(s, max(1, R // 2)) splits, split i taking rounds R i // S_b ..
    R (i + 1) // S_b (tokens to n at most): none empty unless n is 0 (one
    split of no tokens). The kernel takes the same bounds from the
    sequence's length on the card; the grid's other splits of the sequence
    return."""
    r = cdiv(n, MLA_ROUND)
    sb = min(s, max(1, r // MLA_MIN_ROUNDS))
    return [(min(n, MLA_ROUND * (r * i // sb)), min(n, MLA_ROUND * (r * (i + 1) // sb)))
            for i in range(sb)]


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
    mp = bt.shape[1]
    rows = b * cdiv(h, MLA_HEADS)
    splits = mla_splits(torch.cuda.get_device_properties(dev).multi_processor_count, b, h,
                        mp * ps)
    ws = arrivals = None
    if splits > 1:
        ws = torch.empty(rows * splits * MLA_HEADS * (2 + lkv), dtype=torch.float32,
                         device=dev)
        arrivals = _build.arrival_counters("decode_mla", dev, rows)
    fn = _build.launcher("decode_mla", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(q.data_ptr(), ckv_cache.data_ptr(), krope_cache.data_ptr(), sl.data_ptr(),
              bt.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
              arrivals.data_ptr() if arrivals is not None else None, b, h, lkv, lrope, ps,
              mp, splits, float(sm_scale), stream)
    _build.check("decode_mla", code)
    _build.launches["decode_mla"] += 1
    return out


def _int8_scores(q8, k8):
    """Exact int32 sums q8 [B, H, L] int8 . k8 [B, N, L] int8 -> [B, H, N]:
    on the CPU one int32 batched product; on the card `torch._int_mm` a
    sequence (cuBLASLt's int8 GEMM, int32 accumulation), its H rows padded
    to at least 32 and to a multiple of 8, N to a multiple of 8 (_int_mm's
    shape rules)."""
    if q8.device.type == "cpu":
        return torch.bmm(q8.int(), k8.int().transpose(1, 2))
    b, h, lkv = q8.shape
    n = k8.shape[1]
    rows, n_pad = max(32, cdiv(h, 8) * 8), cdiv(n, 8) * 8
    qp = q8.new_zeros((rows, lkv))
    kp = k8.new_zeros((n_pad, lkv))
    out = torch.empty((b, h, n), dtype=torch.int32, device=q8.device)
    for i in range(b):
        qp[:h] = q8[i]
        kp[:n] = k8[i]
        out[i] = torch._int_mm(qp, kp.t())[:h, :n]
    return out


def decode_mla_int8_ref(q_nope_q, q_pe, ckv_cache_q, krope_cache, q_nope_scale, ctkv_scale,
                        seq_lens, block_table, sm_scale, page_size=None):
    """MLA decode over the int8 latent cache of mla_preprocess's
    int8_nzcache mode (decode.py:421-460 of the JAX package, plain there too:
    no kernel behind it). q_nope_q [B, H, Lkv] int8, quantised with the
    per-head q_nope_scale [H] MULTIPLYING; ckv_cache_q [P, ps, Lkv] int8,
    quantised with the scalar ctkv_scale DIVIDING; q_pe [B, H, Lrope] and
    krope_cache [P, ps, Lrope] float. So
      qk_nope = (q_q . ckv_q) * ctkv_scale / q_nope_scale[h]
      out     = (p . ckv_q) * ctkv_scale
    The int8 x int8 products are summed exactly in int32 (`_int8_scores`:
    an int32 product on the CPU, torch._int_mm on the card), the epilogue in
    f32. seq_lens includes the current token. Returns [B, H, Lkv] f32."""
    b, h, lkv = q_nope_q.shape
    ps = ckv_cache_q.shape[1]
    mp = block_table.shape[1]
    dev = q_nope_q.device
    bt = block_table.long()
    cs = torch.as_tensor(ctkv_scale, dtype=torch.float32, device=dev).reshape(())
    ckv_q = ckv_cache_q[bt].reshape(b, mp * ps, lkv)
    krope = krope_cache[bt].reshape(b, mp * ps, -1).float()
    qk_n = _int8_scores(q_nope_q, ckv_q).float() * (cs / q_nope_scale.float())[None, :, None]
    qk_r = torch.einsum("bhd,bnd->bhn", q_pe.float(), krope)
    logits = (qk_n + qk_r) * sm_scale
    mask = torch.arange(mp * ps, device=dev)[None, :] < seq_lens.long()[:, None]
    logits = torch.where(mask[:, None, :], logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhn,bnd->bhd", p, ckv_q.float()) * cs
