"""Page-major ("hm") KV pages: the cache scatters and the v3 paged GQA decode
(counterpart of the JAX package's ops/attention/decode_v3.py).

Pages are k/v [P, Hkv, ps, D] (one layer; the model's caches lead with the
layer dim), bf16, or int8 with per-token f32 scales [P, Hkv, 1, ps].

  decode_gqa_v3(q, k_cache, v_cache, seq_lens, block_table, sm_scale, ps)
  decode_gqa_v3_int8(q, k_cache, v_cache, k_scales, v_scales, seq_lens, ...)
      the current token is already in the cache; seq_lens [B] includes it;
  decode_gqa_v3_defer(q, k_new, v_new, k_cache, v_cache, cached_lens, ...)
  decode_gqa_v3_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales,
                           v_scales, cached_lens, ...)
      the cache holds cached_lens [B] tokens (clamped at 0) and the current
      token's k_new / v_new [B, Hkv, D] fold in last;
q [B, Hq, D] -> [B, Hq, D] bf16. On a CUDA tensor each launches its contract
of kernel K16 (csrc/decode_hm.cu), counted under its own name; on a CPU
tensor it runs its plain version, the TPU kernel's order in f32
(decode.py::_pages_ref).

The scatters write the cache IN PLACE where the JAX package returned new
arrays, with no host sync (utils.index_copy_kept_); a slot < 0 drops its row.
"""

from __future__ import annotations

import torch

from ...utils import index_copy_kept_, use_kernel
from .decode import _launch_hm, _pages_ref
from .decode_v8 import quant_rows_int8


def _slot_rows(slot_mapping, hkv, ps, num_pages):
    """Token slots [T] -> row indices [T*hkv] of a [P*hkv*ps] view of the
    pages (row (page*hkv + h)*ps + off) and whether each is kept."""
    slots = slot_mapping.long()
    keep = (slots >= 0) & (slots < num_pages * ps)
    h = torch.arange(hkv, device=slots.device)
    rows = ((slots // ps)[:, None] * hkv + h[None, :]) * ps + (slots % ps)[:, None]
    return rows.reshape(-1), keep[:, None].expand(-1, hkv).reshape(-1)


def reshape_and_cache_gqa_page_major(k, v, k_cache, v_cache, slot_mapping):
    """Scatter k, v [T, Hkv, D] into page-major caches [P, Hkv, ps, D] at
    slot_mapping [T] (page * ps + offset, -1 = skip), in place. Returns the
    (mutated) caches."""
    num_pages, hkv, ps, d = k_cache.shape
    rows, keep = _slot_rows(slot_mapping, hkv, ps, num_pages)
    index_copy_kept_(k_cache.view(-1, d), rows, k.reshape(-1, d), keep)
    index_copy_kept_(v_cache.view(-1, d), rows, v.reshape(-1, d), keep)
    return k_cache, v_cache


def reshape_and_cache_gqa_page_major_int8(k, v, k_cache, v_cache, k_scale_cache,
                                          v_scale_cache, slot_mapping):
    """The int8 scatter: k, v [T, Hkv, D] quantised per (token, head)
    (decode_v8.quant_rows_int8: scale = max(absmax, 1e-7) * f32(1/127), as
    compiled XLA takes the JAX code's division by 127) into int8 caches [P,
    Hkv, ps, D] and f32 scales [P, Hkv, 1, ps], in place. Returns the
    (mutated) caches."""
    num_pages, hkv, ps, d = k_cache.shape
    kq, vq, ks, vs = quant_rows_int8(k, v)
    rows, keep = _slot_rows(slot_mapping, hkv, ps, num_pages)
    index_copy_kept_(k_cache.view(-1, d), rows, kq.reshape(-1, d), keep)
    index_copy_kept_(v_cache.view(-1, d), rows, vq.reshape(-1, d), keep)
    index_copy_kept_(k_scale_cache.view(-1), rows, ks.reshape(-1), keep)
    index_copy_kept_(v_scale_cache.view(-1), rows, vs.reshape(-1), keep)
    return k_cache, v_cache, k_scale_cache, v_scale_cache


def _gather_pm(cache, scales, block_table):
    """Pages of `block_table` [B, MP] from page-major cache [P, Hkv, ps, D]
    -> f32 [B, Hkv, MP*ps, D], int8 rows dequantised as f32(row * scale)."""
    b, mp = block_table.shape
    _, hkv, ps, d = cache.shape
    bt = block_table.long()
    vals = cache[bt].transpose(1, 2).reshape(b, hkv, mp * ps, d).float()
    if scales is None:
        return vals
    return vals * scales[bt].transpose(1, 2).reshape(b, hkv, mp * ps, 1).float()


def decode_gqa_v3_ref(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size=None,
                      k_scales=None, v_scales=None, k_new=None, v_new=None):
    """Plain version of every v3 contract (_kernel, _kernel_int8,
    _kernel_defer, _kernel_int8_defer of the JAX decode_v3.py): the pages in
    the TPU kernel's order, all f32, a deferred token last."""
    return _pages_ref(q, _gather_pm(k_cache, k_scales, block_table),
                      _gather_pm(v_cache, v_scales, block_table), seq_lens,
                      k_cache.shape[2], sm_scale, k_new, v_new)


def decode_gqa_v3(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v3_ref(q, k_cache, v_cache, seq_lens, block_table, sm_scale)
    return _launch_hm("decode_v3", q, k_cache, v_cache, None, None, seq_lens, block_table,
                      sm_scale, page_size)


def decode_gqa_v3_int8(q, k_cache, v_cache, k_scales, v_scales, seq_lens, block_table,
                       sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v3_ref(q, k_cache, v_cache, seq_lens, block_table, sm_scale,
                                 k_scales=k_scales, v_scales=v_scales)
    return _launch_hm("decode_v3_int8", q, k_cache, v_cache, (k_scales, v_scales), None,
                      seq_lens, block_table, sm_scale, page_size)


def decode_gqa_v3_defer(q, k_new, v_new, k_cache, v_cache, cached_lens, block_table,
                        sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v3_ref(q, k_cache, v_cache, cached_lens, block_table, sm_scale,
                                 k_new=k_new, v_new=v_new)
    return _launch_hm("decode_v3_defer", q, k_cache, v_cache, None, (k_new, v_new),
                      cached_lens, block_table, sm_scale, page_size)


def decode_gqa_v3_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                             cached_lens, block_table, sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v3_ref(q, k_cache, v_cache, cached_lens, block_table, sm_scale,
                                 k_scales=k_scales, v_scales=v_scales, k_new=k_new,
                                 v_new=v_new)
    return _launch_hm("decode_v3_int8_defer", q, k_cache, v_cache, (k_scales, v_scales),
                      (k_new, v_new), cached_lens, block_table, sm_scale, page_size)
