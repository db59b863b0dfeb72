"""Fused scatter + attend over stacked per-layer caches (counterpart of
attic/ops_attention/decode_v4.py).

Caches are stacked page-major pages [L, P, Hkv, ps, D], bf16, or int8 with
per-token f32 scales [L, P, Hkv, 1, ps]; `layer_idx` picks the layer, a
Python int or a 0-dim tensor (read on the device, never on the host).

  decode_fused_v4_int8(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                       seq_lens, block_table, slot_mapping, layer_idx,
                       sm_scale, page_size)
      -> (att, k_cache, v_cache, k_scales, v_scales)
  decode_fused_v4(q, k_new, v_new, k_cache, v_cache, seq_lens, block_table,
                  slot_mapping, layer_idx, sm_scale, page_size)
      -> (att, k_cache, v_cache)
      write the current token k_new / v_new [B, Hkv, D] (int8: quantised per
      (token, head) as reshape_and_cache_gqa_page_major_int8 does) at
      slot_mapping [B] (< 0 writes nothing) into layer layer_idx, and attend:
      seq_lens [B] counts the current token, whose position is masked out of
      the pages and whose contribution is added from the values just
      written (int8: the dequantised row, in f32), as the TPU kernel does;
  scatter_stacked_int8(k, v, k_cache, v_cache, k_scales, v_scales,
                       layer_idx, slot_mapping)
      -> (k_cache, v_cache, k_scales, v_scales), the int8 write alone;
  decode_v4b_int8(q, k_cache, v_cache, k_scales, v_scales, seq_lens,
                  block_table, layer_idx, sm_scale, page_size)
      -> (att, k_cache, v_cache, k_scales, v_scales), the attention alone,
      the current token already in the cache (seq_lens counts it).
q [B, Hq, D] bf16, att [B, Hq, D] bf16.

The port writes the caches IN PLACE and returns the tensors it was given,
where the JAX package returned the aliased outputs of its Pallas calls;
nothing here syncs the host. The TPU kernels take f32 products and an
unrounded p (int8 rows dequantised as f32(row * scale)), K16's rounding. On
a CUDA tensor the three attentions launch their contracts of kernel K23
(csrc/decode_v3.cu, through decode_v3.launch_v3), each counted under its own
name; on a CPU tensor each
runs its plain version, the scatter then the pages in the TPU kernel's
order (decode.py::_pages_ref). scatter_stacked_int8 is plain PyTorch, as in
the JAX package.
"""

from __future__ import annotations

import torch

from ...ops.attention.decode import _pages_ref
from ...ops.attention.decode_v3 import _gather_pm, launch_v3
from ...ops.attention.decode_v8 import quant_rows_int8
from ...utils import index_copy_kept_, use_kernel


def _layer_index(layer_idx, device) -> torch.Tensor:
    """layer_idx (an int or a 0-dim tensor) as a 0-dim long tensor on device."""
    return torch.as_tensor(layer_idx, device=device).long().reshape(())


def _stacked_rows(slot_mapping, li, layers, num_pages, hkv, ps):
    """Token slots [T] at layer li -> row indices [T*hkv] of a
    [L*P*hkv*ps] view of stacked page-major pages, and whether each is kept
    (slot in [0, P*ps) and li in [0, L), as the JAX scatter's mode="drop"
    keeps them)."""
    slots = slot_mapping.long()
    keep = (slots >= 0) & (slots < num_pages * ps) & (li >= 0) & (li < layers)
    h = torch.arange(hkv, device=slots.device)
    page = (li * num_pages + slots // ps)[:, None]
    rows = (page * hkv + h[None, :]) * ps + (slots % ps)[:, None]
    return rows.reshape(-1), keep[:, None].expand(-1, hkv).reshape(-1)


def scatter_stacked_int8(k, v, k_cache, v_cache, k_scales, v_scales, layer_idx,
                         slot_mapping):
    """Quantise k, v [T, Hkv, D] per (token, head) (decode_v8.quant_rows_int8,
    bit-equal to the JAX scatter) and write them at slot_mapping [T] into
    layer layer_idx of the stacked int8 caches and scales, in place."""
    layers, num_pages, hkv, ps, d = k_cache.shape
    kq, vq, ks, vs = quant_rows_int8(k, v)
    li = _layer_index(layer_idx, k_cache.device)
    rows, keep = _stacked_rows(slot_mapping, li, layers, num_pages, hkv, ps)
    index_copy_kept_(k_cache.view(-1, d), rows, kq.reshape(-1, d), keep)
    index_copy_kept_(v_cache.view(-1, d), rows, vq.reshape(-1, d), keep)
    index_copy_kept_(k_scales.view(-1), rows, ks.reshape(-1), keep)
    index_copy_kept_(v_scales.view(-1), rows, vs.reshape(-1), keep)
    return k_cache, v_cache, k_scales, v_scales


def _layer(cache, layer_idx):
    """Layer layer_idx of a stacked cache: a view for an int, a copy for a
    tensor (no host read)."""
    if isinstance(layer_idx, torch.Tensor):
        return cache.index_select(0, _layer_index(layer_idx, cache.device).reshape(1))[0]
    return cache[layer_idx]


def _attend_ref(q, k_cache, v_cache, k_scales, v_scales, lens, block_table, layer_idx,
                sm_scale, new=None):
    """The pages of layer layer_idx in the TPU kernel's order (lens [B]
    live tokens each), then the current token `new` (k, v f32 [B, Hkv, D],
    unrounded) when given."""
    kc, vc = _layer(k_cache, layer_idx), _layer(v_cache, layer_idx)
    ks = vs = None
    if k_scales is not None:
        ks, vs = _layer(k_scales, layer_idx), _layer(v_scales, layer_idx)
    return _pages_ref(q, _gather_pm(kc, ks, block_table), _gather_pm(vc, vs, block_table),
                      lens, kc.shape[2], sm_scale, *(new or (None, None)), round_new=False)


def decode_fused_v4_int8_ref(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, seq_lens,
                             block_table, slot_mapping, layer_idx, sm_scale, page_size=None):
    """Plain version of K23's decode_fused_v4_int8 contract."""
    scatter_stacked_int8(k_new, v_new, k_cache, v_cache, k_scales, v_scales, layer_idx,
                         slot_mapping)
    kq, vq, ks, vs = quant_rows_int8(k_new, v_new)
    new = (kq.float() * ks[..., None], vq.float() * vs[..., None])
    att = _attend_ref(q, k_cache, v_cache, k_scales, v_scales, seq_lens - 1, block_table,
                      layer_idx, sm_scale, new)
    return att, k_cache, v_cache, k_scales, v_scales


def decode_fused_v4_ref(q, k_new, v_new, k_cache, v_cache, seq_lens, block_table, slot_mapping,
                        layer_idx, sm_scale, page_size=None):
    """Plain version of K23's decode_fused_v4 contract (bf16 caches)."""
    layers, num_pages, hkv, ps, d = k_cache.shape
    kn, vn = k_new.to(k_cache.dtype), v_new.to(v_cache.dtype)
    li = _layer_index(layer_idx, k_cache.device)
    rows, keep = _stacked_rows(slot_mapping, li, layers, num_pages, hkv, ps)
    index_copy_kept_(k_cache.view(-1, d), rows, kn.reshape(-1, d), keep)
    index_copy_kept_(v_cache.view(-1, d), rows, vn.reshape(-1, d), keep)
    att = _attend_ref(q, k_cache, v_cache, None, None, seq_lens - 1, block_table, layer_idx,
                      sm_scale, (kn.float(), vn.float()))
    return att, k_cache, v_cache


def decode_v4b_int8_ref(q, k_cache, v_cache, k_scales, v_scales, seq_lens, block_table,
                        layer_idx, sm_scale, page_size=None):
    """Plain version of K23's decode_v4b_int8 contract."""
    att = _attend_ref(q, k_cache, v_cache, k_scales, v_scales, seq_lens, block_table,
                      layer_idx, sm_scale)
    return att, k_cache, v_cache, k_scales, v_scales


def decode_fused_v4_int8(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, seq_lens,
                         block_table, slot_mapping, layer_idx, sm_scale, page_size):
    if not use_kernel(q):
        return decode_fused_v4_int8_ref(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                                        seq_lens, block_table, slot_mapping, layer_idx,
                                        sm_scale)
    att = launch_v3("decode_fused_v4_int8", q, k_cache, v_cache, (k_scales, v_scales),
                    (k_new, v_new), seq_lens, block_table, sm_scale, page_size,
                    layout="stacked", layer_idx=layer_idx, slots=slot_mapping)
    return att, k_cache, v_cache, k_scales, v_scales


def decode_fused_v4(q, k_new, v_new, k_cache, v_cache, seq_lens, block_table, slot_mapping,
                    layer_idx, sm_scale, page_size):
    if not use_kernel(q):
        return decode_fused_v4_ref(q, k_new, v_new, k_cache, v_cache, seq_lens, block_table,
                                   slot_mapping, layer_idx, sm_scale)
    att = launch_v3("decode_fused_v4", q, k_cache, v_cache, None, (k_new, v_new), seq_lens,
                    block_table, sm_scale, page_size, layout="stacked", layer_idx=layer_idx,
                    slots=slot_mapping)
    return att, k_cache, v_cache


def decode_v4b_int8(q, k_cache, v_cache, k_scales, v_scales, seq_lens, block_table, layer_idx,
                    sm_scale, page_size):
    if not use_kernel(q):
        return decode_v4b_int8_ref(q, k_cache, v_cache, k_scales, v_scales, seq_lens,
                                   block_table, layer_idx, sm_scale)
    att = launch_v3("decode_v4b_int8", q, k_cache, v_cache, (k_scales, v_scales), None,
                    seq_lens, block_table, sm_scale, page_size, layout="stacked",
                    layer_idx=layer_idx)
    return att, k_cache, v_cache, k_scales, v_scales
