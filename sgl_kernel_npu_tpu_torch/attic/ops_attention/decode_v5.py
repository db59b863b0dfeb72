"""The grid-pipelined deferred paged decode (counterpart of
attic/ops_attention/decode_v5.py): page-major ("hm") pages [P, Hkv, ps, D],
the cache holds cached_lens [B] tokens (clamped at 0), the current token's
k_new / v_new [B, Hkv, D] fold in last.

  decode_gqa_v5_defer(q, k_new, v_new, k_cache, v_cache, cached_lens,
                      block_table, sm_scale, page_size)
  decode_gqa_v5_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales,
                           v_scales, cached_lens, block_table, sm_scale,
                           page_size)
q [B, Hq, D] bf16 -> [B, Hq, D] bf16; int8 caches with per-token f32 scales
[P, Hkv, 1, ps].

The TPU kernels (decode_gqa_pallas_v5_defer, decode_gqa_pallas_v5_int8_defer)
take one page per grid step and the v3 deferred kernels' arithmetic: f32
products (int8 rows dequantised as f32(row * scale)), an unrounded p. On a
CUDA tensor each launches its contract of kernel K23 (csrc/decode_v3.cu,
K16's design), counted under "decode_v5_defer" / "decode_v5_int8_defer"; on a
CPU tensor it runs `decode_gqa_v5_defer_ref`, the pages in the TPU kernel's
order (decode_v3.decode_gqa_v3_ref).
"""

from __future__ import annotations

from ...ops.attention.decode_v3 import decode_gqa_v3_ref, launch_v3
from ...utils import use_kernel


def decode_gqa_v5_defer_ref(q, k_new, v_new, k_cache, v_cache, cached_lens, block_table,
                            sm_scale, page_size=None, k_scales=None, v_scales=None):
    """Plain version of both contracts (bf16 pages, or int8 with scales)."""
    return decode_gqa_v3_ref(q, k_cache, v_cache, cached_lens, block_table, sm_scale,
                             k_scales=k_scales, v_scales=v_scales, k_new=k_new, v_new=v_new)


def decode_gqa_v5_defer(q, k_new, v_new, k_cache, v_cache, cached_lens, block_table,
                        sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v5_defer_ref(q, k_new, v_new, k_cache, v_cache, cached_lens,
                                       block_table, sm_scale)
    return launch_v3("decode_v5_defer", q, k_cache, v_cache, None, (k_new, v_new),
                     cached_lens, block_table, sm_scale, page_size)


def decode_gqa_v5_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                             cached_lens, block_table, sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v5_defer_ref(q, k_new, v_new, k_cache, v_cache, cached_lens,
                                       block_table, sm_scale, k_scales=k_scales,
                                       v_scales=v_scales)
    return launch_v3("decode_v5_int8_defer", q, k_cache, v_cache, (k_scales, v_scales),
                     (k_new, v_new), cached_lens, block_table, sm_scale, page_size)
