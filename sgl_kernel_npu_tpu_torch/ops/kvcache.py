"""Paged-KV cache ops (counterpart of the JAX package's ops/kvcache.py,
limited to what the ported paths run): `reshape_and_cache_mla`, the latent
cache scatter of mla_preprocess, and `reshape_and_cache_gqa`, the head-major
scatter of the Qwen3-Next attention layers. The JAX package returns new
caches; the port writes them in place."""

from __future__ import annotations

import torch

from ..utils import index_copy_kept_


def _put_rows(cache, slots, rows):
    """cache [P, ps, D] viewed as P * ps rows; rows [T, D] go to `slots` [T];
    a slot < 0 or >= P * ps drops its row (the JAX scatter's mode="drop"),
    with no host sync (utils.index_copy_kept_)."""
    flat = cache.view(-1, cache.shape[-1])
    slots = slots.long()
    index_copy_kept_(flat, slots, rows, (slots >= 0) & (slots < flat.shape[0]))


def reshape_and_cache_mla(ckv, krope, ckv_cache, krope_cache, slot_mapping):
    """MLA latent cache scatter, in place: ckv [T, Lkv], krope [T, Lrope];
    caches [num_pages, page_size, L]; slot_mapping [T] global slot ids
    (page * page_size + offset), -1 = skip. Returns the (mutated) caches."""
    _put_rows(ckv_cache, slot_mapping, ckv)
    _put_rows(krope_cache, slot_mapping, krope)
    return ckv_cache, krope_cache


def reshape_and_cache_gqa(k, v, k_cache, v_cache, slot_mapping):
    """Head-major cache scatter, in place: k, v [T, Hkv, D]; caches [Hkv,
    num_pages, page_size, D]; slot_mapping [T] global slot ids, -1 = skip.
    One scatter a cache over every head's rows; no host sync. Returns the
    (mutated) caches."""
    hkv, pages, ps, d = k_cache.shape
    slots = slot_mapping.long()
    keep = ((slots >= 0) & (slots < pages * ps)).repeat(hkv)
    rows = (torch.arange(hkv, device=slots.device)[:, None] * (pages * ps)
            + slots[None, :]).reshape(-1)
    for cache, x in ((k_cache, k), (v_cache, v)):
        index_copy_kept_(cache.view(-1, d), rows, x.transpose(0, 1).reshape(-1, d), keep)
    return k_cache, v_cache
