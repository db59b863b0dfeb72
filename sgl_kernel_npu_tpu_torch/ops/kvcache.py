"""Paged-KV cache ops (counterpart of the JAX package's ops/kvcache.py,
limited to what the MLA slice runs): `reshape_and_cache_mla`, the latent
cache scatter of mla_preprocess. The JAX package returns new caches; the
port writes them in place."""

from __future__ import annotations

import torch


def _put_rows(cache, slots, rows):
    """cache [P, ps, D] viewed as P * ps rows; rows [T, D] go to `slots` [T];
    a slot < 0 or >= P * ps drops its row (the JAX scatter's mode="drop").

    Taken with tensor ops only, so no host sync: a dropped row rewrites the
    first kept row's slot with that row's own value (the same bytes, so the
    duplicate index is harmless), or slot 0 with its current value when no
    row is kept."""
    flat = cache.view(-1, cache.shape[-1])
    slots = slots.long()
    keep = (slots >= 0) & (slots < flat.shape[0])
    first = torch.argmax(keep.int())
    any_keep = keep[first]
    src = torch.where(keep, torch.arange(slots.shape[0], device=slots.device), first)
    tgt = torch.where(any_keep, slots[src], 0)
    vals = torch.where(any_keep, rows[src].to(cache.dtype), flat[0:1])
    flat.index_copy_(0, tgt, vals)


def reshape_and_cache_mla(ckv, krope, ckv_cache, krope_cache, slot_mapping):
    """MLA latent cache scatter, in place: ckv [T, Lkv], krope [T, Lrope];
    caches [num_pages, page_size, L]; slot_mapping [T] global slot ids
    (page * page_size + offset), -1 = skip. Returns the (mutated) caches."""
    _put_rows(ckv_cache, slot_mapping, ckv)
    _put_rows(krope_cache, slot_mapping, krope)
    return ckv_cache, krope_cache
