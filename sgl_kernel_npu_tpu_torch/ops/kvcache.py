"""Paged-KV cache ops (counterpart of the JAX package's ops/kvcache.py):
`reshape_and_cache_mla`, the latent cache scatter of mla_preprocess;
`reshape_and_cache_gqa` (bf16) and `reshape_and_cache_gqa_int8`, the
head-major scatters; the allocator helpers `alloc_extend`,
`cache_loc_assign` / `cache_loc_update` and `assign_cache_op`; and
`transfer_kv_to_host` / `transfer_kv_to_device`, the paged offload with the
layer-dim exchange that the engines' pause / resume use. Plain PyTorch, as
the JAX functions are plain jnp. The JAX package returns new arrays; the
port writes caches and pools in place (and returns them)."""

from __future__ import annotations

import torch

from ..utils import index_copy_kept_, resolve_device
from .quant import per_token_quant_int8


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


def alloc_extend(pre_lens, seq_lens, last_loc, free_pages, page_size: int, out_size: int):
    """Paged allocator extend: for request i, the slots of tokens pre_lens[i]
    .. seq_lens[i] - 1: first the rest of the partial page after
    last_loc[i], then whole pages taken in order from free_pages, the last
    one partial. Returns (out_indices [out_size] int32, -1 padded;
    num_pages_used, a 0-d tensor). Vectorised (cumsum / searchsorted), no
    host sync."""
    pre = pre_lens.long()
    seq = seq_lens.long()
    extend = seq - pre
    ext_cum = torch.cumsum(extend, 0)
    pre_pages = -(-pre // page_size)
    new_pages = -(-seq // page_size) - pre_pages
    page_start = torch.cumsum(new_pages, 0) - new_pages       # exclusive

    j = torch.arange(out_size, device=pre.device)
    req = torch.searchsorted(ext_cum, j, right=True).clamp(0, pre.shape[0] - 1)
    p = j - (ext_cum[req] - extend[req])                      # index within the request
    pos = pre[req] + p                                        # absolute token position
    boundary = pre_pages[req] * page_size                     # first fresh-page slot
    in_part1 = pos < boundary
    slot_part1 = last_loc.long()[req] + 1 + p
    new_page_idx = torch.where(in_part1, 0, torch.div(pos - boundary, page_size,
                                                      rounding_mode="floor"))
    page_id = free_pages.long()[(page_start[req] + new_page_idx).clamp(0, free_pages.shape[0] - 1)]
    slot_rest = page_id * page_size + pos % page_size
    out = torch.where(in_part1, slot_part1, slot_rest)
    out = torch.where(j < ext_cum[-1], out, -1).to(torch.int32)
    return out, new_pages.sum()


def cache_loc_assign(req_indices, token_pool, start_offset, end_offset, out_cache_loc):
    """token_pool[req_indices[i], start[i]:end[i]] = out_cache_loc[cum[i]:
    cum[i + 1]], in place (entries past the total are dropped); returns
    token_pool."""
    bs = req_indices.shape[0]
    pool_rows, pool_cols = token_pool.shape
    n = out_cache_loc.shape[0]
    lengths = (end_offset - start_offset).long()
    ends = torch.cumsum(lengths, 0)
    j = torch.arange(n, device=token_pool.device)
    req = torch.searchsorted(ends, j, right=True).clamp(0, bs - 1)
    rows = req_indices.long()[req]
    cols = start_offset.long()[req] + j - (ends[req] - lengths[req])
    keep = (j < ends[-1]) & (rows >= 0) & (rows < pool_rows) & (cols >= 0) & (cols < pool_cols)
    index_copy_kept_(token_pool.view(-1), rows * pool_cols + cols,
                     out_cache_loc.to(token_pool.dtype), keep)
    return token_pool


# cache_loc_update shares the implementation (the reference splits them only by
# launch style)
cache_loc_update = cache_loc_assign


def assign_cache_op(dst, src, dst_start_idx, dst_end_idx, src_start_idx, src_end_idx):
    """dst[dst_start:dst_end] = src[src_start:src_start + (dst_end -
    dst_start)], the bounds tensors or ints, in place; rows past dst's end
    are dropped. Returns dst."""
    n = dst.shape[0]
    j = torch.arange(n, device=dst.device)
    dst_start = torch.as_tensor(dst_start_idx, device=dst.device).long()
    length = torch.as_tensor(dst_end_idx, device=dst.device).long() - dst_start
    src_rows = (torch.as_tensor(src_start_idx, device=dst.device).long() + j).clamp(
        0, src.shape[0] - 1)
    tgt = dst_start + j
    index_copy_kept_(dst, tgt, src[src_rows], (j < length) & (tgt < n))
    return dst


def transfer_kv_to_host(device_cache):
    """Device -> host offload with the layer-dim exchange: [L, P, ...] on
    the device -> [P, L, ...] on the host, in pinned memory when the source
    is on a CUDA device. The copy is complete when this returns."""
    swapped = device_cache.transpose(0, 1)
    host = torch.empty(swapped.shape, dtype=swapped.dtype,
                       pin_memory=swapped.device.type == "cuda")
    host.copy_(swapped)
    return host


def transfer_kv_to_device(host_cache, like=None, device="cuda"):
    """Host -> device reload with the inverse layer-dim exchange: [P, L,
    ...] -> [L, P, ...] on `like`'s device (else `device`); from pinned
    memory the copy is asynchronous, ordered on the current stream."""
    dev = like.device if like is not None else resolve_device(device)
    return host_cache.to(dev, non_blocking=True).transpose(0, 1)


def reshape_and_cache_gqa_int8(k, v, k_cache, v_cache, k_scale_cache, v_scale_cache,
                               slot_mapping):
    """Int8 head-major cache scatter with per-(token, head) dynamic scales,
    in place: k, v [T, Hkv, D]; caches int8 [Hkv, pages, ps, D]; scale
    caches f32 [Hkv, pages, 1, ps]; slot -1 skips. The scale is
    max(absmax, 1e-7) * f32(1/127), as compiled XLA computes the JAX code's
    division by 127 (ops/quant.py). Returns the four caches."""
    hkv, pages, ps, d = k_cache.shape
    slots = slot_mapping.long()
    keep = ((slots >= 0) & (slots < pages * ps)).repeat(hkv)
    rows = (torch.arange(hkv, device=slots.device)[:, None] * (pages * ps)
            + slots[None, :]).reshape(-1)
    for x, cache, scales in ((k, k_cache, k_scale_cache), (v, v_cache, v_scale_cache)):
        q, s = per_token_quant_int8(x)                       # [T, Hkv, D], [T, Hkv, 1]
        index_copy_kept_(cache.view(-1, d), rows, q.transpose(0, 1).reshape(-1, d), keep)
        index_copy_kept_(scales.view(-1), rows, s[..., 0].transpose(0, 1).reshape(-1), keep)
    return k_cache, v_cache, k_scale_cache, v_scale_cache
