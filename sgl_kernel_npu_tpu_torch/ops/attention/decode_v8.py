"""Token-major int8 KV pages: row quantization, the post-step append, the
scale updates and the per-page decode (counterpart of the JAX package's
ops/attention/decode_v8.py).

Pages are [L, P, ps*hkv, D] int8, row r = t*hkv + h, so one token of one
layer is a single contiguous [hkv, D] run; scales are [L, P, 1, ps*hkv] f32
in the same row order.

`init_cache_tm_int8` and `reshape_and_cache_gqa_token_major_int8` are the
one-layer form (pages [P, ps*hkv, D], scales [P, 1, ps*hkv]) of the JAX
package, which calls them nowhere; the port keeps them for its surface.

The port writes the cache IN PLACE where the JAX package returned new arrays
(it aliased them into the Pallas call): `append_tm_int8` and the two scale
updates mutate the tensors they are given. The scale updates are direct
indexed writes: the dense masked select of the JAX version was a workaround
for TPU scatters, and the slots written are the same.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import resolve_device, use_kernel
from ..kvcache import _put_rows
from ..quant import INV_INT8_MAX
from . import decode_v9 as _v9

# kq, vq, k_cache, v_cache, pages, offs, L, B, P, ps, run_bytes, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def init_cache_tm_int8(num_pages: int, hkv: int, page_size: int, d: int, device="cuda"):
    """One layer of token-major int8 pages, zeroed, on `device`: k/v [P,
    ps*hkv, D] int8, ks/vs [P, 1, ps*hkv] f32."""
    dev = resolve_device(device)
    shape = (num_pages, page_size * hkv, d)
    sshape = (num_pages, 1, page_size * hkv)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=dev),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=dev)}


def reshape_and_cache_gqa_token_major_int8(k, v, k_cache, v_cache, k_scale_cache,
                                           v_scale_cache, slot_mapping):
    """Quantise and scatter new rows into one layer of token-major int8
    pages, in place: one contiguous [hkv, D] run per token. k, v [T, Hkv,
    D]; caches [P, ps*hkv, D] int8; scale caches [P, 1, ps*hkv] f32;
    slot_mapping [T] (page * ps + offset; < 0 or past the pages drops the
    row). Each (token, head) row is quantised symmetrically with scale
    max(absmax, 1e-7) / 127, divided as the JAX function divides eagerly
    (by a tensor: PyTorch's CUDA division by a Python number multiplies by
    the reciprocal). No host sync. Returns the (mutated) caches."""
    num_pages, rows, d = k_cache.shape
    hkv = k.shape[1]
    ps = rows // hkv
    int8_max = torch.tensor(127.0, device=k.device)

    def q8(x):
        x = x.float()
        scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-7) / int8_max
        return torch.round(x / scale).clamp(-128, 127).to(torch.int8), scale[..., 0]

    kq, ks = q8(k)
    vq, vs = q8(v)
    _put_rows(k_cache.view(num_pages, ps, hkv * d), slot_mapping, kq.reshape(-1, hkv * d))
    _put_rows(v_cache.view(num_pages, ps, hkv * d), slot_mapping, vq.reshape(-1, hkv * d))
    _put_rows(k_scale_cache.view(num_pages, ps, hkv), slot_mapping, ks)
    _put_rows(v_scale_cache.view(num_pages, ps, hkv), slot_mapping, vs)
    return k_cache, v_cache, k_scale_cache, v_scale_cache


def quant_rows_int8(k, v):
    """Per-(token, head) symmetric int8 quant of new k/v rows [..., hkv, D].
    Returns (kq, vq int8, ks, vs f32 [..., hkv]). The scale is absmax times
    f32(1/127), as compiled XLA computes the JAX code's division by 127."""
    def q8(x):
        x = x.float()
        absmax = x.abs().amax(dim=-1, keepdim=True)
        scale = absmax.clamp_min(1e-7) * INV_INT8_MAX
        qv = torch.round(x / scale).clamp(-128, 127)
        return qv.to(torch.int8), scale[..., 0]
    kq, ks = q8(k)
    vq, vs = q8(v)
    return kq, vq, ks, vs


def append_tm_int8_ref(kq, vq, k_cache, v_cache, pages, offs):
    """Plain version of kernel D (same contract as `append_tm_int8`)."""
    l, num_pages, rows, d = k_cache.shape
    hkv = kq.shape[2]
    ps = rows // hkv
    bi = ((pages >= 0) & (pages < num_pages)).nonzero(as_tuple=True)[0]
    pg, off = pages[bi].long(), offs[bi].long()
    k_cache.view(l, num_pages, ps, hkv, d)[:, pg, off] = kq[:, bi]
    v_cache.view(l, num_pages, ps, hkv, d)[:, pg, off] = vq[:, bi]
    return k_cache, v_cache


def append_tm_int8(kq, vq, k_cache, v_cache, pages, offs):
    """Write one quantized token per (layer, row) into token-major pages, in
    place. kq/vq [L, B, hkv, D] int8; k_cache/v_cache [L, P, ps*hkv, D] int8;
    pages [B] page index (>= P, the sentinel, or < 0 drops the row); offs [B]
    token slot within the page. Returns the (mutated) caches. On a CUDA
    tensor it launches kernel D, K6's copy loop with two (rows, cache)
    pairs (csrc/append_mla.cu)."""
    if not use_kernel(k_cache):
        return append_tm_int8_ref(kq, vq, k_cache, v_cache, pages, offs)
    l, num_pages, rows, d = k_cache.shape
    _, b, hkv, d2 = kq.shape
    if (kq.shape != vq.shape or kq.shape[0] != l or d2 != d or rows % hkv
            or k_cache.shape != v_cache.shape or (hkv * d) % 16):
        raise ValueError(f"append_tm: kq {tuple(kq.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    pages = pages.to(torch.int32).contiguous()
    offs = offs.to(torch.int32).contiguous()
    if any(t.dtype != torch.int8 for t in (kq, vq, k_cache, v_cache)):
        raise TypeError("append_tm: int8 rows and caches expected")
    _build.check_operands("append_tm", k_cache.device, kq, vq, k_cache,
                          v_cache, pages, offs)
    fn = _build.launcher("append_tm", _ARGTYPES)
    stream = torch.cuda.current_stream(k_cache.device).cuda_stream
    code = fn(kq.data_ptr(), vq.data_ptr(), k_cache.data_ptr(),
              v_cache.data_ptr(), pages.data_ptr(), offs.data_ptr(),
              l, b, num_pages, rows // hkv, hkv * d, stream)
    _build.check("append_tm", code)
    _build.launches["append_tm"] += 1
    return k_cache, v_cache


def scatter_scales_tm(k_scales, v_scales, ks, vs, pages, offs):
    """Decode scale update, in place. k_scales/v_scales [L, P, 1, ps*hkv] f32;
    ks/vs [L*B, hkv] (layer-major); pages [B] (>= P drops the row), offs [B]."""
    l, num_pages, _, rows = k_scales.shape
    hkv = ks.shape[-1]
    b = pages.shape[0]
    bi = ((pages >= 0) & (pages < num_pages)).nonzero(as_tuple=True)[0]
    pg = pages[bi].long()[:, None]
    col = offs[bi].long()[:, None] * hkv + torch.arange(hkv, device=pages.device)
    k_scales[:, pg, 0, col] = ks.float().reshape(l, b, hkv)[:, bi]
    v_scales[:, pg, 0, col] = vs.float().reshape(l, b, hkv)[:, bi]
    return k_scales, v_scales


def decode_gqa_v8_int8_defer_ref(q, k_new, v_new, k_cache, v_cache, k_scales,
                                 v_scales, cached_lens, block_table, sm_scale,
                                 page_size, layer_idx=0):
    """Plain version of the per-page decode: one page per online-softmax
    step, as the TPU kernel decode_gqa_pallas_v8_int8_defer takes them."""
    hkv = k_new.shape[1]
    kc, ks = _v9._gather_layer(k_cache, k_scales, layer_idx, block_table, hkv)
    vc, vs = _v9._gather_layer(v_cache, v_scales, layer_idx, block_table, hkv)
    return _v9.attend_gathered_ref(q, k_new, v_new, kc, ks, vc, vs, cached_lens,
                                   page_size, sm_scale)


def decode_gqa_v8_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales,
                             v_scales, cached_lens, block_table, sm_scale,
                             page_size, layer_idx=0):
    """Token-major int8 deferred-write decode, the contract of the JAX
    package's decode_v8.py::decode_gqa_pallas_v8_int8_defer (the same as
    decode_v9's). On a CUDA tensor it launches kernel C (csrc/decode_tm.cu)
    with one page per online-softmax step, as the plain version steps."""
    if not use_kernel(q):
        return decode_gqa_v8_int8_defer_ref(
            q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, cached_lens,
            block_table, sm_scale, page_size, layer_idx)
    return _v9.launch_decode_tm(q, k_new, v_new, k_cache, v_cache, k_scales,
                                v_scales, cached_lens, block_table, sm_scale,
                                page_size, layer_idx, step_pages=1)


def scatter_scales_prefill_tm(k_scales, v_scales, ksn, vsn, block_tables,
                              prefix_lens, valid_lens):
    """Prefill-chunk scale update, in place. k_scales/v_scales
    [L, P, 1, ps*hkv] f32; ksn/vsn [L, S, T, hkv]; block_tables [S, MP];
    prefix_lens/valid_lens [S].

    Token i < valid_lens[s] of chunk s sits at position prefix_lens[s] + i,
    in page block_tables[s, pos // ps], slot pos % ps. Only those live tokens
    are written, so a pad block-table entry (commonly 0) can never claim a
    real page and overwrite its scales (the guard of the JAX version)."""
    l, num_pages, _, rows = k_scales.shape
    hkv = ksn.shape[-1]
    ps = rows // hkv
    t = ksn.shape[2]
    dev = k_scales.device
    tok = torch.arange(t, device=dev)
    live = tok[None, :] < valid_lens.to(dev)[:, None]                # [S, T]
    si, ti = live.nonzero(as_tuple=True)
    pos = prefix_lens.to(dev).long()[si] + ti
    pg = block_tables.to(dev).long()[si, pos // ps][:, None]
    col = (pos % ps)[:, None] * hkv + torch.arange(hkv, device=dev)
    k_scales[:, pg, 0, col] = ksn.float()[:, si, ti]
    v_scales[:, pg, 0, col] = vsn.float()[:, si, ti]
    return k_scales, v_scales
