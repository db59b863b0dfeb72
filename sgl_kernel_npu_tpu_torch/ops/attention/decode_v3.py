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
of kernel K16 (csrc/decode_v3.cu: C's tensor-core loop, csrc/
decode_tm_core.cuh, with p kept in f32 as three bf16 parts), counted under
its own name (`launch_v3`, which K23's attic decodes and decode.py's
decode_gqa_int8kv launch too); on a CPU tensor it runs its plain version,
the TPU kernel's order in f32 (decode.py::_pages_ref).

The scatters write the cache IN PLACE where the JAX package returned new
arrays, with no host sync (utils.index_copy_kept_); a slot < 0 drops its row.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import index_copy_kept_, use_kernel
from .decode import _pages_ref
from .decode_v8 import quant_rows_int8

# every contract of csrc/decode_v3.cu (K16, K23): q, k_new, v_new, k cache,
# v cache, k scales, v scales, lens, block table, out, workspace, arrivals,
# layer, slots, B, Hq, Hkv, L, P, ps, MP, li, ng, S, sm_scale, stream
_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
HEAD_GROUPS = (1, 2, 4, 8, 16)       # query heads a kv head that K14 and K16 take
# decode_tm_core.cuh's blocks (K14's and K16's): at most V3_MAXG query heads
# each, at most V3_MAX_SPLITS splits a row; decode_v3.cu's STEP_MAX
V3_MAXG = 8
V3_MAX_SPLITS = 8
V3_STEP = 4096


def v3_step(ps: int) -> int:
    """K16's online-softmax step (decode_v3.cu's step_of): one page, at most
    V3_STEP tokens of it, so that a block's kept scores fit in shared memory
    at any page size."""
    return min(ps, V3_STEP)


def v3_groups(g: int) -> int:
    """ng: K14 and K16 run the G query heads of a kv head as ng blocks of
    at most V3_MAXG heads over the same rows (G 16: two)."""
    return -(-g // V3_MAXG)


def v3_splits(resident: int, b: int, rows: int, mp: int, ps: int) -> int:
    """S of K16 and K23 (decode_v3.cu's skt_*_splits, through
    decode_tm_core.cuh::splits_for): the card's co-resident blocks over the
    B * rows rows (rows = Hkv * ng), at most the block table's steps (a split
    holds whole steps) and V3_MAX_SPLITS, at least 1. Each split walks its
    own steps (decode_v9.tm_split_walk with unit = step), from its first
    step: p is not rounded, so it needs no maximum of the keys before it."""
    step = v3_step(ps)
    return max(1, min(resident // (b * rows), -(-mp * ps // step), V3_MAX_SPLITS))


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


def _layer_arg(layer_idx, layers, dev, name):
    """(layer tensor or None, li) for a stacked cache: a tensor is read on
    the device (clamped to the stack there), an int checked here."""
    if isinstance(layer_idx, torch.Tensor):
        layer = layer_idx.to(device=dev, dtype=torch.int32).reshape(1).contiguous()
        if layer.data_ptr() % 4:
            raise ValueError(f"{name}: the layer tensor must be an aligned int on {dev}")
        return layer, 0
    li = int(layer_idx)
    if not 0 <= li < layers:
        raise ValueError(f"{name}: layer {li} of {layers}")
    return None, li


def launch_v3(name, q, k_cache, v_cache, scales, new, lens, block_table, sm_scale, page_size,
              layout="page", layer_idx=0, slots=None):
    """One launch of a contract of csrc/decode_v3.cu (K16, K23), or of K10
    (csrc/decode_hm.cu, the same arguments), on CUDA tensors: `name` is its
    C entry point and launch counter. Caches
    page-major [P, Hkv, ps, 128] (layout "page"), kv-head-major [Hkv, P, ps,
    128] ("kv_head") or stacked page-major [L, P, Hkv, ps, 128] ("stacked",
    at layer_idx, an int or a device tensor); scales (k, v) f32 of the same
    layout with a 1 before ps for int8 pages, else None; new (k, v) [B, Hkv,
    128] for a deferred or fused current token, slots [B] for a fused write
    (into the caches and scales in place), else None. Each (sequence, kv
    head, group of heads) is split over the blocks that skt_<name>_splits
    sizes from the card; the splits' partials meet in a workspace and the
    last to arrive merges them. Returns [B, Hq, 128] bf16. "decode_hm" with
    f32 q and f32 pages launches K10's f32 form instead (_launch_hm_f32),
    which returns f32; "decode_hm256" is K10 at head dim 256 (bf16, the
    kv-head-major layout only), which returns [B, Hq, 256] bf16."""
    b, hq, d = q.shape
    shape = k_cache.shape
    layers = shape[0] if layout == "stacked" else 1
    pshape = shape[1:] if layout == "stacked" else shape
    num_pages, hkv, ps = ((pshape[1], pshape[0], pshape[2]) if layout == "kv_head"
                          else pshape[:3])
    sshape = tuple(shape[:-2]) + (1, ps)
    d_ok = d == (256 if name == "decode_hm256" else 128)
    if (v_cache.shape != shape or shape[-1] != d or not d_ok or ps != page_size
            or hq % hkv or hq // hkv not in HEAD_GROUPS
            or (scales is not None and any(s.shape != sshape for s in scales))):
        raise ValueError(f"{name}: q {tuple(q.shape)}, caches {tuple(shape)}: needs head "
                         f"dim {256 if name == 'decode_hm256' else 128}, Hq / Hkv in "
                         f"{HEAD_GROUPS} and scales {sshape}")
    if (name == "decode_hm" and layout == "kv_head" and scales is None and new is None
            and all(t.dtype == torch.float32 for t in (q, k_cache, v_cache))):
        return _launch_hm_f32(q, k_cache, v_cache, lens, block_table, sm_scale)
    want = torch.int8 if scales is not None else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_cache.dtype != want or v_cache.dtype != want:
        raise TypeError(f"{name}: bf16 q and {want} caches expected"
                        + (" (or f32 q and f32 caches)" if name == "decode_hm" else ""))
    if slots is not None and scales is not None and any(s.dtype != torch.float32
                                                        for s in scales):
        raise TypeError(f"{name}: the fused write takes f32 scales")
    dev = q.device
    q = q.contiguous()
    sc = [s.float().contiguous() for s in scales] if scales is not None else []
    kn, vn = ((x.to(torch.bfloat16).contiguous() for x in new) if new is not None
              else (None, None))
    if kn is not None and (kn.shape != (b, hkv, d) or vn.shape != (b, hkv, d)):
        raise ValueError(f"{name}: k_new / v_new {tuple(kn.shape)} != {(b, hkv, d)}")
    sl = lens.to(torch.int32).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    sm = slots.to(torch.int32).contiguous() if slots is not None else None
    layer, li = _layer_arg(layer_idx, layers, dev, name)
    out = torch.empty((b, hq, d), dtype=torch.bfloat16, device=dev)
    opt = [t for t in (kn, vn, sm) if t is not None]
    _build.check_operands(name, dev, q, k_cache, v_cache, *sc, *opt, sl, bt, out)
    g, mp = hq // hkv, bt.shape[1]
    ng = v3_groups(g)
    rows = b * hkv * ng
    splits = _build.splits(name, b, hkv, g // ng, ng, mp, ps)
    ws = torch.empty(rows * splits * V3_MAXG * (2 + d) if splits > 1 else 0,
                     dtype=torch.float32, device=dev)
    arrivals = _build.arrival_counters(name, dev, rows)

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = _build.launcher(name, _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(q.data_ptr(), ptr(kn), ptr(vn), k_cache.data_ptr(), v_cache.data_ptr(),
              *(ptr(s) for s in (sc or (None, None))), sl.data_ptr(), bt.data_ptr(),
              out.data_ptr(), ws.data_ptr(), arrivals.data_ptr(), ptr(layer), ptr(sm), b, hq,
              hkv, layers, num_pages, ps, mp, li, ng, splits, float(sm_scale), stream)
    _build.check(name, code)
    _build.launches[name] += 1
    return out


# K10's f32 form (csrc/decode_hm_f32.cu): q, k cache, v cache, lens, block
# table, out, workspace, arrivals, B, Hq, Hkv, P, ps, MP, S, sm_scale, stream
_F32_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
HM_F32_STEP = 512       # decode_hm_f32.cu's STEP_MAX


def _launch_hm_f32(q, k_cache, v_cache, lens, block_table, sm_scale):
    """K10 on f32 pages (launch_v3's "decode_hm" contract with f32 q and f32
    kv-head-major caches [Hkv, P, ps, 128]), counted under "decode_hm_f32".
    Pages of at most HM_F32_STEP tokens, or a multiple of it. Returns [B, Hq,
    128] f32."""
    name = "decode_hm_f32"
    b, hq, d = q.shape
    hkv, num_pages, ps, _ = k_cache.shape
    if ps > HM_F32_STEP and ps % HM_F32_STEP:
        raise ValueError(f"{name}: pages of {ps} tokens: at most {HM_F32_STEP} or a "
                         "multiple of it")
    dev = q.device
    q = q.contiguous()
    sl = lens.to(torch.int32).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    _build.check_operands(name, dev, q, k_cache, v_cache, sl, bt, out)
    g, mp = hq // hkv, bt.shape[1]
    splits = _build.splits(name, b, hkv, g, mp, ps)
    ws = torch.empty(b * hkv * splits * g * (4 + d) if splits > 1 else 0,
                     dtype=torch.float32, device=dev)
    arrivals = _build.arrival_counters(name, dev, b * hkv)
    fn = _build.launcher(name, _F32_ARGTYPES)
    code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), sl.data_ptr(),
              bt.data_ptr(), out.data_ptr(), ws.data_ptr(), arrivals.data_ptr(), b, hq, hkv,
              num_pages, ps, mp, splits, float(sm_scale),
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(name, code)
    _build.launches[name] += 1
    return out


def decode_gqa_v3(q, k_cache, v_cache, seq_lens, block_table, sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v3_ref(q, k_cache, v_cache, seq_lens, block_table, sm_scale)
    return launch_v3("decode_v3", q, k_cache, v_cache, None, None, seq_lens, block_table,
                     sm_scale, page_size)


def decode_gqa_v3_int8(q, k_cache, v_cache, k_scales, v_scales, seq_lens, block_table,
                       sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v3_ref(q, k_cache, v_cache, seq_lens, block_table, sm_scale,
                                 k_scales=k_scales, v_scales=v_scales)
    return launch_v3("decode_v3_int8", q, k_cache, v_cache, (k_scales, v_scales), None,
                     seq_lens, block_table, sm_scale, page_size)


def decode_gqa_v3_defer(q, k_new, v_new, k_cache, v_cache, cached_lens, block_table,
                        sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v3_ref(q, k_cache, v_cache, cached_lens, block_table, sm_scale,
                                 k_new=k_new, v_new=v_new)
    return launch_v3("decode_v3_defer", q, k_cache, v_cache, None, (k_new, v_new),
                     cached_lens, block_table, sm_scale, page_size)


def decode_gqa_v3_int8_defer(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales,
                             cached_lens, block_table, sm_scale, page_size):
    if not use_kernel(q):
        return decode_gqa_v3_ref(q, k_cache, v_cache, cached_lens, block_table, sm_scale,
                                 k_scales=k_scales, v_scales=v_scales, k_new=k_new,
                                 v_new=v_new)
    return launch_v3("decode_v3_int8_defer", q, k_cache, v_cache, (k_scales, v_scales),
                     (k_new, v_new), cached_lens, block_table, sm_scale, page_size)
