"""Sparse attention family (counterpart of the JAX package's
ops/attention/sparse.py): the sparse-block estimator, block-sparse
attention, and top-k ("rainfusion") sparse decode over a paged cache.

  sparse_block_estimate(q, k, block_size, keep_ratio=0.25, causal=True,
                        always_keep_first=True, always_keep_last=True)
q, k [B, H, T, D] -> (mask [B, H, NQ, NK] bool, count [B, H, NQ] int32):
block means of q and k, one score per (query block, kv block), causal -1e30,
the keep = max(1, int(NK * keep_ratio)) largest scores of a row kept (ties
with the keep-th kept too), then the first column and the diagonal.
`sparse_block_estimate_fused` is the kernel tier (the JAX package's
sparse_block_estimate_pallas): the scores are block SUMS dotted and scaled
by 1 / block_size^2, from kernel K18 (csrc/sparse_estimate.cu: a pooling
kernel and a score kernel, both counted under "sparse_estimate", through a
workspace of pooled rows; `estimate_plan` sizes both) on a CUDA tensor or
`block_scores_ref` on a CPU one, at any length, any head dim, and bf16,
fp16 or f32 rows; the top-k threshold stays a PyTorch sort, as it stays in
XLA there.
`sparse_block_estimate_dispatch` takes the fused tier when D % 128 == 0 and
both lengths are multiples of block_size (the JAX gate), else the plain one.

  block_sparse_attention(q, k, v, block_mask, sm_scale, block_size, causal)
the dense reference tier, plain PyTorch: the mask expanded to tokens and
multiplied into the logits; a row with nothing selected gives 0. The
compute-skipping tier is paged_prefill.block_sparse_paged_attention.

  topk_block_sparse_attention(q, k_cache, v_cache, block_ids, sm_scale,
                              page_size, chunk=64)
q [B, H, D] over one shared cache [P, ps, D] / [P, ps, Dv] (MLA's
single-head layout); block_ids [B, KB] int32 select 8-token blocks (id =
slot // 8, -1 unused). The selected blocks are taken in chunks of `chunk`
(the last padded with -1), one online-softmax step per chunk, all f32;
scores of -1 ids are -1e30 (not -inf) and their rows read block 0, so a row
whose ids are all -1 returns the mean of block 0's eight V rows, as the TPU
kernel (topk_block_sparse_attention_pallas) does; out = acc / max(l,
1e-20). Kernel K19 (csrc/topk_sparse.cu, counted under "topk_block_sparse")
on a CUDA tensor, `topk_block_sparse_attention_ref` on a CPU one. K19 takes
(D, Dv) in TOPK_DIMS, bf16 or fp16, any number of heads (multi-query models
such as Falcon-7B's 71 heads over one kv head); f32 and other widths raise.

  topk_sparse_attention(q, k_cache, v_cache, topk_indices, seq_lens,
                        sm_scale, page_size)
the token-granular form, plain PyTorch: topk_indices [B, K] are token slots
(-1 unused; such a row reads slot 0). `topk_sparse_attention_dispatch` is
the same call, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import cdiv, use_kernel

_NEG_INF = -1e30
BLK = 8                  # tokens per selected block of the top-k decode
# q, k, workspace, scores, BH, NQ, NK, block_size, D, workspace row, causal,
# tile, dtype, stream
_EST_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# q, k_cache, v_cache, block_ids, out, workspace, arrivals, B, H, KB, chunk,
# splits, D, Dv, dtype, sm_scale, stream
_TOPK_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_TOPK_HEADS = 16         # heads of one K19 block
# (D, Dv) of K19's instantiations: Falcon-7B (64), bench_ops.py (128),
# Gemma-3 (256), the MLA latent rows (576 / 512)
TOPK_DIMS = ((64, 64), (128, 128), (256, 256), (576, 512))
# the C interfaces' dtype codes: K18 takes all three, K19 the first two
_EST_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_TOPK_DTYPES = {torch.bfloat16: 0, torch.float16: 1}


def _causal_blocks(nq: int, nk: int, dev):
    return torch.arange(nq, device=dev)[:, None] >= torch.arange(nk, device=dev)[None, :]


def _threshold(scores, keep_ratio, causal, always_keep_first, always_keep_last):
    """The estimator's top-k mask of scores [B, H, NQ, NK] and its counts."""
    nq, nk = scores.shape[-2:]
    keep = max(1, int(nk * keep_ratio))
    thresh = torch.sort(scores, dim=-1).values[..., nk - keep:nk - keep + 1]
    mask = scores >= thresh
    if causal:
        mask = mask & _causal_blocks(nq, nk, scores.device)
    if always_keep_first:
        mask[..., 0] = True
    if always_keep_last and causal:
        rows = torch.arange(nq, device=scores.device)
        mask[..., rows, rows.clamp(max=nk - 1)] = True
    return mask, mask.sum(dim=-1, dtype=torch.int32)


def sparse_block_estimate(q, k, block_size: int, keep_ratio: float = 0.25,
                          causal: bool = True, always_keep_first: bool = True,
                          always_keep_last: bool = True):
    """Plain estimator over block means (module docstring)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    nq, nk = cdiv(tq, block_size), cdiv(tk, block_size)

    def block_mean(x, n):
        xp = torch.zeros((b, h, n * block_size, d), dtype=torch.float32, device=x.device)
        xp[:, :, : x.shape[2]] = x.float()
        return xp.reshape(b, h, n, block_size, d).mean(dim=3)

    scores = torch.einsum("bhqd,bhkd->bhqk", block_mean(q, nq), block_mean(k, nk))
    if causal:
        scores = torch.where(_causal_blocks(nq, nk, q.device), scores, _NEG_INF)
    return _threshold(scores, keep_ratio, causal, always_keep_first, always_keep_last)


def block_scores_ref(q, k, block_size: int, causal: bool = True):
    """Plain version of K18: q [BH, NQ*bs, D], k [BH, NK*bs, D] -> f32
    [BH, NQ, NK], (sum of q block i) . (sum of k block j) / bs^2, causal
    -1e30."""
    bh, tq, d = q.shape
    nq, nk = tq // block_size, k.shape[1] // block_size
    qs = q.float().reshape(bh, nq, block_size, d).sum(dim=2)
    ks = k.float().reshape(bh, nk, block_size, d).sum(dim=2)
    sc = torch.einsum("bqd,bkd->bqk", qs, ks) * (1.0 / (block_size * block_size))
    if causal:
        sc = torch.where(_causal_blocks(nq, nk, q.device), sc, _NEG_INF)
    return sc


def estimate_plan(bh: int, nq: int, nk: int, sms: int, d: int = 128):
    """K18's launch plan: (tile, workspace shape). The pooling kernel takes
    one block per pooled block, bh * (nq + nk) of them, and writes them to
    the workspace [bh, nq + nk, d'] f32 (q's blocks first; d' = d rounded up
    to a multiple of 4, the score kernel's float4 reads); the score kernel
    takes tiles of tile x tile scores: 64 where those tiles alone give at
    least half the SMs one, else 32, so that small estimates still spread
    over the card."""
    tile = 64 if bh * cdiv(nq, 64) * cdiv(nk, 64) >= cdiv(sms, 2) else 32
    return tile, (bh, nq + nk, cdiv(d, 4) * 4)


def check_block_scores(q, k, block_size: int):
    """Raise unless K18 takes q [BH, NQ*bs, D], k [BH, NK*bs, D]: any D >= 1,
    lengths that are multiples of the block, bf16, fp16 or f32 (one dtype)."""
    bh, tq, d = q.shape
    if (k.dim() != 3 or k.shape[0] != bh or k.shape[2] != d or d < 1 or block_size < 1
            or tq % block_size or k.shape[1] % block_size):
        raise ValueError(f"sparse_estimate: q {tuple(q.shape)}, k {tuple(k.shape)}, block "
                         f"{block_size}: needs q [BH, NQ*bs, D], k [BH, NK*bs, D] (any D) "
                         "with lengths that are multiples of the block")
    if q.dtype not in _EST_DTYPES or k.dtype != q.dtype:
        raise TypeError(f"sparse_estimate: q {q.dtype}, k {k.dtype}: bf16, fp16 or f32 q and "
                        "k of one dtype expected")


def _block_scores_cuda(q, k, block_size: int, causal: bool):
    """K18 on q [BH, NQ*bs, D], k [BH, NK*bs, D]: the pooling kernel, then
    the score kernel (two launches)."""
    check_block_scores(q, k, block_size)
    bh, tq, d = q.shape
    nq, nk = tq // block_size, k.shape[1] // block_size
    dev = q.device
    q, k = q.contiguous(), k.contiguous()
    out = torch.empty((bh, nq, nk), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    tile, ws_shape = estimate_plan(bh, nq, nk,
                                   torch.cuda.get_device_properties(dev).multi_processor_count, d)
    ws = torch.empty(ws_shape, dtype=torch.float32, device=dev)
    _build.check_operands("sparse_estimate", dev, q, k, ws, out)
    fn = _build.launcher("sparse_estimate", _EST_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), ws.data_ptr(), out.data_ptr(), bh, nq, nk, block_size,
              d, ws_shape[2], int(causal), tile, _EST_DTYPES[q.dtype],
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check("sparse_estimate", code)
    _build.launches["sparse_estimate"] += 2          # the pooling and the score kernel
    return out


def block_scores(q, k, block_size: int, causal: bool = True):
    """Block scores of K18 (or its plain version on the CPU)."""
    if use_kernel(q):
        return _block_scores_cuda(q, k, block_size, causal)
    return block_scores_ref(q, k, block_size, causal)


def padded_rows(x, block_size: int):
    """[B, H, T, D] as [B*H, N*block_size, D], N = ceil(T / block_size), the
    rows past T zero: K18's operand layout."""
    b, h, t, d = x.shape
    n = cdiv(t, block_size)
    if t == n * block_size:
        return x.reshape(b * h, t, d)
    xp = x.new_zeros((b, h, n * block_size, d))
    xp[:, :, :t] = x
    return xp.reshape(b * h, n * block_size, d)


def sparse_block_estimate_fused(q, k, block_size: int, keep_ratio: float = 0.25,
                                causal: bool = True, always_keep_first: bool = True,
                                always_keep_last: bool = True):
    """The kernel tier of the estimator: one K18 launch for the scores of
    every (batch, head), then the top-k threshold in PyTorch."""
    b, h, tq, _ = q.shape
    nq, nk = cdiv(tq, block_size), cdiv(k.shape[2], block_size)
    scores = block_scores(padded_rows(q, block_size), padded_rows(k, block_size), block_size,
                          causal)
    return _threshold(scores.reshape(b, h, nq, nk), keep_ratio, causal, always_keep_first,
                      always_keep_last)


def sparse_block_estimate_dispatch(q, k, block_size: int, **kw):
    """The fused tier where the JAX gate takes its kernel, else the plain
    estimator."""
    if q.shape[-1] % 128 == 0 and q.shape[2] % block_size == 0 \
            and k.shape[2] % block_size == 0:
        return sparse_block_estimate_fused(q, k, block_size, **kw)
    return sparse_block_estimate(q, k, block_size, **kw)


def block_sparse_attention(q, k, v, block_mask, sm_scale, block_size: int,
                           causal: bool = True):
    """Dense attention restricted to selected blocks: q [B, H, Tq, D];
    k, v [B, H, Tk, D]; block_mask [B, H, NQ, NK] bool -> [B, H, Tq, Dv]."""
    tq, tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    tok = block_mask.repeat_interleave(block_size, dim=2).repeat_interleave(
        block_size, dim=3)[:, :, :tq, :tk]
    if causal:
        tok = tok & torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
    s = torch.where(tok, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(tok.any(dim=-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def topk_sparse_attention(q, k_cache, v_cache, topk_indices, seq_lens, sm_scale,
                          page_size: int):
    """Decode attention over top-k token slots (module docstring):
    q [B, H, D], caches [P, ps, D] / [P, ps, Dv], topk_indices [B, K]."""
    valid = topk_indices >= 0
    slots = torch.where(valid, topk_indices, 0).long()
    page, off = slots // page_size, slots % page_size
    k = k_cache[page, off].float()                       # [B, K, D]
    v = v_cache[page, off].float()
    s = torch.einsum("bhd,bkd->bhk", q.float(), k) * sm_scale
    s = torch.where(valid[:, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkd->bhd", p, v).to(q.dtype)


def topk_sparse_attention_dispatch(q, k_cache, v_cache, topk_indices, seq_lens, sm_scale,
                                   page_size: int):
    """The token-granular API: arbitrary token slots take the plain gather;
    block-granular callers use topk_block_sparse_attention."""
    return topk_sparse_attention(q, k_cache, v_cache, topk_indices, seq_lens, sm_scale,
                                 page_size)


def topk_block_sparse_attention_ref(q, k_cache, v_cache, block_ids, sm_scale,
                                    page_size: int, chunk: int = 64):
    """Plain version of K19: the TPU kernel's chunks, all f32."""
    b, h, d = q.shape
    dv = v_cache.shape[-1]
    kb = block_ids.shape[1]
    chunk = min(chunk, kb)
    nc = cdiv(kb, chunk)
    dev = q.device
    ids = torch.full((b, nc * chunk), -1, dtype=torch.int32, device=dev)
    ids[:, :kb] = block_ids
    kf = k_cache.reshape(-1, BLK, d)                     # [P*ps/8, 8, D]
    vf = v_cache.reshape(-1, BLK, dv)
    qf = q.float()
    m = torch.full((b, h, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, dv), dtype=torch.float32, device=dev)
    for c in range(nc):
        cid = ids[:, c * chunk:(c + 1) * chunk]
        blocks = cid.clamp_min(0).long()
        kk = kf[blocks].reshape(b, chunk * BLK, d).float()
        vv = vf[blocks].reshape(b, chunk * BLK, dv).float()
        valid = (cid >= 0).repeat_interleave(BLK, dim=1)[:, None, :]
        sc = torch.where(valid, torch.einsum("bhd,brd->bhr", qf, kk) * sm_scale, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhr,brd->bhd", p, vv)
        m = m_new
    return (acc / l.clamp_min(1e-20)).to(q.dtype)


def check_topk(q, k_cache, v_cache, page_size: int, chunk: int):
    """Raise unless K19 takes q [B, H, D] over caches [P, ps, D] /
    [P, ps, Dv]: (D, Dv) in TOPK_DIMS, any H >= 1, pages of a multiple of 8
    tokens, 0 < chunk <= 64, bf16 or fp16 throughout."""
    b, h, d = q.shape
    dv = v_cache.shape[-1]
    if ((d, dv) not in TOPK_DIMS or h < 1 or page_size % BLK or k_cache.shape[-1] != d
            or k_cache.shape[:2] != v_cache.shape[:2] or k_cache.shape[1] != page_size
            or not 0 < chunk <= 64):
        raise ValueError(f"topk_block_sparse: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, page size "
                         f"{page_size}, chunk {chunk}: needs (D, Dv) in {TOPK_DIMS}, at "
                         "least one head, pages of a multiple of 8 tokens, chunk <= 64")
    if q.dtype not in _TOPK_DTYPES or not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError(f"topk_block_sparse: q {q.dtype}, caches {k_cache.dtype} / "
                        f"{v_cache.dtype}: bf16 or fp16 q and caches of one dtype expected")


def _topk_cuda(q, k_cache, v_cache, block_ids, sm_scale, page_size: int, chunk: int):
    """One launch of K19: q [B, H, D], caches [P, ps, D] / [P, ps, Dv]."""
    check_topk(q, k_cache, v_cache, page_size, chunk)
    b, h, d = q.shape
    dv = v_cache.shape[-1]
    kb = block_ids.shape[1]
    dt = _TOPK_DTYPES[q.dtype]
    dev = q.device
    q = q.contiguous()
    ids = block_ids.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((b, h, dv), dtype=q.dtype, device=dev)
    _build.check_operands("topk_block_sparse", dev, q, k_cache, v_cache, ids, out)
    if b == 0:
        return out
    # each row's blocks split over S blocks of the card; their partials
    # (m, l, acc of 16 heads) meet in a workspace, merged by the last to arrive
    splits = _build.splits("topk_block_sparse", b, h, kb, d, dv, dt)
    rows = b * cdiv(h, _TOPK_HEADS)
    ws = torch.empty(rows * splits * (2 + dv) * _TOPK_HEADS if splits > 1 else 0,
                     dtype=torch.float32, device=dev)
    arrivals = _build.arrival_counters("topk_block_sparse", dev, rows)
    fn = _build.launcher("topk_block_sparse", _TOPK_ARGTYPES)
    code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ids.data_ptr(),
              out.data_ptr(), ws.data_ptr(), arrivals.data_ptr(), b, h, kb, chunk, splits,
              d, dv, dt, float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("topk_block_sparse", code)
    _build.launches["topk_block_sparse"] += 1
    return out


def topk_block_sparse_attention(q, k_cache, v_cache, block_ids, sm_scale, page_size: int,
                                chunk: int = 64):
    """Block-granular top-k decode attention (module docstring)."""
    chunk = min(chunk, block_ids.shape[1])
    if use_kernel(q):
        return _topk_cuda(q, k_cache, v_cache, block_ids, sm_scale, page_size, chunk)
    return topk_block_sparse_attention_ref(q, k_cache, v_cache, block_ids, sm_scale, page_size,
                                           chunk)
