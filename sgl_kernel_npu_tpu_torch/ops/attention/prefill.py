"""Prefill / training attention (counterpart of the JAX package's
ops/attention/prefill.py): laser attention, a flash forward over dense
[B, H, T, D] tensors, and the varlen causal prefill over flat [T, H, D].

  laser_attention(q, k, v, sm_scale, causal=True)
q [B, Hq, T, D], k [B, Hkv, T, D], v [B, Hkv, T, Dv] (GQA: query head h
reads kv head h // (Hq / Hkv)); returns [B, Hq, T, Dv] in q's dtype. Causal
masks by absolute position (row >= column); masked scores are -1e30.

On a CUDA tensor it launches kernel K17 once, at every T, by the route
`laser_route(D, Dv, dtype)` picks:
  * "laser_attention" (csrc/laser_attention.cu, wgmma on bf16 / fp16): bf16
    or fp16 at any D and Dv that are multiples of 8 up to 256. Its four
    instantiations TENSOR_CORE_WIDTHS take their own widths as they are;
    any other pair runs on the tile `laser_tile(D, Dv)` gives (the least
    Dp + Dvp that holds both: Phi-3's 96 and Phi-2's 80 on (128, 128)),
    its columns past D and Dv zero-filled by TMA, for (Dp + Dvp) / (D + Dv)
    times the work of the real widths;
  * "laser_attention_general" (csrc/laser_attention_general.cu, split TF32
    on the tensor cores): f32 at any D and Dv up to GENERAL_MAX_D, and bf16
    or fp16 at widths up to it that are not multiples of 8.
It raises beyond those. K17 reads the kv heads where they are (the JAX
wrapper repeats K and V to Hq heads first). On a CPU tensor it keeps the JAX
wrapper's gate: T >= 512 runs `laser_attention_blocked_ref`, the TPU kernel's
plain version, and shorter T `laser_attention_ref`; both take any D, Dv and
float dtype, as the TPU kernel does.

The TPU kernel (laser_attention_pallas) reads past row T when T is not a
multiple of its block (256): those scores are not masked, and 0 * NaN from
the out-of-range V rows poisons P.V. The port masks columns >= T and reads
no row past T, in K17 and in the blocked plain version, so both equal
`laser_attention_ref` there.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import cdiv, use_kernel

_NEG_INF = -1e30
_GATE_T = 512          # the JAX wrapper's kernel gate
_BLOCK = 256           # the TPU kernel's block_q = block_k
# q, k, v, out, B, Hq, Hkv, T, D, Dv, causal, dtype, sm_scale, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
# (D, Dv) of the bf16 / fp16 kernel's instantiations, bf16 and fp16 each:
# SD3 / Falcon (64), Llama (128), DeepSeek-V3's MLA prefill (192 / 128),
# Qwen3-Next and Gemma-3 (256); other multiples of 8 run padded to one
TENSOR_CORE_WIDTHS = ((64, 64), (128, 128), (192, 128), (256, 256))
GENERAL_MAX_D = 256    # the split-TF32 kernel: any D, Dv up to this
# the C interface's dtype codes
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def laser_attention_ref(q, k, v, sm_scale, causal=True):
    """One masked softmax in f32: q [B, Hq, T, D]; k, v [B, Hkv, T, D]."""
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, t, d)
    s = torch.einsum("bhgtd,bhnd->bhgtn", qf, k.float()) * sm_scale
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgtn,bhnd->bhgtd", p, v.float())
    return out.reshape(b, hq, t, -1).to(q.dtype)


def laser_attention_blocked_ref(q, k, v, sm_scale, causal=True, block: int = _BLOCK):
    """Plain version of K17: the TPU kernel's online softmax over kv blocks
    of min(block, T) columns, all f32, out = acc / max(l, 1e-37). Columns
    >= T are masked (the TPU kernel leaves them in). Every query row takes
    every kv block: a block the TPU kernel skips as wholly above the
    diagonal changes nothing (its scores are -1e30, so alpha = 1, p = 0)."""
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    dv = v.shape[-1]
    bk = min(block, t)
    dev = q.device
    qf = q.float().reshape(b, hkv, g, t, d)
    rows = torch.arange(t, device=dev)[:, None]
    m = torch.full((b, hkv, g, t, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, t, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, t, dv), dtype=torch.float32, device=dev)
    for j in range(cdiv(t, bk)):
        c0, c1 = j * bk, min((j + 1) * bk, t)
        kb = torch.zeros((b, hkv, bk, d), dtype=torch.float32, device=dev)
        vb = torch.zeros((b, hkv, bk, dv), dtype=torch.float32, device=dev)
        kb[:, :, : c1 - c0] = k[:, :, c0:c1].float()
        vb[:, :, : c1 - c0] = v[:, :, c0:c1].float()
        s = torch.einsum("bhgtd,bhnd->bhgtn", qf, kb) * sm_scale
        cols = c0 + torch.arange(bk, device=dev)[None, :]
        keep = cols < t
        if causal:
            keep = keep & (rows >= cols)
        s = torch.where(keep, s, _NEG_INF)
        m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgtn,bhnd->bhgtd", p, vb)
        m = m_cur
    out = acc / l.clamp_min(1e-37)
    return out.reshape(b, hq, t, dv).to(q.dtype)


def laser_tile(d: int, dv: int):
    """The (Dp, Dvp) of TENSOR_CORE_WIDTHS that a bf16 / fp16 (d, dv) runs
    at: the one with the least Dp + Dvp that holds both, or None where d or
    dv is not a multiple of 8 in 8..256 (TMA's 16-byte rows)."""
    if d < 8 or dv < 8 or d % 8 or dv % 8:
        return None
    fits = [w for w in TENSOR_CORE_WIDTHS if w[0] >= d and w[1] >= dv]
    return min(fits, key=sum) if fits else None


def laser_route(d: int, dv: int, dtype) -> str:
    """The K17 kernel that takes head dims (d, dv) in `dtype` on the card:
    "laser_attention" (bf16 or fp16 where laser_tile gives a tile) or
    "laser_attention_general" (f32, and bf16 or fp16 at other widths; D and
    Dv up to GENERAL_MAX_D). Raises TypeError for another dtype and
    ValueError for widths neither kernel takes."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"laser_attention: {dtype} inputs; the kernels take bf16, fp16 and f32")
    if dtype != torch.float32 and laser_tile(d, dv) is not None:
        return "laser_attention"
    if 1 <= d <= GENERAL_MAX_D and 1 <= dv <= GENERAL_MAX_D:
        return "laser_attention_general"
    raise ValueError(f"laser_attention: head dims (D {d}, Dv {dv}): the bf16 / fp16 kernel "
                     f"takes (D, Dv) in {TENSOR_CORE_WIDTHS} and other multiples of 8 padded "
                     f"to one, the split-TF32 kernel any D and Dv up to {GENERAL_MAX_D}")


def _laser_cuda(q, k, v, sm_scale, causal):
    """One launch of K17 on the route laser_route picks: q [B, Hq, T, D],
    k [B, Hkv, T, D], v [B, Hkv, T, Dv], all of one dtype."""
    b, hq, t, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    if (k.shape != (b, hkv, t, d) or v.shape != (b, hkv, t, dv) or hkv == 0 or hq % hkv):
        raise ValueError(f"laser_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: needs k [B, Hkv, T, D], v [B, Hkv, T, Dv] and "
                         "Hq a multiple of Hkv")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"laser_attention: q, k and v of one dtype expected, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    name = laser_route(d, dv, q.dtype)
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, hq, t, dv), dtype=q.dtype, device=dev)
    _build.check_operands(name, dev, q, k, v, out)
    if out.numel() == 0:
        return out
    fn = _build.launcher(name, _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, t, d, dv,
              int(causal), DTYPE_CODES[q.dtype], float(sm_scale),
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(name, code)
    _build.launches[name] += 1
    return out


def laser_attention(q, k, v, sm_scale, causal=True):
    """Flash forward attention (module docstring)."""
    if use_kernel(q):
        return _laser_cuda(q, k, v, sm_scale, causal)
    if q.shape[2] >= _GATE_T:
        return laser_attention_blocked_ref(q, k, v, sm_scale, causal)
    return laser_attention_ref(q, k, v, sm_scale, causal)


def prefill_attention_varlen(q, k, v, cu_seqlens, sm_scale):
    """Varlen causal prefill over flat [T, H, D] tensors (the layout SGLang
    feeds): block-diagonal causal masking by sequence id. Plain PyTorch."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    dev = q.device
    pos = torch.arange(t, device=dev)
    seq_id = torch.searchsorted(cu_seqlens[1:].to(device=dev, dtype=torch.int64), pos,
                                right=True)
    qf = q.float().reshape(t, hkv, g, d)
    s = torch.einsum("thgd,nhd->thgn", qf, k.float()) * sm_scale
    valid = (seq_id[:, None] == seq_id[None, :]) & (pos[:, None] >= pos[None, :])
    s = torch.where(valid[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("thgn,nhd->thgd", p, v.float())
    return out.reshape(t, hq, -1).to(q.dtype)
