"""Fused RMSNorm -> INT8 quant -> W8A8 GEMM (+ int32 bias) -> dequant
(counterpart of the JAX package's ops/rmsq_gemm.py::rmsnorm_quant_gemm).

On a CUDA tensor `rmsnorm_quant_gemm` launches kernel K2 (csrc/rmsq_gemm.cu):
a row pass quantises each row once into int8 rows xq [M, K] and writes the
epilogue's row scale, and the GEMM, the int8 stage of csrc/w8a8_wgmma.cuh
that kernel K1 shares, streams the weights through rings of asynchronous
copies against xq, K split over blocks where the output has too few tiles
for the card (ops/matmul.py::gemm_plan). On a CPU tensor it runs the plain
version, `rmsnorm_quant_gemm_ref`, whose row pass is `rmsq_rows_ref`.

Both modes of the JAX package are served:
  * quant_mode="per_token" (the Llama path): dynamic symmetric row scales,
    multiplied in the epilogue;
  * quant_mode="per_tensor" (the MLA path's mla_preprocess stages): the
    static quant_scale / quant_offset, epilogue row scale 1.
Either mode takes an optional int32 bias, added to the sum before the
dequant (the per_tensor offset's GEMM contribution).
quant_cast="fp16" rounds the value to fp16 before rint, as the plain
version's cast to float16 (and the JAX reference's) does. x is bf16 or f32
[M, K] with unit column stride; its rows may lie further apart than K (a
column slice of a wider f32 output goes in without a copy). w is a pretiled
[L, N/bn, K, bn] bank with `li` the layer, or a plain [K, N] weight. Out is
bf16 or f32. Launches in the per_tensor mode count under "rmsq_gemm_pt",
those in the per_token mode under "rmsq_gemm".

Rounding, as the compiled JAX code rounds:
  * per_token scale = max(amax, 1e-7) * f32(1/127): compiled XLA turns
    `_row_stats`'s division by 127.0 into that multiply (ops/quant.py);
  * x is then DIVIDED by the scale (or quant_scale), as the TPU kernel
    divides (rmsq_gemm.py:83-88), and the offset added after;
  * the sum of squares of RMSNorm is taken in float64 and rounded to f32
    once: every bf16 or f32 square is exact there, so the mean does not
    depend on the order of the sum; rstd is 1/sqrt of the f32 mean + eps,
    taken in float64 and rounded to f32 once (correctly rounded on every
    device, where rsqrt approximates). The kernel's row pass computes both
    the same way, so kernel and plain version agree bit for bit. The JAX
    package sums in f32 and XLA's CPU rsqrt approximates, which moves some
    rows' rstd an ulp from the port's.
A fused and an unfused quant may still differ by rare +-1 flips of values
within an ulp of a rounding boundary (rmsq_gemm.py:30-36 of the JAX package),
so comparisons bound flips instead of asking for equality.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import use_kernel
from .matmul import _BK, _BN, gemm_plan, gemm_scratch, untile_weight_bank
from .quant import INV_INT8_MAX

# x, gamma, beta, w, ws, bias, quant_scale, quant_offset, xq, xs, out,
# partials, arrivals, M, N, K, ldx, li, bn, bm, splits, eps, apply_norm,
# per_tensor, x_f32, fp16_cast, out_f32, stream
_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_MODES = ("per_token", "per_tensor")
_CASTS = ("f32", "fp16")
def _check_mode(quant_scale, quant_mode, quant_cast):
    if quant_mode not in _MODES or quant_cast not in _CASTS:
        raise ValueError(f"rmsnorm_quant_gemm: quant_mode {quant_mode!r} not in "
                         f"{_MODES} or quant_cast {quant_cast!r} not in {_CASTS}")
    if quant_mode == "per_tensor" and quant_scale is None:
        raise ValueError("rmsnorm_quant_gemm: the per_tensor mode needs quant_scale")


def _rstd(x, apply_norm: bool, eps: float):
    """[M, 1] f32: 1/rms of each row (ones without the norm)."""
    if not apply_norm:
        return torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device)
    x64 = x.double()
    mean = (x64 * x64).sum(dim=-1, keepdim=True).float() / x.shape[-1]
    return (1.0 / torch.sqrt((mean + eps).double())).float()


def _row_stats(x, gamma, beta, apply_norm: bool, eps: float):
    """Per-row statistics of the per_token mode: rstd [M, 1] (ones without
    the norm) and the per-token scale [M, 1], both f32. The scale is the
    quant divisor and the epilogue's row scale."""
    rstd = _rstd(x, apply_norm, eps)
    normed = x.float() * rstd * gamma.float()[None, :] + beta.float()[None, :]
    amax = normed.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-7) * INV_INT8_MAX
    return rstd, scale


def _layer_slice(t, w, li):
    """Row li of a per-layer [L, N] tensor for a pretiled bank, else t [N]."""
    if w.dim() == 4:
        return t.reshape(w.shape[0], -1)[li]
    return t.reshape(-1)


def _layer_weight(w, li):
    """w [K, N] of layer li of a pretiled bank, or of a plain weight."""
    if w.dim() == 4:
        return untile_weight_bank(w[li:li + 1])[0]
    return w


def _quant_rows(x, rstd, gamma, beta, qdiv, qoff, fp16_cast: bool):
    """int8 [M, K]: (x * rstd * gamma + beta) / qdiv (+ qoff), rounded to fp16
    first where asked, then half to even and clipped to [-128, 127]."""
    qv = (x.float() * rstd * gamma.float()[None, :] + beta.float()[None, :]) / qdiv
    if qoff is not None:
        qv = qv + qoff
    if fp16_cast:
        qv = qv.to(torch.float16).float()
    return torch.round(qv).clamp(-128, 127).to(torch.int8)


def rmsq_rows_ref(x, gamma, beta, quant_scale=None, quant_offset=None,
                  quant_mode: str = "per_tensor", apply_norm: bool = True,
                  eps: float = 1e-6, quant_cast: str = "f32"):
    """Plain version of K2's row pass: (xq [M, K] int8, x_scale [M, 1] f32),
    the quantised rows and the epilogue's row scale (the per-token scale,
    or ones in the per_tensor mode)."""
    _check_mode(quant_scale, quant_mode, quant_cast)
    if quant_mode == "per_token":
        rstd, qdiv = _row_stats(x, gamma, beta, apply_norm, eps)
        qoff, outsc = None, qdiv
    else:
        rstd = _rstd(x, apply_norm, eps)
        qdiv = quant_scale.float().reshape(())
        qoff = (quant_offset.float().reshape(()) if quant_offset is not None
                else None)
        outsc = torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device)
    return _quant_rows(x, rstd, gamma, beta, qdiv, qoff, quant_cast == "fp16"), outsc


def rmsnorm_quant_gemm_ref(x, gamma, beta, w, descale, bias=None,
                           quant_scale=None, quant_offset=None, li=None,
                           quant_mode: str = "per_tensor", apply_norm: bool = True,
                           eps: float = 1e-6, out_dtype=torch.float32,
                           quant_cast: str = "f32"):
    """Plain version of kernel K2 (same contract as rmsnorm_quant_gemm)."""
    q, outsc = rmsq_rows_ref(x, gamma, beta, quant_scale, quant_offset, quant_mode,
                             apply_norm, eps, quant_cast)
    acc = q.double() @ _layer_weight(w, li).double()
    if bias is not None:
        acc = acc + _layer_slice(bias, w, li).double()[None, :]
    out = acc.float() * _layer_slice(descale, w, li).float()[None, :]
    return (out * outsc).to(out_dtype)


def rmsnorm_quant_gemm(x, gamma, beta, w, descale, bias=None,
                       quant_scale=None, quant_offset=None, li=None,
                       quant_mode: str = "per_tensor", apply_norm: bool = True,
                       eps: float = 1e-6, out_dtype=torch.float32,
                       quant_cast: str = "f32"):
    """out[M, N] = dequant((quant(rmsnorm(x) * gamma + beta) @ w) + bias).

    x [M, K] bf16 or f32 (unit column stride); gamma/beta [K]; w a pretiled
    bank [L, NB, K, bn] int8 with `li` the layer, or [K, N] int8; descale and
    bias [L, N] (or [N] for a plain weight), f32 and int32; quant_scale /
    quant_offset one value each (per_tensor). apply_norm=False skips the
    RMSNorm but keeps the affine."""
    _check_mode(quant_scale, quant_mode, quant_cast)
    if not use_kernel(x):
        return rmsnorm_quant_gemm_ref(
            x, gamma, beta, w, descale, bias, quant_scale, quant_offset, li=li,
            quant_mode=quant_mode, apply_norm=apply_norm, eps=eps,
            out_dtype=out_dtype, quant_cast=quant_cast)
    return _rmsq_gemm(x, gamma, beta, w, descale, bias, quant_scale, quant_offset,
                      li, quant_mode == "per_tensor", apply_norm, eps, out_dtype,
                      quant_cast == "fp16")


def _scalar_operand(t, dev, name):
    """One f32 value on `dev`, for the kernel to read through a pointer."""
    t = t.reshape(-1)
    if t.numel() != 1 or t.device != dev:
        raise ValueError(f"rmsq_gemm: {name} must be one value on {dev}")
    return t.float()


def _rmsq_gemm(x, gamma, beta, w, descale, bias, quant_scale, quant_offset, li,
               per_tensor, apply_norm, eps, out_dtype, fp16_cast):
    m, k = x.shape
    dev = x.device
    if w.dim() == 4:
        l, nb, k2, bn = w.shape
        n = nb * bn
        li = int(li)
        if bn % _BN or not 0 <= li < l:
            raise ValueError(f"rmsq_gemm: bank {tuple(w.shape)}, li={li}: "
                             f"needs bn % {_BN} == 0")
    else:
        k2, n = w.shape
        l, bn, li = 1, n, 0
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != torch.int8:
        raise TypeError(f"rmsq_gemm takes bf16 or f32 x and int8 w, got {x.dtype}, "
                        f"{w.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rmsq_gemm writes bf16 or f32, not {out_dtype}")
    if k2 != k or k % _BK or n % 16:
        raise ValueError(f"rmsq_gemm: x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         f"needs K % {_BK} == 0, N % 16 == 0")
    ldx = x.stride(0) if m > 1 else k
    if (x.stride(1) != 1 or x.device != dev or x.data_ptr() % 16
            or (ldx * x.element_size()) % 16 or ldx < k):
        raise ValueError(f"rmsq_gemm: x rows must be 16-byte aligned with unit "
                         f"column stride; got strides {x.stride()}")
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    ws = descale.float().reshape(l, n).contiguous()
    ops = [g32, b32, w, ws]
    bias32 = None
    if bias is not None:
        bias32 = bias.to(torch.int32).reshape(l, n).contiguous()
        ops.append(bias32)
    _build.check_operands("rmsq_gemm", dev, *ops)
    if g32.shape != (k,) or b32.shape != (k,):
        raise ValueError(f"rmsq_gemm: gamma/beta {tuple(g32.shape)}, "
                         f"{tuple(b32.shape)} != ({k},)")
    qs = qo = None
    if per_tensor:
        qs = _scalar_operand(quant_scale, dev, "quant_scale")
        if quant_offset is not None:
            qo = _scalar_operand(quant_offset, dev, "quant_offset")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    bm, tiles_m, tiles_n, splits = gemm_plan(
        m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    n_part, n_arrivals = gemm_scratch(bm, tiles_m, tiles_n, splits)
    part = arrivals = None
    if splits > 1:
        part = torch.empty(n_part, dtype=torch.int32, device=dev)
        arrivals = _build.arrival_counters("rmsq_gemm", dev, n_arrivals)
    fn = _build.launcher("rmsq_gemm", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return t.data_ptr() if t is not None else None
    code = fn(x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
              ws.data_ptr(), ptr(bias32), ptr(qs), ptr(qo), xq.data_ptr(), xs.data_ptr(),
              out.data_ptr(), ptr(part), ptr(arrivals), m, n, k, ldx, li, bn, bm, splits,
              float(eps), int(bool(apply_norm)), int(per_tensor),
              int(x.dtype == torch.float32), int(fp16_cast), int(out_dtype == torch.float32),
              stream)
    _build.check("rmsq_gemm", code)
    _build.launches["rmsq_gemm_pt" if per_tensor else "rmsq_gemm"] += 1
    return out
