"""Fused RMSNorm -> per-token INT8 quant -> W8A8 GEMM -> dequant
(counterpart of the JAX package's ops/rmsq_gemm.py::rmsnorm_quant_gemm).

On a CUDA tensor `rmsnorm_quant_gemm` launches kernel K2 (csrc/rmsq_gemm.cu):
a row pass writes each row's rstd and per-token scale, and the GEMM
normalises and quantises each bf16 x block in its prologue, so the int8
activation never reaches device memory. On a CPU tensor it runs the plain
version, `rmsnorm_quant_gemm_ref`.

The port serves what the Llama decode path uses: quant_mode="per_token",
apply_norm True or False, no bias, a pretiled [L, N/bn, K, bn] bank with `li`
or a plain [K, N] weight, bf16 or f32 out. The per_tensor mode, the bias and
quant_cast="fp16" belong to the MLA slice and raise NotImplementedError.

Rounding, as the compiled JAX code rounds:
  * scale = max(amax, 1e-7) * f32(1/127): compiled XLA turns `_row_stats`'s
    division by 127.0 into that multiply (ops/quant.py);
  * x is then DIVIDED by the scale, as the TPU kernel divides
    (rmsq_gemm.py:83-88);
  * the sum of squares of RMSNorm is taken in float64 and rounded to f32
    once: every bf16 square is exact there, so the mean does not depend on
    the order of the sum; rstd is 1/sqrt of the f32 mean + eps, taken in
    float64 and rounded to f32 once (correctly rounded on every device,
    where rsqrt approximates). The kernel's row pass computes both the same
    way, so kernel and plain version agree bit for bit. The JAX package sums
    in f32 and XLA's CPU rsqrt approximates, which moves some rows' rstd an
    ulp from the port's.
A fused and an unfused quant may still differ by rare +-1 flips of values
within an ulp of a rounding boundary (rmsq_gemm.py:30-36 of the JAX package),
so comparisons bound flips instead of asking for equality.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import use_kernel
from .matmul import _BK, _BN, splits_for, untile_weight_bank
from .quant import INV_INT8_MAX

# x, gamma, beta, w, ws, rstd, scale, out, workspace, M, N, K, li, bn, splits,
# eps, apply_norm, out_f32, stream
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _check_mode(bias, quant_mode, quant_cast):
    if quant_mode != "per_token" or bias is not None or quant_cast != "f32":
        raise NotImplementedError(
            "rmsnorm_quant_gemm serves quant_mode='per_token' without bias in "
            "f32 quant; the per_tensor mode, the bias and quant_cast='fp16' "
            "come with the MLA slice (ROADMAP Queue 1)")


def _row_stats(x, gamma, beta, apply_norm: bool, eps: float):
    """Per-row statistics of the per_token mode: rstd [M, 1] (ones without
    the norm) and the per-token scale [M, 1], both f32. The scale is the
    quant divisor and the epilogue's row scale."""
    x32 = x.float()
    if apply_norm:
        x64 = x32.double()
        mean = (x64 * x64).sum(dim=-1, keepdim=True).float() / x.shape[-1]
        rstd = (1.0 / torch.sqrt((mean + eps).double())).float()
    else:
        rstd = torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device)
    normed = x32 * rstd * gamma.float()[None, :] + beta.float()[None, :]
    amax = normed.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-7) * INV_INT8_MAX
    return rstd, scale


def _layer_weight(w, descale, li):
    """(w [K, N], descale [N]) of layer li of a pretiled bank, or of a plain
    weight."""
    if w.dim() == 4:
        n = w.shape[1] * w.shape[3]
        return (untile_weight_bank(w[li:li + 1])[0],
                descale.reshape(w.shape[0], n)[li])
    return w, descale.reshape(-1)


def rmsnorm_quant_gemm_ref(x, gamma, beta, w, descale, bias=None,
                           quant_scale=None, quant_offset=None, li=None,
                           quant_mode: str = "per_tensor", apply_norm: bool = True,
                           eps: float = 1e-6, out_dtype=torch.float32,
                           quant_cast: str = "f32"):
    """Plain version of kernel K2 (same contract as rmsnorm_quant_gemm)."""
    _check_mode(bias, quant_mode, quant_cast)
    rstd, scale = _row_stats(x, gamma, beta, apply_norm, eps)
    xn = x.float() * rstd * gamma.float()[None, :] + beta.float()[None, :]
    q = torch.round(xn / scale).clamp(-128, 127).to(torch.int8)
    w_kn, ds = _layer_weight(w, descale, li)
    acc = (q.double() @ w_kn.double()).float()
    return (acc * ds.float()[None, :] * scale).to(out_dtype)


def rmsnorm_quant_gemm(x, gamma, beta, w, descale, bias=None,
                       quant_scale=None, quant_offset=None, li=None,
                       quant_mode: str = "per_tensor", apply_norm: bool = True,
                       eps: float = 1e-6, out_dtype=torch.float32,
                       quant_cast: str = "f32"):
    """out[M, N] = dequant(quant(rmsnorm(x) * gamma + beta) @ w).

    x [M, K] bf16; gamma/beta [K]; w a pretiled bank [L, NB, K, bn] int8 with
    `li` the layer, or [K, N] int8; descale [L, N] (or [N] for a plain
    weight) f32. quant_mode must be "per_token" (dynamic symmetric row
    scales, multiplied in the epilogue); apply_norm=False skips the RMSNorm
    but keeps the affine. quant_scale / quant_offset belong to the per_tensor
    mode and are not read."""
    _check_mode(bias, quant_mode, quant_cast)
    if not use_kernel(x):
        return rmsnorm_quant_gemm_ref(
            x, gamma, beta, w, descale, li=li, quant_mode=quant_mode,
            apply_norm=apply_norm, eps=eps, out_dtype=out_dtype)
    return _rmsq_gemm(x, gamma, beta, w, descale, li, apply_norm, eps, out_dtype)


def _rmsq_gemm(x, gamma, beta, w, descale, li, apply_norm, eps, out_dtype):
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
    if x.dtype != torch.bfloat16 or w.dtype != torch.int8:
        raise TypeError(f"rmsq_gemm takes bf16 x and int8 w, got {x.dtype}, {w.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rmsq_gemm writes bf16 or f32, not {out_dtype}")
    if k2 != k or k % _BK or n % 16:
        raise ValueError(f"rmsq_gemm: x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         f"needs K % {_BK} == 0, N % 16 == 0")
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    ws = descale.float().reshape(l, n).contiguous()
    _build.check_operands("rmsq_gemm", dev, x, g32, b32, w, ws)
    if g32.shape != (k,) or b32.shape != (k,):
        raise ValueError(f"rmsq_gemm: gamma/beta {tuple(g32.shape)}, "
                         f"{tuple(b32.shape)} != ({k},)")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    rstd = torch.empty((m,), dtype=torch.float32, device=dev)
    scale = torch.empty((m,), dtype=torch.float32, device=dev)
    splits = splits_for(m, n, k, dev)
    work = (torch.empty((m, n), dtype=torch.int32, device=dev) if splits > 1
            else None)
    fn = _build.launcher("rmsq_gemm", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
              ws.data_ptr(), rstd.data_ptr(), scale.data_ptr(), out.data_ptr(),
              work.data_ptr() if work is not None else None, m, n, k, li, bn,
              splits, float(eps), int(bool(apply_norm)),
              int(out_dtype == torch.float32), stream)
    _build.check("rmsq_gemm", code)
    _build.launches["rmsq_gemm"] += 1
    return out
