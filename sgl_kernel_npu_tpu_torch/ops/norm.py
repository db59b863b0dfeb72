"""Norm-family ops (counterpart of the JAX package's ops/norm.py): fused
residual-add + RMSNorm (+bias, +static int8 quant), the gemma variant,
RMSNorm split into variance and rsqrt-mul, the no-weight RMSNorm, the L1
norm and scale-shift.

  add_rmsnorm_bias(x, residual, weight, bias, eps, quant_scale=None,
                   quant_offset=None) -> (normed or int8, x + residual)
h = x + residual is stored in x's dtype; the norm is taken over h in f32,
then * weight + bias, then (with quant) q = clip(rint(y * quant_scale +
quant_offset), -128, 127) with per-column scale and offset vectors.

With quant and a 2-D x (the JAX gate to its Pallas kernel), a CUDA tensor
launches kernel K20 (csrc/add_rmsnorm_quant.cu), counted under
"add_rmsnorm_quant"; a CPU tensor runs `add_rmsnorm_bias_ref`. Every other
call, and every other function here, is plain PyTorch on either device, as
the JAX package runs its jnp forms.

Rounding: the mean of squares is summed in float64 and rounded to f32 once
(every bf16 square is exact there, so the order does not matter), and rstd =
1 / sqrt(mean + eps) is taken in float64 and rounded to f32 once, where
rsqrt approximates; K20 computes both the same way. Every later step is one
f32 operation rounded on its own, rint is half-to-even. XLA's CPU rsqrt
approximates and it sums in f32, so a row's rstd can sit an ulp from the
JAX package's and an int8 value can flip by one.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import use_kernel

# x, residual, weight, bias, quant_scale, quant_offset, q, h, N, d, x_f32,
# eps, stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
_MAX_D = 8192


def _rstd(x32, eps: float):
    """[..., 1] f32: 1 / sqrt(mean(x^2) + eps), the sum in float64 rounded to
    f32 once, the root in float64 rounded once."""
    x64 = x32.double()
    mean = (x64 * x64).sum(dim=-1, keepdim=True).float() / x32.shape[-1]
    return (1.0 / torch.sqrt((mean + eps).double())).float()


def _rms(h32, eps: float):
    return h32 * _rstd(h32, eps)


def _quant_static(y32, quant_scale, quant_offset):
    q = y32 * quant_scale.float() + quant_offset.float()
    return torch.clamp(torch.round(q), -128, 127).to(torch.int8)


# ---------------------------------------------------------------- add_rmsnorm


def add_rmsnorm_bias_ref(x, residual, weight, bias, eps, quant_scale=None, quant_offset=None):
    """Plain version of K20 (and the un-gated path): returns (normed or
    int8, x + residual in x's dtype)."""
    h = x + residual
    y32 = _rms(h.float(), eps) * weight.float() + bias.float()
    if quant_scale is not None:
        return _quant_static(y32, quant_scale, quant_offset), h
    return y32.to(x.dtype), h


def _vector(t, d: int, dev):
    """A per-column f32 [d] operand of K20 (a scalar is broadcast)."""
    t = torch.as_tensor(t, device=dev).float().reshape(-1)
    if t.numel() == 1:
        t = t.expand(d)
    if t.numel() != d:
        raise ValueError(f"add_rmsnorm_quant: a per-column vector of {t.numel()} for width {d}")
    return t.contiguous()


def _add_rmsnorm_quant_cuda(x, residual, weight, bias, quant_scale, quant_offset, eps):
    """One launch of K20 on x, residual [N, d] (bf16 or f32, one dtype)."""
    n, d = x.shape
    if (residual.shape != x.shape or residual.dtype != x.dtype
            or x.dtype not in (torch.bfloat16, torch.float32) or d % 8 or d > _MAX_D):
        raise ValueError(f"add_rmsnorm_quant: x {tuple(x.shape)} {x.dtype}, residual "
                         f"{tuple(residual.shape)} {residual.dtype}: needs one dtype, bf16 or "
                         f"f32, and a width that is a multiple of 8 up to {_MAX_D}")
    dev = x.device
    x, residual = x.contiguous(), residual.contiguous()
    vecs = [_vector(t, d, dev) for t in (weight, bias, quant_scale, quant_offset)]
    q = torch.empty((n, d), dtype=torch.int8, device=dev)
    h = torch.empty_like(x)
    _build.check_operands("add_rmsnorm_quant", dev, x, residual, *vecs, q, h)
    if n == 0:
        return q, h
    fn = _build.launcher("add_rmsnorm_quant", _ARGTYPES)
    code = fn(x.data_ptr(), residual.data_ptr(), *(t.data_ptr() for t in vecs), q.data_ptr(),
              h.data_ptr(), n, d, int(x.dtype == torch.float32), float(eps),
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check("add_rmsnorm_quant", code)
    _build.launches["add_rmsnorm_quant"] += 1
    return q, h


def add_rmsnorm_bias(x, residual, weight, bias, eps, quant_scale=None, quant_offset=None):
    """Residual add + RMSNorm + bias (+ static int8 quant); module docstring."""
    if quant_scale is not None and x.ndim == 2 and use_kernel(x):
        return _add_rmsnorm_quant_cuda(x, residual, weight, bias, quant_scale, quant_offset,
                                       eps)
    return add_rmsnorm_bias_ref(x, residual, weight, bias, eps, quant_scale, quant_offset)


def add_gemma_rms_norm(x, residual, weight, eps):
    """Gemma-style: scale by (1 + weight); returns (normed, x + residual)."""
    h = x + residual
    y32 = _rms(h.float(), eps) * (1.0 + weight.float())
    return y32.to(x.dtype), h


def rmsnorm_bias(x, weight, bias, eps, quant_scale=None, quant_offset=None):
    """RMSNorm + bias (+ optional static int8 quant)."""
    y32 = _rms(x.float(), eps) * weight.float() + bias.float()
    if quant_scale is not None:
        return _quant_static(y32, quant_scale, quant_offset)
    return y32.to(x.dtype)


# ------------------------------------------------------------- rmsnorm pieces


def fused_variance(x):
    """Per-token mean of squares, [..., 1] in x's dtype (summed in f32, as
    the JAX package's split variance stage)."""
    x32 = x.float()
    return (x32 * x32).mean(dim=-1, keepdim=True).to(x.dtype)


def fused_rsqrt_mul(x, variance, weight, eps=1e-6):
    """x * rsqrt(variance + eps) * weight, in x's dtype."""
    y = x.float() * torch.rsqrt(variance.float() + eps)
    return (y * weight.float()).to(x.dtype)


def rmsnorm_without_weight(x, eps):
    return _rms(x.float(), eps).to(x.dtype)


def l1_norm(x):
    """Row L1 normalisation, f32 out."""
    x32 = x.float()
    return x32 / x32.abs().sum(dim=-1, keepdim=True)


def fused_scale_shift(x, scale, shift, scale_constant: float = 1.0):
    """out = x * (scale * scale_constant) + shift; scale of size 1 or hidden,
    shift of size 1, hidden, or x's."""
    x32 = x.float()
    s = scale.reshape(-1).float() * scale_constant
    sh = shift.float()
    sh = sh.reshape(x.shape) if sh.numel() == x.numel() else sh.reshape(-1)
    return (x32 * s + sh).to(x.dtype)
