"""MX-format block quantisation, MXFP8 and MXFP4, of EP payloads
(counterpart of the JAX package's ops/mxquant.py). Plain PyTorch, as the
JAX functions are plain jnp: no kernel.

Blocks of 32 values along the last dim share one E8M0 scale, a power of
two stored as a biased-127 uint8 exponent: the smallest 2^e with
absmax / 2^e <= the element maximum (448 for e4m3, 6 for e2m1). Elements
are float8_e4m3fn (MXFP8) or 4-bit e2m1 codes (MXFP4, sign << 3 | the
index of the magnitude in 0, 0.5, 1, 1.5, 2, 3, 4, 6; two a byte, the
even element in the low nibble; a value halfway between two magnitudes
takes the smaller).

The bits are those of the jitted JAX functions, which XLA compiles so:
absmax / elt_max becomes a product with f32(1 / elt_max), and log2 is
f32(log(y)) / f32(log(2)); ceil of that is the exponent, which near a
power of two is not always the exact ceil(log2(y)). The log is taken in
float64 and rounded to f32, so that it is correctly rounded on every
device. Dividing by the power-of-two scale is exact.
"""

from __future__ import annotations

import math

import torch

MX_BLOCK = 32
E4M3_MAX = 448.0
E2M1_MAX = 6.0
_E2M1_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
_LN2 = math.log(2.0)


def to_e4m3(x):
    """f32 -> float8_e4m3fn as ml_dtypes and XLA cast: round to nearest
    even, and a magnitude past 464 (the tie between 448 and the next step
    up) or an infinity is NaN with x's sign, where torch's cast saturates
    to 448."""
    nan = torch.copysign(torch.tensor(float("nan"), device=x.device), x)
    return torch.where(x.abs() > 464.0, nan, x).to(torch.float8_e4m3fn)


def _e8m0_scale(absmax, elt_max: float):
    """(biased uint8 exponent, f32 scale 2^e) of each block's absmax."""
    y = absmax.clamp_min(1e-30) * torch.tensor(1.0 / elt_max, dtype=torch.float32)
    log2 = torch.log(y.double()).float() / torch.tensor(_LN2, dtype=torch.float32)
    e = torch.ceil(log2).clamp(-127, 127)
    return (e + 127).to(torch.uint8), torch.exp2(e)


def _e8m0_decode(scale_u8):
    return torch.exp2(scale_u8.float() - 127.0)


def _blocks(x, block: int):
    h = x.shape[-1]
    assert h % block == 0, f"hidden {h} not a multiple of MX block {block}"
    return x.float().reshape(*x.shape[:-1], h // block, block)


def quantize_mxfp8(x, block: int = MX_BLOCK):
    """x [..., H] (H % block == 0) -> (q [..., H] float8_e4m3fn, scales
    [..., H / block] uint8 E8M0)."""
    xb = _blocks(x, block)
    s_u8, s = _e8m0_scale(xb.abs().amax(-1), E4M3_MAX)
    q = to_e4m3(xb / s[..., None])
    return q.reshape(x.shape), s_u8


def dequantize_mxfp8(q, scales_u8, block: int = MX_BLOCK, out_dtype=torch.bfloat16):
    out = _blocks(q, block) * _e8m0_decode(scales_u8)[..., None]
    return out.reshape(q.shape).to(out_dtype)


def _fp4_encode(x):
    """f32 -> e2m1 code (sign << 3 | magnitude index), to the nearest
    magnitude (the smaller at a tie)."""
    grid = torch.tensor(_E2M1_GRID, dtype=torch.float32, device=x.device)
    idx = torch.argmin((x.abs()[..., None] - grid).abs(), dim=-1).to(torch.uint8)
    return (x < 0).to(torch.uint8) << 3 | idx


def _fp4_decode(code):
    grid = torch.tensor(_E2M1_GRID, dtype=torch.float32, device=code.device)
    mag = grid[(code & 7).long()]
    return torch.where((code >> 3) > 0, -mag, mag)


def quantize_mxfp4(x, block: int = MX_BLOCK):
    """x [..., H] -> (packed uint8 [..., H / 2] (low nibble: the even
    element), scales [..., H / block] uint8 E8M0)."""
    h = x.shape[-1]
    assert h % 2 == 0
    xb = _blocks(x, block)
    s_u8, s = _e8m0_scale(xb.abs().amax(-1), E2M1_MAX)
    codes = _fp4_encode(xb / s[..., None]).reshape(x.shape)
    return codes[..., ::2] | (codes[..., 1::2] << 4), s_u8


def dequantize_mxfp4(packed, scales_u8, block: int = MX_BLOCK, out_dtype=torch.bfloat16):
    h = packed.shape[-1] * 2
    codes = torch.stack([_fp4_decode(packed & 15), _fp4_decode(packed >> 4)], -1)
    out = codes.reshape(*packed.shape[:-1], h // block, block) * \
        _e8m0_decode(scales_u8)[..., None]
    return out.reshape(*packed.shape[:-1], h).to(out_dtype)


def quantize_fp8_per_token(x, eps: float = 1e-7):
    """The low-latency dispatch's per-token fp8 mode: x [..., H] -> (q
    float8_e4m3fn, scale [..., 1] f32 = max(absmax, eps) * f32(1 / 448),
    the product compiled XLA takes for the JAX code's division by 448)."""
    x32 = x.float()
    scale = x32.abs().amax(-1, keepdim=True).clamp_min(eps) * \
        torch.tensor(1.0 / E4M3_MAX, dtype=torch.float32)
    return to_e4m3(x32 / scale), scale
