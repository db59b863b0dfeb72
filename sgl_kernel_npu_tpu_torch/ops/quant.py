"""Quantization primitives (counterpart of the JAX package's ops/quant.py):
per-token dynamic int8, static per-tensor asymmetric int8, block fp8 e4m3.
Plain PyTorch, as the JAX functions are plain jnp: no kernel.

Rounding is half-to-even (`torch.round`), as `jnp.round` does.

  * per_token_quant_int8: the scale is absmax times f32(1/127). Compiled XLA
    turns the JAX code's division by the constant 127 into that multiply,
    so the scales match the compiled reference bit for bit. x is then
    divided by the scale, as there.
  * per_block_quant_fp8: the scale is absmax / 448, a division, as eager
    JAX computes the JAX code. Compiled XLA multiplies by f32(1/448)
    instead, which moves a scale by one f32 ulp now and then (the e4m3
    bytes rarely); tests/test_torch_fp8.py holds the port against both.

`fp8_from_jax` carries a JAX float8_e4m3fn array (as numpy) into a
torch.float8_e4m3fn tensor bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device

INT8_MAX = 127.0
INV_INT8_MAX = 1.0 / INT8_MAX     # rounded to f32 where it meets an f32 tensor
FP8_E4M3_MAX = 448.0


def per_token_quant_int8(x: torch.Tensor, eps: float = 1e-7):
    """x [..., D] float -> (q int8 [..., D], scale f32 [..., 1]), x ~ q*scale."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(eps) * INV_INT8_MAX
    q = torch.round(x32 / scale).clamp(-INT8_MAX - 1, INT8_MAX)
    return q.to(torch.int8), scale


def per_tensor_quant_int8_asymm(x: torch.Tensor, scale, offset) -> torch.Tensor:
    """Static per-tensor asymmetric int8 (mla_preprocess quant mode 0):
    q = clamp(round(x / scale + offset), -128, 127)."""
    q = torch.round(x.float() / scale + offset)
    return q.clamp(-128, 127).to(torch.int8)


def dequant_int8(q: torch.Tensor, scale, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def per_block_quant_fp8(x: torch.Tensor, block: int = 128, eps: float = 1e-7):
    """Block-wise fp8 e4m3 quant over the last dim: x [..., D], D % block
    == 0 -> (q float8_e4m3fn [..., D], scales f32 [..., D / block])."""
    *lead, d = x.shape
    if d % block:
        raise ValueError(f"D={d} not divisible by block={block}")
    xb = x.float().reshape(*lead, d // block, block)
    scale = xb.abs().amax(dim=-1, keepdim=True).clamp_min(eps) / FP8_E4M3_MAX
    q = (xb / scale).to(torch.float8_e4m3fn)
    return q.reshape(*lead, d), scale.squeeze(-1)


def dequant_fp8_block(q: torch.Tensor, scales: torch.Tensor, block: int = 128,
                      dtype=torch.bfloat16) -> torch.Tensor:
    *lead, d = q.shape
    xb = q.float().reshape(*lead, d // block, block)
    return (xb * scales[..., None]).reshape(*lead, d).to(dtype)


def fp8_from_jax(a, device="cuda") -> torch.Tensor:
    """A JAX float8_e4m3fn array, given as numpy, as a torch.float8_e4m3fn
    tensor on `device`: the bytes are carried through a uint8 view, so no
    value is rounded (NaN codes included)."""
    a = np.asarray(a)
    if a.dtype.name != "float8_e4m3fn":
        raise TypeError(f"fp8_from_jax takes float8_e4m3fn, not {a.dtype}")
    return (torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn)
            .to(resolve_device(device)))
