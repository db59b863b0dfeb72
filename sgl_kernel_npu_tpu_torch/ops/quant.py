"""Per-token dynamic INT8 quantization (counterpart of the JAX package's
ops/quant.py::per_token_quant_int8).

Rounding is half-to-even (`torch.round`), as `jnp.round` does. The scale is
absmax times f32(1/127): compiled XLA turns the JAX code's division by the
constant 127 into that multiply, so the scales match the compiled reference
bit for bit. x is then divided by the scale, as there.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0
INV_INT8_MAX = 1.0 / INT8_MAX     # rounded to f32 where it meets an f32 tensor


def per_token_quant_int8(x: torch.Tensor, eps: float = 1e-7):
    """x [..., D] float -> (q int8 [..., D], scale f32 [..., 1]), x ~ q*scale."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(eps) * INV_INT8_MAX
    q = torch.round(x32 / scale).clamp(-INT8_MAX - 1, INT8_MAX)
    return q.to(torch.int8), scale
