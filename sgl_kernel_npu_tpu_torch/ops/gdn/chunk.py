"""l2norm and the float64 reciprocal-norm rule of the GDN ops (counterpart
of `l2norm` in the JAX package's ops/gdn/chunk.py; the chunked prefill is
not ported).

Every reciprocal square root of the ported GDN path (l2norm, the gated
RMSNorm, the model's RMSNorm, and inside K9) is taken from a float64 sum of
squares rounded to f32, then 1/sqrt of that plus eps in float64, rounded
once, on every device alike, since `torch.rsqrt`, `rsqrtf` and XLA's CPU
rsqrt each approximate differently.
"""

from __future__ import annotations

from typing import Optional

import torch


def inv_norm(sumsq64: torch.Tensor, eps: float, n: Optional[int] = None):
    """f32 1/sqrt(sum [/ n] + eps) from a float64 sum of squares: the sum
    (or mean) rounded to f32, eps added in f32, 1/sqrt in float64 rounded
    once."""
    s = sumsq64.float()
    if n is not None:
        s = s / n
    return (1.0 / torch.sqrt((s + eps).double())).float()


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L2 normalisation over the last dim in f32, result in x's dtype
    (chunk.py:27 of the JAX package)."""
    x32 = x.float()
    inv = inv_norm((x32.double() ** 2).sum(-1, keepdim=True), eps)
    return (x32 * inv).to(x.dtype)
