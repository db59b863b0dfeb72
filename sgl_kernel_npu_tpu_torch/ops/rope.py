"""Rotary position embedding, neox style (counterpart of the JAX package's
ops/rope.py). The table packs [cos | sin] halves per position."""

from __future__ import annotations

import torch


def make_cos_sin_cache(max_pos: int, rotary_dim: int, base: float = 10000.0,
                       dtype=torch.float32, device="cuda") -> torch.Tensor:
    """[max_pos, rotary_dim] table: row = [cos(theta_0..), sin(theta_0..)],
    on `device` (the card unless the caller asks for the CPU)."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=device) / rotary_dim
    inv_freq = 1.0 / (base ** exps)
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate the last dim of x by (cos, sin) ([..., rotary_dim/2]); f32
    arithmetic, result in x's dtype."""
    x32 = x.float()
    cos = cos.float()
    sin = sin.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
