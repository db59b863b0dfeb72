"""Rotary position embedding (counterpart of the JAX package's ops/rope.py).
The table packs [cos | sin] halves per position. Two pairings of the
rotated dims: neox style (first half with second half) and interleaved
(even with odd, GPT-J style)."""

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


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               is_neox_style: bool = True):
    """Rotate the last dim of x by (cos, sin) ([..., rotary_dim/2]); f32
    arithmetic, result in x's dtype."""
    x32 = x.float()
    cos = cos.float()
    sin = sin.float()
    if is_neox_style:
        half = x.shape[-1] // 2
        x1, x2 = x32[..., :half], x32[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = x32[..., 0::2], x32[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def fused_rope_qk_mqa(query, key, cos_sin, rotary_dim: int, is_neox_style: bool = True):
    """RoPE on query [T, Hq*D] and the single MQA key head [T, D] in one
    call: the first rotary_dim dims of each head rotated by cos_sin [T,
    rotary_dim] ([cos | sin] halves), the rest kept. Returns (query, key)
    in their shapes and dtypes."""
    t = query.shape[0]
    head_dim = key.shape[-1]
    q = query.reshape(t, -1, head_dim)
    cos = cos_sin[..., : rotary_dim // 2]
    sin = cos_sin[..., rotary_dim // 2: rotary_dim]
    q_rot = apply_rope(q[..., :rotary_dim], cos[:, None, :], sin[:, None, :], is_neox_style)
    k_rot = apply_rope(key[..., :rotary_dim], cos, sin, is_neox_style)
    if rotary_dim < head_dim:
        q_rot = torch.cat([q_rot, q[..., rotary_dim:]], dim=-1)
        k_rot = torch.cat([k_rot, key[..., rotary_dim:]], dim=-1)
    return q_rot.reshape(query.shape), k_rot
