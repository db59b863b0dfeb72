"""Fused QKV split + per-head RMSNorm + RoPE family (counterpart of the JAX
package's ops/qkv_fusion.py). Plain PyTorch, as the JAX package leaves the
chain to XLA, which fuses it into one pass over the projection output.

  split_qkv_rmsnorm_rope            q | k | v split, per-head RMSNorm of q, k,
                                    RoPE on the first rope_dim of each head
  split_qkv_rmsnorm_rope_pos_cache  the same from positions and a packed
                                    [max_pos, rope_dim] cos | sin table
  split_qkv_tp_rmsnorm_rope         one tensor-parallel rank's shard
  fused_split_qk_norm               the MLA projection split
  split_qkvgate_gemma_rmsnorm_rope  [q | gate] per head, Gemma (1 + w) norms

The RoPE takes both styles: neox (rotate-half, the table as it is) and
interleaved (pairs (2i, 2i + 1), the first half of the table spread over
them). Each per-head RMSNorm takes its reciprocal norm by gdn.chunk's
float64 rule, as every RMSNorm of the port does.
"""

from __future__ import annotations

import torch

from .gdn.chunk import inv_norm


def _head_rms(x, weight, bias, eps, head_dim):
    """RMSNorm over each trailing group of head_dim, in f32."""
    shape = x.shape
    xh = x.float().reshape(*shape[:-1], shape[-1] // head_dim, head_dim)
    inv = inv_norm((xh.double() ** 2).sum(-1, keepdim=True), eps, head_dim)
    out = xh * inv * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.reshape(shape)


def _rope_heads(x, sin, cos, head_dim, rope_dim, is_neox_style):
    """RoPE on the first rope_dim dims of every head_dim group of x [B, N],
    in f32. sin / cos [B, rope_dim] full tables: neox rotates halves with
    the table as it is; the interleaved style rotates pairs (2i, 2i + 1) by
    entry i of the first half."""
    b = x.shape[0]
    xh = x.float().reshape(b, -1, head_dim)
    rot = xh[..., :rope_dim]
    s, c = sin.float(), cos.float()
    half = rope_dim // 2
    if is_neox_style:
        rot = rot * c[:, None] + torch.cat([-rot[..., half:], rot[..., :half]], -1) * s[:, None]
    else:
        s = torch.repeat_interleave(s[..., :half], 2, dim=-1)
        c = torch.repeat_interleave(c[..., :half], 2, dim=-1)
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        o1 = x1 * c[:, None, 0::2] - x2 * s[:, None, 0::2]
        o2 = x2 * c[:, None, 1::2] + x1 * s[:, None, 1::2]
        rot = torch.stack([o1, o2], -1).reshape(rot.shape)
    return torch.cat([rot, xh[..., rope_dim:]], -1).reshape(b, -1)


def split_qkv_rmsnorm_rope(x, sin, cos, q_hidden_size, kv_hidden_size, head_dim, eps=None,
                           q_weight=None, k_weight=None, q_bias=None, k_bias=None,
                           is_neox_style=True):
    """x [B, qh + 2 kvh] -> (q [B, qh], k [B, kvh], v [B, kvh]): q and k
    per-head RMSNormed (when eps is given) and rotated on the first
    rope_dim = sin.shape[-1] dims of each head, in x's dtype; v as it is."""
    q = x[:, :q_hidden_size]
    k = x[:, q_hidden_size:q_hidden_size + kv_hidden_size]
    v = x[:, q_hidden_size + kv_hidden_size:]
    if eps is not None:
        q = _head_rms(q, q_weight, q_bias, eps, head_dim)
        k = _head_rms(k, k_weight, k_bias, eps, head_dim)
    rope_dim = sin.shape[-1]
    q = _rope_heads(q, sin, cos, head_dim, rope_dim, is_neox_style)
    k = _rope_heads(k, sin, cos, head_dim, rope_dim, is_neox_style)
    return q.to(x.dtype), k.to(x.dtype), v


def split_qkv_rmsnorm_rope_pos_cache(x, positions, cos_sin_cache, q_hidden_size,
                                     kv_hidden_size, head_dim, eps=None, q_weight=None,
                                     k_weight=None, q_bias=None, k_bias=None,
                                     is_neox_style=True):
    """split_qkv_rmsnorm_rope from token positions and a packed [max_pos,
    rope_dim] cos | sin half-table cache."""
    cs = cos_sin_cache[positions.long()]
    half = cs.shape[-1] // 2
    cos = torch.cat([cs[:, :half], cs[:, :half]], -1)
    sin = torch.cat([cs[:, half:], cs[:, half:]], -1)
    return split_qkv_rmsnorm_rope(x, sin, cos, q_hidden_size, kv_hidden_size, head_dim, eps,
                                  q_weight, k_weight, q_bias, k_bias, is_neox_style)


def split_qkv_tp_rmsnorm_rope(x, sin, cos, num_q_heads, num_kv_heads, head_dim, tp_rank=0,
                              tp_size=1, eps=None, q_weight=None, k_weight=None,
                              is_neox_style=True):
    """split_qkv_rmsnorm_rope on this rank's shard of the fused projection,
    x [B, (nq + 2 nkv) / tp * head_dim]."""
    qh = num_q_heads // tp_size * head_dim
    kvh = num_kv_heads // tp_size * head_dim
    return split_qkv_rmsnorm_rope(x, sin, cos, qh, kvh, head_dim, eps, q_weight, k_weight,
                                  None, None, is_neox_style)


def fused_split_qk_norm(x, q_norm_weight, kv_norm_weight, q_lora_rank, kv_lora_rank,
                        qk_rope_dim, eps=1e-6, q_norm_bias=None, kv_norm_bias=None):
    """The MLA projection split: x [B, qlr + kvlr + rope] -> (q_lora
    RMSNormed [B, qlr], k_nope RMSNormed [B, 1, kvlr], k_pe [B, 1, rope])."""
    q = x[:, :q_lora_rank]
    kn = x[:, q_lora_rank:q_lora_rank + kv_lora_rank]
    kp = x[:, q_lora_rank + kv_lora_rank:]
    q = _head_rms(q, q_norm_weight, q_norm_bias, eps, q_lora_rank).to(x.dtype)
    kn = _head_rms(kn, kv_norm_weight, kv_norm_bias, eps, kv_lora_rank).to(x.dtype)
    return q, kn[:, None, :], kp[:, None, :]


def split_qkvgate_gemma_rmsnorm_rope(x, sin, cos, q_hidden_size, kv_hidden_size, head_dim,
                                     rope_dim, eps, q_weight, k_weight):
    """The Gemma-gated split: x [B, 2 qh + 2 kvh], its q section [q | gate]
    per head; q and k get the (1 + weight) per-head RMSNorm and neox RoPE on
    their first rope_dim dims; gate and v pass through. Returns (q [B, qh],
    k [B, kvh], v [B, kvh], gate [B, qh])."""
    b = x.shape[0]
    qgate = x[:, : 2 * q_hidden_size].reshape(b, q_hidden_size // head_dim, 2 * head_dim)
    q = qgate[..., :head_dim].reshape(b, q_hidden_size)
    gate = qgate[..., head_dim:].reshape(b, q_hidden_size)
    k = x[:, 2 * q_hidden_size: 2 * q_hidden_size + kv_hidden_size]
    v = x[:, 2 * q_hidden_size + kv_hidden_size:]
    q = _head_rms(q, 1.0 + q_weight.float(), None, eps, head_dim)
    k = _head_rms(k, 1.0 + k_weight.float(), None, eps, head_dim)
    q = _rope_heads(q, sin, cos, head_dim, rope_dim, True)
    k = _rope_heads(k, sin, cos, head_dim, rope_dim, True)
    return q.to(x.dtype), k.to(x.dtype), v, gate.to(x.dtype)
