"""GDN gating, gated RMSNorm, the fused gating + recurrent decode update and
the Qwen-Next QKVZ/BA split (counterpart of the JAX package's
ops/gdn/gating.py). Plain PyTorch, as the JAX package leaves it to XLA, but
for the recurrence: `fused_sigmoid_gating_delta_rule_update` runs it through
recurrent_pallas.delta_rule_step, kernel K9 on the card.

The gated RMSNorm takes its reciprocal norm by chunk.py's float64 rule.
"""

from __future__ import annotations

from typing import Optional

import torch

from .chunk import inv_norm
from .recurrent_pallas import delta_rule_step


def _softplus(x, beta: float, threshold: float):
    """The JAX package's expression: log1p(exp(beta x)) / beta below the
    threshold, x above it."""
    return torch.where(beta * x <= threshold, (1.0 / beta) * torch.log1p(torch.exp(beta * x)),
                       x)


def fused_gdn_gating(A_log, a, b, dt_bias, beta: float = 1.0, threshold: float = 20.0):
    """g = -exp(A_log) * softplus(a + dt_bias), beta_out = sigmoid(b); both
    [B, H] f32."""
    x = a.float() + dt_bias.float()[None, :]
    g = -torch.exp(A_log.float())[None, :] * _softplus(x, beta, threshold)
    return g, torch.sigmoid(b.float())


def fused_gdn_gating_without_sigmoid(A_log, a, b, dt_bias, beta: float = 1.0,
                                     threshold: float = 20.0):
    """fused_gdn_gating's g, with b passed through unchanged."""
    x = a.float() + dt_bias.float()[None, :]
    return -torch.exp(A_log.float())[None, :] * _softplus(x, beta, threshold), b


def _silu(x):
    return x * torch.sigmoid(x)


def layernorm_gated(x, weight, bias=None, z=None, eps: float = 1e-6,
                    group_size: Optional[int] = None, norm_before_gate: bool = True,
                    is_rms_norm: bool = False):
    """Group-wise (layer|rms)norm with optional silu(z) gating. x, z [M, N];
    weight / bias [N]; group_size divides N. norm_before_gate: out =
    norm(x) * silu(z); else norm(x * silu(z)). Result in x's dtype."""
    m, n = x.shape
    gs = group_size or n
    x32 = x.float()
    if z is not None and not norm_before_gate:
        x32 = x32 * _silu(z.float())
    xg = x32.reshape(m, n // gs, gs)
    xc = xg if is_rms_norm else xg - xg.mean(-1, keepdim=True)
    inv = inv_norm((xc.double() ** 2).sum(-1, keepdim=True), eps, gs)
    out = (xc * inv).reshape(m, n) * weight.float()
    if bias is not None:
        out = out + bias.float()
    if z is not None and norm_before_gate:
        out = out * _silu(z.float())
    return out.to(x.dtype)


def fused_sigmoid_gating_delta_rule_update(A_log, a, dt_bias, softplus_beta, softplus_threshold,
                                           q, k, v, b, initial_state_source,
                                           initial_state_indices, scale=None,
                                           use_qk_l2norm_in_kernel: bool = False):
    """Fused gating + one recurrent delta-rule step (gating.py:72-118 of the
    JAX package, and the contract of its recurrent_pallas.py:136
    fused_sigmoid_gating_delta_rule_update_pallas): the gating in PyTorch,
    the recurrence through delta_rule_step (K9 on the card).

    q, k [B, 1, H, K]; v [B, 1, HV, V]; a, b [B, 1, HV]; initial_state_source
    [pool, HV, K, V], updated IN PLACE (the JAX package returns a new pool);
    indices [B] (< 0: read the clamped row, write nothing). Returns (o [B, 1,
    HV, V] in q's dtype, the pool)."""
    bsz, _, h, kd = q.shape
    hv, vd = v.shape[2], v.shape[3]
    g, beta = fused_gdn_gating(A_log, a.reshape(bsz, hv), b.reshape(bsz, hv), dt_bias,
                               softplus_beta, softplus_threshold)
    o = delta_rule_step(q.reshape(bsz, h, kd), k.reshape(bsz, h, kd), v.reshape(bsz, hv, vd),
                        g, beta, initial_state_source, initial_state_indices,
                        kd ** -0.5 if scale is None else scale, use_qk_l2norm_in_kernel)
    return o.reshape(bsz, 1, hv, vd).to(q.dtype), initial_state_source


def fused_qkvzba_split_reshape_cat(mixed_qkvz, mixed_ba, num_heads_qk, num_heads_v, head_qk,
                                   head_v):
    """Split the fused Qwen-Next projections. mixed_qkvz [B, Hqk*(2*Dqk +
    2*r*Dv)] laid out per qk head as [q | k | v (r*Dv) | z (r*Dv)]; mixed_ba
    [B, Hqk*2r] per qk head [b (r) | a (r)]. Returns (mixed_qkv [B, 2*Hqk*Dqk
    + Hv*Dv], z [B, Hv, Dv], b [B, Hv], a [B, Hv])."""
    bsz = mixed_qkvz.shape[0]
    r = num_heads_v // num_heads_qk
    per = mixed_qkvz.reshape(bsz, num_heads_qk, 2 * head_qk + 2 * r * head_v)
    q = per[..., :head_qk]
    k = per[..., head_qk:2 * head_qk]
    v = per[..., 2 * head_qk:2 * head_qk + r * head_v]
    z = per[..., 2 * head_qk + r * head_v:]
    mixed_qkv = torch.cat([q.reshape(bsz, -1), k.reshape(bsz, -1), v.reshape(bsz, -1)], -1)
    ba = mixed_ba.reshape(bsz, num_heads_qk, 2 * r)
    return (mixed_qkv, z.reshape(bsz, num_heads_v, head_v), ba[..., :r].reshape(bsz, num_heads_v),
            ba[..., r:].reshape(bsz, num_heads_v))
