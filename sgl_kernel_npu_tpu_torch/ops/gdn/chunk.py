"""The chunked gated-delta-rule prefill, its per-chunk cumsum, l2norm and the
float64 reciprocal-norm rule of the GDN ops (counterpart of the JAX
package's ops/gdn/chunk.py). Plain PyTorch, as the JAX package leaves the
chunked pipeline to XLA: batched matmuls over [B, H, N, C, D] chunk tensors
and a loop over the chunks that carries the f32 [B, H, Dk, Dv] state (the
JAX package's lax.scan).

Every reciprocal square root of the ported GDN path (l2norm, the gated
RMSNorm, the model's RMSNorm, and inside K9) is taken from a float64 sum of
squares rounded to f32, then 1/sqrt of that plus eps in float64, rounded
once, on every device alike, since `torch.rsqrt`, `rsqrtf` and XLA's CPU
rsqrt each approximate differently.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .tri_inv import inv_unit_lower


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


def chunk_gated_delta_rule(q, k, v, g, beta, chunk_size: int = 64, initial_state=None,
                           output_final_state: bool = False,
                           use_qk_l2norm_in_kernel: bool = False, scale: Optional[float] = None):
    """Chunked GDN forward (chunk.py:34 of the JAX package).

    q, k [B, T, H, Dk]; v [B, T, H, Dv]; g, beta [B, T, H] (g the log
    decay); initial_state [B, H, Dk, Dv]. T is padded to a multiple of the
    chunk. Returns (out [B, T, H, Dv] in q's dtype, final_state [B, H, Dk,
    Dv] f32 or None).

      within-chunk decay D_ij = exp(g_i - g_j) (i >= j, g cumsummed)
      T = (I + tril(K_beta K^T * D, -1))^{-1}  (the WY transform)
      W = T (K_beta * exp(g));  U = T V_beta
      per chunk: o = (q * exp(g)) S + tril(q k^T * D) (U - W S)
                 S <- exp(g_C) S + (k * exp(g_C - g))^T (U - W S)
    """
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = chunk_size
    if use_qk_l2norm_in_kernel:
        q, k = l2norm(q), l2norm(k)
    if scale is None:
        scale = dk ** -0.5
    pad = (-t) % c
    n = (t + pad) // c

    def chunks(x):                       # [B, T, H, D] -> f32 [B, H, N, C, D]
        x = F.pad(x.float().transpose(1, 2), (0, 0, 0, pad))
        return x.reshape(b, h, n, c, x.shape[-1])

    def chunks3(x):                      # [B, T, H] -> f32 [B, H, N, C]
        return F.pad(x.float().transpose(1, 2), (0, pad)).reshape(b, h, n, c)

    qc = chunks(q) * scale
    kc, vc = chunks(k), chunks(v)
    gc = torch.cumsum(chunks3(g), -1)
    bc = chunks3(beta)
    k_beta = kc * bc[..., None]
    v_beta = vc * bc[..., None]
    # the inner tril keeps exp of the upper triangle's positive differences
    # from reaching inf
    diff = gc[..., :, None] - gc[..., None, :]
    decay = torch.tril(torch.exp(torch.tril(diff)))
    kkt = torch.matmul(k_beta, kc.transpose(-1, -2))
    t_inv = inv_unit_lower(-torch.tril(kkt * decay, diagonal=-1))
    u = torch.matmul(t_inv, v_beta)
    w = torch.matmul(t_inv, k_beta * torch.exp(gc)[..., None])
    qk = torch.tril(torch.matmul(qc, kc.transpose(-1, -2)) * decay)
    g_last = gc[..., -1]
    k_decay = kc * torch.exp(g_last[..., None, None] - gc[..., None])
    q_decay = qc * torch.exp(gc)[..., None]

    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state.float())
    outs = []
    for i in range(n):
        v_new = u[:, :, i] - torch.matmul(w[:, :, i], state)
        outs.append(torch.matmul(q_decay[:, :, i], state) + torch.matmul(qk[:, :, i], v_new))
        state = (state * torch.exp(g_last[:, :, i])[..., None, None]
                 + torch.matmul(k_decay[:, :, i].transpose(-1, -2), v_new))
    out = torch.stack(outs, 2).reshape(b, h, n * c, dv)[:, :, :t]
    return out.transpose(1, 2).to(q.dtype), (state if output_final_state else None)


def chunk_gated_delta_rule_varlen(q, k, v, g, beta, cu_seqlens, initial_state,
                                  max_seq_len: Optional[int] = None, chunk_size: int = 64,
                                  use_qk_l2norm_in_kernel: bool = True,
                                  scale: Optional[float] = None):
    """Varlen form over flat [1, total, H, D] inputs and cu_seqlens
    (chunk.py:132 of the JAX package), the qk heads repeated up to the v
    heads (v-head i reads qk head i // r). Each sequence is gathered into a
    row of max_seq_len (default: total) positions; padding positions get
    decay 0 and beta 0, so the state is frozen there. initial_state
    [num_seqs, Hv, Dk, Dv]. Returns (out [1, total, Hv, Dv], final_states
    [num_seqs, Hv, Dk, Dv] f32)."""
    hq, hv = q.shape[-2], v.shape[-2]
    if hv > hq:
        q = torch.repeat_interleave(q, hv // hq, dim=-2)
        k = torch.repeat_interleave(k, hv // hq, dim=-2)
    total = q.shape[1]
    nseq = cu_seqlens.shape[0] - 1
    maxt = max_seq_len or total
    cu = cu_seqlens.long()
    seqlens, starts = cu[1:] - cu[:-1], cu[:-1]
    j = torch.arange(maxt, device=q.device)
    cols = (starts[:, None] + j[None, :]).clamp(0, total - 1)
    m = j[None, :] < seqlens[:, None]

    def padseq(x):
        rows = x[0][cols]                                    # [nseq, maxt, ...]
        keep = m.reshape(nseq, maxt, *([1] * (rows.dim() - 2)))
        return torch.where(keep, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))

    out, final = chunk_gated_delta_rule(
        padseq(q), padseq(k), padseq(v), padseq(g), padseq(beta), chunk_size=chunk_size,
        initial_state=initial_state, output_final_state=True,
        use_qk_l2norm_in_kernel=use_qk_l2norm_in_kernel, scale=scale)
    # scatter back; every padding position aims at row `total`, dropped
    tgt = torch.where(m, starts[:, None] + j[None, :], total).reshape(-1)
    flat = torch.zeros((total + 1,) + tuple(out.shape[2:]), dtype=out.dtype, device=out.device)
    flat.index_copy_(0, tgt, out.reshape((nseq * maxt,) + tuple(out.shape[2:])))
    return flat[:total][None], final


def chunk_local_cumsum(g, chunk_size: int, reverse: bool = False):
    """Inclusive cumsum over the time dim within each chunk of `chunk_size`
    positions, in f32 (reverse: from the chunk's end). g [B, T, H] -> the
    same shape and dtype (chunk.py:182 of the JAX package)."""
    b, t, h = g.shape
    pad = (-t) % chunk_size
    n = (t + pad) // chunk_size
    gc = F.pad(g.float(), (0, 0, 0, pad)).reshape(b, n, chunk_size, h)
    if reverse:
        out = torch.flip(torch.cumsum(torch.flip(gc, (2,)), 2), (2,))
    else:
        out = torch.cumsum(gc, 2)
    return out.reshape(b, n * chunk_size, h)[:, :t].to(g.dtype)
