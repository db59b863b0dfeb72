"""The recurrent gated delta rule over token sequences with a paged SSM state,
for speculative (MTP) decoding (counterpart of the JAX package's
ops/gdn/recurrent.py). Plain PyTorch, as the JAX package runs it as a
lax.scan: a loop over the steps of the longest sequence, batched over
(sequence, head). Its state layout [slots, nv, dv, dk] is the transpose of
K9's pool, and it is not routed to K9.

Per token: q, k l2-normalised, q *= scale; alpha = exp(g), b = sigmoid(beta);
S *= alpha; y = (v - S k) b; S += y k^T; out = S q. Value head i reads qk
head i // (nv / nk).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils import index_copy_kept_
from .chunk import l2norm


def recurrent_gated_delta_rule(mix_qkv, recurrent_state, beta, scale, actual_seq_lengths,
                               ssm_state_indices, nk: int, nv: int, intermediate_state=None,
                               cache_indices=None, num_accepted_tokens=None, g=None, gk=None,
                               max_steps: Optional[int] = None):
    """mix_qkv [T, nk*dk*2 + nv*dv]; recurrent_state [slots, nv, dv, dk];
    beta [T, nv] (before the sigmoid; None: 1); g [T, nv] (log decay; None:
    0); actual_seq_lengths [num_seqs], the sequences laid end to end;
    ssm_state_indices [T], the state slot (in [0, slots)) each token reads
    and writes. `gk` is taken for the reference's signature and not read,
    as in the JAX package.

    With intermediate_state [lines, steps, nv, dv, dk] and cache_indices
    [lines'], step 0 of each named line is seeded with the recurrent state
    of the same index, and the slots address the flattened intermediate
    cache (line * steps + step). A sequence starts from the slot of its
    token num_accepted_tokens - 1 (default: its first token). Every active
    token writes its state to its slot, the steps in order, so that a later
    step wins at the same slot.

    Returns (out [T, nv, dv] in mix_qkv's dtype, the new state in
    recurrent_state's dtype: [slots, nv, dv, dk], or the flattened
    intermediate cache). The inputs are not modified."""
    t = mix_qkv.shape[0]
    dev = mix_qkv.device
    dv, dk = recurrent_state.shape[2], recurrent_state.shape[3]
    maxs = max_steps or t
    x32 = mix_qkv.float()
    qf = l2norm(x32[:, : nk * dk].reshape(t, nk, dk))
    kf = l2norm(x32[:, nk * dk: 2 * nk * dk].reshape(t, nk, dk))
    vf = x32[:, 2 * nk * dk:].reshape(t, nv, dv)
    qf = qf * (dk ** -0.5 if scale is None else scale)
    ones = torch.ones((t, nv), dtype=torch.float32, device=dev)
    alpha = torch.exp(g.float()) if g is not None else ones
    bsig = torch.sigmoid(beta.float()) if beta is not None else ones
    head_src = torch.arange(nv, device=dev) // (nv // nk)

    lens = actual_seq_lengths.long()
    starts = torch.cumsum(lens, 0) - lens
    j = torch.arange(maxs, device=dev)
    m = j[None, :] < lens[:, None]                              # [nseq, maxs]
    tok = (starts[:, None] + j[None, :]).clamp(0, t - 1)
    idx = ssm_state_indices.long()

    state = recurrent_state.to(torch.float32, copy=True)
    if intermediate_state is not None and cache_indices is not None:
        lines = intermediate_state.shape[0]
        ci = cache_indices.long().clamp(0, lines - 1)
        inter = intermediate_state.clone()
        inter[ci, 0] = recurrent_state[ci.clamp(0, recurrent_state.shape[0] - 1)].to(
            inter.dtype)
        state = inter.reshape(-1, nv, dv, dk).float()
    slots = state.shape[0]

    init_tok = starts + (num_accepted_tokens.long() - 1 if num_accepted_tokens is not None
                         else 0)
    s = state[idx[init_tok.clamp(0, t - 1)].clamp(0, slots - 1)]   # [nseq, nv, dv, dk]
    out = torch.zeros((t + 1, nv, dv), dtype=torch.float32, device=dev)
    for step in range(maxs):
        tk, active = tok[:, step], m[:, step]
        k_i = kf[tk][:, head_src]
        s_new = s * alpha[tk][..., None, None]
        y = (vf[tk] - torch.einsum("snvk,snk->snv", s_new, k_i)) * bsig[tk][..., None]
        s_new = s_new + y[..., :, None] * k_i[..., None, :]
        o = torch.einsum("snvk,snk->snv", s_new, qf[tk][:, head_src])
        out.index_copy_(0, torch.where(active, tk, t), o)
        index_copy_kept_(state, idx[tk].clamp(0, slots - 1), s_new, active)
        s = torch.where(active[:, None, None, None], s_new, s)
    return out[:t].to(mix_qkv.dtype), state.to(recurrent_state.dtype)
