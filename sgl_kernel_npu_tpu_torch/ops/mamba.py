"""Mamba / SSM causal conv1d ops: the prefill conv (dense and varlen), the
decode-time conv state update (one token, or S speculative tokens with their
intermediate windows) and the speculative state management (conv window
rollback, moving an intermediate SSM state into the pool). Counterpart of
the JAX package's ops/mamba.py. Plain PyTorch: the JAX package leaves all of
it to XLA.

Every width-W conv sums its taps in order, in f32, starting from 0: y = 0 +
x_0 w_0 + ... + x_{W-1} w_{W-1}, then the bias. The state updates are in
place (the JAX package returns new arrays): the conv state of
causal_conv1d_update and conv_state_rollback, the SSM pool of
move_intermediate_cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import index_copy_kept_

PAD_SLOT_ID = -1


def _act(y, activation):
    return y * torch.sigmoid(y) if activation in ("silu", "swish") else y


def causal_conv1d_fn(x, weight, bias=None, initial_states=None,
                     activation: Optional[str] = "silu", return_final_states: bool = False,
                     seqlens=None):
    """Depthwise causal conv over x [B, dim, T]: weight [dim, W], bias [dim],
    initial_states [B, dim, W - 1] (zeros when None). Returns (out [B, dim,
    T] in x's dtype, final_states [B, dim, W - 1] in x's dtype or None): the
    last W - 1 inputs of each sequence, ending at seqlens[b] (default T),
    read from [initial_states | x]."""
    b, dim, t = x.shape
    w = weight.shape[1]
    init = (torch.zeros((b, dim, w - 1), dtype=torch.float32, device=x.device)
            if initial_states is None else initial_states.float())
    xp = torch.cat([init, x.float()], -1)                       # [B, dim, W - 1 + T]
    w32 = weight.float()
    out = torch.zeros((b, dim, t), dtype=torch.float32, device=x.device)
    for i in range(w):
        out = out + w32[None, :, i:i + 1] * xp[..., i:i + t]
    if bias is not None:
        out = out + bias.float()[None, :, None]
    out = _act(out, activation).to(x.dtype)
    if not return_final_states:
        return out, None
    lens = (torch.full((b,), t, dtype=torch.long, device=x.device) if seqlens is None
            else seqlens.long())
    cols = (lens[:, None] + torch.arange(w - 1, device=x.device)[None, :]).clamp(
        0, xp.shape[-1] - 1)
    final = torch.gather(xp, 2, cols[:, None, :].expand(b, dim, w - 1))
    return out, final.to(x.dtype)


def causal_conv1d_varlen(x_flat, query_start_loc, weight, bias=None, conv_states=None,
                         cache_indices=None, has_initial_state=None, activation="silu",
                         max_seq_len: Optional[int] = None):
    """Varlen prefill over x_flat [dim, total] and query_start_loc (the
    sequences' cumulative starts, [B + 1]). Each sequence is gathered into a
    row of max_seq_len (default: total) positions, zero past its end; with
    conv_states [lines, dim, W - 1] and has_initial_state [B], sequence b
    starts from line cache_indices[b] (default b) times has_initial_state[b].
    Returns (out_flat [dim, total], final_states [B, dim, W - 1])."""
    dim, total = x_flat.shape
    bsz = query_start_loc.shape[0] - 1
    qsl = query_start_loc.long()
    seqlens, starts = qsl[1:] - qsl[:-1], qsl[:-1]
    maxt = max_seq_len or total
    j = torch.arange(maxt, device=x_flat.device)
    cols = (starts[:, None] + j[None, :]).clamp(0, total - 1)
    mask = j[None, :] < seqlens[:, None]
    x_pad = torch.where(mask[:, None, :], x_flat[:, cols].transpose(0, 1),
                        torch.zeros((), dtype=x_flat.dtype, device=x_flat.device))
    init = None
    if conv_states is not None and has_initial_state is not None:
        ci = (cache_indices.long() if cache_indices is not None
              else torch.arange(bsz, device=x_flat.device))
        init = conv_states[ci.clamp(0, conv_states.shape[0] - 1)] * has_initial_state[:, None,
                                                                                       None]
    out_pad, final = causal_conv1d_fn(x_pad, weight, bias, initial_states=init,
                                      activation=activation, return_final_states=True,
                                      seqlens=seqlens)
    # un-pad: every padding position aims at column `total`, dropped
    tgt = torch.where(mask, starts[:, None] + j[None, :], total).reshape(-1)
    out_flat = torch.zeros((total + 1, dim), dtype=out_pad.dtype, device=x_flat.device)
    out_flat.index_copy_(0, tgt, out_pad.transpose(1, 2).reshape(-1, dim))
    return out_flat[:total].T, final


def causal_conv1d_update(x, conv_state, weight, bias=None, activation=None,
                         conv_state_indices=None, num_accepted_tokens=None,
                         intermediate_conv_window=None, pad_slot_id: int = PAD_SLOT_ID,
                         cache_seqlens=None):
    """Decode-time conv update. x [B, dim] (one token) or [B, dim, S] (S
    speculative tokens); conv_state [lines, dim, state_len] (f32 on the Qwen
    path), updated IN PLACE; weight [dim, W] with W - 1 <= state_len; bias
    [dim]; conv_state_indices [B] picks the lines (default: line b for row
    b); rows at pad_slot_id read the clamped line and write nothing.

    Each token: y = the W-tap sum over [the last W - 1 state values | x]
    (+ bias), "silu" applies y * sigmoid(y); then the state shifts left by
    one and takes x. Returns (out like x in x's dtype, conv_state), and with
    intermediate_conv_window also the window after every token ([B, S, dim,
    state_len] in that buffer's dtype, a new tensor, as the JAX package
    returns it). num_accepted_tokens and cache_seqlens are taken for the
    reference's signature and not read, as in the JAX package."""
    squeeze = x.dim() == 2
    x3 = x[..., None] if squeeze else x
    b, _, s = x3.shape
    lines, _, state_len = conv_state.shape
    w = weight.shape[1]
    idx = (conv_state_indices.long() if conv_state_indices is not None
           else torch.arange(b, device=x.device))
    valid = idx != pad_slot_id
    idx_safe = idx.clamp(0, lines - 1)
    state = conv_state[idx_safe].float()                         # [B, dim, state_len]
    x32 = x3.float()
    w32 = weight.float()
    outs, inters = [], []
    for step in range(s):
        window = torch.cat([state[..., state_len - (w - 1):], x32[..., step:step + 1]], -1)
        y = torch.zeros_like(x32[..., 0])
        for i in range(w):
            y = y + window[..., i] * w32[None, :, i]
        if bias is not None:
            y = y + bias.float()[None]
        outs.append(_act(y, activation))
        state = torch.cat([state[..., 1:], x32[..., step:step + 1]], -1)
        inters.append(state)
    index_copy_kept_(conv_state, idx_safe, state, valid)
    out = torch.stack(outs, -1).to(x.dtype)
    results = (out[..., 0] if squeeze else out, conv_state)
    if intermediate_conv_window is not None:
        results += (torch.stack(inters, 1).to(intermediate_conv_window.dtype),)
    return results


def conv_state_rollback(conv_states, state_indices, step_indices, draft_token_num: int):
    """Shift each request's window right by draft_token_num - 1 - step,
    dropping the entries of its rejected tokens (the columns that come in
    from the left keep their values), IN PLACE. conv_states [layers, pool,
    window, dims]; state_indices, step_indices [R] (a step < 0, or a shift
    of 0, leaves the request's line as it is). Returns conv_states."""
    _, pool, win, dims = conv_states.shape
    shift = (draft_token_num - 1) - step_indices.long()
    do = (step_indices >= 0) & (shift > 0)
    idx_safe = state_indices.long().clamp(0, pool - 1)
    rows = conv_states[:, idx_safe]                              # [L, R, win, dims]
    src = torch.arange(win, device=rows.device)[None, :] - shift[:, None]
    shifted = torch.gather(rows, 2, src.clamp(0, win - 1)[None, :, :, None].expand_as(rows))
    shifted = torch.where((src >= 0)[None, :, :, None], shifted, rows)
    index_copy_kept_(conv_states.transpose(0, 1), idx_safe, shifted.transpose(0, 1), do)
    return conv_states


def move_intermediate_cache(ssm_states, intermediate_state_cache, dst_indices, src_indices,
                            last_steps):
    """ssm_states[:, dst] = intermediate_state_cache[:, src, last_step], IN
    PLACE (indices clamped into range). ssm_states [layers, pool, H, V, K];
    intermediate_state_cache [layers, S, D, H, V, K]. Returns ssm_states."""
    _, s, d = intermediate_state_cache.shape[:3]
    src = src_indices.long().clamp(0, s - 1)
    stp = last_steps.long().clamp(0, d - 1)
    tgt = dst_indices.long().clamp(0, ssm_states.shape[1] - 1)
    ssm_states[:, tgt] = intermediate_state_cache[:, src, stp].to(ssm_states.dtype)
    return ssm_states
