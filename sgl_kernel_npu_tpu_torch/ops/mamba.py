"""Causal depthwise conv state update for decoding (counterpart of the JAX
package's ops/mamba.py::causal_conv1d_update, its single-token decode form).
Plain PyTorch: the JAX package leaves it to XLA. The conv state is updated
in place (the JAX package returns a new one). The speculative branch (an
[B, dim, S] x with intermediate windows) is not ported."""

from __future__ import annotations

import torch

from ..utils import index_copy_kept_

PAD_SLOT_ID = -1


def causal_conv1d_update(x, conv_state, weight, bias=None, activation=None,
                         conv_state_indices=None, pad_slot_id: int = PAD_SLOT_ID):
    """x [B, dim]; conv_state [lines, dim, state_len] (f32 on the Qwen path);
    weight [dim, width] with width - 1 <= state_len; bias [dim];
    conv_state_indices [B] picks the lines (default: line b for row b), rows
    at pad_slot_id are skipped (their line is not written).

    y = sum_w window[w] * weight[w] (+ bias), window = the last width - 1
    state values then x, summed in order in f32; "silu" applies y * sigmoid(y).
    Returns (y [B, dim] in x's dtype, conv_state)."""
    if x.dim() != 2:
        raise NotImplementedError("causal_conv1d_update: the port serves the decode form "
                                  "x [B, dim] only")
    b = x.shape[0]
    lines, _, state_len = conv_state.shape
    width = weight.shape[1]
    idx = (conv_state_indices.long() if conv_state_indices is not None
           else torch.arange(b, device=x.device))
    valid = idx != pad_slot_id
    idx_safe = idx.clamp(0, lines - 1)
    state = conv_state[idx_safe].float()                         # [B, dim, state_len]
    x32 = x.float()
    window = torch.cat([state[..., state_len - (width - 1):], x32[..., None]], -1)
    w32 = weight.float()
    y = torch.zeros_like(x32)
    for i in range(width):
        y = y + window[..., i] * w32[None, :, i]
    if bias is not None:
        y = y + bias.float()[None]
    if activation in ("silu", "swish"):
        y = y * torch.sigmoid(y)
    new_state = torch.cat([state[..., 1:], x32[..., None]], -1)
    index_copy_kept_(conv_state, idx_safe, new_state, valid)
    return y.to(x.dtype), conv_state
