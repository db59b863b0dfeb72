"""Multi-LoRA serving matmuls: the BGMV / SGMV / SGEMMV / SGEMMC families
(counterpart of the JAX package's ops/lora.py). Plain PyTorch, as the JAX
functions are plain jnp (their grouped products are `jax.lax.ragged_dot`):
no kernel.

  bgmv_{shrink,expand}    an adapter id a token (decode batches)
  sgmv_{shrink,expand}    an adapter id a sequence, with seq_len (prefill)
  sgemmv_* / sgemmc_*     the same functions under the reference's names for
                          its variable-rank and multi-slice variants

Every variant is one pattern: token i's row times its adapter's weight, in
f32, an id of -1 contributing 0. Each adapter's product is taken over all
rows and kept where the id matches (no sort, no host sync). The JAX
roundings are kept: a shrink rounds its f32 product to x's dtype; an expand
adds its f32 product rounded to y's dtype.
"""

from __future__ import annotations

import torch


def _grouped_matmul_by_index(x, weights_t, token_ids):
    """y[i] = x[i] @ weights_t[token_ids[i]] in f32, 0 where the id is -1
    (or past the bank). x [S, K]; weights_t [L, K, N]; token_ids [S]."""
    x32 = x.float()
    ids = token_ids.long()
    y = torch.zeros((x.shape[0], weights_t.shape[-1]), dtype=torch.float32, device=x.device)
    for a in range(weights_t.shape[0]):
        y = torch.where((ids == a)[:, None], x32 @ weights_t[a].float(), y)
    return y


def _expand_seq_ids(lora_indices, seq_len, total_tokens: int):
    """Adapter ids a sequence -> ids a token ([total_tokens]; tokens past the
    sequences get -1)."""
    cum = torch.cumsum(seq_len.to(torch.int32), 0)
    j = torch.arange(total_tokens, dtype=torch.int32, device=seq_len.device)
    seq = torch.searchsorted(cum, j, right=True).clamp(0, seq_len.shape[0] - 1)
    ids = lora_indices.to(torch.int32)[seq.long()]
    return torch.where(j < cum[-1], ids, -1)


def _per_token(values, ids, fill):
    """values[id] for each token, `fill` where the id is -1."""
    safe = ids.long().clamp(0, values.shape[0] - 1)
    return torch.where(ids >= 0, values[safe], torch.as_tensor(fill, dtype=values.dtype,
                                                               device=values.device))


# ------------------------------------------------------------------------ BGMV


def bgmv_shrink(x, weights, indices, scale: float = 1.0):
    """x [B, H] @ A^T a token: weights [L, R, H], indices [B] -> [B, R] *
    scale, in x's dtype."""
    y = _grouped_matmul_by_index(x, weights.transpose(1, 2), indices)
    return (y * scale).to(x.dtype)


def bgmv_expand(x, weights, indices, y, slice_offset: int, slice_size: int):
    """y[:, off:off + size] += x @ B^T a token: weights [L, O, R], x [B, >= R].
    Returns the updated copy of y."""
    _, o, r = weights.shape
    if o != slice_size:
        raise ValueError("weight output dim must equal the slice it fills")
    out = _grouped_matmul_by_index(x[:, :r], weights.transpose(1, 2), indices)
    y = y.clone()
    y[:, slice_offset:slice_offset + slice_size] += out.to(y.dtype)
    return y


# ------------------------------------------------------------------------ SGMV


def sgmv_shrink(x, weights, lora_indices, seq_len, lora_ranks, lora_scales,
                num_slices: int = 1):
    """Sequence-grouped shrink: x [S, H]; weights [L, num_slices * maxR, H];
    lora_indices, seq_len a sequence; lora_ranks, lora_scales [L]. Column c
    of a token's row holds x . weights[id, c] * scale for c < num_slices *
    rank (the slices packed by actual rank), else 0. Returns [S, out_dim]."""
    out_dim = weights.shape[1]
    ids = _expand_seq_ids(lora_indices, seq_len, x.shape[0])
    y = _grouped_matmul_by_index(x, weights.transpose(1, 2), ids)
    ranks = _per_token(lora_ranks, ids, 0)
    scales = _per_token(lora_scales, ids, 0.0)
    col = torch.arange(out_dim, device=x.device)
    mask = col[None, :] < (num_slices * ranks)[:, None]
    return (y * scales[:, None] * mask).to(x.dtype)


def sgmv_expand(x, weights, lora_indices, seq_len, lora_ranks, slice_offsets,
                base_output=None):
    """Sequence-grouped expand with a multi-slice scatter: x [S, num_slices *
    maxR] (slice si of a token at columns si * rank ..); weights [L, O, maxR];
    slice_offsets the num_slices + 1 output boundaries. Returns [S,
    slice_offsets[-1]] in base_output's dtype (x's without one)."""
    max_rank = weights.shape[2]
    slice_offsets = tuple(int(v) for v in slice_offsets)
    s = x.shape[0]
    ids = _expand_seq_ids(lora_indices, seq_len, s)
    ranks = _per_token(lora_ranks, ids, 0)
    out = (base_output.float() if base_output is not None
           else torch.zeros((s, slice_offsets[-1]), dtype=torch.float32, device=x.device))
    wt = weights.transpose(1, 2)                        # [L, maxR, O]
    rank_col = torch.arange(max_rank, device=x.device)[None, :]
    rank_mask = rank_col < ranks[:, None]
    for si in range(len(slice_offsets) - 1):
        lo, hi = slice_offsets[si], slice_offsets[si + 1]
        cols = (si * ranks[:, None] + rank_col).clamp(0, x.shape[1] - 1)
        x_slice = torch.where(rank_mask, torch.gather(x, 1, cols.long()),
                              torch.zeros((), dtype=x.dtype, device=x.device))
        out[:, lo:hi] += _grouped_matmul_by_index(x_slice, wt[:, :, lo:hi], ids)
    dtype = base_output.dtype if base_output is not None else x.dtype
    return out.to(dtype)


# -------------------------------------------------- SGEMMV / SGEMMC (aliases)
# The reference splits these by engine (vector vs cube) and rank
# variability; the functions above take variable ranks and slices already.


def sgemmv_shrink(x, weights, lora_indices, seq_len, lora_ranks, lora_scales,
                  num_slices: int = 1):
    """Variable-rank shrink (sgmv_shrink)."""
    return sgmv_shrink(x, weights, lora_indices, seq_len, lora_ranks, lora_scales,
                       num_slices)


def sgemmv_expand(x, weights, lora_indices, seq_len, lora_ranks, slice_offsets,
                  base_output=None):
    """Variable-rank expand with slice offsets (sgmv_expand)."""
    return sgmv_expand(x, weights, lora_indices, seq_len, lora_ranks, slice_offsets,
                       base_output)


def sgemmc_shrink(x, weights, lora_indices, seq_len, lora_ranks, lora_scales,
                  slice_count: int = 1):
    """Multi-slice shrink (sgmv_shrink)."""
    return sgmv_shrink(x, weights, lora_indices, seq_len, lora_ranks, lora_scales,
                       slice_count)


def sgemmc_expand(x, weights, lora_indices, seq_len, lora_ranks, slice_offsets,
                  base_output=None):
    """Multi-slice expand (sgmv_expand)."""
    return sgmv_expand(x, weights, lora_indices, seq_len, lora_ranks, slice_offsets,
                       base_output)
