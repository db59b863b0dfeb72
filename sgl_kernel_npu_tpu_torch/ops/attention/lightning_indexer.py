"""Lightning indexer: DeepSeek-V3.2-style sparse top-k token selection
(counterpart of the JAX package's ops/attention/lightning_indexer.py; plain
PyTorch there too: no kernel behind it).

Per query token, over the keys it may see,
  score_j = sum_g w_g * ReLU(q_g . k_j)        (g over the indexer's heads)
and the top `sparse_count` positions are returned, -1 where fewer keys are
valid. Layouts: batched (BSND), paged (PA_BSND, with a block table) and
varlen (TND, prefix sums). Scores are f32; ties are ordered as torch.topk
orders them, which may differ from jax.lax.top_k's (lower index first).
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def lightning_indexer_scores(q, k, weights):
    """q [B, Sq, G, D]; k [B, Sk, D] (one index head); weights [B, Sq, G].
    Returns scores [B, Sq, Sk] f32."""
    s = torch.relu(torch.einsum("bqgd,bkd->bqgk", q.float(), k.float()))
    return torch.einsum("bqgk,bqg->bqk", s, weights.float())


def _top(scores, sparse_count: int):
    """(top scores, top positions) of the last axis, at most its length."""
    return torch.topk(scores, min(sparse_count, scores.shape[-1]), dim=-1)


def lightning_indexer(q, k, weights, sparse_count: int = 2048, actual_seq_lengths_key=None,
                      causal: bool = True, query_positions=None):
    """Batched (BSND) selection. q [B, Sq, G, D]; k [B, Sk, D]; weights
    [B, Sq, G]; actual_seq_lengths_key [B] (None: all Sk keys);
    query_positions [B, Sq] (None: 0..Sq-1), the causal frontier. Returns
    (topk_idx [B, Sq, min(sparse_count, Sk)] int32, -1 padded; the masked
    scores [B, Sq, Sk])."""
    b, sq = q.shape[:2]
    sk = k.shape[1]
    scores = lightning_indexer_scores(q, k, weights)
    pos_k = torch.arange(sk, device=q.device)[None, None, :]
    valid = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if actual_seq_lengths_key is not None:
        valid = valid & (pos_k < actual_seq_lengths_key.long()[:, None, None])
    if causal:
        qpos = (query_positions.long() if query_positions is not None
                else torch.arange(sq, device=q.device)[None].expand(b, sq))
        valid = valid & (pos_k <= qpos[:, :, None])
    scores = torch.where(valid, scores, _NEG_INF)
    top_scores, top_idx = _top(scores, sparse_count)
    return torch.where(top_scores > _NEG_INF / 2, top_idx, -1).to(torch.int32), scores


def lightning_indexer_paged(q, k_cache, weights, block_table, seq_lens,
                            sparse_count: int = 2048):
    """Paged decode form (PA_BSND). q [B, G, D]; k_cache [P, ps, D];
    weights [B, G]; block_table [B, max_pages]; seq_lens [B]. Returns
    topk_idx [B, min(sparse_count, max_pages * ps)] int32 of token SLOT ids
    (page * ps + offset, -1 padded), as topk_sparse_attention takes them."""
    b, _, d = q.shape
    ps = k_cache.shape[1]
    mp = block_table.shape[1]
    bt = block_table.long()
    k = k_cache[bt].reshape(b, mp * ps, d).float()
    s = torch.relu(torch.einsum("bgd,bkd->bgk", q.float(), k))
    scores = torch.einsum("bgk,bg->bk", s, weights.float())
    valid = torch.arange(mp * ps, device=q.device)[None] < seq_lens.long()[:, None]
    scores = torch.where(valid, scores, _NEG_INF)
    top_scores, top_pos = _top(scores, sparse_count)
    page_of = torch.gather(bt, 1, torch.div(top_pos, ps, rounding_mode="floor").clamp(0, mp - 1))
    slot = page_of * ps + top_pos % ps
    return torch.where(top_scores > _NEG_INF / 2, slot, -1).to(torch.int32)


def lightning_indexer_varlen(q, k, weights, actual_seq_lengths_query, actual_seq_lengths_key,
                             sparse_count: int = 2048, causal: bool = True):
    """Varlen (TND) form. q [T, G, D] and weights [T, G] over all sequences,
    k [Tk, D]; actual_seq_lengths_{query,key} [num_seqs] are PREFIX SUMS
    (element i the tokens of sequences 0..i), so sequence i spans
    [cu[i-1], cu[i]). The causal frontier is aligned at the sequence END:
    query j of a sequence of Sq queries and Sk keys sees local keys
    <= j + Sk - Sq. Returns (topk_idx [T, min(sparse_count, Tk)] int32 of
    LOCAL key positions in the token's own sequence, -1 padded; the masked
    scores [T, Tk])."""
    t, tk = q.shape[0], k.shape[0]
    dev = q.device
    cu_q = torch.as_tensor(actual_seq_lengths_query, device=dev).long()
    cu_k = torch.as_tensor(actual_seq_lengths_key, device=dev).long()
    last = cu_q.shape[0] - 1

    def bounds(cu, n):
        seg = torch.searchsorted(cu, torch.arange(n, device=dev), right=True)
        start = torch.cat([cu.new_zeros(1), cu[:-1]])
        # a token past the last boundary reads the last sequence's start, as
        # the JAX gather clamps its index
        return seg, start, torch.arange(n, device=dev) - start[seg.clamp_max(last)]

    seg_q, start_q, local_q = bounds(cu_q, t)
    seg_k, start_k, local_k = bounds(cu_k, tk)
    s = torch.relu(torch.einsum("tgd,kd->tgk", q.float(), k.float()))
    scores = torch.einsum("tgk,tg->tk", s, weights.float())
    valid = seg_q[:, None] == seg_k[None, :]
    if causal:
        frontier = local_q + ((cu_k - start_k) - (cu_q - start_q))[seg_q.clamp_max(last)]
        valid = valid & (local_k[None, :] <= frontier[:, None])
    scores = torch.where(valid, scores, _NEG_INF)
    top_scores, top_idx = _top(scores, sparse_count)
    top_local = local_k[top_idx]
    return torch.where(top_scores > _NEG_INF / 2, top_local, -1).to(torch.int32), scores
