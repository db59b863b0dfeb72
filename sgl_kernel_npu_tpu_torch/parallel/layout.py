"""Dispatch layout (counterpart of the JAX package's parallel/layout.py):
per-token routing metadata from topk_idx [T, K] (global expert ids, -1 =
dropped slot); expert e lives on rank e // (num_experts // num_ranks). No
host sync."""

from __future__ import annotations

import torch


def _expert_one_hot(topk_idx, num_experts: int):
    valid = topk_idx >= 0
    safe = torch.where(valid, topk_idx, 0).long()
    hot = torch.zeros((*topk_idx.shape, num_experts), dtype=torch.int32,
                      device=topk_idx.device)
    hot.scatter_(-1, safe[..., None], 1)
    return hot * valid[..., None], safe, valid


def get_dispatch_layout(topk_idx, num_experts: int, num_ranks: int):
    """Returns (num_tokens_per_rank [R], num_tokens_per_expert [E],
    is_token_in_rank [T, R] bool). A token counts once per rank even when
    several of its experts live there."""
    assert num_experts % num_ranks == 0
    per_rank = num_experts // num_ranks
    hot, safe, valid = _expert_one_hot(topk_idx, num_experts)
    num_tokens_per_expert = hot.sum(dim=(0, 1), dtype=torch.int32)
    in_rank = torch.zeros((*topk_idx.shape, num_ranks), dtype=torch.int32,
                          device=topk_idx.device)
    in_rank.scatter_(-1, (safe // per_rank)[..., None], 1)
    is_token_in_rank = (in_rank * valid[..., None]).amax(dim=1) > 0      # [T, R]
    num_tokens_per_rank = is_token_in_rank.sum(dim=0, dtype=torch.int32)
    return num_tokens_per_rank, num_tokens_per_expert, is_token_in_rank


def tokens_per_local_expert(topk_idx, num_experts: int, num_ranks: int):
    """Per (dest_rank, local_expert) token counts [R, E/R] of one rank's
    topk_idx."""
    hot, _, _ = _expert_one_hot(topk_idx, num_experts)
    return hot.sum(dim=(0, 1), dtype=torch.int32).reshape(num_ranks, -1)
