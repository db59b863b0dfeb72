"""Small MoE helper ops (counterpart of the JAX package's ops/moe_helpers.py):
`mul_add` and `zero_experts_compute_identity`, single elementwise passes
with no kernel of their own."""

from __future__ import annotations

import torch


def mul_add(routed_input, shared_input, scaling_factor):
    """out = routed * factor + shared, in f32, cast to the routed dtype."""
    return (routed_input.float() * scaling_factor
            + shared_input.float()).to(routed_input.dtype)


def zero_experts_compute_identity(expert_indices, expert_scales, num_experts,
                                  zero_expert_type, hidden_states,
                                  identity_mask_value=0):
    """'Zero experts' (ids >= num_experts) pass the hidden states through,
    weighted by the sum of their scales; their slots are then neutralised.

    Returns (zero_result, new_expert_indices, new_expert_scales): new
    tensors, as in the JAX package."""
    assert zero_expert_type == "identity"
    is_zero = expert_indices >= num_experts
    sum_scales = torch.where(is_zero, expert_scales, 0.0).sum(dim=1, keepdim=True)
    zero_result = (hidden_states.float() * sum_scales).to(hidden_states.dtype)
    new_scales = torch.where(is_zero, 0.0, expert_scales)
    new_indices = torch.where(is_zero, identity_mask_value, expert_indices)
    return zero_result, new_indices, new_scales
