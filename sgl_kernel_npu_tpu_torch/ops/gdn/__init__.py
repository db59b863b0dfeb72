"""Gated delta net ops (counterpart of the JAX package's ops/gdn/): the
chunked prefill and its per-chunk cumsum, l2norm, the gating, the gated
RMSNorm, the QKVZ/BA split, the recurrent rule over token sequences (MTP),
the triangular inverse, and the recurrent decode step (kernel K9 on the
card)."""

from .chunk import (  # noqa: F401
    chunk_gated_delta_rule,
    chunk_gated_delta_rule_varlen,
    chunk_local_cumsum,
    l2norm,
)
from .gating import (  # noqa: F401
    fused_gdn_gating,
    fused_gdn_gating_without_sigmoid,
    fused_qkvzba_split_reshape_cat,
    fused_sigmoid_gating_delta_rule_update,
    layernorm_gated,
)
from .recurrent import recurrent_gated_delta_rule  # noqa: F401
from .recurrent_pallas import delta_rule_step, delta_rule_step_ref  # noqa: F401
from .tri_inv import inv_unit_lower, solve_tril, tri_inv_col_sweep  # noqa: F401

# The JAX package's name for its kernel's twin: the port's update launches K9
# on the card itself
fused_sigmoid_gating_delta_rule_update_pallas = fused_sigmoid_gating_delta_rule_update
