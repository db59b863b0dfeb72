"""Gated delta net ops (counterpart of the JAX package's ops/gdn/), limited
to the Qwen3-Next decode step: the gating, the gated RMSNorm, the QKVZ/BA
split, l2norm, and the recurrent decode step (kernel K9 on the card)."""

from .chunk import l2norm  # noqa: F401
from .gating import (  # noqa: F401
    fused_gdn_gating,
    fused_qkvzba_split_reshape_cat,
    fused_sigmoid_gating_delta_rule_update,
    layernorm_gated,
)
from .recurrent_pallas import delta_rule_step, delta_rule_step_ref  # noqa: F401
