"""Reference-name compatibility table (counterpart of the JAX package's
compat.py, with exactly its five namespaces and keys).

Maps every public op name of sgl-kernel-npu (the `torch.ops.npu.*` and
`torch.ops.attentions.*` registrations, and the Python package surfaces) to
the port's implementation:

  * migration: `from sgl_kernel_npu_tpu_torch.compat import npu;
    npu.mla_preprocess(...)`
  * parity audit: tests assert that every reference name resolves to a
    callable.

Where the port names a function differently, the reference's name maps to
the port's: decode_gqa_high_performance to decode_v3.decode_gqa_v3 (K16).

attentions.sparse_block_estimate differs in meaning, not in name: the JAX
table maps it to its plain estimator, which takes any head dim, while here
it maps to sparse.sparse_block_estimate_fused, because the reference op is a
kernel. That is K18 on the card, at any length, any head dim and bf16, fp16
or f32 rows, with the plain estimator's contract (block sums over bs^2
instead of block means: the same scores up to f32 rounding). On the CPU it
runs K18's plain version.

attentions.la takes on the card the widths of its two K17 routes
(prefill.laser_route): the bf16 / fp16 kernel at any D and Dv that are
multiples of 8 up to 256 (padded to a tile of prefill.TENSOR_CORE_WIDTHS
where they are not one), the split-TF32 kernel at any D and Dv up to 256 in
f32, and in bf16 and fp16 at the other widths.

A name whose kernel refuses a width on the card raises that kernel's error
there; none falls back to a plain version on a CUDA tensor.
"""

from __future__ import annotations

from types import SimpleNamespace

from . import memsaver, parallel
from .ops import activation, grammar, helloworld, kvcache, lora, mamba
from .ops import matmul, mla_preprocess, moe_helpers, norm, qkv_fusion
from .ops import rope, speculative
from .ops import gdn as _gdn
from .ops.attention import decode, decode_v3, lightning_indexer, prefill, sinks, sparse

# torch.ops.npu.*
npu = SimpleNamespace(
    helloworld=helloworld.helloworld,
    cache_loc_assign=kvcache.cache_loc_assign,
    cache_loc_update=kvcache.cache_loc_update,
    assign_cache_op=kvcache.assign_cache_op,
    alloc_extend=kvcache.alloc_extend,
    build_tree_efficient=speculative.build_tree_efficient,
    mla_preprocess=mla_preprocess.mla_preprocess,
    bgmv_expand=lora.bgmv_expand,
    bgmv_shrink=lora.bgmv_shrink,
    sgmv_expand=lora.sgmv_expand,
    sgmv_shrink=lora.sgmv_shrink,
    sgemmv_expand=lora.sgemmv_expand,
    sgemmv_shrink=lora.sgemmv_shrink,
    sgemmc_expand=lora.sgemmc_expand,
    sgemmc_shrink=lora.sgemmc_shrink,
    recurrent_gated_delta_rule=_gdn.recurrent_gated_delta_rule,
    causal_conv1d=mamba.causal_conv1d_fn,
    causal_conv1d_update=mamba.causal_conv1d_update,
    transfer_kv_dim_exchange=kvcache.transfer_kv_to_host,
    apply_token_bitmask=grammar.apply_token_bitmask,
    batch_matmul_transpose=matmul.batch_matmul_transpose,
    tri_inv_col_sweep=_gdn.tri_inv_col_sweep,
    mega_chunk_gdn=_gdn.chunk_gated_delta_rule,
    lightning_indexer=lightning_indexer.lightning_indexer,
    catlass_matmul_basic=matmul.batch_matmul_transpose,
    softfp8_w8a16_matmul=matmul.mm_wfp8a16,
    softfp8_w8a16_grouped_matmul=matmul.gmm_wfp8a16,
)

# torch.ops.attentions.*
attentions = SimpleNamespace(
    la=prefill.laser_attention,
    rainfusionattention=sparse.topk_sparse_attention,
    block_sparse_attention=sparse.block_sparse_attention,
    sparse_block_estimate=sparse.sparse_block_estimate_fused,
    layernorm=norm.rmsnorm_bias,
)

# the python/sgl_kernel_npu package surface
sgl_kernel = SimpleNamespace(
    decode_mla=decode.decode_mla,
    decode_gqa=decode.decode_gqa,
    decode_gqa_high_performance=decode_v3.decode_gqa_v3,
    attention_sinks=sinks.decode_attention_with_sinks,
    attention_sinks_prefill=sinks.prefill_attention_with_sinks,
    chunk_gated_delta_rule=_gdn.chunk_gated_delta_rule,
    chunk_gated_delta_rule_npu=_gdn.chunk_gated_delta_rule_varlen,
    solve_tril=_gdn.solve_tril,
    l2norm_fwd=_gdn.l2norm,
    layer_norm_fwd=_gdn.layernorm_gated,
    fused_gdn_gating=_gdn.fused_gdn_gating,
    fused_gdn_gating_without_sigmoid=_gdn.fused_gdn_gating_without_sigmoid,
    fused_sigmoid_gating_delta_rule_update=_gdn.fused_sigmoid_gating_delta_rule_update,
    fused_qkvzba_split_reshape_cat=_gdn.fused_qkvzba_split_reshape_cat,
    chunk_local_cumsum=_gdn.chunk_local_cumsum,
    causal_conv1d_fn=mamba.causal_conv1d_fn,
    causal_conv1d_update=mamba.causal_conv1d_update,
    conv_state_rollback=mamba.conv_state_rollback,
    move_intermediate_cache=mamba.move_intermediate_cache,
    add_rmsnorm_bias=norm.add_rmsnorm_bias,
    add_gemma_rms_norm=norm.add_gemma_rms_norm,
    rmsnorm_bias=norm.rmsnorm_bias,
    fused_variance=norm.fused_variance,
    fused_rsqrt_mul=norm.fused_rsqrt_mul,
    fused_rmsnorm_without_weight=norm.rmsnorm_without_weight,
    l1_norm=norm.l1_norm,
    fused_scale_shift=norm.fused_scale_shift,
    fused_split_qk_norm=qkv_fusion.fused_split_qk_norm,
    fused_rope_qk_mqa=rope.fused_rope_qk_mqa,
    split_qkv_rmsnorm_rope=qkv_fusion.split_qkv_rmsnorm_rope,
    split_qkv_rmsnorm_rope_pos_cache_half_npu=qkv_fusion.split_qkv_rmsnorm_rope_pos_cache,
    split_qkv_tp_rmsnorm_rope=qkv_fusion.split_qkv_tp_rmsnorm_rope,
    split_qkvgate_gemma_rmsnorm_rope=qkv_fusion.split_qkvgate_gemma_rmsnorm_rope,
    swiglu_quant=activation.swiglu_quant,
    swiglu_oai=activation.swiglu_oai,
    mul_add=moe_helpers.mul_add,
    zero_experts_compute_identity=moe_helpers.zero_experts_compute_identity,
    verify_tree_greedy=speculative.verify_tree_greedy,
    build_tree_efficient_native=speculative.build_tree_efficient,
    verify_tree_greedy_native=speculative.verify_tree_greedy,
)

# the python/deep_ep package surface
deep_ep = SimpleNamespace(
    Buffer=parallel.Buffer,
    Config=parallel.Config,
    EventOverlap=parallel.EventOverlap,
    FuseMode=parallel.FuseMode,
    get_dispatch_layout=parallel.get_dispatch_layout,
    normal_strategies=parallel.normal_strategy_names,
    low_latency_strategies=parallel.low_latency_strategy_names,
)

# contrib: torch_memory_saver
torch_memory_saver = SimpleNamespace(
    MemorySaver=memsaver.MemorySaver,
    get_memory_saver=memsaver.get_memory_saver,
)
