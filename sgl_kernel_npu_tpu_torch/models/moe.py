"""The GQA MoE decoder with expert parallelism (counterpart of the JAX
package's models/moe.py).

Per layer: RMSNorm -> wqkv (f32 product) -> RoPE -> the head-major f32
cache scatter (in place) -> paged GQA decode (ops/attention/decode.py::
decode_gqa: at head dims that are multiples of 128, kernel K10 on f32 pages
on the card, its plain version decode_gqa_hm_ref on the CPU; other head
dims decode_gqa_ref) -> wo; RMSNorm -> the softmax router -> the routed
experts through fused_deep_moe_shard (kernel K8 twice on the card) + the
shared expert, merged with mul_add (deepseek_v3.moe_ffn). The f32 products
stay torch.matmul, as they are plain jnp in the JAX package.

As models/deepseek_v3.py: one rank's step, its requests' caches ([L, Hkv,
P, ps, D] f32, pages local to the rank) and its expert shard
(deepseek_v3.expert_shard, which cuts both models' experts); the JAX
package's shard_map over "ep" becomes the EPGroup.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..ops.attention.decode import decode_gqa
from ..ops.kvcache import reshape_and_cache_gqa
from ..ops.rope import apply_rope, make_cos_sin_cache
from ..parallel.comm import EPGroup
from ..parallel.strategy import get_low_latency_strategy
from ..utils import resolve_device
from .deepseek_v3 import Draws, _layer, moe_ffn


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 1024
    hidden_size: int = 256
    num_layers: int = 2
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 32
    num_experts: int = 16
    top_k: int = 4
    moe_intermediate: int = 128
    shared_intermediate: int = 128
    routed_scaling_factor: float = 1.0
    page_size: int = 16
    rms_eps: float = 1e-6
    max_position: int = 1024


def init_params(cfg: MoEConfig, seed: int = 0, device="cuda",
                draws: str = "numpy") -> Dict[str, Any]:
    """The JAX package's init_params (its shapes, scales and draw order),
    from `draws` (deepseek_v3.Draws: "numpy" is bit-identical to the JAX
    package)."""
    dev = resolve_device(device)
    d = Draws(seed, dev, draws)
    l, h, e, f = cfg.num_layers, cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    embed = d.normal(cfg.vocab_size, h, s=0.02)
    lm_head = d.normal(h, cfg.vocab_size, s=0.02)
    layers = {"in_norm": ones(l, h),
              "wqkv": d.normal(l, h, (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim),
              "wo": d.normal(l, cfg.num_heads * cfg.head_dim, h),
              "post_norm": ones(l, h),
              "router": d.normal(l, h, e, s=0.5)}
    layers["w13"] = {"q": d.int8(l, e, h, 2 * f),
                     "scale": torch.full((l, e, 2 * f), 0.05 / 127.0, device=dev)}
    layers["w2"] = {"q": d.int8(l, e, f, h),
                    "scale": torch.full((l, e, h), 0.05 / 127.0, device=dev)}
    layers["shared_w13"] = d.normal(l, h, 2 * cfg.shared_intermediate)
    layers["shared_w2"] = d.normal(l, cfg.shared_intermediate, h)
    return {"embed": embed, "final_norm": ones(h), "lm_head": lm_head,
            "cos_sin": make_cos_sin_cache(cfg.max_position, cfg.head_dim, device=dev),
            "layers": layers}


def init_kv_cache(cfg: MoEConfig, num_pages: int, device="cuda"):
    """Zeroed f32 head-major caches (k, v), each [L, Hkv, P, ps, D]."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, cfg.page_size, cfg.head_dim)
    return (torch.zeros(shape, dtype=torch.float32, device=dev),
            torch.zeros(shape, dtype=torch.float32, device=dev))


def _rms(x, w, eps):
    x32 = x.float()
    return x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps) * w


def decode_step_shard(params, cfg: MoEConfig, k_cache, v_cache, input_ids, positions,
                      seq_lens, block_table, slot_mapping, *, group, strategy,
                      max_tokens: int):
    """One rank's decode step (as deepseek_v3.decode_step_shard). Returns
    (logits [B, V] f32, k_cache, v_cache), the caches written in place."""
    b = input_ids.shape[0]
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = params["embed"][input_ids.long()]
    cs = params["cos_sin"][positions.long()]
    cos, sin = cs[:, None, : d // 2], cs[:, None, d // 2:]
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        qkv = _rms(x, lp["in_norm"], cfg.rms_eps) @ lp["wqkv"]
        q = apply_rope(qkv[:, : nq * d].reshape(b, nq, d), cos, sin)
        k = apply_rope(qkv[:, nq * d:(nq + nkv) * d].reshape(b, nkv, d), cos, sin)
        v = qkv[:, (nq + nkv) * d:].reshape(b, nkv, d)
        kc, vc = reshape_and_cache_gqa(k, v, k_cache[li], v_cache[li], slot_mapping)
        att = decode_gqa(q, kc, vc, seq_lens, block_table, 1.0 / d ** 0.5, cfg.page_size)
        x = x + att.reshape(b, -1) @ lp["wo"]
        h2 = _rms(x, lp["post_norm"], cfg.rms_eps)
        x = x + moe_ffn(h2, lp, cfg, group=group, strategy=strategy, max_tokens=max_tokens)
    x = _rms(x, params["final_norm"], cfg.rms_eps)
    return x @ params["lm_head"], k_cache, v_cache


def make_decode_step(group, cfg: MoEConfig, max_tokens: int,
                     low_latency_strategy: str = "default"):
    """This rank's decode step over `group` (as deepseek_v3.make_decode_step)."""
    group = group if isinstance(group, EPGroup) else EPGroup(group)
    strategy = get_low_latency_strategy(low_latency_strategy)

    def step(params, kc, vc, ids, pos, seq, bt, slots):
        return decode_step_shard(params, cfg, kc, vc, ids, pos, seq, bt, slots, group=group,
                                 strategy=strategy, max_tokens=max_tokens)
    return step
