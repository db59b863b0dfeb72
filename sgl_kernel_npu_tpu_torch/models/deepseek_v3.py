"""DeepSeek-V3-class decoder: MLA attention + the EP-routed MoE FFN
(counterpart of the JAX package's models/deepseek_v3.py).

Per layer:
  mla_preprocess (unfused, cache_mode "krope_ctkv") -> the plain paged MLA
  decode (decode_mla_ref) -> W_UV, then wo through _qmm (kernel A at L = 1
  on the card)
  softmax router, top-k, renormalised -> fused_deep_moe_shard over the EP
  group (int8 low-latency dispatch, kernel K8 twice on the card, combine)
  + the shared expert's FFN (f32 products) merged with mul_add.
The JAX package runs the step inside one shard_map over "ep"; here it is one
rank's step (`decode_step_shard`, or `make_decode_step(group, ...)`): each
rank holds its own requests' latent caches and block tables (pages local to
the rank) and its shard of the experts (`expert_shard`), and replicates the
other weights. As in the JAX package the router scores with a softmax, not
DeepSeek-V3's grouped sigmoid.

Caches are f32 [L, P, ps, kv_lora] and [L, P, ps, rope] and are written in
place (the JAX package returns new stacked caches).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..ops import mla_preprocess as mp
from ..ops.attention.decode import decode_mla_ref
from ..ops.moe_helpers import mul_add
from ..parallel.comm import EPGroup
from ..parallel.fused_moe import fused_deep_moe_shard
from ..parallel.strategy import get_low_latency_strategy
from ..utils import resolve_device
from .deepseek_mla import _qmm, _rms


@dataclass(frozen=True)
class DeepSeekV3Config:
    vocab_size: int = 1024
    hidden_size: int = 256
    num_layers: int = 2
    num_heads: int = 4
    kv_lora_rank: int = 64
    qk_rope_dim: int = 16
    qk_nope_dim: int = 32
    v_head_dim: int = 32
    q_lora_rank: int = 96
    num_experts: int = 16
    top_k: int = 4
    moe_intermediate: int = 64
    shared_intermediate: int = 64
    routed_scaling_factor: float = 1.0
    rms_eps: float = 1e-6
    page_size: int = 16
    max_position: int = 1024

    @property
    def mm1_out(self):
        return self.kv_lora_rank + self.qk_rope_dim + self.q_lora_rank


class Draws:
    """The seeded draws of an init_params: "numpy" draws what the JAX
    package's init_params draws (np.random.default_rng(seed): float64
    normals times the scale, cast to f32; int8 integers in [-127, 127]), in
    the order they are asked for, so the weights are bit-identical;
    "torch" draws the same shapes and scales from a torch.Generator on the
    device (other numbers, made on the card in seconds where numpy takes
    minutes at full width)."""

    def __init__(self, seed: int, device, source: str = "numpy"):
        if source not in ("numpy", "torch"):
            raise ValueError(f"draw source {source!r}: numpy or torch")
        self.dev = device
        self.source = source
        if source == "numpy":
            self.rng = np.random.default_rng(int(seed))
        else:
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(int(seed))

    def normal(self, *shape, s=0.05):
        if self.source == "numpy":
            a = (self.rng.standard_normal(shape) * s).astype(np.float32)
            return torch.from_numpy(a).to(self.dev)
        return torch.randn(shape, generator=self.gen, device=self.dev) * s

    def int8(self, *shape):
        if self.source == "numpy":
            return torch.from_numpy(self.rng.integers(-127, 128, shape, dtype=np.int8)).to(
                self.dev)
        return torch.randint(-127, 128, shape, generator=self.gen, device=self.dev,
                             dtype=torch.int8)


def init_params(cfg: DeepSeekV3Config, seed: int = 0, device="cuda",
                draws: str = "numpy") -> Dict[str, Any]:
    """The JAX package's init_params (its shapes, scales and draw order),
    from `draws` (Draws: "numpy" is bit-identical to the JAX package)."""
    dev = resolve_device(device)
    d = Draws(seed, dev, draws)
    l, h, heads = cfg.num_layers, cfg.hidden_size, cfg.num_heads
    qdim = cfg.qk_nope_dim + cfg.qk_rope_dim
    e, f = cfg.num_experts, cfg.moe_intermediate

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def wq(out, inp):
        return {"q": d.int8(l, out, inp), "descale": full((l, out), 0.02 / 127.0),
                "bias": full((l, out), 0, torch.int32)}

    embed = d.normal(cfg.vocab_size, h, s=0.02)
    lm_head = d.normal(h, cfg.vocab_size, s=0.02)
    inv = 1.0 / np.arange(1, cfg.qk_rope_dim // 2 + 1, dtype=np.float64)
    t = np.arange(cfg.max_position, dtype=np.float64)[:, None] * inv[None] * 0.01
    layers = {"wdqkv": wq(cfg.mm1_out, h), "wuq": wq(heads * qdim, cfg.q_lora_rank)}
    layers["wuk"] = d.normal(l, heads, cfg.qk_nope_dim, cfg.kv_lora_rank)
    layers["wuv"] = d.normal(l, heads, cfg.kv_lora_rank, cfg.v_head_dim)
    layers["wo"] = {"q": d.int8(l, heads * cfg.v_head_dim, h),
                    "scale": full((l, h), 0.02 / 127.0)}
    layers.update({
        "gamma0": full((l, h), 1.0), "beta0": full((l, h), 0.0),
        "gamma1": full((l, cfg.q_lora_rank), 1.0), "beta1": full((l, cfg.q_lora_rank), 0.0),
        "gamma2": full((l, cfg.kv_lora_rank), 1.0), "post_norm": full((l, h), 1.0),
        "qscale0": full((l, 1), 0.05), "qoffset0": full((l, 1), 0.0),
        "qscale1": full((l, 1), 0.05), "qoffset1": full((l, 1), 0.0),
    })
    layers["router"] = d.normal(l, h, e, s=0.5)
    layers["w13"] = {"q": d.int8(l, e, h, 2 * f), "scale": full((l, e, 2 * f), 0.05 / 127.0)}
    layers["w2"] = {"q": d.int8(l, e, f, h), "scale": full((l, e, h), 0.05 / 127.0)}
    layers["shared_w13"] = d.normal(l, h, 2 * cfg.shared_intermediate)
    layers["shared_w2"] = d.normal(l, cfg.shared_intermediate, h)
    return {
        "embed": embed,
        "final_norm": full((h,), 1.0),
        "lm_head": lm_head,
        "cos": torch.from_numpy(np.cos(np.concatenate([t, t], -1)).astype(np.float32)).to(dev),
        "sin": torch.from_numpy(np.sin(np.concatenate([t, t], -1)).astype(np.float32)).to(dev),
        "layers": layers,
    }


def init_kv_cache(cfg: DeepSeekV3Config, num_pages: int, device="cuda"):
    """Zeroed f32 latent caches (ckv [L, P, ps, kv_lora], krope [L, P, ps,
    rope])."""
    dev = resolve_device(device)
    ckv = torch.zeros((cfg.num_layers, num_pages, cfg.page_size, cfg.kv_lora_rank),
                      dtype=torch.float32, device=dev)
    krope = torch.zeros((cfg.num_layers, num_pages, cfg.page_size, cfg.qk_rope_dim),
                        dtype=torch.float32, device=dev)
    return ckv, krope


EXPERT_LEAVES = ("w13", "w2")


def expert_shard(params, rank: int, num_ranks: int):
    """This rank's params: the experts [L, E, ...] of w13 and w2 (q and
    scale) cut to [L, E/R, ...] (the JAX package's P(None, "ep") specs), the
    other leaves shared. A new top-level dict; the tensors are views."""
    lay = dict(params["layers"])
    for name in EXPERT_LEAVES:
        e = lay[name]["q"].shape[1]
        el = e // num_ranks
        lay[name] = {k: v[:, rank * el:(rank + 1) * el] for k, v in lay[name].items()}
    out = dict(params)
    out["layers"] = lay
    return out


def _layer(tree, li: int):
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return tree[li]


def route(h2, router, top_k: int):
    """Softmax router: (renormalised top-k weights [B, K] f32, ids [B, K]
    int32)."""
    w, i = torch.topk(torch.softmax(h2 @ router, -1), top_k)
    return w / w.sum(-1, keepdim=True), i.to(torch.int32)


def shared_ffn(h2, w13, w2):
    """The shared expert: SiLU-gated FFN in f32 products."""
    fs = w2.shape[0]
    ug = h2 @ w13
    return (ug[:, :fs] * torch.sigmoid(ug[:, :fs]) * ug[:, fs:]) @ w2


def moe_ffn(h2, lp, cfg, *, group, strategy, max_tokens):
    """The routed experts through fused_deep_moe_shard plus the shared
    expert, merged by mul_add: the FFN half of a layer of both EP models."""
    topk_w, topk_i = route(h2, lp["router"], cfg.top_k)
    routed = fused_deep_moe_shard(
        h2.to(torch.bfloat16), topk_i, topk_w * cfg.routed_scaling_factor,
        lp["w13"]["q"], lp["w13"]["scale"], lp["w2"]["q"], lp["w2"]["scale"],
        strategy=strategy, group=group, num_experts=cfg.num_experts,
        num_max_dispatch_tokens_per_rank=max_tokens).float()
    return mul_add(routed, shared_ffn(h2, lp["shared_w13"], lp["shared_w2"]), 1.0)


def decode_step_shard(params, cfg: DeepSeekV3Config, ckv_cache, krope_cache, input_ids,
                      positions, seq_lens, block_table, slot_mapping, *, group, strategy,
                      max_tokens: int):
    """One rank's decode step: input_ids / positions / slot_mapping [B];
    seq_lens [B] including the new token; block_table [B, MP] of this
    rank's pages. Returns (logits [B, V] f32, ckv_cache, krope_cache), the
    caches written in place."""
    b = input_ids.shape[0]
    sm_scale = 1.0 / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    ids, pos = input_ids.long(), positions.long()
    x = params["embed"][ids]
    cos, sin = params["cos"][pos], params["sin"][pos]
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        out = mp.mla_preprocess(
            x, lp["gamma0"], lp["beta0"], lp["wdqkv"]["q"], lp["wdqkv"]["descale"],
            lp["gamma1"], lp["beta1"], lp["wuq"]["q"], lp["wuq"]["descale"], lp["gamma2"],
            cos, sin, lp["wuk"], ckv_cache[li], krope_cache[li], slot_mapping,
            lp["qscale0"], lp["qoffset0"], lp["wdqkv"]["bias"],
            lp["qscale1"], lp["qoffset1"], lp["wuq"]["bias"], cache_mode="krope_ctkv")
        q = torch.cat([out.q_nope.float(), out.q_pe.float()], -1)
        att = decode_mla_ref(q, out.kv_cache, out.krope_cache, seq_lens, block_table,
                             sm_scale, cfg.page_size)
        att = torch.einsum("bhk,hkd->bhd", att.float(), lp["wuv"])
        x = x + _qmm(att.reshape(b, -1), lp["wo"])
        h2 = _rms(x, lp["post_norm"], cfg.rms_eps)
        x = x + moe_ffn(h2, lp, cfg, group=group, strategy=strategy, max_tokens=max_tokens)
    x = _rms(x, params["final_norm"], cfg.rms_eps)
    return x @ params["lm_head"], ckv_cache, krope_cache


def make_decode_step(group, cfg: DeepSeekV3Config, max_tokens: int,
                     low_latency_strategy: str = "default"):
    """This rank's decode step over `group` (an EPGroup, a process group or
    None for one rank): step(params, ckv, krope, ids, positions, seq_lens,
    block_table, slots) with params cut by expert_shard."""
    group = group if isinstance(group, EPGroup) else EPGroup(group)
    strategy = get_low_latency_strategy(low_latency_strategy)

    def step(params, ckv, kr, ids, pos, seq, bt, slots):
        return decode_step_shard(params, cfg, ckv, kr, ids, pos, seq, bt, slots, group=group,
                                 strategy=strategy, max_tokens=max_tokens)
    return step
