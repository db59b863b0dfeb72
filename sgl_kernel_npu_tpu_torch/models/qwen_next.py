"""Qwen3-Next hybrid decoder (counterpart of the JAX package's
models/qwen_next.py): the f32 paths (decode_step, forward_full,
prefill_gdn_layer) and the W8A8 int8 decode step that `bench.py --config
qwen` times (decode_step_q), with QwenNextConfig, init_state, init_params,
init_params_q and quantize_qwen_weights.

Layer i is a full-attention block iff (i + 1) % full_attention_interval == 0,
otherwise a gated-delta-net (GDN) block; every layer is followed by a sparse
MoE MLP (top-k routed experts and a sigmoid-gated shared expert).

decode_step_q (int8 banks, bf16 activations):
  GDN block: RMSNorm -> wqkvz (K1) and wba (f32) -> split -> conv update
    -> gating and the recurrent delta rule on the state pool (K9)
    -> gated RMSNorm -> wo (K1)
  attention block: RMSNorm -> wq ([q | gate] per head), wk, wv (K1) ->
    per-head RMSNorm of q and k -> rotary on the first rotary_dim dims ->
    scatter into head-major bf16 pages -> paged GQA decode (K10) ->
    out * sigmoid(gate) -> wo (K1), plus the LoRA delta of lora_indices
  MoE: f32 router -> top-k -> aligned compaction (each expert's rows padded
    to block_m) -> GMM1 (K8) -> SwiGLU -> per-token int8 -> GMM2 (K8) ->
    inverse-gather combine; the shared expert's w13 and w2 on K1
decode_step (the f32 tree, f32 activations): the same blocks with f32
  products (torch.matmul, TF32 off), K9 on an f32 pool, K10 on bf16 pages
  (head dims of 128 and 256; below 128 decode_gqa takes its plain version,
  as in the JAX package), LoRA on the f32 attention output, and the f32 MoE
  (_moe_mlp: a stable sort by expert and a grouped product over the sorted
  rows, the JAX package's ragged_dot).
forward_full and prefill_gdn_layer (the f32 tree over [B, T] sequences): the
  GDN blocks through causal_conv1d_fn and the chunked delta rule, the
  attention blocks dense causal attention in f32 (einsum, the -inf mask, f32
  softmax, the sigmoid gate), kept plain: forward_full is the HF-parity
  golden.

Parameters are a dict of tensors with the JAX package's tree; the big int8
banks are pretiled [L, N/bn, K, bn], the expert banks flat over (layer,
expert) so that K8 selects expert e of layer li as e + li * num_experts.
Every cast of the JAX code is kept where it has one. The state (`init_state`)
is updated in place: the conv state, the SSM pool (one flat pool over the GDN
layers, rows gi * B + b) and the caches.

The quantised MoE follows the aligned tier the bench runs (qwen_next.py:
587-630 of the JAX package) with its m-tile of 32 (SKT_QWEN_TILE's default),
not the tight-sort reference tier. `init_params` draws the f32 tree (which
models/loader.py::load_qwen_next fills from a checkpoint) that
quantize_qwen_weights turns into the banks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..ops import gdn
from ..ops.attention.decode import decode_gqa
from ..ops.gdn.chunk import inv_norm
from ..ops.kvcache import reshape_and_cache_gqa
from ..ops.lora import bgmv_expand, bgmv_shrink
from ..ops.mamba import causal_conv1d_fn, causal_conv1d_update
from ..ops.matmul import grouped_matmul_int8, pretile_weight_bank, quant_matmul_int8_stacked
from ..ops.quant import per_token_quant_int8
from ..ops.rope import apply_rope, make_cos_sin_cache
from ..utils import cdiv, resolve_device
from .llama import params_from_jax  # noqa: F401  (the shared tree walker)

MOE_TILE = 32          # the aligned compaction's m-tile (SKT_QWEN_TILE's default)


@dataclass(frozen=True)
class QwenNextConfig:
    vocab_size: int = 1024
    hidden_size: int = 256
    num_layers: int = 4
    full_attention_interval: int = 4   # layer i full-attn iff (i+1) % this == 0
    # GDN (linear attention) block
    num_qk_heads: int = 4
    num_v_heads: int = 8
    head_qk_dim: int = 32
    head_v_dim: int = 32
    conv_width: int = 4
    chunk_size: int = 16
    # full attention block
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 32
    partial_rotary_factor: float = 0.25
    rope_theta: float = 10000.0
    page_size: int = 16
    # sparse MoE MLP (per layer)
    num_experts: int = 4
    top_k: int = 2
    norm_topk_prob: bool = True
    moe_intermediate_size: int = 128
    shared_intermediate_size: int = 128
    rms_eps: float = 1e-6
    max_position: int = 1024
    # LoRA
    num_loras: int = 2
    lora_rank: int = 8

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    def is_full_attention(self, layer: int) -> bool:
        return (layer + 1) % self.full_attention_interval == 0

    @property
    def num_gdn_layers(self) -> int:
        return sum(not self.is_full_attention(i) for i in range(self.num_layers))

    @property
    def num_attn_layers(self) -> int:
        return self.num_layers - self.num_gdn_layers

    @property
    def conv_dim(self) -> int:
        return 2 * self.num_qk_heads * self.head_qk_dim + self.num_v_heads * self.head_v_dim


def init_state(cfg: QwenNextConfig, batch: int, num_pages: int, ssm_dtype=torch.float32,
               device="cuda"):
    """Zeroed decode state: conv [ng, B, conv_dim, width - 1] f32, ssm [ng, B,
    HV, K, V] (bf16 on the quantised path), k_cache / v_cache [na, Hkv, P,
    ps, D] bf16."""
    dev = resolve_device(device)
    ng, na = cfg.num_gdn_layers, cfg.num_attn_layers
    kv = (na, cfg.num_kv_heads, num_pages, cfg.page_size, cfg.head_dim)
    return {
        "conv": torch.zeros((ng, batch, cfg.conv_dim, cfg.conv_width - 1),
                            dtype=torch.float32, device=dev),
        "ssm": torch.zeros((ng, batch, cfg.num_v_heads, cfg.head_qk_dim, cfg.head_v_dim),
                           dtype=ssm_dtype, device=dev),
        "k_cache": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
        "v_cache": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
    }


def _on(dev, a, dtype=None):
    """numpy -> tensor on dev; any cast happens on the host, so every device
    holds the same bits."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return (t if dtype is None else t.to(dtype)).to(dev)


# float64 normals drawn a chunk at a time where a leaf is dropped
_SKIP_CHUNK = 1 << 22


def init_params(cfg: QwenNextConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """The f32 parameter tree, with the same draws, in the same order and
    the same dtypes, as the JAX package's init_params, so the weights are
    bit-identical: float64 normals times their scale, rounded to f32 on the
    host; the norms (their effective 1 + w) ones, conv_b zeros, cos_sin the
    rotary table."""
    return _init_params(cfg, seed, resolve_device(device))


def _init_params(cfg: QwenNextConfig, seed: int, dev, drop=frozenset()):
    """init_params; the top-level keys in `drop` are drawn (each leaf's
    place in the stream is kept) but not kept, their normals drawn a chunk
    at a time and thrown away."""
    rng = np.random.default_rng(int(seed))
    h = cfg.hidden_size
    r = cfg.num_v_heads // cfg.num_qk_heads
    qkvz_dim = cfg.num_qk_heads * (2 * cfg.head_qk_dim + 2 * r * cfg.head_v_dim)
    ba_dim = cfg.num_qk_heads * 2 * r
    ng, na, nl = cfg.num_gdn_layers, cfg.num_attn_layers, cfg.num_layers
    e, f, fs = cfg.num_experts, cfg.moe_intermediate_size, cfg.shared_intermediate_size
    hvd, hd = cfg.num_v_heads * cfg.head_v_dim, cfg.num_heads * cfg.head_dim
    skip = None                                   # the dropped leaves' chunk

    def draw(key):
        def w(*shape, s=0.05):
            nonlocal skip
            if key not in drop:
                return _on(dev, rng.standard_normal(shape) * s, torch.float32)
            if skip is None:
                skip = np.empty(_SKIP_CHUNK)
            n = int(np.prod(shape))
            while n:
                k = min(n, skip.size)
                rng.standard_normal(out=skip[:k])
                n -= k
            return None
        return w

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    w = draw("embed")
    params = {"embed": w(cfg.vocab_size, h, s=0.02), "final_norm": full((h,), 1.0)}
    params["lm_head"] = draw("lm_head")(h, cfg.vocab_size, s=0.02)
    params["cos_sin"] = make_cos_sin_cache(cfg.max_position, cfg.rotary_dim,
                                           base=cfg.rope_theta, device="cpu").to(dev)
    w = draw("gdn")
    params["gdn"] = {"in_norm": full((ng, h), 1.0), "wqkvz": w(ng, h, qkvz_dim)}
    params["gdn"]["wba"] = w(ng, h, ba_dim)
    params["gdn"]["conv_w"] = w(ng, cfg.conv_dim, cfg.conv_width)
    params["gdn"]["conv_b"] = full((ng, cfg.conv_dim), 0.0)
    params["gdn"]["A_log"] = w(ng, cfg.num_v_heads, s=0.2)
    params["gdn"]["dt_bias"] = w(ng, cfg.num_v_heads, s=0.2)
    params["gdn"]["out_norm_w"] = full((ng, hvd), 1.0)
    params["gdn"]["wo"] = w(ng, hvd, h)
    w = draw("attn")
    params["attn"] = {"in_norm": full((na, h), 1.0), "wq": w(na, h, hd * 2)}
    params["attn"]["wk"] = w(na, h, cfg.num_kv_heads * cfg.head_dim)
    params["attn"]["wv"] = w(na, h, cfg.num_kv_heads * cfg.head_dim)
    params["attn"]["wo"] = w(na, hd, h)
    params["attn"]["q_norm"] = full((na, cfg.head_dim), 1.0)
    params["attn"]["k_norm"] = full((na, cfg.head_dim), 1.0)
    w = draw("moe")
    params["moe"] = {"norm": full((nl, h), 1.0), "router": w(nl, h, e)}
    params["moe"]["w13"] = w(nl, e, h, 2 * f)
    params["moe"]["w2"] = w(nl, e, f, h)
    params["moe"]["shared_w13"] = w(nl, h, 2 * fs)
    params["moe"]["shared_w2"] = w(nl, fs, h)
    params["moe"]["shared_gate"] = w(nl, h, 1)
    w = draw("lora")
    params["lora"] = {"A": w(cfg.num_loras, cfg.lora_rank, hd)}
    params["lora"]["B"] = w(cfg.num_loras, h, cfg.lora_rank)
    for key in drop:
        params.pop(key, None)
    return params


def init_params_q(cfg: QwenNextConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random int8 weights straight in the bank layout, with the same draws,
    in the same order and the same dtypes, as the JAX package's
    init_params_q, so the weights are bit-identical: embed, wba, conv_w,
    A_log, dt_bias, router, shared_gate, the LoRA pair (drawn though no
    adapter is served), then the banks. Float64 draws are rounded to f32 (or
    embed to bf16) on the host."""
    dev = resolve_device(device)
    rng = np.random.default_rng(int(seed))
    h = cfg.hidden_size
    r = cfg.num_v_heads // cfg.num_qk_heads
    qkvz_dim = cfg.num_qk_heads * (2 * cfg.head_qk_dim + 2 * r * cfg.head_v_dim)
    ba_dim = cfg.num_qk_heads * 2 * r
    ng, na, nl = cfg.num_gdn_layers, cfg.num_attn_layers, cfg.num_layers
    e, f, fs = cfg.num_experts, cfg.moe_intermediate_size, cfg.shared_intermediate_size
    hvd = cfg.num_v_heads * cfg.head_v_dim

    def w(*shape, s=0.05):
        return _on(dev, rng.standard_normal(shape) * s, torch.float32)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def bank(layers, k, n, s=0.05, bn_max=512):
        cands = [c for c in range(min(bn_max, n), 0, -128) if n % c == 0]
        bn = cands[0] if cands else n
        q = _on(dev, rng.integers(-127, 128, (layers, n // bn, k, bn), dtype=np.int8))
        return {"q": q, "scale": full((layers, n), s / 127.0)}

    params = {"embed": _on(dev, rng.standard_normal((cfg.vocab_size, h)) * 0.02,
                           torch.bfloat16),
              "final_norm": full((h,), 1.0),
              "cos_sin": make_cos_sin_cache(cfg.max_position, cfg.rotary_dim,
                                            base=cfg.rope_theta, device="cpu").to(dev)}
    params["gdn"] = {"in_norm": full((ng, h), 1.0), "wba": w(ng, h, ba_dim)}
    params["gdn"]["conv_w"] = w(ng, cfg.conv_dim, cfg.conv_width)
    params["gdn"]["conv_b"] = full((ng, cfg.conv_dim), 0.0)
    params["gdn"]["A_log"] = w(ng, cfg.num_v_heads, s=0.2)
    params["gdn"]["dt_bias"] = w(ng, cfg.num_v_heads, s=0.2)
    params["gdn"]["out_norm_w"] = full((ng, hvd), 1.0)
    params["attn"] = {"in_norm": full((na, h), 1.0), "q_norm": full((na, cfg.head_dim), 1.0),
                      "k_norm": full((na, cfg.head_dim), 1.0)}
    params["moe"] = {"norm": full((nl, h), 1.0), "router": w(nl, h, e)}
    params["moe"]["shared_gate"] = w(nl, h, 1)
    nlora = max(cfg.num_loras, 1)
    params["lora"] = {"A": w(nlora, cfg.lora_rank, cfg.num_heads * cfg.head_dim)}
    params["lora"]["B"] = w(nlora, h, cfg.lora_rank)
    fast = {}
    for name, args, kw in (
            ("gdn_wqkvz", (ng, h, qkvz_dim), {}),
            ("gdn_wo", (ng, hvd, h), {}),
            ("attn_wq", (na, h, cfg.num_heads * cfg.head_dim * 2), {}),
            ("attn_wk", (na, h, cfg.num_kv_heads * cfg.head_dim), {}),
            ("attn_wv", (na, h, cfg.num_kv_heads * cfg.head_dim), {}),
            ("attn_wo", (na, cfg.num_heads * cfg.head_dim, h), {}),
            ("shared_w13", (nl, h, 2 * fs), {}),
            ("shared_w2", (nl, fs, h), {}),
            # 1024-wide expert panels, as the JAX init (qwen_next.py:537-541)
            ("experts_w13", (nl * e, h, 2 * f), {"bn_max": 1024}),
            ("experts_w2", (nl * e, f, h), {"bn_max": 1024}),
            ("lm_head", (1, h, cfg.vocab_size), {"s": 0.02})):
        fast[name] = bank(*args, **kw)
    params["fast"] = fast
    return params


def _quantize_w(w):
    """f32 [..., K, N] -> per-output-channel symmetric int8 + scale [..., N]."""
    s = torch.clamp_min(w.abs().amax(dim=-2), 1e-8) / 127.0
    q = torch.clamp(torch.round(w / s[..., None, :]), -127, 127).to(torch.int8)
    return q, s


def _pretile(w_q, bn):
    """[L, K, N] -> [L, NB, K, bn'], bn' the largest 128-stepped divisor of N
    at most bn (the whole N when none divides)."""
    n = w_q.shape[-1]
    cands = [c for c in range(min(bn, n), 0, -128) if n % c == 0]
    return pretile_weight_bank(w_q, cands[0] if cands else n)


def quantize_qwen_weights(params, cfg: QwenNextConfig, block_n: int = 512):
    """Quantise an f32 parameter set (the JAX package's init_params tree,
    carried over by params_from_jax) into the bank layout of params["fast"],
    dropping each f32 original as its int8 copy lands. The f32 router, conv,
    norm, gating and LoRA parameters stay. Returns params."""
    def swap(tree, key, build):
        q, s = build(tree[key])
        tree[key] = None
        return {"q": q, "scale": s}

    def bank(w):
        q, s = _quantize_w(w)
        return _pretile(q, block_n), s

    def expert_bank(w):
        nl, e = w.shape[:2]
        q, s = _quantize_w(w.reshape((nl * e,) + tuple(w.shape[2:])))
        return _pretile(q, block_n), s

    g, a, m = params["gdn"], params["attn"], params["moe"]
    fast = {"gdn_wqkvz": swap(g, "wqkvz", bank), "gdn_wo": swap(g, "wo", bank),
            "attn_wq": swap(a, "wq", bank), "attn_wk": swap(a, "wk", bank),
            "attn_wv": swap(a, "wv", bank), "attn_wo": swap(a, "wo", bank),
            "shared_w13": swap(m, "shared_w13", bank),
            "shared_w2": swap(m, "shared_w2", bank),
            "experts_w13": swap(m, "w13", expert_bank),
            "experts_w2": swap(m, "w2", expert_bank),
            "lm_head": swap(params, "lm_head", lambda w: bank(w[None]))}
    params["fast"] = fast
    return params


def _rms(x, w, eps):
    """RMSNorm in f32 (the JAX package's _rms, whose result is f32): rstd from
    a float64 sum of squares, the f32 mean plus eps, 1/sqrt in float64,
    rounded once (gdn.gating's rule)."""
    x32 = x.float()
    inv = inv_norm((x32.double() ** 2).sum(-1, keepdim=True), eps, x.shape[-1])
    return x32 * inv * w.float()


def _apply_partial_rope(q, k, cos, sin, rd):
    q = torch.cat([apply_rope(q[..., :rd], cos, sin), q[..., rd:]], -1)
    k = torch.cat([apply_rope(k[..., :rd], cos, sin), k[..., rd:]], -1)
    return q, k


def _layer(tree, i: int):
    """The slice of every leaf at layer i (views, no copies)."""
    return {k: v[i] for k, v in tree.items()}


def _lora(params, cfg: QwenNextConfig, att, o, lora_indices):
    """o + the BGMV delta of each sequence's adapter on the attention output
    att (both f32), the JAX package's shrink then expand."""
    shr = bgmv_shrink(att, params["lora"]["A"], lora_indices)
    return bgmv_expand(shr, params["lora"]["B"], lora_indices, o, 0, cfg.hidden_size)


def _ragged_dot(xs, w, sizes):
    """The JAX package's jax.lax.ragged_dot: the rows of xs [M, K], grouped by
    expert in order (sizes [E], summing to M), each group times its expert's
    w [E, K, N], in f32. One batched product over the groups padded to the
    largest (the bank read once, never gathered per row)."""
    m, e = xs.shape[0], w.shape[0]
    grp = torch.repeat_interleave(torch.arange(e, device=xs.device), sizes, output_size=m)
    pos = torch.arange(m, device=xs.device) - (torch.cumsum(sizes, 0) - sizes)[grp]
    xp = torch.zeros((e, int(sizes.max()), xs.shape[1]), dtype=xs.dtype, device=xs.device)
    xp[grp, pos] = xs
    return torch.bmm(xp, w)[grp, pos]


def _moe_mlp(x, p, cfg: QwenNextConfig):
    """The f32 sparse MoE block on x [T, H] with one layer's parameters p:
    softmax router, top-k (renormalised when norm_topk_prob), the T * k
    routed rows stably sorted by expert, the grouped SwiGLU expert products
    (_ragged_dot), scattered back and summed over k in top-k order, plus the
    sigmoid-gated shared expert."""
    t, h = x.shape
    e, k, f = cfg.num_experts, cfg.top_k, cfg.moe_intermediate_size
    probs = torch.softmax((x @ p["router"]).float(), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1, sorted=True)
    if cfg.norm_topk_prob:
        topw = topw / topw.sum(-1, keepdim=True)
    flat_i = topi.reshape(-1)
    order = torch.argsort(flat_i, stable=True)
    sizes = torch.bincount(flat_i, minlength=e)
    h1 = _ragged_dot(x[order // k], p["w13"], sizes)
    act = h1[:, :f] * torch.sigmoid(h1[:, :f]) * h1[:, f:]
    out_sorted = _ragged_dot(act, p["w2"], sizes) * topw.reshape(-1)[order][:, None]
    rows = torch.empty_like(out_sorted).index_copy_(0, order, out_sorted).reshape(t, k, h)
    routed = rows[:, 0]
    for i in range(1, k):                  # the k slots of a token, in top-k order
        routed = routed + rows[:, i]
    fs = cfg.shared_intermediate_size
    ug = x @ p["shared_w13"]
    shared = (ug[:, :fs] * torch.sigmoid(ug[:, :fs]) * ug[:, fs:]) @ p["shared_w2"]
    return routed + shared * torch.sigmoid(x @ p["shared_gate"])


def _gdn_project(p, cfg: QwenNextConfig, h1):
    """The GDN block's head: the fused QKVZ / BA projections and their split."""
    return gdn.fused_qkvzba_split_reshape_cat(h1 @ p["wqkvz"], h1 @ p["wba"], cfg.num_qk_heads,
                                              cfg.num_v_heads, cfg.head_qk_dim, cfg.head_v_dim)


def _attn_qkv(p, cfg: QwenNextConfig, h1):
    """The gated q projection, k and v, and the per-head-dim q / k RMSNorms.
    h1 [T, H] -> (q [T, nq, d], gate [T, nq * d], k [T, nkv, d], v [T, nkv,
    d], rotary_dim)."""
    t = h1.shape[0]
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = (h1 @ p["wq"]).reshape(t, nq, 2 * d)
    q, gate = qg[..., :d], qg[..., d:].reshape(t, nq * d)
    k = (h1 @ p["wk"]).reshape(t, nkv, d)
    v = (h1 @ p["wv"]).reshape(t, nkv, d)
    q = _rms(q, p["q_norm"], cfg.rms_eps)
    k = _rms(k, p["k_norm"], cfg.rms_eps)
    return q, gate, k, v, cfg.rotary_dim


def decode_step(params, cfg: QwenNextConfig, state, input_ids, positions, seq_lens,
                block_table, slot_mapping, lora_indices=None):
    """One f32 hybrid decode step on the f32 tree (init_params or
    models/loader.py::load_qwen_next), state from init_state (an f32 SSM
    pool, the JAX package's default). Arguments as decode_step_q's. On the
    card the GDN recurrence is K9 on the f32 pool and the attention K10 on
    the bf16 head-major pages. Updates the state in place; returns (logits
    [B, V] f32, state)."""
    b = input_ids.shape[0]
    hqk, hv = cfg.num_qk_heads, cfg.num_v_heads
    dqk, dv = cfg.head_qk_dim, cfg.head_v_dim
    d, rd, eps = cfg.head_dim, cfg.rotary_dim, cfg.rms_eps
    x = params["embed"][input_ids.long()]
    ssm = state["ssm"]
    pool = ssm.view((ssm.shape[0] * ssm.shape[1],) + tuple(ssm.shape[2:]))
    rows = torch.arange(b, dtype=torch.int32, device=x.device)
    cs = params["cos_sin"][positions.long()]
    cos, sin = cs[:, None, : rd // 2], cs[:, None, rd // 2:]
    gi = ai = 0
    for li in range(cfg.num_layers):
        if not cfg.is_full_attention(li):             # GDN block
            p = _layer(params["gdn"], gi)
            mixed_qkv, z, bb, aa = _gdn_project(p, cfg, _rms(x, p["in_norm"], eps))
            qkv, _ = causal_conv1d_update(mixed_qkv, state["conv"][gi], p["conv_w"],
                                          p["conv_b"], activation="silu")
            q = qkv[:, : hqk * dqk].reshape(b, 1, hqk, dqk)
            k = qkv[:, hqk * dqk:2 * hqk * dqk].reshape(b, 1, hqk, dqk)
            v = qkv[:, 2 * hqk * dqk:].reshape(b, 1, hv, dv)
            o, _ = gdn.fused_sigmoid_gating_delta_rule_update(
                p["A_log"], aa[:, None], p["dt_bias"], 1.0, 20.0, q, k, v, bb[:, None], pool,
                gi * b + rows, use_qk_l2norm_in_kernel=True)
            o = gdn.layernorm_gated(o.reshape(b, hv * dv), p["out_norm_w"], None,
                                    z.reshape(b, hv * dv), eps, group_size=dv, is_rms_norm=True)
            x = x + o @ p["wo"]
            gi += 1
        else:                                         # full attention block
            p = _layer(params["attn"], ai)
            q, gate, k, v, _ = _attn_qkv(p, cfg, _rms(x, p["in_norm"], eps))
            q, k = _apply_partial_rope(q, k, cos, sin, rd)
            kc, vc = reshape_and_cache_gqa(k.to(torch.bfloat16), v.to(torch.bfloat16),
                                           state["k_cache"][ai], state["v_cache"][ai],
                                           slot_mapping)
            att = decode_gqa(q.to(torch.bfloat16), kc, vc, seq_lens, block_table,
                             1.0 / d ** 0.5, cfg.page_size)
            att = att.reshape(b, -1).float() * torch.sigmoid(gate)
            o = att @ p["wo"]
            if lora_indices is not None:
                o = _lora(params, cfg, att, o, lora_indices)
            x = x + o
            ai += 1
        mp = _layer(params["moe"], li)
        x = x + _moe_mlp(_rms(x, mp["norm"], eps), mp, cfg)
    return _rms(x, params["final_norm"], eps) @ params["lm_head"], state


def _gdn_seq(p, cfg: QwenNextConfig, x, output_final_state: bool):
    """One GDN block over x [B, T, H] with one layer's parameters p:
    causal_conv1d_fn, the gating, the qk heads repeated up to the v heads
    (v-head i reads qk head i // r, as K9's head map), the chunked delta
    rule. Returns (x + the block's output, final state [B, HV, Dk, Dv] f32
    or None)."""
    b, t, h = x.shape
    hqk, hv = cfg.num_qk_heads, cfg.num_v_heads
    dqk, dv = cfg.head_qk_dim, cfg.head_v_dim
    mixed_qkv, z, bb, aa = _gdn_project(p, cfg, _rms(x, p["in_norm"], cfg.rms_eps)
                                        .reshape(b * t, h))
    conv_out, _ = causal_conv1d_fn(mixed_qkv.reshape(b, t, -1).transpose(1, 2), p["conv_w"],
                                   p["conv_b"], activation="silu")
    qkv = conv_out.transpose(1, 2)                               # [B, T, dim]
    q = qkv[..., : hqk * dqk].reshape(b, t, hqk, dqk)
    k = qkv[..., hqk * dqk:2 * hqk * dqk].reshape(b, t, hqk, dqk)
    v = qkv[..., 2 * hqk * dqk:].reshape(b, t, hv, dv)
    g, beta = gdn.fused_gdn_gating(p["A_log"], aa.reshape(b * t, hv), bb.reshape(b * t, hv),
                                   p["dt_bias"])
    r = hv // hqk
    o, final = gdn.chunk_gated_delta_rule(
        torch.repeat_interleave(q, r, dim=2), torch.repeat_interleave(k, r, dim=2), v,
        g.reshape(b, t, hv), beta.reshape(b, t, hv), chunk_size=cfg.chunk_size,
        output_final_state=output_final_state, use_qk_l2norm_in_kernel=True)
    o = gdn.layernorm_gated(o.reshape(b * t, hv * dv), p["out_norm_w"], None,
                            z.reshape(b * t, hv * dv), cfg.rms_eps, group_size=dv,
                            is_rms_norm=True)
    return x + (o @ p["wo"]).reshape(b, t, h), final


def prefill_gdn_layer(params, cfg: QwenNextConfig, x_seq, gi: int = 0):
    """GDN block gi over x_seq [B, T, H] (the chunked prefill). Returns
    (x_seq + the block's output, its final state [B, HV, Dk, Dv] f32, the
    layout of the decode pool's rows)."""
    return _gdn_seq(_layer(params["gdn"], gi), cfg, x_seq, True)


def forward_full(params, cfg: QwenNextConfig, input_ids):
    """The dense full-sequence forward on the f32 tree: input_ids [B, T] ->
    logits [B, T, V] f32. The GDN blocks as prefill_gdn_layer; the attention
    blocks dense causal attention in f32 (query head i reads kv head
    i // (nq / nkv)), kept plain as the JAX package's HF-parity golden."""
    b, t = input_ids.shape
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rd, eps = cfg.rotary_dim, cfg.rms_eps
    x = params["embed"][input_ids.long()]                       # [B, T, H]
    positions = torch.arange(t, device=x.device)
    cs = params["cos_sin"][positions]
    cos, sin = cs[None, :, None, : rd // 2], cs[None, :, None, rd // 2:]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    gi = ai = 0
    for li in range(cfg.num_layers):
        if not cfg.is_full_attention(li):
            x = _gdn_seq(_layer(params["gdn"], gi), cfg, x, False)[0]
            gi += 1
        else:
            p = _layer(params["attn"], ai)
            q, gate, k, v, _ = _attn_qkv(p, cfg, _rms(x, p["in_norm"], eps).reshape(b * t, -1))
            q, k = _apply_partial_rope(q.reshape(b, t, nq, d), k.reshape(b, t, nkv, d), cos,
                                       sin, rd)
            k = torch.repeat_interleave(k, nq // nkv, dim=2)
            v = torch.repeat_interleave(v.reshape(b, t, nkv, d), nq // nkv, dim=2)
            scores = torch.einsum("bihd,bjhd->bhij", q, k) / d ** 0.5
            scores = torch.where(mask[None, None], scores, float("-inf"))
            att = torch.einsum("bhij,bjhd->bihd", torch.softmax(scores.float(), -1), v)
            att = att.reshape(b, t, nq * d) * torch.sigmoid(gate.reshape(b, t, nq * d))
            x = x + att @ p["wo"]
            ai += 1
        mp = _layer(params["moe"], li)
        x = x + _moe_mlp(_rms(x, mp["norm"], eps).reshape(b * t, -1), mp, cfg).reshape(b, t, -1)
    return _rms(x, params["final_norm"], eps) @ params["lm_head"]


def _qmm_st(x, bank, li: int):
    """Per-token int8 quant + the pretiled stacked GEMM (K1) at layer li."""
    xq, xs = per_token_quant_int8(x)
    return quant_matmul_int8_stacked(xq, bank["q"], li, xs, bank["scale"], out_dtype=x.dtype)


def align_routes(topi, e: int, tile: int):
    """The aligned compaction of the JAX package's _moe_mlp_q
    (qwen_next.py:581-612): the T * k routed slots of topi [T, k], sorted
    stably by expert, each expert's rows padded to a multiple of `tile`,
    then cap_pad = (ceil(T * k / tile) + e) * tile rows in all. Returns, per
    padded row, ok (a real slot) and src (its flat slot t * k + i; clipped
    for padding rows), and the expert of each tile ([cap_pad / tile] int32;
    tiles past the last group take expert e - 1). No host sync."""
    t, k = topi.shape
    dev = topi.device
    flat_i = topi.reshape(-1)
    order = torch.argsort(flat_i, stable=True)
    group_list = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_i, torch.ones_like(flat_i))
    cap = t * k
    tight_off = torch.cumsum(group_list, 0) - group_list
    al_sizes = (group_list + tile - 1) // tile * tile
    incl = torch.cumsum(al_sizes, 0)
    al_off = incl - al_sizes
    cap_pad = (cdiv(cap, tile) + e) * tile
    j = torch.arange(cap_pad, device=dev)
    eix = torch.searchsorted(incl, j, right=True).clamp(0, e - 1)     # #(incl <= j)
    idx = j - al_off[eix]
    ok = idx < group_list[eix]
    src = order[(tight_off[eix] + idx).clamp(0, cap - 1)]
    jt = torch.arange(cap_pad // tile, device=dev) * tile
    eid = torch.searchsorted(incl, jt, right=True).clamp(0, e - 1).to(torch.int32)
    return ok, src, eid


def _moe_mlp_q(x, params, cfg: QwenNextConfig, li: int):
    """Quantised sparse-MoE block of layer li on x [T, H] bf16 (module
    docstring), the JAX package's aligned tier. Every step is a tensor op
    without a host sync."""
    fast = params["fast"]
    t, h = x.shape
    e, k, f = cfg.num_experts, cfg.top_k, cfg.moe_intermediate_size
    dev = x.device
    probs = torch.softmax(x.float() @ params["moe"]["router"][li], dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1, sorted=True)
    if cfg.norm_topk_prob:
        topw = topw / topw.sum(-1, keepdim=True)

    ok, src, eid = align_routes(topi, e, MOE_TILE)
    eid = eid + li * e                     # expert e of layer li in the flat banks
    xq, xs = per_token_quant_int8(x)
    tok = src // k
    xg = torch.where(ok[:, None], xq[tok], 0).to(torch.int8)
    xsg = torch.where(ok[:, None], xs[tok], 0.0)
    w13, w2 = fast["experts_w13"], fast["experts_w2"]
    g32 = grouped_matmul_int8(xg, w13["q"], xsg, w13["scale"], eid, MOE_TILE).float()
    act = g32[:, :f] * torch.sigmoid(g32[:, :f]) * g32[:, f:]
    actq, acts = per_token_quant_int8(act)
    acts = torch.where(ok[:, None], acts, 0.0)
    y = grouped_matmul_int8(actq, w2["q"], acts, w2["scale"], eid, MOE_TILE)
    # inverse-gather combine: every padding row aims at index cap, which is
    # dropped (the JAX scatter's mode="drop")
    cap = t * k
    j = torch.arange(ok.shape[0], device=dev)
    inv = torch.zeros(cap + 1, dtype=torch.long, device=dev).scatter_(
        0, torch.where(ok, src, cap), j)[:cap]
    rows = (y[inv].float() * topw.reshape(-1)[:, None]).reshape(t, k, h)
    routed = rows[:, 0]
    for i in range(1, k):                  # the k slots of a token, in top-k order
        routed = routed + rows[:, i]

    fs = cfg.shared_intermediate_size
    ug_s = _qmm_st(x, fast["shared_w13"], li).float()
    act_s = (ug_s[:, :fs] * torch.sigmoid(ug_s[:, :fs]) * ug_s[:, fs:]).to(x.dtype)
    shared = _qmm_st(act_s, fast["shared_w2"], li).float()
    shared = shared * torch.sigmoid(x.float() @ params["moe"]["shared_gate"][li])
    return (routed + shared).to(x.dtype)


def decode_step_q(params, cfg: QwenNextConfig, state, input_ids, positions, seq_lens,
                  block_table, slot_mapping, lora_indices=None):
    """One quantised hybrid decode step (params from init_params_q or
    quantize_qwen_weights, state from init_state with a bf16 or f32 SSM
    pool).

    input_ids / positions / slot_mapping [B]; seq_lens [B] INCLUDING the new
    token; block_table [B, max_pages]; a slot of -1 writes no cache row;
    lora_indices [B] (an adapter of params["lora"] a sequence, -1 none):
    its delta is added in f32 to the f32 of wo's output, then cast back to
    bf16. Updates the state in place; returns (logits [B, V] f32, state)."""
    b = input_ids.shape[0]
    hqk, hv = cfg.num_qk_heads, cfg.num_v_heads
    dqk, dv = cfg.head_qk_dim, cfg.head_v_dim
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rd, eps = cfg.rotary_dim, cfg.rms_eps
    fast, pg, pa = params["fast"], params["gdn"], params["attn"]
    x = params["embed"][input_ids.long()].to(torch.bfloat16)
    ssm = state["ssm"]
    pool = ssm.view((ssm.shape[0] * ssm.shape[1],) + tuple(ssm.shape[2:]))
    rows = torch.arange(b, dtype=torch.int32, device=x.device)
    cs = params["cos_sin"][positions.long()]
    cos, sin = cs[:, None, : rd // 2], cs[:, None, rd // 2:]
    gi = ai = 0
    for li in range(cfg.num_layers):
        if not cfg.is_full_attention(li):             # GDN block
            h1 = _rms(x, pg["in_norm"][gi], eps).to(torch.bfloat16)
            qkvz = _qmm_st(h1, fast["gdn_wqkvz"], gi)
            ba = h1.float() @ pg["wba"][gi]
            mixed_qkv, z, bb, aa = gdn.fused_qkvzba_split_reshape_cat(
                qkvz.float(), ba, hqk, hv, dqk, dv)
            qkv, _ = causal_conv1d_update(mixed_qkv, state["conv"][gi], pg["conv_w"][gi],
                                          pg["conv_b"][gi], activation="silu")
            q = qkv[:, : hqk * dqk].reshape(b, 1, hqk, dqk)
            k = qkv[:, hqk * dqk:2 * hqk * dqk].reshape(b, 1, hqk, dqk)
            v = qkv[:, 2 * hqk * dqk:].reshape(b, 1, hv, dv)
            o, _ = gdn.fused_sigmoid_gating_delta_rule_update(
                pg["A_log"][gi], aa[:, None], pg["dt_bias"][gi], 1.0, 20.0, q, k, v,
                bb[:, None], pool, gi * b + rows, use_qk_l2norm_in_kernel=True)
            o = gdn.layernorm_gated(o.reshape(b, hv * dv), pg["out_norm_w"][gi], None,
                                    z.reshape(b, hv * dv), eps, group_size=dv, is_rms_norm=True)
            x = x + _qmm_st(o.to(torch.bfloat16), fast["gdn_wo"], gi)
            gi += 1
        else:                                         # full attention block
            h1 = _rms(x, pa["in_norm"][ai], eps).to(torch.bfloat16)
            qg = _qmm_st(h1, fast["attn_wq"], ai).reshape(b, nq, 2 * d)
            q, gate = qg[..., :d], qg[..., d:].reshape(b, nq * d)
            k = _qmm_st(h1, fast["attn_wk"], ai).reshape(b, nkv, d)
            v = _qmm_st(h1, fast["attn_wv"], ai).reshape(b, nkv, d)
            q = _rms(q, pa["q_norm"][ai], eps)
            k = _rms(k, pa["k_norm"][ai], eps)
            q, k = _apply_partial_rope(q, k, cos, sin, rd)
            kc, vc = reshape_and_cache_gqa(k.to(torch.bfloat16), v, state["k_cache"][ai],
                                           state["v_cache"][ai], slot_mapping)
            att = decode_gqa(q.to(torch.bfloat16), kc, vc, seq_lens, block_table,
                             1.0 / d ** 0.5, cfg.page_size)
            att = (att.reshape(b, -1).float() * torch.sigmoid(gate.float())).to(torch.bfloat16)
            o = _qmm_st(att, fast["attn_wo"], ai)
            if lora_indices is not None:
                o = _lora(params, cfg, att.float(), o.float(), lora_indices).to(torch.bfloat16)
            x = x + o
            ai += 1
        h2 = _rms(x, params["moe"]["norm"][li], eps).to(torch.bfloat16)
        x = x + _moe_mlp_q(h2, params, cfg, li)

    x = _rms(x, params["final_norm"], eps).to(torch.bfloat16)
    return _qmm_st(x, fast["lm_head"], 0).float(), state
