"""f32 twins of the Llama and MLA decoders, their int8 quantisation, and the
checkpoint-free quantisation delta (counterpart of the JAX package's
models/quant_ref.py).

Smooth random f32 weights are drawn with numpy from a seed, in the JAX
package's order and dtypes, so that both packages quantise identical f32
weights. A dense causal f32 forward is the golden; the same weights
quantised to the engines' W8A8 format (per-output-channel symmetric int8
weights; per-token dynamic activations for Llama, calibrated per-tensor
activation scales for the MLA pipeline) run through the int8 engine
(`llama.prefill_step`, `deepseek_mla.prefill_step`) on the same tokens, and
`delta_metrics` compares the two: perplexity of each, its change, and the
KL divergence of the int8 logits from the f32 ones. `quant_delta` does all
of it for one config, as scripts/accuracy_delta.py does for the JAX package;
scripts/accuracy_delta_torch.py runs it on the card.

Every function makes its tensors on the device of its inputs (the drawing
functions on `device`, the card unless the caller asks for the CPU). The f32
products stay f32 on the card as long as TF32 is off (PyTorch's default:
torch.backends.cuda.matmul.allow_tf32 False). Scales divide by a tensor 127,
as the JAX package divides eagerly: PyTorch's CUDA division by a Python
number multiplies by the reciprocal, which would move int8 codes off the
CPU's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.mla_preprocess import rotate_half_rope
from ..ops.rope import apply_rope, make_cos_sin_cache
from ..utils import resolve_device
from . import deepseek_mla, llama
from .deepseek_mla import make_mla_cos_sin


def _drawer(rng, dev):
    """w(*shape, s): a float64 standard-normal draw times s, rounded to f32
    (the JAX package's jnp.asarray(draw * s, float32)), on dev."""
    def w(*shape, s):
        a = rng.standard_normal(shape)
        a *= s
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    return w


def _int8_max(dev):
    return torch.tensor(127.0, dtype=torch.float32, device=dev)


def _quantize(w, axis: int):
    """Symmetric int8 over `axis` (the input axis): scale max(max|w|, 1e-8)
    / 127 per output channel, codes round(w / scale) clipped to +-127."""
    s = w.abs().amax(dim=axis).clamp_min(1e-8) / _int8_max(w.device)
    qw = torch.round(w / s.unsqueeze(axis)).clamp(-127, 127).to(torch.int8)
    return qw, s


def _rms(x, eps, w=None):
    n = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return n if w is None else n * w


def _swiglu_mlp(x, w13, w2, f):
    ug = x @ w13
    return (ug[:, :f] * torch.sigmoid(ug[:, :f]) * ug[:, f:]) @ w2


def _causal(t, dev):
    return torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))


# ------------------------------------------------------------------ llama


def llama_f32_params(cfg, seed: int = 0, device="cuda"):
    """Smooth random f32 weights in the [in, out] layout of models/llama.py's
    banks, drawn in the JAX package's order (embed, lm_head, wqkv, wo, w13,
    w2)."""
    dev = resolve_device(device)
    w = _drawer(np.random.default_rng(seed), dev)
    l, h = cfg.num_layers, cfg.hidden_size
    qs, kvs, f = cfg.q_size, cfg.kv_size, cfg.intermediate_size
    embed = w(cfg.vocab_size, h, s=0.02)
    lm_head = w(h, cfg.vocab_size, s=0.02)
    layers = {
        "wqkv": w(l, h, qs + 2 * kvs, s=h ** -0.5),
        "wo": w(l, qs, h, s=qs ** -0.5),
        "w13": w(l, h, 2 * f, s=h ** -0.5),
        "w2": w(l, f, h, s=f ** -0.5),
        "input_norm": torch.ones((l, h), device=dev),
        "post_norm": torch.ones((l, h), device=dev),
    }
    return {"embed": embed, "final_norm": torch.ones((h,), device=dev), "lm_head": lm_head,
            "layers": layers}


def quantize_llama(p32, cfg):
    """f32 params -> the Llama engine's int8 params: per-output-channel
    symmetric weights (activations are quantised per token in the engine)."""
    dev = p32["embed"].device

    def q(w):
        qw, s = _quantize(w, -2)
        return {"q": qw, "scale": s}

    lay = p32["layers"]
    return {
        "embed": p32["embed"].to(torch.bfloat16),
        "final_norm": p32["final_norm"].to(torch.bfloat16),
        "lm_head": q(p32["lm_head"]),
        "layers": {
            **{name: q(lay[name]) for name in ("wqkv", "wo", "w13", "w2")},
            "input_norm": lay["input_norm"].to(torch.bfloat16),
            "post_norm": lay["post_norm"].to(torch.bfloat16),
        },
        "cos_sin": make_cos_sin_cache(cfg.max_position, cfg.head_dim, cfg.rope_base,
                                      device=dev),
    }


def llama_f32_forward(p32, cfg, ids):
    """Dense causal f32 forward, ids [T] -> logits [T, V] f32: the math of
    models/llama.py's prefill with exact f32 weights."""
    dev = p32["embed"].device
    t = ids.shape[0]
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    sm = 1.0 / d ** 0.5
    cs = make_cos_sin_cache(cfg.max_position, d, cfg.rope_base, device=dev)[:t].float()
    cos, sin = cs[:, None, : d // 2], cs[:, None, d // 2:]
    causal = _causal(t, dev)
    eps = cfg.rms_eps
    x = p32["embed"][ids.long()]
    lay = p32["layers"]
    for li in range(cfg.num_layers):
        qkv = _rms(x, eps, lay["input_norm"][li]) @ lay["wqkv"][li]
        q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size], -1)
        q = apply_rope(q.reshape(t, hq, d), cos, sin)
        k = apply_rope(k.reshape(t, hkv, d), cos, sin)
        s = torch.einsum("thgd,nhd->hgtn", q.reshape(t, hkv, g, d), k) * sm
        s = torch.where(causal, s, -1e30)
        att = torch.einsum("hgtn,nhd->thgd", torch.softmax(s, -1), v.reshape(t, hkv, d))
        x = x + att.reshape(t, -1) @ lay["wo"][li]
        x = x + _swiglu_mlp(_rms(x, eps, lay["post_norm"][li]), lay["w13"][li], lay["w2"][li],
                            cfg.intermediate_size)
    return _rms(x, eps, p32["final_norm"]) @ p32["lm_head"]


# -------------------------------------------------------------------- mla


def mla_f32_params(cfg, seed: int = 0, device="cuda"):
    """Smooth f32 weights for the MLA pipeline, wdqkv and wuq in [out, in]
    layout (the mla_preprocess convention, models/deepseek_mla.py), drawn
    in the JAX package's order (embed, lm_head, wdqkv, wuq, wuk, wuv, wo,
    w13, w2)."""
    dev = resolve_device(device)
    w = _drawer(np.random.default_rng(seed), dev)
    l, h = cfg.num_layers, cfg.hidden_size
    heads = cfg.num_heads
    qdim = cfg.qk_nope_dim + cfg.qk_rope_dim
    vd, f = heads * cfg.v_head_dim, cfg.intermediate_size
    embed = w(cfg.vocab_size, h, s=0.02)
    lm_head = w(h, cfg.vocab_size, s=0.02)
    layers = {
        "wdqkv": w(l, cfg.mm1_out, h, s=h ** -0.5),
        "wuq": w(l, heads * qdim, cfg.q_lora_rank, s=cfg.q_lora_rank ** -0.5),
        "wuk": w(l, heads, cfg.qk_nope_dim, cfg.kv_lora_rank, s=0.06),
        "wuv": w(l, heads, cfg.kv_lora_rank, cfg.v_head_dim, s=0.04),
        "wo": w(l, vd, h, s=vd ** -0.5),
        "w13": w(l, h, 2 * f, s=h ** -0.5),
        "w2": w(l, f, h, s=f ** -0.5),
    }
    return {"embed": embed, "final_norm": torch.ones((h,), device=dev), "lm_head": lm_head,
            "layers": layers}


def _mla_layers(p32, cfg, ids, stats=None):
    """The f32 MLA decoder's layers over ids [T] -> the last hidden state
    [T, H]. With `stats` (two lists), each layer appends max|rms(x)| and
    max|rms(cq)|, the two quantised activations of mla_preprocess (the
    calibration of quantize_mla)."""
    dev = p32["embed"].device
    t = ids.shape[0]
    heads = cfg.num_heads
    lkv, lrope, qn = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim
    sm = 1.0 / ((qn + lrope) ** 0.5)
    eps = cfg.rms_eps
    cos, sin = make_mla_cos_sin(cfg, device=dev)
    cos, sin = cos[:t], sin[:t]
    causal = _causal(t, dev)
    x = p32["embed"][ids.long()]
    lay = p32["layers"]
    for li in range(cfg.num_layers):
        h1 = _rms(x, eps)
        fused = h1 @ lay["wdqkv"][li].T
        latent, cq = fused[:, :lkv + lrope], fused[:, lkv + lrope:]
        cqn = _rms(cq, eps)
        if stats is not None:
            stats[0].append(h1.abs().amax())
            stats[1].append(cqn.abs().amax())
        ctkv = _rms(latent[:, :lkv], eps)
        k_pe = rotate_half_rope(latent[:, lkv:], cos, sin)
        q_out = (cqn @ lay["wuq"][li].T).reshape(t, heads, qn + lrope)
        q_nope = torch.einsum("thd,hdk->thk", q_out[..., :qn], lay["wuk"][li])
        q_pe = rotate_half_rope(q_out[..., qn:], cos[:, None], sin[:, None])
        s = (torch.einsum("thk,nk->thn", q_nope, ctkv)
             + torch.einsum("thr,nr->thn", q_pe, k_pe)) * sm
        s = torch.where(causal[:, None], s, -1e30)
        att = torch.einsum("thn,nk->thk", torch.softmax(s, -1), ctkv)
        att = torch.einsum("thk,hkd->thd", att, lay["wuv"][li])
        x = x + att.reshape(t, -1) @ lay["wo"][li]
        x = x + _swiglu_mlp(_rms(x, eps), lay["w13"][li], lay["w2"][li],
                            cfg.intermediate_size)
    return x


def mla_f32_forward(p32, cfg, ids):
    """Dense causal f32 MLA forward (the mla_preprocess pipeline with exact
    f32 GEMMs and full latent attention), ids [T] -> logits [T, V] f32."""
    x = _mla_layers(p32, cfg, ids)
    return _rms(x, cfg.rms_eps, p32["final_norm"]) @ p32["lm_head"]


def quantize_mla(p32, cfg, calib_ids):
    """f32 MLA params -> the MLA engine's params: per-output-channel int8
    weights and PER-TENSOR activation scales calibrated on `calib_ids` (the
    reference op's static quant contract, as a checkpoint exporter
    calibrates): qscale = max|activation| / 127 per layer, folded into the
    GEMMs' descale (the int8 GEMM sums (x / qs) . (w / ws), so descale =
    qs * ws per channel)."""
    dev = p32["embed"].device
    l, h = cfg.num_layers, cfg.hidden_size
    lay = p32["layers"]
    stats = ([], [])
    _mla_layers(p32, cfg, calib_ids, stats)
    qscale0 = torch.stack(stats[0]).reshape(l, 1) / _int8_max(dev)
    qscale1 = torch.stack(stats[1]).reshape(l, 1) / _int8_max(dev)
    wdq, wdq_s = _quantize(lay["wdqkv"], -1)      # [L, out, in]
    wuq, wuq_s = _quantize(lay["wuq"], -1)
    banks = {name: dict(zip(("q", "scale"), _quantize(lay[name], -2)))
             for name in ("wo", "w13", "w2")}
    lm, lm_s = _quantize(p32["lm_head"], -2)
    cos, sin = make_mla_cos_sin(cfg, device=dev)

    def ones(*shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        "embed": p32["embed"].to(torch.bfloat16),
        "final_norm": ones(h, dtype=torch.bfloat16),
        "lm_head": {"q": lm, "scale": lm_s},
        "cos": cos, "sin": sin,
        "layers": {
            "wdqkv": {"q": wdq, "descale": wdq_s * qscale0,
                      "bias": torch.zeros_like(wdq_s, dtype=torch.int32)},
            "wuq": {"q": wuq, "descale": wuq_s * qscale1,
                    "bias": torch.zeros_like(wuq_s, dtype=torch.int32)},
            "wuk": lay["wuk"], "wuv": lay["wuv"],
            **banks,
            "gamma0": ones(l, h), "beta0": zeros(l, h),
            "gamma1": ones(l, cfg.q_lora_rank), "beta1": zeros(l, cfg.q_lora_rank),
            "gamma2": ones(l, cfg.kv_lora_rank),
            "post_norm": ones(l, h, dtype=torch.bfloat16),
            "qscale0": qscale0, "qoffset0": zeros(l, 1),
            "qscale1": qscale1, "qoffset1": zeros(l, 1),
        },
    }


# ------------------------------------------------------------------ metrics


def delta_metrics(logits_ref, logits_q, targets):
    """Perplexity of both logits on `targets`, its change in percent, and
    KL(ref || q) per token (mean, max), and the share of tokens whose
    argmax agrees. Returns Python floats."""
    lr = torch.log_softmax(logits_ref.float(), -1)
    lq = torch.log_softmax(logits_q.float(), -1)
    tgt = targets.long().to(lr.device)[:, None]
    ppl_r = torch.exp(-lr.gather(1, tgt).mean())
    ppl_q = torch.exp(-lq.gather(1, tgt).mean())
    kl = (torch.exp(lr) * (lr - lq)).sum(-1)
    agree = (lr.argmax(-1) == lq.argmax(-1)).float().mean()
    return {
        "ppl_f32": float(ppl_r),
        "ppl_int8": float(ppl_q),
        "ppl_delta_pct": float((ppl_q / ppl_r - 1) * 100),
        "kl_mean": float(kl.mean()),
        "kl_max": float(kl.max()),
        "greedy_agreement": float(agree),
    }


def quant_delta(kind: str, cfg, t: int, seed: int = 0, device="cuda"):
    """scripts/accuracy_delta.py's measurement of one config on `device`:
    t + 1 token ids drawn with numpy from `seed`, the f32 weights from the
    same seed; the f32 forward over the first t against the int8 engine's
    single-sequence prefill_step (kind "llama": LlamaEngine's bank layout on
    bf16 page-major caches; "mla": the calibrated per-tensor pipeline, both
    mla_preprocess stages through the fused RMSNorm-quant GEMM). Returns
    delta_metrics on the t next tokens."""
    dev = resolve_device(device)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, t + 1)).to(dev)
    tok, pos = ids[:-1], torch.arange(t, device=dev)
    ps = cfg.page_size
    pages = -(-t // ps) + 1
    if kind == "llama":
        p32 = llama_f32_params(cfg, seed, device=dev)
        logits32 = llama_f32_forward(p32, cfg, tok)
        pq = quantize_llama(p32, cfg)
        del p32
        logits8 = llama.prefill_step(pq, cfg, *llama.init_kv_cache(cfg, pages, layout="hm",
                                                                    device=dev),
                                     tok, pos, pos + ps)[0]
    elif kind == "mla":
        p32 = mla_f32_params(cfg, seed, device=dev)
        logits32 = mla_f32_forward(p32, cfg, tok)
        pq = deepseek_mla.fuse_mla_weights(quantize_mla(p32, cfg, tok))
        del p32
        logits8 = deepseek_mla.prefill_step(pq, cfg, *deepseek_mla.init_kv_cache(
            cfg, pages, device=dev), tok, pos, pos + ps)[0]
    else:
        raise ValueError(f"quant_delta: kind {kind!r} is llama or mla")
    if not (bool(torch.isfinite(logits32).all()) and bool(torch.isfinite(logits8).all())):
        raise FloatingPointError(f"quant_delta {kind}: logits not finite")
    return delta_metrics(logits32, logits8, ids[1:])
