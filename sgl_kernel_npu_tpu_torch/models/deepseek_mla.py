"""DeepSeek-V2-class MLA decoder with W8A8 int8 weights (counterpart of the
JAX package's models/deepseek_mla.py).

Two paths, as in the JAX package:
  * `decode_step_c`, the decode that `bench.py --config mla` times: the five
    big banks pretiled (`pretile_mla_weights`), both mla_preprocess
    RMSNormQuant->GEMM stages through the fused GEMM in its per_tensor mode
    (K2), attention over a COMBINED latent cache read-only (K5), and one
    append of every layer's new latent rows after the loop (K6); bf16 or
    int8 (per-token scales) latent rows.
  * `decode_step`, `decode_verify_step` and `prefill_step`, which
    serving.MlaEngine runs: `ops/mla_preprocess.mla_preprocess` on split
    ckv / krope caches (K2 per_tensor when `fuse_mla_weights` has made the
    [in, out] copies), paged MLA decode (K7) or, for verify and prefill,
    plain PyTorch attention over the gathered prefix, as the JAX code leaves
    it to XLA; wo, w13, w2 and lm_head through kernel A.

Parameters are a dict of tensors with the JAX package's tree (`init_params`).
Layers run as a Python loop; every cast of the JAX code is kept where it has
one. The knobs the JAX path reads are held at their MLA defaults:
SKT_FUSED_RMSQ on (the w13 stage is K2 per_token at M >= 8), SKT_W13_F32 on
(its output is f32), SKT_WUKV_T off (wuk / wuv keep their natural layout).
The wuk / wuv einsums stay plain f32 products over the bf16-stored weights,
as the JAX code computes them off the TPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..ops import mla_preprocess as mp
from ..ops.attention.decode import decode_mla
from ..ops.attention.decode_mla_v2 import (append_mla, decode_mla_v3_defer,
                                           quant_latent_rows, scatter_latent_scales)
from ..ops.matmul import (pretile_weight_bank, quant_matmul_int8,
                          quant_matmul_int8_stacked)
from ..ops.quant import per_token_quant_int8
from ..ops.rmsq_gemm import rmsnorm_quant_gemm
from ..utils import resolve_device
from .llama import _pages_offs, params_from_jax  # noqa: F401  (the shared tree walker)


@dataclass(frozen=True)
class MlaConfig:
    vocab_size: int = 32768
    hidden_size: int = 2048
    num_layers: int = 4
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    q_lora_rank: int = 1536
    intermediate_size: int = 4096
    rms_eps: float = 1e-6
    page_size: int = 128
    max_position: int = 4096

    @property
    def mm1_out(self):
        return self.kv_lora_rank + self.qk_rope_dim + self.q_lora_rank


def tiny_config(**kw) -> MlaConfig:
    base = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
                kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
                q_lora_rank=96, intermediate_size=256, page_size=16,
                max_position=512)
    base.update(kw)
    return MlaConfig(**base)


def make_mla_cos_sin(cfg: MlaConfig, theta: float = 10000.0, device="cuda"):
    """Neox-style cos/sin tables [max_position, qk_rope_dim] f32 for the
    rotate-half RoPE of mla_preprocess."""
    d = cfg.qk_rope_dim
    inv = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
    t = np.arange(cfg.max_position, dtype=np.float64)[:, None] * inv[None, :]
    cos = np.cos(np.concatenate([t, t], -1)).astype(np.float32)
    sin = np.sin(np.concatenate([t, t], -1)).astype(np.float32)
    dev = resolve_device(device)
    return torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev)


def init_params(cfg: MlaConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Seeded numpy init with the same draws, in the same order and the same
    dtypes, as the JAX package's init_params, so the weights are
    bit-identical: wdqkv, wuq, wuk, wuv, wo, w13, w2, then embed and lm_head;
    wuk, wuv and embed are float64 normal draws (a float32 draw would consume
    the stream differently), embed rounded from float64 to bf16."""
    dev = resolve_device(device)
    rng = np.random.default_rng(int(seed))
    l, h = cfg.num_layers, cfg.hidden_size
    heads = cfg.num_heads
    qdim = cfg.qk_nope_dim + cfg.qk_rope_dim

    def t(a, dtype=None):
        out = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return out if dtype is None else out.to(dtype)

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def wq(out, inp):
        # [out, in] int8 + [out] descale (the mla_preprocess convention)
        return {"q": t(rng.integers(-127, 128, (l, out, inp), dtype=np.int8)),
                "descale": full((l, out), 0.02 / 127.0),
                "bias": full((l, out), 0, torch.int32)}

    def w8(*shape):
        return t(rng.integers(-127, 128, shape, dtype=np.int8))

    layers = {"wdqkv": wq(cfg.mm1_out, h),
              "wuq": wq(heads * qdim, cfg.q_lora_rank)}
    layers["wuk"] = t(rng.standard_normal(
        (l, heads, cfg.qk_nope_dim, cfg.kv_lora_rank)) * 0.05, torch.float32)
    layers["wuv"] = t(rng.standard_normal(
        (l, heads, cfg.kv_lora_rank, cfg.v_head_dim)) * 0.05, torch.float32)
    layers["wo"] = {"q": w8(l, heads * cfg.v_head_dim, h), "scale": full((l, h), 0.02 / 127.0)}
    layers["w13"] = {"q": w8(l, h, 2 * cfg.intermediate_size),
                     "scale": full((l, 2 * cfg.intermediate_size), 0.02 / 127.0)}
    layers["w2"] = {"q": w8(l, cfg.intermediate_size, h), "scale": full((l, h), 0.02 / 127.0)}
    layers.update({
        "gamma0": full((l, h), 1.0), "beta0": full((l, h), 0.0),
        "gamma1": full((l, cfg.q_lora_rank), 1.0), "beta1": full((l, cfg.q_lora_rank), 0.0),
        "gamma2": full((l, cfg.kv_lora_rank), 1.0),
        "post_norm": full((l, h), 1.0, torch.bfloat16),
        "qscale0": full((l, 1), 0.05), "qoffset0": full((l, 1), 0.0),
        "qscale1": full((l, 1), 0.05), "qoffset1": full((l, 1), 0.0),
    })
    embed = t(rng.standard_normal((cfg.vocab_size, h)) * 0.02, torch.bfloat16)
    lm_head = {"q": w8(h, cfg.vocab_size), "scale": full((cfg.vocab_size,), 0.02 / 127.0)}
    inv = 1.0 / (np.arange(1, cfg.qk_rope_dim // 2 + 1, dtype=np.float64))
    tt = np.arange(cfg.max_position, dtype=np.float64)[:, None] * inv[None, :] * 0.01
    return {
        "embed": embed,
        "final_norm": full((h,), 1.0, torch.bfloat16),
        "lm_head": lm_head,
        "cos": t(np.cos(np.concatenate([tt, tt], -1)), torch.float32),
        "sin": t(np.sin(np.concatenate([tt, tt], -1)), torch.float32),
        "layers": layers,
    }


def init_kv_cache(cfg: MlaConfig, num_pages: int, dtype=torch.bfloat16, device="cuda"):
    """Split latent caches, zeroed: ckv [L, P, ps, kv_lora] and krope
    [L, P, ps, rope]."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.page_size)
    return (torch.zeros(shape + (cfg.kv_lora_rank,), dtype=dtype, device=dev),
            torch.zeros(shape + (cfg.qk_rope_dim,), dtype=dtype, device=dev))


def combined_width(cfg: MlaConfig) -> int:
    """Latent row width of the combined cache: kv_lora + rope (576 for
    DeepSeek). The JAX package pads it to a multiple of 128 for Mosaic's DMA
    slices; the port does not."""
    return cfg.kv_lora_rank + cfg.qk_rope_dim


def init_kv_cache_combined(cfg: MlaConfig, num_pages: int, dtype=torch.bfloat16,
                           quant: str = "bf16", device="cuda"):
    """Combined latent pages [L, P, ps, C] (ctkv | krope), zeroed; with
    quant="int8" a dict of int8 rows "kv" and per-token scales "s"
    [L, P, 1, ps] f32."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.page_size, combined_width(cfg))
    if quant == "int8":
        return {"kv": torch.zeros(shape, dtype=torch.int8, device=dev),
                "s": torch.zeros((cfg.num_layers, num_pages, 1, cfg.page_size),
                                 dtype=torch.float32, device=dev)}
    return torch.zeros(shape, dtype=dtype, device=dev)


def _rms(x, w, eps):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def fuse_mla_weights(params):
    """Add [in, out] copies ("kn") of wdqkv / wuq, so that mla_preprocess runs
    its two RMSNormQuant->GEMM stages through the fused GEMM (a one-time load
    transform). Returns params."""
    for name in ("wdqkv", "wuq"):
        bank = params["layers"][name]
        if "kn" not in bank:
            bank["kn"] = bank["q"].transpose(1, 2).contiguous()
    return params


def _pad_cols(a, n_pad):
    """Zero-pad the last axis to n_pad."""
    if a.shape[-1] == n_pad:
        return a
    return torch.nn.functional.pad(a, (0, n_pad - a.shape[-1]))


def pretile_mla_weights(params, cfg: MlaConfig, block_n: int = 512):
    """Build the fast-decode weight set under params["fast"] (a one-time load
    transform, as the JAX package's):
      * the five big int8 banks pretiled to [L, NB, K, bn] panels
        (ops/matmul.py::pretile_weight_bank), transposed to [K, N] where the
        checkpoint stores [out, in], with N zero-padded up to a panel
        multiple (wdqkv's 2112 becomes 3072 at bn = 1024) and the
        intermediate of w13 / w2 padded to a panel multiple; zero columns
        give exact zeros, so sliced outputs are unchanged;
      * wuk / wuv as bf16.
    The originals stay (the serving path and the tests read them). The JAX
    package also keeps contracted-axis-last copies of wuk / wuv for
    SKT_WUKV_T, which is off; the port makes none. Returns params."""
    bn = block_n
    lay = params["layers"]
    f = cfg.intermediate_size
    f_pad = -(-f // min(bn, f)) * min(bn, f)

    def tile(kn):
        bn_i = min(bn, kn.shape[-1])
        n_pad = -(-kn.shape[-1] // bn_i) * bn_i
        return pretile_weight_bank(_pad_cols(kn, n_pad), bn_i), n_pad

    def tile_out_in(bank):
        q, n_pad = tile(bank["q"].transpose(1, 2))
        return {"q": q, "scale": _pad_cols(bank["descale"], n_pad),
                "bias": _pad_cols(bank["bias"], n_pad)}

    w13q, w13s = lay["w13"]["q"], lay["w13"]["scale"]
    w13_pad = torch.cat([_pad_cols(w13q[..., :f], f_pad), _pad_cols(w13q[..., f:], f_pad)], -1)
    w13s_pad = torch.cat([_pad_cols(w13s[..., :f], f_pad), _pad_cols(w13s[..., f:], f_pad)], -1)
    w2_pad = torch.nn.functional.pad(lay["w2"]["q"], (0, 0, 0, f_pad - f))
    params["fast"] = {
        "wdqkv": tile_out_in(lay["wdqkv"]),
        "wuq": tile_out_in(lay["wuq"]),
        "wo": {"q": tile(lay["wo"]["q"])[0], "scale": lay["wo"]["scale"]},
        "w13": {"q": tile(w13_pad)[0], "scale": w13s_pad},
        "w2": {"q": tile(w2_pad)[0], "scale": lay["w2"]["scale"]},
        "wuk": lay["wuk"].to(torch.bfloat16),
        "wuv": lay["wuv"].to(torch.bfloat16),
    }
    return params


def _qmm(x, w):
    """x [M, K] x a plain weight {q [K, N], scale [N]}: per-token quant, then
    kernel A with L = 1 (quant_matmul_int8)."""
    xq, xs = per_token_quant_int8(x)
    return quant_matmul_int8(xq, w["q"], xs, w["scale"], out_dtype=x.dtype)


def _qmm_l(x, bank, li: int, out_dtype=None):
    """Per-token quant + the stacked GEMM at layer li (kernel A on [L, K, N],
    K1 on a pretiled bank)."""
    xq, xs = per_token_quant_int8(x)
    return quant_matmul_int8_stacked(xq, bank["q"], li, xs, bank["scale"],
                                     out_dtype=out_dtype or x.dtype)


def _nrq_l(x, norm_w, bank, li: int, eps: float, out_dtype=None):
    """RMSNorm -> per-token quant -> stacked GEMM at layer li: K2 per_token
    when M >= 8, else the unfused pair, as the JAX package gates it."""
    od = out_dtype or x.dtype
    if x.shape[0] >= 8:
        beta = torch.zeros((x.shape[-1],), dtype=torch.float32, device=x.device)
        return rmsnorm_quant_gemm(x, norm_w, beta, bank["q"], bank["scale"], None, li=li,
                                  quant_mode="per_token", eps=eps, out_dtype=od)
    return _qmm_l(_rms(x, norm_w, eps), bank, li, out_dtype=od)


def _rmsq_gemm_pt(x, gamma, beta, bank, li, qscale, qoffset, eps):
    """One mla_preprocess RMSNormQuant->GEMM stage on a pretiled bank: K2 in
    its per_tensor mode with the int32 bias and the fp16 rounding. (The JAX
    package takes its unfused reference below M = 8; that is the same
    formula.)"""
    return rmsnorm_quant_gemm(x, gamma, beta, bank["q"], bank["scale"], bank["bias"],
                              qscale, qoffset, li=li, quant_mode="per_tensor", eps=eps,
                              quant_cast="fp16")


def decode_step_c(params, cfg: MlaConfig, kv_cache, input_ids, positions, seq_lens,
                  block_table, slot_mapping):
    """Fast MLA decode over the COMBINED latent cache (bench.py --config mla).

    Needs pretile_mla_weights(params, cfg) and an init_kv_cache_combined
    cache (bf16, or the int8 dict). input_ids/positions/slot_mapping [B];
    seq_lens [B] INCLUDING the new token; block_table [B, max_pages]. The
    cache is read-only inside the layer loop; all layers' new latent rows
    are appended after it, in place. Returns (logits [B, V] f32, kv_cache)."""
    b = input_ids.shape[0]
    heads = cfg.num_heads
    lkv, lrope = cfg.kv_lora_rank, cfg.qk_rope_dim
    qn, kp = cfg.qk_nope_dim, cfg.qk_rope_dim
    ps = cfg.page_size
    int8_kv = isinstance(kv_cache, dict)
    kv_arr = kv_cache["kv"] if int8_kv else kv_cache
    kv_s = kv_cache["s"] if int8_kv else None
    sm_scale = 1.0 / ((qn + kp) ** 0.5)
    fast = params["fast"]
    lay = params["layers"]
    f_pad = fast["w2"]["q"].shape[2]      # the padded intermediate
    eps = cfg.rms_eps

    x = params["embed"][input_ids.long()]
    cos = params["cos"][positions.long()]
    sin = params["sin"][positions.long()]
    cached = seq_lens - 1
    new_rows = []
    for li in range(cfg.num_layers):
        # stage 1: RMSNormQuant -> wdqkv (fp16-rounded per-tensor quant)
        fused = _rmsq_gemm_pt(x, lay["gamma0"][li], lay["beta0"][li], fast["wdqkv"], li,
                              lay["qscale0"][li], lay["qoffset0"][li], eps)
        latent = fused[:, : lkv + lrope]
        cq = fused[:, lkv + lrope: cfg.mm1_out]
        ctkv = _rms(latent[:, :lkv], lay["gamma2"][li], eps)
        k_pe = latent[:, lkv:]
        # stage 2: RMSNormQuant -> wuq on the f32 slice cq (no copy)
        q_out = _rmsq_gemm_pt(cq, lay["gamma1"][li], lay["beta1"][li], fast["wuq"], li,
                              lay["qscale1"][li], lay["qoffset1"][li], eps)
        q_out = q_out[:, : heads * (qn + kp)].reshape(b, heads, qn + kp)
        q_nope, q_pe = q_out[..., :qn], q_out[..., qn:]
        q_nope = torch.einsum("bhd,hdk->bhk", q_nope.float(), fast["wuk"][li].float())
        q_pe = mp.rotate_half_rope(q_pe, cos[:, None, :], sin[:, None, :])
        k_pe = mp.rotate_half_rope(k_pe, cos, sin)
        new_latent = torch.cat([ctkv, k_pe], -1).to(x.dtype)
        q = torch.cat([q_nope, q_pe.float()], -1).to(x.dtype)
        att = decode_mla_v3_defer(q, new_latent, kv_arr, cached, block_table, sm_scale, ps,
                                  lkv, layer_idx=li, kv_scales=kv_s)
        att = torch.einsum("bhk,hkd->bhd", att.float(), fast["wuv"][li].float())
        x = x + _qmm_l(att.reshape(b, -1).to(x.dtype), fast["wo"], li)
        g32 = _nrq_l(x, lay["post_norm"][li], fast["w13"], li, eps,
                     out_dtype=torch.float32).float()
        act = (g32[:, :f_pad] * torch.sigmoid(g32[:, :f_pad]) * g32[:, f_pad:]).to(x.dtype)
        x = x + _qmm_l(act, fast["w2"], li)
        new_rows.append(new_latent)

    new_all = torch.stack(new_rows)                                   # [L, B, C]
    pages, offs = _pages_offs(slot_mapping, ps, kv_arr.shape[1])
    if int8_kv:
        new_q, new_s = quant_latent_rows(new_all)
        append_mla(new_q, kv_arr, pages, offs)
        scatter_latent_scales(kv_s, new_s, pages, offs)
    else:
        append_mla(new_all, kv_arr, pages, offs)
    x = _rms(x, params["final_norm"], eps)
    return _qmm(x, params["lm_head"]).float(), kv_cache


def _preprocess(x, lay, li, cos, sin, ckv_c, kr_c, slots):
    """mla_preprocess of layer li on the split caches (written in place)."""
    return mp.mla_preprocess(
        x, lay["gamma0"][li], lay["beta0"][li],
        lay["wdqkv"]["q"][li], lay["wdqkv"]["descale"][li],
        lay["gamma1"][li], lay["beta1"][li],
        lay["wuq"]["q"][li], lay["wuq"]["descale"][li],
        lay["gamma2"][li], cos, sin, lay["wuk"][li],
        ckv_c, kr_c, slots,
        lay["qscale0"][li], lay["qoffset0"][li], lay["wdqkv"]["bias"][li],
        lay["qscale1"][li], lay["qoffset1"][li], lay["wuq"]["bias"][li],
        cache_mode="krope_ctkv",
        wdqkv_kn=lay["wdqkv"]["kn"][li] if "kn" in lay["wdqkv"] else None,
        wuq_kn=lay["wuq"]["kn"][li] if "kn" in lay["wuq"] else None)


def _ffn(x, lay, li, cfg):
    """post RMSNorm -> w13 -> SwiGLU -> w2, residual added (kernel A)."""
    f = cfg.intermediate_size
    h2 = _rms(x, lay["post_norm"][li], cfg.rms_eps)
    ug = _qmm_l(h2, lay["w13"], li).float()
    act = (ug[:, :f] * torch.sigmoid(ug[:, :f]) * ug[:, f:]).to(x.dtype)
    return x + _qmm_l(act, lay["w2"], li)


def decode_step(params, cfg: MlaConfig, ckv_cache, krope_cache, input_ids, positions,
                seq_lens, block_table, slot_mapping):
    """One MLA decode step on split caches [L, P, ps, D] (serving.MlaEngine).
    seq_lens [B] INCLUDING the new token, whose latent row mla_preprocess
    writes before attention reads it. Updates the caches in place; returns
    (logits [B, V] f32, ckv_cache, krope_cache)."""
    b = input_ids.shape[0]
    sm_scale = 1.0 / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    lay = params["layers"]
    x = params["embed"][input_ids.long()]
    cos = params["cos"][positions.long()]
    sin = params["sin"][positions.long()]
    for li in range(cfg.num_layers):
        out = _preprocess(x, lay, li, cos, sin, ckv_cache[li], krope_cache[li], slot_mapping)
        q = torch.cat([out.q_nope.float(), out.q_pe.float()], -1).to(x.dtype)
        att = decode_mla(q, ckv_cache[li], krope_cache[li], seq_lens, block_table, sm_scale,
                         cfg.page_size)
        att = torch.einsum("bhk,hkd->bhd", att.float(), lay["wuv"][li])
        x = x + _qmm_l(att.reshape(b, -1).to(x.dtype), lay["wo"], li)
        x = _ffn(x, lay, li, cfg)
    x = _rms(x, params["final_norm"], cfg.rms_eps)
    return _qmm(x, params["lm_head"]).float(), ckv_cache, krope_cache


def _attend_rows(qn, qp, ckv_rows, kr_rows, allowed, wuv, sm_scale):
    """Plain latent attention: qn [B, T, H, Lkv], qp [B, T, H, R], rows
    [B, N, .] f32, allowed [B, T, N] -> [B, T, H, v_head] f32."""
    s = (torch.einsum("bthk,bnk->bthn", qn, ckv_rows)
         + torch.einsum("bthr,bnr->bthn", qp, kr_rows)) * sm_scale
    s = torch.where(allowed[:, :, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    att = torch.einsum("bthn,bnk->bthk", p, ckv_rows)
    return torch.einsum("bthk,hkd->bthd", att, wuv)


def decode_verify_step(params, cfg: MlaConfig, ckv_cache, krope_cache, input_ids,
                       positions, tree_mask, seq_lens, block_table, slot_mapping):
    """Multi-token MLA step: B rows of dt tokens each, attended over each
    row's cached prefix (seq_lens, EXCLUDING the dt tokens) and, among the
    dt tokens, where tree_mask [B, dt, dt] allows. The engine's chunked
    prefill is this with a causal mask. Updates the caches in place; returns
    (logits [B, dt, V] f32, ckv_cache, krope_cache)."""
    b, dt = input_ids.shape
    n = b * dt
    heads = cfg.num_heads
    sm_scale = 1.0 / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    npos = block_table.shape[1] * cfg.page_size
    lay = params["layers"]
    dev = input_ids.device
    x = params["embed"][input_ids.long()].reshape(n, -1)
    cos = params["cos"][positions.reshape(-1).long()]
    sin = params["sin"][positions.reshape(-1).long()]
    slots = slot_mapping.reshape(-1)
    nidx = torch.arange(npos, device=dev)
    off = nidx[None, :] - seq_lens.long()[:, None]                    # [B, N]
    in_tree = (off >= 0) & (off < dt)
    tree_ok = torch.gather(tree_mask, 2,
                           off.clamp(0, dt - 1)[:, None, :].expand(b, dt, npos))
    allowed = ((nidx[None, None, :] < seq_lens.long()[:, None, None])
               | (in_tree[:, None, :] & tree_ok))                       # [B, dt, N]
    bt = block_table.long()
    for li in range(cfg.num_layers):
        out = _preprocess(x, lay, li, cos, sin, ckv_cache[li], krope_cache[li], slots)
        ckv_rows = ckv_cache[li][bt].reshape(b, npos, -1).float()
        kr_rows = krope_cache[li][bt].reshape(b, npos, -1).float()
        att = _attend_rows(out.q_nope.reshape(b, dt, heads, -1).float(),
                           out.q_pe.reshape(b, dt, heads, -1).float(),
                           ckv_rows, kr_rows, allowed, lay["wuv"][li], sm_scale)
        x = x + _qmm_l(att.reshape(n, -1).to(x.dtype), lay["wo"], li)
        x = _ffn(x, lay, li, cfg)
    x = _rms(x, params["final_norm"], cfg.rms_eps)
    return _qmm(x, params["lm_head"]).float().reshape(b, dt, -1), ckv_cache, krope_cache


def prefill_step(params, cfg: MlaConfig, ckv_cache, krope_cache, input_ids, positions,
                 slot_mapping):
    """Single-sequence MLA prefill of T tokens from an empty prefix: causal
    latent attention over the chunk's own rows, read back from their cache
    slots. Updates the caches in place; returns (logits [T, V] f32,
    ckv_cache, krope_cache)."""
    t = input_ids.shape[0]
    heads = cfg.num_heads
    sm_scale = 1.0 / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    lay = params["layers"]
    ps = cfg.page_size
    x = params["embed"][input_ids.long()]
    cos = params["cos"][positions.long()]
    sin = params["sin"][positions.long()]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    page, off = slot_mapping.long() // ps, slot_mapping.long() % ps
    for li in range(cfg.num_layers):
        out = _preprocess(x, lay, li, cos, sin, ckv_cache[li], krope_cache[li], slot_mapping)
        ckv_rows = ckv_cache[li][page, off].float()
        kr_rows = krope_cache[li][page, off].float()
        att = _attend_rows(out.q_nope.float()[None], out.q_pe.float()[None], ckv_rows[None],
                           kr_rows[None], causal[None], lay["wuv"][li], sm_scale)[0]
        x = x + _qmm_l(att.reshape(t, -1).to(x.dtype), lay["wo"], li)
        x = _ffn(x, lay, li, cfg)
    x = _rms(x, params["final_norm"], cfg.rms_eps)
    return _qmm(x, params["lm_head"]).float(), ckv_cache, krope_cache
