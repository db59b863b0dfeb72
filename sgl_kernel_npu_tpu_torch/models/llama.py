"""Llama-3-class GQA decoder with W8A8 int8 weights and an int8 KV cache on
token-major pages (counterpart of the JAX package's models/llama.py, its "tm"
branches of `decode_step_kv` and `prefill_batch_step_kv`).

Parameters are a dict of tensors with the JAX package's tree:
  embed [V, H] bf16, final_norm [H] bf16, lm_head {q [H, V] int8, scale [V]},
  cos_sin [max_pos, D] f32, layers {wqkv|wo|w13|w2: {q [L, K, N] int8,
  scale [L, N] f32}, input_norm|post_norm [L, H] bf16}.
Layers run as a Python loop; each GEMM reads its layer straight out of the
stacked bank (kernel A), attention reads the cache without writing it
(kernels B and C), and one append after the loop writes every layer's new
rows (kernel D). Every cast of the JAX code is kept where it has one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..ops.attention import decode_v8 as _v8
from ..ops.attention.decode_v9 import decode_gqa_v9_int8_defer
from ..ops.attention.paged_prefill_tm import paged_prefill_attention_tm
from ..ops.matmul import quant_matmul_int8_stacked
from ..ops.quant import per_token_quant_int8
from ..ops.rope import apply_rope, make_cos_sin_cache
from ..utils import resolve_device


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    rope_base: float = 500000.0
    rms_eps: float = 1e-5
    page_size: int = 128
    max_position: int = 8192
    int8_kv: bool = False

    @property
    def q_size(self):
        return self.num_heads * self.head_dim

    @property
    def kv_size(self):
        return self.num_kv_heads * self.head_dim


def tiny_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=8,
                num_kv_heads=4, head_dim=32, intermediate_size=512,
                page_size=16, max_position=256)
    base.update(kw)
    return LlamaConfig(**base)


_BIG_WEIGHTS = ("wqkv", "wo", "w13", "w2")


def _quantize_w(rng, shape, device, scale=0.02):
    """Random int8 weight + per-output-channel f32 scale ([out] = last dim)."""
    w8 = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    s = torch.full((shape[-1],), scale / 127.0, dtype=torch.float32)
    return {"q": w8.to(device), "scale": s.to(device)}


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Seeded numpy init with the same draws, in the same order, as the JAX
    package's init_params, so the weights are bit-identical."""
    dev = resolve_device(device)
    rng = np.random.default_rng(int(seed))
    l = cfg.num_layers
    h, qs, kvs, f = cfg.hidden_size, cfg.q_size, cfg.kv_size, cfg.intermediate_size
    layer = {
        "wqkv": _quantize_w(rng, (l, h, qs + 2 * kvs), dev),
        "wo": _quantize_w(rng, (l, qs, h), dev),
        "w13": _quantize_w(rng, (l, h, 2 * f), dev),
        "w2": _quantize_w(rng, (l, f, h), dev),
        "input_norm": torch.ones((l, h), dtype=torch.bfloat16, device=dev),
        "post_norm": torch.ones((l, h), dtype=torch.bfloat16, device=dev),
    }
    for name in _BIG_WEIGHTS:   # stacked banks carry per-layer scales [L, out]
        scale = layer[name]["scale"]
        layer[name]["scale"] = scale[None].expand(l, scale.shape[0]).contiguous()
    embed = rng.standard_normal((cfg.vocab_size, h), dtype=np.float32) * 0.02
    return {
        "embed": torch.from_numpy(embed).to(dev).to(torch.bfloat16),
        "final_norm": torch.ones((h,), dtype=torch.bfloat16, device=dev),
        "lm_head": _quantize_w(rng, (h, cfg.vocab_size), dev),
        "layers": layer,
        "cos_sin": make_cos_sin_cache(cfg.max_position, cfg.head_dim,
                                      cfg.rope_base, device=dev),
    }


def params_from_jax(np_params, device="cuda"):
    """Carry the JAX parameter tree, given as numpy arrays (bf16 leaves as
    ml_dtypes bfloat16 or float32), into the port's dict on `device`."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return conv(tree)

    return walk(np_params)


def init_kv_cache(cfg: LlamaConfig, num_pages: int, layout: str = "tm",
                  device="cuda"):
    """Token-major int8 pages: k/v [L, P, ps*hkv, D], scales [L, P, 1, ps*hkv]
    f32, row r = t*hkv + h. The only layout of this port so far."""
    if layout != "tm" or not cfg.int8_kv:
        raise NotImplementedError(
            "the port serves the int8 token-major ('tm') layout only; the hm "
            "and tm2 layouts and bf16 caches come in later slices")
    dev = resolve_device(device)
    rows = cfg.page_size * cfg.num_kv_heads
    shape = (cfg.num_layers, num_pages, rows, cfg.head_dim)
    sshape = (cfg.num_layers, num_pages, 1, rows)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=dev),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=dev)}


def _rmsnorm(x, w, eps):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _qmm_l(x, bank, li: int):
    """x [M, K] bf16 x bank {q: [L, K, N], scale: [L, N]} at layer li."""
    xq, xs = per_token_quant_int8(x)
    return quant_matmul_int8_stacked(xq, bank["q"], li, xs, bank["scale"],
                                     out_dtype=x.dtype)


def _swiglu(g32, f):
    return g32[:, :f] * torch.sigmoid(g32[:, :f]) * g32[:, f:]


def _final_logits(x, params, cfg):
    """final RMSNorm -> lm_head logits (f32); lm_head runs through kernel A
    as a one-layer bank."""
    x = _rmsnorm(x, params["final_norm"], cfg.rms_eps)
    lm = params["lm_head"]
    xq, xs = per_token_quant_int8(x)
    out = quant_matmul_int8_stacked(xq, lm["q"][None], 0, xs, lm["scale"][None],
                                    out_dtype=x.dtype)
    return out.float()


def _pages_offs(slots, ps, num_pages):
    """slot -> (page, offset); slot < 0 becomes the page sentinel P (skip)."""
    slots = slots.long()
    pages = torch.where(slots >= 0, slots // ps, torch.full_like(slots, num_pages))
    offs = torch.where(slots >= 0, slots % ps, torch.zeros_like(slots))
    return pages, offs


def decode_step_kv(params, cfg: LlamaConfig, kv_cache, input_ids, positions,
                   seq_lens, block_table, slot_mapping):
    """One continuous-batching decode step on token-major pages.

    input_ids/positions/slot_mapping [B]; seq_lens [B] (length INCLUDING the
    new token); block_table [B, max_pages]. Padded rows carry slot -1.
    Updates kv_cache in place; returns (logits [B, V] f32, kv_cache)."""
    b = input_ids.shape[0]
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sm_scale = 1.0 / (d ** 0.5)
    ps = cfg.page_size
    big = params["layers"]
    x = params["embed"][input_ids.long()]
    cs = params["cos_sin"][positions.long()]
    cos, sin = cs[:, None, : d // 2], cs[:, None, d // 2:]
    cached = seq_lens - 1
    f = cfg.intermediate_size
    k_new, v_new = [], []
    for li in range(cfg.num_layers):
        qkv = _qmm_l(_rmsnorm(x, big["input_norm"][li], cfg.rms_eps),
                     big["wqkv"], li)
        q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size], -1)
        q = apply_rope(q.reshape(b, hq, d), cos, sin)
        k = apply_rope(k.reshape(b, hkv, d), cos, sin)
        v = v.reshape(b, hkv, d)
        att = decode_gqa_v9_int8_defer(
            q, k, v, kv_cache["k"], kv_cache["v"], kv_cache["ks"],
            kv_cache["vs"], cached, block_table, sm_scale, ps, layer_idx=li)
        x = x + _qmm_l(att.reshape(b, -1), big["wo"], li)
        g32 = _qmm_l(_rmsnorm(x, big["post_norm"][li], cfg.rms_eps),
                     big["w13"], li).float()
        x = x + _qmm_l(_swiglu(g32, f).to(x.dtype), big["w2"], li)
        k_new.append(k)
        v_new.append(v)

    lcount = cfg.num_layers
    kq, vq, ksn, vsn = _v8.quant_rows_int8(
        torch.stack(k_new).reshape(lcount * b, hkv, d),
        torch.stack(v_new).reshape(lcount * b, hkv, d))
    pages, offs = _pages_offs(slot_mapping, ps, kv_cache["k"].shape[1])
    _v8.append_tm_int8(kq.reshape(lcount, b, hkv, d),
                       vq.reshape(lcount, b, hkv, d),
                       kv_cache["k"], kv_cache["v"], pages, offs)
    _v8.scatter_scales_tm(kv_cache["ks"], kv_cache["vs"], ksn, vsn, pages, offs)
    return _final_logits(x, params, cfg), kv_cache


def prefill_batch_step_kv(params, cfg: LlamaConfig, kv_cache, input_ids,
                          valid_lens, positions, slot_mapping, block_tables,
                          prefix_lens):
    """Batched chunked prefill on token-major pages: S chunks padded to [S, T].

    input_ids/positions/slot_mapping [S, T] (padding rows carry slot -1);
    valid_lens [S]; block_tables [S, max_pages]; prefix_lens [S] tokens of
    each sequence already in the cache. The in-flight chunk is attended in
    bf16; all layers' chunk rows are quantized and appended after the loop.
    Updates kv_cache in place; returns (logits [S, T, V] f32, kv_cache)."""
    s, t = input_ids.shape
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sm_scale = 1.0 / (d ** 0.5)
    ps = cfg.page_size
    n_tok = s * t
    big = params["layers"]
    x = params["embed"][input_ids.long()]                        # [S, T, H]
    cs = params["cos_sin"][positions.long()]
    cos, sin = cs[:, :, None, : d // 2], cs[:, :, None, d // 2:]
    f = cfg.intermediate_size
    k_all, v_all = [], []
    for li in range(cfg.num_layers):
        h1 = _rmsnorm(x, big["input_norm"][li], cfg.rms_eps)
        qkv = _qmm_l(h1.reshape(n_tok, -1), big["wqkv"], li)
        q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size], -1)
        q = apply_rope(q.reshape(s, t, hq, d), cos, sin)
        k = apply_rope(k.reshape(s, t, hkv, d), cos, sin)
        v = v.reshape(s, t, hkv, d)
        att = paged_prefill_attention_tm(
            q, k, v, kv_cache["k"], kv_cache["v"], kv_cache["ks"],
            kv_cache["vs"], block_tables, prefix_lens, valid_lens, sm_scale,
            ps, layer_idx=li)
        x = x + _qmm_l(att.reshape(n_tok, -1), big["wo"], li).reshape(s, t, -1)
        h2 = _rmsnorm(x, big["post_norm"][li], cfg.rms_eps)
        g32 = _qmm_l(h2.reshape(n_tok, -1), big["w13"], li).float()
        act = _swiglu(g32, f).to(x.dtype)
        x = x + _qmm_l(act, big["w2"], li).reshape(s, t, -1)
        k_all.append(k)
        v_all.append(v)

    lcount = cfg.num_layers
    kq, vq, ksn, vsn = _v8.quant_rows_int8(
        torch.stack(k_all).reshape(lcount * n_tok, hkv, d),
        torch.stack(v_all).reshape(lcount * n_tok, hkv, d))
    pages, offs = _pages_offs(slot_mapping.reshape(-1), ps, kv_cache["k"].shape[1])
    _v8.append_tm_int8(kq.reshape(lcount, n_tok, hkv, d),
                       vq.reshape(lcount, n_tok, hkv, d),
                       kv_cache["k"], kv_cache["v"], pages, offs)
    _v8.scatter_scales_prefill_tm(
        kv_cache["ks"], kv_cache["vs"], ksn.reshape(lcount, s, t, hkv),
        vsn.reshape(lcount, s, t, hkv), block_tables, prefix_lens, valid_lens)
    logits = _final_logits(x.reshape(n_tok, -1), params, cfg)
    return logits.reshape(s, t, -1), kv_cache
