"""Llama-3-class GQA decoder with W8A8 int8 weights on a paged KV cache
(counterpart of the JAX package's models/llama.py): int8 token-major ("tm")
pages for `decode_step_kv` and `prefill_batch_step_kv`, int8 "tm2" pages for
`decode_step_kv`, and page-major ("hm") pages [L, P, Hkv, ps, D], bf16 or
int8, for both.

Parameters are a dict of tensors with the JAX package's tree:
  embed [V, H] bf16, final_norm [H] bf16, lm_head {q [H, V] int8, scale [V]},
  cos_sin [max_pos, D] f32, layers {wqkv|wo|w13|w2: {q [L, K, N] int8,
  scale [L, N] f32}, input_norm|post_norm [L, H] bf16}.
`pretile_big_weights` turns the four banks into [L, N/bn, K, bn] and lm_head
into [1, V/bn, H, bn] (ops/matmul.py::pretile_weight_bank).
Layers run as a Python loop; each GEMM reads its layer straight out of the
stacked bank (kernel A, or K1 on a pretiled bank; wqkv and w13 on a pretiled
bank at M >= 8 go through the fused RMSNorm-quant GEMM, K2). On tm and tm2
pages attention reads the cache without writing it (kernels B and C on tm
pages, K3 on tm2 pages), and one append after the loop writes every layer's
new rows (kernel D, or K4). On hm pages decode attends read-only too (K14,
or K16's deferred contracts with SKT_DECODE_ATTN=v3) and scatters all
layers' rows after the loop, unless SKT_DECODE_DEFER or SKT_DECODE_FLAT is
off: then each layer writes its row and attends with K16's v3 contract;
prefill writes each layer's chunk, then attends with K15. Every cast of the
JAX code is kept where it has one.

The rest of the JAX module's single-card surface: `decode_step` (the bf16
tuple-cache wrapper), `prefill_step` (one sequence, plain causal
attention), `prefill_chunk_step(_kv)` (one sequence's chunk over a cached
prefix: tm pages through prefill_batch_step_kv, hm pages through K15),
`decode_verify_step` (draft trees, plain attention over the gathered prefix
and the masked drafts) and `add_lora_adapters`, whose per-layer adapters
the decode and batched prefill steps apply on wo's output for `lora_ids`
(ops/lora.py's BGMV pair). Tensor parallelism: `shard_cfg_tp`,
`shard_params_tp` and `decode_step_tp`, SPMD over a torch.distributed group
(decode_step_kv's `tp_group` all-reduces wo's and w2's outputs).

Two of the JAX package's knobs route decode_step_kv's GEMMs through K2 on
pretiled banks at M >= 8, both off by default as there: SKT_FUSED_LM
(lm_head: the final RMSNorm fused, f32 out) and SKT_FUSED_QGEMM (wo and w2:
the per-token quant fused, apply_norm=False). SKT_GEMM_BK, a TPU K tile of
an int32 accumulation, changes no result and has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..ops.attention import decode_v3 as _v3
from ..ops.attention import decode_v6 as _v6
from ..ops.attention import decode_v8 as _v8
from ..ops.attention import decode_v11 as _v11
from ..ops.attention.decode_v9 import decode_gqa_v9_int8_defer
from ..ops.attention.decode_v13 import decode_gqa_v13_int8_defer
from ..ops import lora as _lora
from ..ops.attention.paged_prefill import (paged_prefill_attention,
                                           paged_prefill_attention_batch)
from ..ops.attention.paged_prefill_tm import paged_prefill_attention_tm
from ..ops.matmul import (pretile_weight_bank, quant_matmul_int8,
                          quant_matmul_int8_stacked)
from ..ops.quant import per_token_quant_int8
from ..ops.rmsq_gemm import rmsnorm_quant_gemm
from ..ops.rope import apply_rope, make_cos_sin_cache
from ..utils import env, resolve_device

_NEG = -1e30


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
    """Carry a JAX tree, given as numpy arrays (bf16 leaves as ml_dtypes
    bfloat16 or float32), into the port's tensors on `device`: dicts stay
    dicts, tuples tuples."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(walk(v) for v in tree)
        return conv(tree)

    return walk(np_params)


def kv_from_jax(np_kv, device="cuda"):
    """A JAX KV cache given as numpy (the hm (k, v) bf16 tuple or an int8
    dict) as the port's cache on `device`."""
    return params_from_jax(np_kv, device)


def tm_layout_ok(cfg: LlamaConfig) -> bool:
    """Whether token-major pages serve this config, as the JAX package
    decides: an int8 cache and the flat deferred decode (SKT_DECODE_FLAT and
    SKT_DECODE_DEFER on). The JAX package's Mosaic tiling conditions have no
    counterpart here: the kernels check their shapes, and the plain versions
    take any."""
    return cfg.int8_kv and env.decode_flat() and env.decode_defer()


def init_kv_cache(cfg: LlamaConfig, num_pages: int, layout: str = "tm",
                  device="cuda"):
    """KV pages, zeroed.

    "tm" (token-major, int8): k/v [L, P, ps*hkv, D], scales [L, P, 1, ps*hkv]
    f32, row r = t*hkv + h. "tm2" (head-major within a page, int8, decode
    only): k/v [L, P, hkv, ps, D], scales [L, P, hkv, ps] f32, row h*ps + t.
    "hm" (page-major): k/v [L, P, hkv, ps, D], a (k, v) bf16 tuple, or with
    cfg.int8_kv an int8 dict with scales [L, P, hkv, 1, ps] f32."""
    if layout not in ("tm", "tm2", "hm"):
        raise ValueError(f"unknown KV layout {layout!r}")
    if layout != "hm" and not cfg.int8_kv:
        raise ValueError(f"the {layout!r} layout is int8 only")
    dev = resolve_device(device)
    if layout == "hm":
        shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, cfg.page_size,
                 cfg.head_dim)
        if not cfg.int8_kv:
            return (torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                    torch.zeros(shape, dtype=torch.bfloat16, device=dev))
        sshape = shape[:3] + (1, cfg.page_size)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.zeros(sshape, dtype=torch.float32, device=dev),
                "vs": torch.zeros(sshape, dtype=torch.float32, device=dev)}
    if layout == "tm2":
        shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, cfg.page_size,
                 cfg.head_dim)
        sshape = shape[:-1]
    else:
        rows = cfg.page_size * cfg.num_kv_heads
        shape = (cfg.num_layers, num_pages, rows, cfg.head_dim)
        sshape = (cfg.num_layers, num_pages, 1, rows)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=dev),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=dev)}


def _rmsnorm(x, w, eps):
    """RMSNorm with 1/rms rounded alike on every device: the sum of squares
    in float64 (every square of a bf16 value is exact there, so the order of
    the sum does not matter), the root in float64, each rounded to f32 once
    (ops/rmsq_gemm.py::_rstd). torch.rsqrt approximates on the card, so an
    f32 mean and rsqrt put the card's rows an ulp from the CPU's."""
    x32 = x.float()
    mean = (x32.double() ** 2).sum(dim=-1, keepdim=True).float() / x.shape[-1]
    rstd = (1.0 / torch.sqrt((mean + eps).double())).float()
    return (x32 * rstd * w.float()).to(x.dtype)


def pretile_big_weights(params, block_n=None):
    """Convert the four stacked banks to the pretiled [L, N/bn, K, bn] layout
    and lm_head to a one-layer [1, V/bn, H, bn] bank
    (ops/matmul.py::pretile_weight_bank); the GEMMs detect the 4-D layout.

    MUTATES `params` in place: each [L, K, N] tensor is dropped as soon as
    its tiled copy replaces it, so that at most one extra bank is alive (as
    long as the caller holds no other reference to it). bn is `block_n`, else
    SKT_GEMM_BN (default 512); Llama-3's vocabulary of 128256 does not divide
    by 512, so lm_head falls through the panel widths 768, 384, 256, 128.
    Banks already tiled are left as they are. Returns `params`."""
    bn = block_n or env.env_int("SKT_GEMM_BN", 512)
    for name in _BIG_WEIGHTS:
        bank = params["layers"][name]
        if bank["q"].dim() == 3 and bank["q"].shape[-1] % bn == 0:
            bank["q"] = pretile_weight_bank(bank["q"], bn)
    lm = params.get("lm_head")
    if lm is not None and lm["q"].dim() == 2:
        for lbn in (bn, 768, 384, 256, 128):
            if lm["q"].shape[-1] % lbn == 0:
                lm["q"] = pretile_weight_bank(lm["q"][None], lbn)
                break
    return params


def _qmm(x, w):
    """x [M, K] bf16 x a single weight {q, scale [N]}: q [K, N] (kernel A on
    a one-layer view), or pretiled [1, N/bn, K, bn] (K1)."""
    xq, xs = per_token_quant_int8(x)
    if w["q"].dim() == 4:
        return quant_matmul_int8_stacked(xq, w["q"], 0, xs, w["scale"][None],
                                         out_dtype=x.dtype)
    return quant_matmul_int8(xq, w["q"], xs, w["scale"], out_dtype=x.dtype)


def _qmm_l(x, bank, li: int):
    """x [M, K] bf16 x bank {q: [L, K, N] or [L, N/bn, K, bn], scale: [L, N]}
    at layer li: per-token quant, then kernel A or K1."""
    xq, xs = per_token_quant_int8(x)
    return quant_matmul_int8_stacked(xq, bank["q"], li, xs, bank["scale"],
                                     out_dtype=x.dtype)


def _q_l(x, bank, li: int):
    """wo's and w2's GEMM (inputs with no norm before them): with
    SKT_FUSED_QGEMM on (off by default, as in the JAX package), a pretiled
    bank and M >= 8, the per-token quant folded into K2 (apply_norm=False,
    ones as gamma, zeros as beta); else `_qmm_l`."""
    if bank["q"].dim() == 4 and x.shape[0] >= 8 and env.env_bool("SKT_FUSED_QGEMM", False):
        k = x.shape[-1]
        return rmsnorm_quant_gemm(
            x, torch.ones((k,), dtype=torch.float32, device=x.device),
            torch.zeros((k,), dtype=torch.float32, device=x.device), bank["q"], bank["scale"],
            None, li=li, quant_mode="per_token", apply_norm=False, out_dtype=x.dtype)
    return _qmm_l(x, bank, li)


def _nrq_l(x, norm_w, bank, li: int, eps: float):
    """RMSNorm -> per-token int8 quant -> W8A8 GEMM at layer li: the fused
    kernel K2 on a pretiled bank when M >= 8, else the unfused RMSNorm (bf16
    out) and `_qmm_l`, as the JAX package gates it by default."""
    if bank["q"].dim() == 4 and x.shape[0] >= 8:
        beta = torch.zeros((x.shape[-1],), dtype=torch.float32, device=x.device)
        return rmsnorm_quant_gemm(
            x, norm_w, beta, bank["q"], bank["scale"], None, li=li,
            quant_mode="per_token", eps=eps, out_dtype=x.dtype)
    return _qmm_l(_rmsnorm(x, norm_w, eps), bank, li)


def _swiglu(g32, f):
    """silu(g) * u in f32, the sigmoid taken in float64 and rounded to f32
    once, so that the card and the CPU round it alike (their f32 sigmoids
    differ in the last bit)."""
    g = g32[:, :f]
    return g * torch.sigmoid(g.double()).float() * g32[:, f:]


def _final_logits(x, params, cfg):
    """final RMSNorm -> lm_head logits (f32)."""
    x = _rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return _qmm(x, params["lm_head"]).float()


def _decode_logits(x, params, cfg):
    """decode_step_kv's logits: with SKT_FUSED_LM on (off by default, as in
    the JAX package), a pretiled lm_head and M >= 8, K2 per_token with the
    final norm as gamma, a zero beta and f32 out; else `_final_logits`."""
    lm = params["lm_head"]
    if lm["q"].dim() == 4 and x.shape[0] >= 8 and env.env_bool("SKT_FUSED_LM", False):
        return rmsnorm_quant_gemm(
            x, params["final_norm"],
            torch.zeros((x.shape[-1],), dtype=torch.float32, device=x.device), lm["q"],
            lm["scale"][None], None, li=0, quant_mode="per_token", eps=cfg.rms_eps,
            out_dtype=torch.float32)
    return _final_logits(x, params, cfg)


def _pages_offs(slots, ps, num_pages):
    """slot -> (page, offset); slot < 0 becomes the page sentinel P (skip)."""
    slots = slots.long()
    pages = torch.where(slots >= 0, slots // ps, torch.full_like(slots, num_pages))
    offs = torch.where(slots >= 0, slots % ps, torch.zeros_like(slots))
    return pages, offs


def _is_hm(kv_cache) -> bool:
    """Page-major caches: the bf16 (k, v) tuple, or an int8 dict whose
    scales are 5-D [L, P, hkv, 1, ps] (tm2's are 4-D, tm's k is 4-D)."""
    return isinstance(kv_cache, tuple) or kv_cache["ks"].dim() == 5


def _layer(kv_cache, li: int):
    """Layer li's pages of every cache array (views)."""
    if isinstance(kv_cache, tuple):
        return tuple(a[li] for a in kv_cache)
    return {k: a[li] for k, a in kv_cache.items()}


def _pool(kv_cache):
    """Every layer's pages as one [L*P, ...] pool (views): page p of layer li
    is pool page li*P + p."""
    def fold(a):
        return a.view(a.shape[0] * a.shape[1], *a.shape[2:])
    if isinstance(kv_cache, tuple):
        return tuple(fold(a) for a in kv_cache)
    return {k: fold(a) for k, a in kv_cache.items()}


def _scatter_hm(k, v, kv, slots):
    """Write rows k, v [T, hkv, D] into page-major pages (a tuple or an int8
    dict of one layer or of the pool) at slots [T], in place."""
    if isinstance(kv, tuple):
        _v3.reshape_and_cache_gqa_page_major(k, v, kv[0], kv[1], slots)
    else:
        _v3.reshape_and_cache_gqa_page_major_int8(k, v, kv["k"], kv["v"], kv["ks"],
                                                  kv["vs"], slots)


def _decode_qkv(x, big, li: int, cfg: LlamaConfig, cos, sin):
    """Layer li's RMSNorm + wqkv + RoPE on the decode rows x [B, H]."""
    b = x.shape[0]
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qkv = _nrq_l(x, big["input_norm"][li], big["wqkv"], li, cfg.rms_eps)
    q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size], -1)
    q = apply_rope(q.reshape(b, hq, d), cos, sin)
    k = apply_rope(k.reshape(b, hkv, d), cos, sin)
    return q, k, v.reshape(b, hkv, d)


def _lora_wo(att, wo_out, big, li: int, lora_ids):
    """The multi-LoRA hook on wo's output (the JAX package's BGMV hook):
    wo_out + B_id (A_id att) for each row's adapter id, 0 for id -1; with
    no ids, wo_out as it is."""
    if lora_ids is None:
        return wo_out
    shrunk = _lora.bgmv_shrink(att, big["lora_wo_A"][li], lora_ids)
    return _lora.bgmv_expand(shrunk, big["lora_wo_B"][li], lora_ids, wo_out, 0,
                             wo_out.shape[-1])


def _reduce(y, tp_group):
    """Sum a row-parallel GEMM's partial output over the tensor-parallel
    group (the JAX package's psum over its mesh axis); without one, y."""
    if tp_group is not None:
        torch.distributed.all_reduce(y, group=tp_group)
    return y


def _decode_tail(x, att, big, li: int, cfg: LlamaConfig, lora_ids=None, tp_group=None):
    """wo (+ the LoRA hook), residual, RMSNorm + w13, SwiGLU, w2, residual;
    with a tensor-parallel group, wo's output (after the hook) and w2's
    summed over it before each residual add."""
    att = att.reshape(x.shape[0], -1)
    x = x + _reduce(_lora_wo(att, _q_l(att, big["wo"], li), big, li, lora_ids), tp_group)
    g32 = _nrq_l(x, big["post_norm"][li], big["w13"], li, cfg.rms_eps).float()
    return x + _reduce(_q_l(_swiglu(g32, cfg.intermediate_size).to(x.dtype), big["w2"], li),
                       tp_group)


def _hm_attend_defer(q, k, v, kv, cached, block_table, sm_scale, ps):
    """The deferred hm attention (SKT_DECODE_ATTN: v6, K14; or v3, K16) on
    one layer's pages."""
    which = env.decode_attn()
    if isinstance(kv, tuple):
        fn = _v6.decode_gqa_v6_defer if which == "v6" else _v3.decode_gqa_v3_defer
        return fn(q, k, v, kv[0], kv[1], cached, block_table, sm_scale, ps)
    fn = _v6.decode_gqa_v6_int8_defer if which == "v6" else _v3.decode_gqa_v3_int8_defer
    return fn(q, k, v, kv["k"], kv["v"], kv["ks"], kv["vs"], cached, block_table, sm_scale, ps)


def _decode_step_hm(params, cfg, kv_cache, x, cos, sin, seq_lens, block_table,
                    slot_mapping, lora_ids=None, tp_group=None):
    """decode_step_kv on page-major pages (the JAX package's llama.py:443-651):
    the flat deferred branch, or with SKT_DECODE_DEFER or SKT_DECODE_FLAT off
    the in-loop write + v3. The JAX flat branches address layer li's pages as
    pages li*P .. li*P + P - 1 of the [L*P] pool; here layer li's view is
    those same pages, so the JAX flat and per-layer non-deferred branches are
    one loop, and the pool is used only by the deferred after-loop scatter."""
    big = params["layers"]
    sm_scale = 1.0 / (cfg.head_dim ** 0.5)
    ps = cfg.page_size
    lcount = cfg.num_layers
    if env.decode_flat() and env.decode_defer():
        pages = (kv_cache[0] if isinstance(kv_cache, tuple) else kv_cache["k"]).shape[1]
        cached = seq_lens - 1
        k_new, v_new = [], []
        for li in range(lcount):
            q, k, v = _decode_qkv(x, big, li, cfg, cos, sin)
            att = _hm_attend_defer(q, k, v, _layer(kv_cache, li), cached, block_table,
                                   sm_scale, ps)
            x = _decode_tail(x, att, big, li, cfg, lora_ids, tp_group)
            k_new.append(k)
            v_new.append(v)
        # every layer's new rows at once into the [L*P] pool
        off = (torch.arange(lcount, device=x.device) * (pages * ps))[:, None]
        slots = slot_mapping.long()[None, :]
        slots_all = torch.where(slots >= 0, slots + off, -1).reshape(-1)
        b, hkv, d = k_new[0].shape
        _scatter_hm(torch.stack(k_new).reshape(lcount * b, hkv, d),
                    torch.stack(v_new).reshape(lcount * b, hkv, d), _pool(kv_cache),
                    slots_all)
        return x
    for li in range(lcount):
        q, k, v = _decode_qkv(x, big, li, cfg, cos, sin)
        kv = _layer(kv_cache, li)
        _scatter_hm(k, v, kv, slot_mapping)
        if isinstance(kv, tuple):
            att = _v3.decode_gqa_v3(q, kv[0], kv[1], seq_lens, block_table, sm_scale, ps)
        else:
            att = _v3.decode_gqa_v3_int8(q, kv["k"], kv["v"], kv["ks"], kv["vs"], seq_lens,
                                         block_table, sm_scale, ps)
        x = _decode_tail(x, att, big, li, cfg, lora_ids, tp_group)
    return x


def decode_step_kv(params, cfg: LlamaConfig, kv_cache, input_ids, positions,
                   seq_lens, block_table, slot_mapping, lora_ids=None, tp_group=None):
    """One continuous-batching decode step, on page-major ("hm": a bf16 (k,
    v) tuple or an int8 dict with 5-D scales), token-major ("tm") or
    head-major-within-page ("tm2") pages, told apart by the cache as the JAX
    package does: tm k is 4-D, tm2 k is 5-D with 4-D scales.

    input_ids/positions/slot_mapping [B]; seq_lens [B] (length INCLUDING the
    new token); block_table [B, max_pages]. Padded rows carry slot -1.
    lora_ids [B]: each row's adapter (add_lora_adapters; -1 none), applied
    on wo's output in every branch. tp_group: a torch.distributed group of
    tensor-parallel ranks; `cfg` and `params` are then this rank's shard
    (shard_cfg_tp, shard_params_tp), and wo's output (after the LoRA hook)
    and w2's are all-reduced over the group. Updates kv_cache in place;
    returns (logits [B, V] f32, kv_cache)."""
    d = cfg.head_dim
    x = params["embed"][input_ids.long()]
    cos, sin = _rope_cs(params, positions, d)
    if _is_hm(kv_cache):
        x = _decode_step_hm(params, cfg, kv_cache, x, cos, sin, seq_lens, block_table,
                            slot_mapping, lora_ids, tp_group)
        return _decode_logits(x, params, cfg), kv_cache
    is_tm2 = kv_cache["k"].dim() == 5
    attend = decode_gqa_v13_int8_defer if is_tm2 else decode_gqa_v9_int8_defer
    b = input_ids.shape[0]
    hkv = cfg.num_kv_heads
    sm_scale = 1.0 / (d ** 0.5)
    ps = cfg.page_size
    big = params["layers"]
    cached = seq_lens - 1
    k_new, v_new = [], []
    for li in range(cfg.num_layers):
        q, k, v = _decode_qkv(x, big, li, cfg, cos, sin)
        att = attend(q, k, v, kv_cache["k"], kv_cache["v"], kv_cache["ks"],
                     kv_cache["vs"], cached, block_table, sm_scale, ps,
                     layer_idx=li)
        x = _decode_tail(x, att, big, li, cfg, lora_ids, tp_group)
        k_new.append(k)
        v_new.append(v)

    lcount = cfg.num_layers
    kq, vq, ksn, vsn = _v8.quant_rows_int8(
        torch.stack(k_new).reshape(lcount * b, hkv, d),
        torch.stack(v_new).reshape(lcount * b, hkv, d))
    pages, offs = _pages_offs(slot_mapping, ps, kv_cache["k"].shape[1])
    append, scatter = ((_v11.append_tm2_int8, _v11.scatter_scales_tm2) if is_tm2
                       else (_v8.append_tm_int8, _v8.scatter_scales_tm))
    append(kq.reshape(lcount, b, hkv, d), vq.reshape(lcount, b, hkv, d),
           kv_cache["k"], kv_cache["v"], pages, offs)
    scatter(kv_cache["ks"], kv_cache["vs"], ksn, vsn, pages, offs)
    return _decode_logits(x, params, cfg), kv_cache


def _rope_cs(params, positions, d: int):
    """cos, sin [..., 1, D/2] of the positions (any leading shape)."""
    cs = params["cos_sin"][positions.long()]
    return cs[..., None, : d // 2], cs[..., None, d // 2:]


def _prefill_qkv(x, big, li: int, cfg: LlamaConfig, cos, sin):
    """Layer li's RMSNorm, wqkv (kernel A, or K1 on a pretiled bank) and
    RoPE on rows x [..., H]: q [..., Hq, D], k and v [..., Hkv, D]."""
    lead = x.shape[:-1]
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h1 = _rmsnorm(x, big["input_norm"][li], cfg.rms_eps)
    qkv = _qmm_l(h1.reshape(-1, x.shape[-1]), big["wqkv"], li)
    q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size], -1)
    q = apply_rope(q.reshape(*lead, hq, d), cos, sin)
    k = apply_rope(k.reshape(*lead, hkv, d), cos, sin)
    return q, k, v.reshape(*lead, hkv, d)


def _prefill_tail(x, att, big, li: int, cfg: LlamaConfig, lora_ids=None):
    """wo (+ the LoRA hook, lora_ids an id a token), residual, RMSNorm,
    w13, SwiGLU, w2, residual on rows x [..., H]."""
    lead = x.shape[:-1]
    att = att.reshape(x.numel() // x.shape[-1], -1)
    wo_out = _lora_wo(att, _qmm_l(att, big["wo"], li), big, li, lora_ids)
    x = x + wo_out.reshape(*lead, -1)
    h2 = _rmsnorm(x, big["post_norm"][li], cfg.rms_eps)
    g32 = _qmm_l(h2.reshape(-1, x.shape[-1]), big["w13"], li).float()
    act = _swiglu(g32, cfg.intermediate_size).to(x.dtype)
    return x + _qmm_l(act, big["w2"], li).reshape(*lead, -1)


def prefill_batch_step_kv(params, cfg: LlamaConfig, kv_cache, input_ids,
                          valid_lens, positions, slot_mapping, block_tables,
                          prefix_lens, lora_ids=None):
    """Batched chunked prefill: S chunks padded to [S, T], on token-major
    or page-major pages.

    input_ids/positions/slot_mapping [S, T] (padding rows carry slot -1);
    valid_lens [S]; block_tables [S, max_pages]; prefix_lens [S] tokens of
    each sequence already in the cache; lora_ids [S] each chunk's adapter
    (-1 none), applied on wo's output. On tm pages the in-flight chunk is
    attended in bf16 and all layers' chunk rows are quantized and appended
    after the loop; on hm pages each layer writes its chunk (quantized for
    an int8 cache) and then attends the cache (K15), as the JAX package does.
    Updates kv_cache in place; returns (logits [S, T, V] f32, kv_cache)."""
    hm = _is_hm(kv_cache)
    if not hm and kv_cache["k"].dim() != 4:
        raise NotImplementedError("prefill serves the 'tm' and 'hm' caches; 'tm2' is "
                                  "a decode-only layout, as in the JAX package")
    s, t = input_ids.shape
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    sm_scale = 1.0 / (d ** 0.5)
    ps = cfg.page_size
    n_tok = s * t
    big = params["layers"]
    x = params["embed"][input_ids.long()]                        # [S, T, H]
    cos, sin = _rope_cs(params, positions, d)
    flat_slots = slot_mapping.reshape(-1)
    tok_ids = None if lora_ids is None else lora_ids.repeat_interleave(t)
    k_all, v_all = [], []
    for li in range(cfg.num_layers):
        q, k, v = _prefill_qkv(x, big, li, cfg, cos, sin)
        if hm:
            kv = _layer(kv_cache, li)
            _scatter_hm(k.reshape(n_tok, hkv, d), v.reshape(n_tok, hkv, d), kv,
                        flat_slots)
            att = paged_prefill_attention_batch(q, kv, block_tables, prefix_lens,
                                                sm_scale, ps, block_q=min(128, t))
            x = _prefill_tail(x, att.to(x.dtype), big, li, cfg, tok_ids)
            continue
        att = paged_prefill_attention_tm(
            q, k, v, kv_cache["k"], kv_cache["v"], kv_cache["ks"],
            kv_cache["vs"], block_tables, prefix_lens, valid_lens, sm_scale,
            ps, layer_idx=li)
        x = _prefill_tail(x, att, big, li, cfg, tok_ids)
        k_all.append(k)
        v_all.append(v)

    if not hm:
        lcount = cfg.num_layers
        kq, vq, ksn, vsn = _v8.quant_rows_int8(
            torch.stack(k_all).reshape(lcount * n_tok, hkv, d),
            torch.stack(v_all).reshape(lcount * n_tok, hkv, d))
        pages, offs = _pages_offs(flat_slots, ps, kv_cache["k"].shape[1])
        _v8.append_tm_int8(kq.reshape(lcount, n_tok, hkv, d),
                           vq.reshape(lcount, n_tok, hkv, d),
                           kv_cache["k"], kv_cache["v"], pages, offs)
        _v8.scatter_scales_prefill_tm(
            kv_cache["ks"], kv_cache["vs"], ksn.reshape(lcount, s, t, hkv),
            vsn.reshape(lcount, s, t, hkv), block_tables, prefix_lens, valid_lens)
    logits = _final_logits(x.reshape(n_tok, -1), params, cfg)
    return logits.reshape(s, t, -1), kv_cache


def decode_step(params, cfg: LlamaConfig, k_cache, v_cache, input_ids, positions,
                seq_lens, block_table, slot_mapping):
    """The bf16 tuple-cache wrapper of decode_step_kv (page-major pages).
    Returns (logits, k_cache, v_cache)."""
    logits, (kc, vc) = decode_step_kv(params, cfg, (k_cache, v_cache), input_ids,
                                      positions, seq_lens, block_table, slot_mapping)
    return logits, kc, vc


def prefill_step(params, cfg: LlamaConfig, k_cache, v_cache, input_ids, positions,
                 slot_mapping, seq_start=0):
    """Single-sequence prefill on bf16 page-major caches: the [T] tokens
    attend causally to each other only (plain f32 attention, as in the JAX
    package), each layer's rows written at slot_mapping; the GEMMs through
    kernel A (K1 on pretiled banks). `seq_start` is unused, as there.
    Returns (logits [T, V] f32, k_cache, v_cache)."""
    t = input_ids.shape[0]
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // hkv
    sm_scale = 1.0 / (d ** 0.5)
    big = params["layers"]
    x = params["embed"][input_ids.long()]
    cos, sin = _rope_cs(params, positions, d)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    for li in range(cfg.num_layers):
        q, k, v = _prefill_qkv(x, big, li, cfg, cos, sin)
        _scatter_hm(k, v, (k_cache[li], v_cache[li]), slot_mapping)
        sc = torch.einsum("thgd,nhd->hgtn", q.reshape(t, hkv, g, d).float(),
                          k.float()) * sm_scale
        p = torch.softmax(torch.where(causal, sc, torch.full_like(sc, _NEG)), dim=-1)
        att = torch.einsum("hgtn,nhd->thgd", p, v.float())
        x = _prefill_tail(x, att.to(x.dtype), big, li, cfg)
    return _final_logits(x, params, cfg), k_cache, v_cache


def prefill_chunk_step(params, cfg: LlamaConfig, k_cache, v_cache, input_ids, positions,
                       slot_mapping, block_table, prefix_len):
    """The bf16 tuple-cache wrapper of prefill_chunk_step_kv. Returns
    (logits, k_cache, v_cache)."""
    logits, (kc, vc) = prefill_chunk_step_kv(params, cfg, (k_cache, v_cache), input_ids,
                                             positions, slot_mapping, block_table,
                                             prefix_len)
    return logits, kc, vc


def prefill_chunk_step_kv(params, cfg: LlamaConfig, kv_cache, input_ids, positions,
                          slot_mapping, block_table, prefix_len):
    """Chunked prefill of ONE sequence: a [T]-token chunk whose first
    `prefix_len` tokens are already cached (block_table [max_pages]) attends
    causally to itself and fully to the prefix, and is written to the cache.
    Token-major pages go through prefill_batch_step_kv with S = 1, as in the
    JAX package; page-major pages (a bf16 tuple or an int8 dict) write each
    layer's chunk, then attend through K15 (paged_prefill_attention).
    Updates kv_cache in place; returns (logits [T, V] f32, kv_cache)."""
    t = input_ids.shape[0]
    if not _is_hm(kv_cache):
        dev = input_ids.device
        logits, kv_cache = prefill_batch_step_kv(
            params, cfg, kv_cache, input_ids[None],
            torch.tensor([t], dtype=torch.int32, device=dev), positions[None],
            slot_mapping[None], block_table[None],
            torch.as_tensor(prefix_len, dtype=torch.int32, device=dev).reshape(1))
        return logits[0], kv_cache
    d = cfg.head_dim
    sm_scale = 1.0 / (d ** 0.5)
    big = params["layers"]
    x = params["embed"][input_ids.long()]
    cos, sin = _rope_cs(params, positions, d)
    for li in range(cfg.num_layers):
        q, k, v = _prefill_qkv(x, big, li, cfg, cos, sin)
        kv = _layer(kv_cache, li)
        _scatter_hm(k, v, kv, slot_mapping)
        att = paged_prefill_attention(q, kv, block_table, prefix_len, sm_scale,
                                      cfg.page_size, block_q=min(128, t))
        x = _prefill_tail(x, att.to(x.dtype), big, li, cfg)
    return _final_logits(x, params, cfg), kv_cache


def decode_verify_step(params, cfg: LlamaConfig, k_cache, v_cache, input_ids, positions,
                       tree_mask, seq_lens, block_table, slot_mapping):
    """Multi-token verification (EAGLE / MTP) on bf16 tuple caches: each of
    B requests carries dt draft tokens that attend to its paged prefix and,
    by tree_mask, to the drafts. Plain f32 attention over the gathered
    prefix plus the masked draft block, as in the JAX package; the GEMMs
    through kernel A (K1 on pretiled banks); each layer writes the drafts'
    rows.

    input_ids/positions/slot_mapping [B, dt]; tree_mask [B, dt, dt] bool
    (token i attends draft j); seq_lens [B] the prefix length, drafts
    excluded; block_table [B, max_pages]. Returns (logits [B, dt, V] f32,
    k_cache, v_cache)."""
    b, dt = input_ids.shape
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // hkv
    sm_scale = 1.0 / (d ** 0.5)
    ps = cfg.page_size
    npos = block_table.shape[1] * ps
    big = params["layers"]
    x = params["embed"][input_ids.long()]                        # [B, dt, H]
    cos, sin = _rope_cs(params, positions, d)
    pre_ok = (torch.arange(npos, device=x.device)[None] < seq_lens[:, None].long())
    bt = block_table.long()
    for li in range(cfg.num_layers):
        q, k, v = _prefill_qkv(x, big, li, cfg, cos, sin)
        kc, vc = k_cache[li], v_cache[li]
        _scatter_hm(k.reshape(b * dt, hkv, d), v.reshape(b * dt, hkv, d), (kc, vc),
                    slot_mapping.reshape(-1))
        # the prefix gathered token-major [B, N, Hkv, D] (drafts past seq_lens masked)
        kp = kc[bt].permute(0, 1, 3, 2, 4).reshape(b, npos, hkv, d)
        vp = vc[bt].permute(0, 1, 3, 2, 4).reshape(b, npos, hkv, d)
        qh = q.reshape(b, dt, hkv, g, d).float()
        sc_pre = torch.einsum("bthgd,bnhd->bhgtn", qh, kp.float()) * sm_scale
        sc_pre = torch.where(pre_ok[:, None, None, None, :], sc_pre,
                             torch.full_like(sc_pre, _NEG))
        sc_tree = torch.einsum("bthgd,bnhd->bhgtn", qh, k.float()) * sm_scale
        sc_tree = torch.where(tree_mask[:, None, None], sc_tree,
                              torch.full_like(sc_tree, _NEG))
        p = torch.softmax(torch.cat([sc_pre, sc_tree], dim=-1), dim=-1)
        att = (torch.einsum("bhgtn,bnhd->bthgd", p[..., :npos], vp.float())
               + torch.einsum("bhgtn,bnhd->bthgd", p[..., npos:], v.float()))
        x = _prefill_tail(x, att.reshape(b, dt, -1).to(x.dtype), big, li, cfg)
    logits = _final_logits(x.reshape(b * dt, -1), params, cfg)
    return logits.reshape(b, dt, -1), k_cache, v_cache


def add_lora_adapters(params, cfg: LlamaConfig, num_adapters: int, rank: int,
                      seed: int = 0, scale: float = 0.05):
    """Attach per-layer multi-LoRA adapters on the attention output
    projection, drawn as the JAX package draws them (numpy's default_rng,
    the same draws in the same order, rounded to f32 once), on the params'
    device. Returns a NEW params dict whose layers carry lora_wo_A [L, n,
    r, Hq * D] and lora_wo_B [L, n, H, r] f32."""
    rng = np.random.default_rng(seed)
    dev = params["embed"].device
    l = cfg.num_layers

    def draw(shape):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    layers = dict(params["layers"])
    layers["lora_wo_A"] = draw((l, num_adapters, rank, cfg.q_size))
    layers["lora_wo_B"] = draw((l, num_adapters, cfg.hidden_size, rank))
    out = dict(params)
    out["layers"] = layers
    return out


def shard_cfg_tp(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """Per-shard config for tensor parallelism (heads and intermediate split)."""
    from dataclasses import replace
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(f"tp {tp} does not divide {cfg.num_heads} / {cfg.num_kv_heads} heads "
                         f"and intermediate {cfg.intermediate_size}")
    return replace(cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                   intermediate_size=cfg.intermediate_size // tp)


def shard_params_tp(params, cfg: LlamaConfig, tp: int):
    """Stack a [tp, ...] leading axis onto the parameter tree (Megatron
    layout: wqkv and w13 column-parallel, wo and w2 row-parallel with their
    output scales replicated, everything else replicated, as expanded views).
    Shard rank r takes [r] of every leaf (decode_step_tp). The banks must be
    untiled [L, K, N]: pretile each shard after sharding."""
    qs_s, kvs_s = cfg.q_size // tp, cfg.kv_size // tp
    f = cfg.intermediate_size
    f_s = f // tp
    lay = params["layers"]
    # col_slices slices the LAST axis; on a pretiled 4-D [L, NB, K, bn] bank
    # that is the bn panel axis: a silent mis-sharding
    for name in _BIG_WEIGHTS:
        if lay[name]["q"].dim() != 3:
            raise ValueError(f"shard_params_tp requires untiled [L, K, N] banks; {name} is "
                             f"{tuple(lay[name]['q'].shape)}: run pretile_big_weights AFTER "
                             "sharding")

    def col_slices(a, starts_sizes):
        # a [..., cols]: each shard's column blocks, concatenated, stacked on axis 0
        return torch.stack([torch.cat([a[..., st + s * sz: st + (s + 1) * sz]
                                       for st, sz in starts_sizes], -1) for s in range(tp)])

    def rows(a, size):
        return torch.stack([a[:, s * size:(s + 1) * size] for s in range(tp)])

    def rep(a):
        return a[None].expand(tp, *a.shape)

    qkv_blocks = [(0, qs_s), (cfg.q_size, kvs_s), (cfg.q_size + cfg.kv_size, kvs_s)]
    w13_blocks = [(0, f_s), (f, f_s)]
    layers = {
        "wqkv": {k: col_slices(lay["wqkv"][k], qkv_blocks) for k in ("q", "scale")},
        "w13": {k: col_slices(lay["w13"][k], w13_blocks) for k in ("q", "scale")},
        # row-parallel: split input rows, replicate the (summed) output scale
        "wo": {"q": rows(lay["wo"]["q"], qs_s), "scale": rep(lay["wo"]["scale"])},
        "w2": {"q": rows(lay["w2"]["q"], f_s), "scale": rep(lay["w2"]["scale"])},
        "input_norm": rep(lay["input_norm"]),
        "post_norm": rep(lay["post_norm"]),
    }
    return {
        "embed": rep(params["embed"]),
        "final_norm": rep(params["final_norm"]),
        "lm_head": {k: rep(params["lm_head"][k]) for k in ("q", "scale")},
        "cos_sin": rep(params["cos_sin"]),
        "layers": layers,
    }


def _take(tree, i: int):
    """[i] of every leaf (dicts stay dicts, tuples tuples)."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_take(v, i) for v in tree)
    return tree[i]


def decode_step_tp(params_tp, cfg: LlamaConfig, kv_tp, input_ids, positions, seq_lens,
                   block_table, slot_mapping, group=None):
    """Tensor-parallel decode step, SPMD: every rank of `group` (a
    torch.distributed process group; None for the default one) calls it
    with the same arguments. Rank r runs decode_step_kv on shard r of
    params_tp (shard_params_tp) and of kv_tp (a [tp, ...]-stacked cache tree
    of per-shard caches, init_kv_cache(shard_cfg_tp(cfg, tp), ...) stacked)
    with shard_cfg_tp(cfg, tp), all-reducing the row-parallel GEMMs' outputs
    over the group. Returns (logits [B, V] f32, the same on every rank;
    kv_tp, its shard r updated in place)."""
    import torch.distributed as dist
    group = dist.group.WORLD if group is None else group
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    logits, _ = decode_step_kv(_take(params_tp, rank), shard_cfg_tp(cfg, world),
                               _take(kv_tp, rank), input_ids, positions, seq_lens, block_table,
                               slot_mapping, tp_group=group)
    return logits, kv_tp
