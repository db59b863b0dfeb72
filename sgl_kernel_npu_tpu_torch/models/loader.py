"""HF checkpoint loading + post-training W8A8 quantisation (counterpart of the
JAX package's models/loader.py): read a HuggingFace checkpoint (config.json +
*.safetensors) of one of four families, fuse the projections into the port's
layouts and quantise the big matrices to int8 with per-output-channel absmax
scales, on the caller's device.

  Llama          config_from_hf, load_llama_w8a8      -> models/llama.py's tree
  DeepSeek MLA   config_mla_from_hf, load_deepseek_mla_w8a8
                                                      -> models/deepseek_mla.py's
  DeepSeek MoE   load_moe_expert_bank                 -> the [L, E, ...] int8 bank
  Qwen3-Next     config_qwen_next_from_hf, load_qwen_next
                                                      -> models/qwen_next.py's f32 tree

The safetensors format is read here (`read_safetensors`: a little-endian u64
header length, a JSON header, then the raw bytes, mapped and viewed with
torch.frombuffer), so no safetensors package is needed. It takes F32, F16,
BF16, I8 and I32 tensors; released checkpoints are bf16 (the JAX loader reads
through safetensors.numpy, which refuses bf16). Each tensor is copied to the
device as stored and widened to f32 there; the big matrices are quantised
layer by layer, so the host holds no f32 copy of a layer. quantize_per_channel
rounds as the JAX loader's numpy code, on the card as on the CPU: f32 absmax,
max(absmax, 1e-8) / 127 as an f32 division, then an f32 division w / scale,
round half to even, clip to +-127.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
import time
from typing import Dict, Optional

import torch

from ..ops.rope import make_cos_sin_cache
from ..utils import resolve_device
from .llama import LlamaConfig

# safetensors dtype name -> (torch dtype, bytes an element)
DTYPES = {"F32": (torch.float32, 4), "F16": (torch.float16, 2), "BF16": (torch.bfloat16, 2),
          "I8": (torch.int8, 1), "I32": (torch.int32, 4)}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, as CPU tensors over a private
    (copy-on-write) map of the file. Raises ValueError on a header that does
    not fit in the file, an unknown dtype, or data offsets that do not tile
    the bytes after the header."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, no header length")
        (n,) = struct.unpack("<Q", f.read(8))
        if n > size - 8:
            raise ValueError(f"{path}: a header of {n} bytes in a file of {size}")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else b""
    header.pop("__metadata__", None)
    spans, out = [], {}
    for name, meta in header.items():
        if meta["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}; "
                             f"read are {sorted(DTYPES)}")
        dtype, width = DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        count = math.prod(meta["shape"])
        if end - begin != count * width:
            raise ValueError(f"{path}: {name} spans {end - begin} bytes for {count} x {width}")
        spans.append((begin, end, name))
        out[name] = ((torch.frombuffer(buf, dtype=dtype, count=count, offset=8 + n + begin)
                      if count else torch.empty(0, dtype=dtype)).reshape(meta["shape"]))
    pos = 0
    for begin, end, name in sorted(spans):
        if begin != pos:
            raise ValueError(f"{path}: {name} starts at {begin}, not {pos}")
        pos = end
    if pos != size - 8 - n:
        raise ValueError(f"{path}: the tensors end at {pos} of {size - 8 - n} data bytes")
    return out


def _load_all_tensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of every *.safetensors file under path, in sorted file
    order (a later file's name replaces an earlier one's)."""
    out = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".safetensors"):
            out.update(read_safetensors(os.path.join(path, fn)))
    return out


def _read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _getter(t: Dict[str, torch.Tensor], dev):
    """name -> the tensor on dev as f32 (copied as stored, widened there)."""
    def get(name):
        return t[name].to(dev).float()
    return get


def quantize_per_channel(w: torch.Tensor):
    """w [in, out] float -> (int8 [in, out], scale [out] f32), symmetric
    absmax per output column, on w's device, bit-identical to the JAX
    loader's numpy function."""
    w = w.float()
    amax = torch.clamp_min(w.abs().amax(0), 1e-8)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which can round the scale an ulp away from numpy's
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q.contiguous(), scale


def config_from_hf(path: str) -> LlamaConfig:
    hf = _read_config(path)
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
        intermediate_size=hf["intermediate_size"],
        rope_base=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        max_position=min(hf.get("max_position_embeddings", 8192), 32768),
    )


def _bank(qs):
    """[(q, scale)] of each layer -> {"q": [L, ...], "scale": [L, ...]}."""
    return {"q": torch.stack([q for q, _ in qs]), "scale": torch.stack([s for _, s in qs])}


def _lm_head(t, get, embed):
    """lm_head [H, V] quantised; the embedding when the checkpoint ties them."""
    lm = get("lm_head.weight") if "lm_head.weight" in t else embed
    return dict(zip(("q", "scale"), quantize_per_channel(lm.T)))


def load_llama_w8a8(path: str, device="cuda"):
    """HF Llama-family checkpoint -> (cfg, params) with models/llama.py's
    tree (untiled [L, K, N] banks; pretile_big_weights tiles them) on
    `device`: wqkv = [q | k | v], w13 = [gate | up], wo, w2 and lm_head
    int8 per output channel; embed and the norms bf16."""
    cfg = config_from_hf(path)
    dev = resolve_device(device)
    t = _load_all_tensors(path)
    get = _getter(t, dev)
    banks = {name: [] for name in ("wqkv", "wo", "w13", "w2")}
    in_norm, post_norm = [], []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        # HF stores [out, in]; the banks are [in, out]
        banks["wqkv"].append(quantize_per_channel(torch.cat(
            [get(pre + f"self_attn.{p}_proj.weight").T for p in "qkv"], 1)))
        banks["wo"].append(quantize_per_channel(get(pre + "self_attn.o_proj.weight").T))
        banks["w13"].append(quantize_per_channel(torch.cat(
            [get(pre + "mlp.gate_proj.weight").T, get(pre + "mlp.up_proj.weight").T], 1)))
        banks["w2"].append(quantize_per_channel(get(pre + "mlp.down_proj.weight").T))
        in_norm.append(get(pre + "input_layernorm.weight"))
        post_norm.append(get(pre + "post_attention_layernorm.weight"))
    embed = get("model.embed_tokens.weight")
    layers = {name: _bank(qs) for name, qs in banks.items()}
    layers["input_norm"] = torch.stack(in_norm).to(torch.bfloat16)
    layers["post_norm"] = torch.stack(post_norm).to(torch.bfloat16)
    params = {
        "embed": embed.to(torch.bfloat16),
        "final_norm": get("model.norm.weight").to(torch.bfloat16),
        "lm_head": _lm_head(t, get, embed),
        "cos_sin": make_cos_sin_cache(cfg.max_position, cfg.head_dim, cfg.rope_base,
                                      device=dev),
        "layers": layers,
    }
    return cfg, params


# ------------------------------------------------------ DeepSeek-V2/V3 (MLA)


def config_mla_from_hf(path: str):
    """MlaConfig from a DeepSeek-V2/V3-family HF config.json. Raises
    ValueError for a null q_lora_rank (DeepSeek-V2-Lite's: its q_proj is not
    factored, and the fused wdqkv layout needs the q LoRA)."""
    from .deepseek_mla import MlaConfig

    hf = _read_config(path)
    if hf.get("q_lora_rank") is None:
        raise ValueError(f"{path}/config.json: q_lora_rank is null; the MLA path fuses "
                         "q_a_proj into wdqkv and needs a q LoRA rank")
    return MlaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        kv_lora_rank=hf["kv_lora_rank"],
        qk_rope_dim=hf["qk_rope_head_dim"],
        qk_nope_dim=hf["qk_nope_head_dim"],
        v_head_dim=hf["v_head_dim"],
        q_lora_rank=hf["q_lora_rank"],
        intermediate_size=hf["intermediate_size"],
        rms_eps=hf.get("rms_norm_eps", 1e-6),
        max_position=min(hf.get("max_position_embeddings", 4096), 32768),
    )


def load_deepseek_mla_w8a8(path: str, device="cuda"):
    """HF DeepSeek-V2/V3 checkpoint -> (cfg, params) with models/deepseek_mla.py's
    tree, as the JAX loader maps it:
      wdqkv = rowstack(kv_a_proj_with_mqa, q_a_proj), int8 per output row
      wuq   = q_b_proj (per-head [nope | rope] columns, as HF's)
      wuk   = kv_b_proj's K half [H, nope, kv_lora], f32
      wuv   = kv_b_proj's V half transposed [H, kv_lora, v_dim], f32
      gamma0/1/2 = input_layernorm / q_a_layernorm / kv_a_layernorm
    with the calibration-free static activation scales qscale0/1 = 0.05 (the
    per_tensor quant mode; per_token serves without calibration)."""
    from .deepseek_mla import make_mla_cos_sin

    cfg = config_mla_from_hf(path)
    dev = resolve_device(device)
    t = _load_all_tensors(path)
    get = _getter(t, dev)
    l, heads = cfg.num_layers, cfg.num_heads

    def quant_rows(w):              # w [out, in] -> int8 [out, in] + descale [out]
        q8, s = quantize_per_channel(w.T)
        return q8.T.contiguous(), s

    acc = {k: [] for k in ("wdqkv", "wuq", "wuk", "wuv", "wo", "w13", "w2", "g0", "g1", "g2",
                           "post")}
    for i in range(l):
        pre = f"model.layers.{i}."
        sa = pre + "self_attn."
        acc["wdqkv"].append(quant_rows(torch.cat(
            [get(sa + "kv_a_proj_with_mqa.weight"), get(sa + "q_a_proj.weight")], 0)))
        acc["wuq"].append(quant_rows(get(sa + "q_b_proj.weight")))
        kv_b = get(sa + "kv_b_proj.weight").reshape(
            heads, cfg.qk_nope_dim + cfg.v_head_dim, cfg.kv_lora_rank)
        acc["wuk"].append(kv_b[:, : cfg.qk_nope_dim, :])
        acc["wuv"].append(kv_b[:, cfg.qk_nope_dim:, :].transpose(1, 2))
        acc["wo"].append(quantize_per_channel(get(sa + "o_proj.weight").T))
        acc["w13"].append(quantize_per_channel(torch.cat(
            [get(pre + "mlp.gate_proj.weight").T, get(pre + "mlp.up_proj.weight").T], 1)))
        acc["w2"].append(quantize_per_channel(get(pre + "mlp.down_proj.weight").T))
        acc["g0"].append(get(pre + "input_layernorm.weight"))
        acc["g1"].append(get(sa + "q_a_layernorm.weight"))
        acc["g2"].append(get(sa + "kv_a_layernorm.weight"))
        acc["post"].append(get(pre + "post_attention_layernorm.weight"))

    def pre_bank(name, out):        # the mla_preprocess stages: descale and an int32 bias
        b = _bank(acc[name])
        return {"q": b["q"], "descale": b["scale"],
                "bias": torch.zeros((l, out), dtype=torch.int32, device=dev)}

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    st = lambda k: torch.stack(acc[k])  # noqa: E731
    layers = {
        "wdqkv": pre_bank("wdqkv", cfg.mm1_out),
        "wuq": pre_bank("wuq", heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
        "wuk": st("wuk"), "wuv": st("wuv"),
        "wo": _bank(acc["wo"]), "w13": _bank(acc["w13"]), "w2": _bank(acc["w2"]),
        "gamma0": st("g0"), "beta0": full((l, cfg.hidden_size), 0.0),
        "gamma1": st("g1"), "beta1": full((l, cfg.q_lora_rank), 0.0),
        "gamma2": st("g2"),
        "post_norm": st("post").to(torch.bfloat16),
        "qscale0": full((l, 1), 0.05), "qoffset0": full((l, 1), 0.0),
        "qscale1": full((l, 1), 0.05), "qoffset1": full((l, 1), 0.0),
    }
    embed = get("model.embed_tokens.weight")
    cos, sin = make_mla_cos_sin(cfg, device=dev)
    params = {
        "embed": embed.to(torch.bfloat16),
        "final_norm": get("model.norm.weight").to(torch.bfloat16),
        "lm_head": _lm_head(t, get, embed),
        "cos": cos, "sin": sin,
        "layers": layers,
    }
    return cfg, params


# ------------------------------------------------ DeepSeek-V3 MoE expert bank


def load_moe_expert_bank(path: str, num_layers: int, num_experts: int, device="cuda"):
    """HF DeepSeek-MoE expert weights -> the [L, E, ...] int8 bank that
    models/moe.py and parallel/fused_moe.py take (w13 = [gate | up], w2 =
    down, int8 per output channel), plus the f32 router [L, H, E] and the
    shared expert's f32 w13 [L, H, 2 Fs] and w2 [L, Fs, H].

    HF names per layer i, expert e:
      model.layers.{i}.mlp.experts.{e}.{gate_proj,up_proj,down_proj}.weight
      model.layers.{i}.mlp.gate.weight            (router [E, H])
      model.layers.{i}.mlp.shared_experts.{gate_proj,up_proj,down_proj}.weight
    Returns dict(w13={q, scale}, w2={q, scale}, router, shared_w13, shared_w2)."""
    dev = resolve_device(device)
    get = _getter(_load_all_tensors(path), dev)
    w13, w2, router, sh13, sh2 = [], [], [], [], []
    for i in range(num_layers):
        pre = f"model.layers.{i}.mlp."
        l13, l2 = [], []
        for e in range(num_experts):
            ep = f"{pre}experts.{e}."
            l13.append(quantize_per_channel(torch.cat(
                [get(ep + "gate_proj.weight").T, get(ep + "up_proj.weight").T], 1)))
            l2.append(quantize_per_channel(get(ep + "down_proj.weight").T))
        w13.append(_bank(l13))
        w2.append(_bank(l2))
        router.append(get(pre + "gate.weight").T)
        sh13.append(torch.cat([get(pre + "shared_experts.gate_proj.weight").T,
                               get(pre + "shared_experts.up_proj.weight").T], 1))
        sh2.append(get(pre + "shared_experts.down_proj.weight").T)

    def stack(banks):
        return {k: torch.stack([b[k] for b in banks]) for k in ("q", "scale")}
    return {"w13": stack(w13), "w2": stack(w2), "router": torch.stack(router),
            "shared_w13": torch.stack(sh13), "shared_w2": torch.stack(sh2)}


# --------------------------------------------------------------- Qwen3-Next


def config_qwen_next_from_hf(path: str):
    """config.json of a HF `Qwen3NextForCausalLM` -> QwenNextConfig, the
    full-attention interval from `layer_types` (the published checkpoints'
    3:1 linear:full pattern is interval 4)."""
    from .qwen_next import QwenNextConfig

    hf = _read_config(path)
    lt = hf.get("layer_types")
    if lt and "full_attention" in lt:
        interval = lt.index("full_attention") + 1
    else:
        interval = hf.get("full_attention_interval", 4)
    return QwenNextConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        full_attention_interval=interval,
        num_qk_heads=hf["linear_num_key_heads"],
        num_v_heads=hf["linear_num_value_heads"],
        head_qk_dim=hf["linear_key_head_dim"],
        head_v_dim=hf["linear_value_head_dim"],
        conv_width=hf["linear_conv_kernel_dim"],
        chunk_size=64,
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
        partial_rotary_factor=hf.get("partial_rotary_factor", 0.25),
        rope_theta=hf.get("rope_theta", 10000.0),
        num_experts=hf["num_experts"],
        top_k=hf["num_experts_per_tok"],
        norm_topk_prob=hf.get("norm_topk_prob", True),
        moe_intermediate_size=hf["moe_intermediate_size"],
        shared_intermediate_size=hf["shared_expert_intermediate_size"],
        rms_eps=hf.get("rms_norm_eps", 1e-6),
        max_position=min(hf.get("max_position_embeddings", 8192), 32768),
    )


# the leaves of qwen_next.init_params that load_qwen_next replaces: drawn for
# their place in the seed's stream, then dropped
_QWEN_LOADED = frozenset(("embed", "lm_head", "gdn", "attn", "moe"))


def load_qwen_next(path: str, device="cuda", timings: Optional[dict] = None):
    """HF Qwen3-Next checkpoint -> (cfg, params) with models/qwen_next.py's
    f32 tree (quantize_qwen_weights turns it into decode_step_q's banks).

    HF's Qwen3NextRMSNorm weights are zero-centred (out = rms(x) * (1 + w)):
    the input / post layernorms, the q / k norms and the final norm get + 1
    here. The GDN block's RMSNormGated weight ([head_v_dim], not
    zero-centred) is tiled over the v-heads. in_proj_qkvz is kept as HF
    interleaves it (per key-head group); fused_qkvzba_split_reshape_cat
    undoes that. cos_sin and lora come from init_params(cfg, seed=0), as in
    the JAX loader: the whole seed-0 stream is drawn (lora is drawn last),
    but what is replaced is not kept. `timings`, when given, receives the
    seconds of the template's draw ("template_s") and of the rest
    ("load_s")."""
    from .qwen_next import _init_params

    cfg = config_qwen_next_from_hf(path)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    params = _init_params(cfg, 0, dev, drop=_QWEN_LOADED)
    t1 = time.perf_counter()
    t = _load_all_tensors(path)
    get = _getter(t, dev)
    e, f, h = cfg.num_experts, cfg.moe_intermediate_size, cfg.hidden_size
    g, a, moe = [], [], []
    # the expert banks are filled in place: a stack of per-layer banks would
    # hold them twice
    w13 = torch.empty((cfg.num_layers, e, h, 2 * f), dtype=torch.float32, device=dev)
    w2 = torch.empty((cfg.num_layers, e, f, h), dtype=torch.float32, device=dev)
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        if not cfg.is_full_attention(i):
            la = pre + "linear_attn."
            conv_w = get(la + "conv1d.weight")
            g.append({
                "in_norm": get(pre + "input_layernorm.weight") + 1.0,
                "wqkvz": get(la + "in_proj_qkvz.weight").T,
                "wba": get(la + "in_proj_ba.weight").T,
                "conv_w": conv_w[:, 0, :],
                "conv_b": (get(la + "conv1d.bias") if la + "conv1d.bias" in t
                           else torch.zeros(conv_w.shape[0], dtype=torch.float32, device=dev)),
                "A_log": get(la + "A_log"),
                "dt_bias": get(la + "dt_bias"),
                "out_norm_w": get(la + "norm.weight").repeat(cfg.num_v_heads),
                "wo": get(la + "out_proj.weight").T,
            })
        else:
            sa = pre + "self_attn."
            a.append({
                "in_norm": get(pre + "input_layernorm.weight") + 1.0,
                "wq": get(sa + "q_proj.weight").T,
                "wk": get(sa + "k_proj.weight").T,
                "wv": get(sa + "v_proj.weight").T,
                "wo": get(sa + "o_proj.weight").T,
                "q_norm": get(sa + "q_norm.weight") + 1.0,
                "k_norm": get(sa + "k_norm.weight") + 1.0,
            })
        mp = pre + "mlp."
        for j in range(e):
            w13[i, j, :, :f] = get(f"{mp}experts.{j}.gate_proj.weight").T
            w13[i, j, :, f:] = get(f"{mp}experts.{j}.up_proj.weight").T
            w2[i, j] = get(f"{mp}experts.{j}.down_proj.weight").T
        moe.append({
            "norm": get(pre + "post_attention_layernorm.weight") + 1.0,
            "router": get(mp + "gate.weight").T,
            "shared_w13": torch.cat([get(mp + "shared_expert.gate_proj.weight").T,
                                     get(mp + "shared_expert.up_proj.weight").T], 1),
            "shared_w2": get(mp + "shared_expert.down_proj.weight").T,
            "shared_gate": get(mp + "shared_expert_gate.weight").T,
        })

    def stack(dicts):
        return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]} if dicts else {}

    embed = get("model.embed_tokens.weight")
    lm_head = get("lm_head.weight").T if "lm_head.weight" in t else embed.T
    moe = stack(moe)
    moe.update(w13=w13, w2=w2)
    params.update({
        "embed": embed,
        "final_norm": get("model.norm.weight") + 1.0,
        "lm_head": lm_head.contiguous(),
        "gdn": stack(g),
        "attn": stack(a),
        "moe": moe,
    })
    if timings is not None:
        timings.update(template_s=t1 - t0, load_s=time.perf_counter() - t1)
    return cfg, params
