"""The port's HF checkpoint loaders (models/loader.py) and the f32
Qwen3-Next init_params against the JAX package on the CPU.

Checkpoints are written into tmp_path with the HF names of
tests/test_loader.py and tests/test_qwen_loader.py, f32 so that the JAX
loader (safetensors.numpy, which refuses bf16) reads the same file. Every
output array of the four loaders is held bit-identical to the JAX loader's
(the RoPE tables, which XLA's CPU cos / sin and torch's round differently,
within one f32 ulp). The reader is also held on bf16 and f16 files and on
broken headers, the Llama loader against HuggingFace's own model (logits
within tests/test_accuracy_vs_hf.py's calc_diff 5e-3), and the loaded and
quantised Qwen3-Next through decode_step_q against the JAX package's loaded
and quantised tree through its decode_step_q (logits within calc_diff 8e-3,
tests/test_torch_qwen.py's bound for the same step).
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.models import loader as jl
from sgl_kernel_npu_tpu.models import qwen_next as jq
from sgl_kernel_npu_tpu_torch.models import llama as tll
from sgl_kernel_npu_tpu_torch.models import loader as tl
from sgl_kernel_npu_tpu_torch.models import qwen_next as tq

from .torch_hf import assert_trees_equal, leaves, write_safetensors
from .utils import calc_diff

NO_EXCESS = {"xla_allow_excess_precision": False}


def _r(rng, *shape, s=0.05):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _config(path, **hf):
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)


# ------------------------------------------------------------------ the reader


def test_reader_reads_bf16_and_f16_as_their_f32_values(tmp_path):
    """bf16 and f16 tensors read back as the values they hold: equal, widened,
    to the same values stored as f32; int8 and int32 exact; a file of the
    safetensors package reads the same."""
    from safetensors.numpy import save_file
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32) * 3)
    for dtype in (torch.bfloat16, torch.float16):
        low = base.to(dtype)
        write_safetensors(tmp_path / "low.safetensors", {"w": low, "v": low[0]})
        write_safetensors(tmp_path / "f32.safetensors", {"w": low.float(), "v": low[0].float()})
        got, want = (tl.read_safetensors(str(tmp_path / f"{n}.safetensors"))
                     for n in ("low", "f32"))
        assert got["w"].dtype == dtype and torch.equal(got["w"], low)
        for k in ("w", "v"):
            assert torch.equal(got[k].float(), want[k])
    ints = {"i8": torch.from_numpy(rng.integers(-128, 128, (4, 3), dtype=np.int8)),
            "i32": torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 9, dtype=np.int64)
                                    .astype(np.int32)),
            "empty": torch.zeros((0, 4))}
    write_safetensors(tmp_path / "ints.safetensors", ints)
    got = tl.read_safetensors(str(tmp_path / "ints.safetensors"))
    assert all(torch.equal(got[k], v) for k, v in ints.items())
    arrays = {"a": _r(rng, 3, 8), "b": _r(rng, 11)}
    save_file(arrays, str(tmp_path / "pkg.safetensors"))
    got = tl.read_safetensors(str(tmp_path / "pkg.safetensors"))
    assert all(np.array_equal(got[k].numpy(), v) for k, v in arrays.items())


def test_reader_refuses_broken_files(tmp_path):
    """A header longer than the file (a truncated file), offsets with a gap
    or past the end, and an unknown dtype each raise ValueError."""
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, {"a": torch.ones(4), "b": torch.ones(2, dtype=torch.bfloat16)})
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])

    def put(data):
        with open(path, "wb") as f:
            f.write(data)

    def with_header(h, body=raw[8 + n:]):
        text = json.dumps(h).encode()
        return struct.pack("<Q", len(text)) + text + body

    cases = [raw[: 8 + n // 2],                                   # truncated header
             raw[:4],                                             # no header length
             raw[: len(raw) - 2],                                 # truncated data
             with_header({**header, "a": {**header["a"], "dtype": "F64"}}),
             with_header({**header, "b": {**header["b"], "data_offsets": [18, 22]}},
                         raw[8 + n:] + b"\0\0"),                   # a gap
             with_header({**header, "a": {**header["a"], "shape": [3]}})]
    for i, data in enumerate(cases):
        put(data)
        with pytest.raises(ValueError):
            tl.read_safetensors(path)
        assert i >= 0


def test_quantize_per_channel_bit_identical():
    """quantize_per_channel equals the JAX loader's numpy function bit for
    bit, on random columns, a zero column, values on rounding ties (x.5 of
    the scale) and a column of one huge value."""
    rng = np.random.default_rng(7)
    w = _r(rng, 64, 40, s=0.3)
    w[:, 3] = 0.0
    w[:, 5] = np.arange(64, dtype=np.float32) - 31.5        # absmax 32: ties at .5 steps
    w[:, 6] = 1e-3
    w[0, 6] = 3e4
    q, s = jl.quantize_per_channel(w)
    tq_, ts = tl.quantize_per_channel(torch.from_numpy(w))
    assert tq_.dtype == torch.int8 and np.array_equal(tq_.numpy(), q)
    assert np.array_equal(ts.numpy(), s)
    tq_t, ts_t = tl.quantize_per_channel(torch.from_numpy(w.T.copy()).T)
    assert tq_t.is_contiguous() and torch.equal(tq_t, tq_) and torch.equal(ts_t, ts)


# -------------------------------------------------------------- the families


def _llama_checkpoint(path, rng, tied):
    _config(path, vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=96, rope_theta=10000.0,
            rms_norm_eps=1e-6, max_position_embeddings=256, head_dim=16)
    h, f, v, hd, nh, nkv = 64, 96, 128, 16, 4, 2
    t = {"model.embed_tokens.weight": _r(rng, v, h, s=0.02),
         "model.norm.weight": 1 + _r(rng, h, s=0.1)}
    if not tied:
        t["lm_head.weight"] = _r(rng, v, h, s=0.02)
    for i in range(2):
        pre = f"model.layers.{i}."
        t.update({pre + "self_attn.q_proj.weight": _r(rng, nh * hd, h),
                  pre + "self_attn.k_proj.weight": _r(rng, nkv * hd, h),
                  pre + "self_attn.v_proj.weight": _r(rng, nkv * hd, h),
                  pre + "self_attn.o_proj.weight": _r(rng, h, nh * hd),
                  pre + "mlp.gate_proj.weight": _r(rng, f, h),
                  pre + "mlp.up_proj.weight": _r(rng, f, h),
                  pre + "mlp.down_proj.weight": _r(rng, h, f),
                  pre + "input_layernorm.weight": 1 + _r(rng, h, s=0.1),
                  pre + "post_attention_layernorm.weight": 1 + _r(rng, h, s=0.1)})
    # two files, as a sharded checkpoint
    names = sorted(t)
    write_safetensors(os.path.join(path, "model-00001.safetensors"),
                      {k: t[k] for k in names[: len(names) // 2]})
    write_safetensors(os.path.join(path, "model-00002.safetensors"),
                      {k: t[k] for k in names[len(names) // 2:]})


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_load_llama_matches_jax(tmp_path, tied):
    """load_llama_w8a8 on a 2-file f32 checkpoint: cfg equal to the JAX
    loader's (page_size and int8_kv at their defaults), every array
    bit-identical; with tied embeddings lm_head quantises the embedding."""
    _llama_checkpoint(str(tmp_path), np.random.default_rng(11), tied)
    jcfg, jp = jl.load_llama_w8a8(str(tmp_path))
    tcfg, tp = tl.load_llama_w8a8(str(tmp_path), device="cpu")
    assert jcfg.__dict__ == tcfg.__dict__
    assert_trees_equal(jp, tp, near=("/cos_sin",))
    assert torch.equal(tp["cos_sin"], tll.make_cos_sin_cache(
        tcfg.max_position, tcfg.head_dim, tcfg.rope_base, device="cpu"))


def _mla_config(**kw):
    cfg = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
               kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
               q_lora_rank=48, intermediate_size=96, rms_norm_eps=1e-6,
               max_position_embeddings=128)
    cfg.update(kw)
    return cfg


def _mla_checkpoint(path, rng):
    c = _mla_config()
    _config(path, **c)
    h, heads, kvl, rope = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"], 8
    nope, vd, ql, f = 16, 16, 48, 96
    t = {"model.embed_tokens.weight": _r(rng, 128, h), "model.norm.weight": 1 + _r(rng, h)}
    for i in range(2):
        p = f"model.layers.{i}."
        t.update({p + "self_attn.q_a_proj.weight": _r(rng, ql, h),
                  p + "self_attn.q_a_layernorm.weight": 1 + _r(rng, ql),
                  p + "self_attn.q_b_proj.weight": _r(rng, heads * (nope + rope), ql),
                  p + "self_attn.kv_a_proj_with_mqa.weight": _r(rng, kvl + rope, h),
                  p + "self_attn.kv_a_layernorm.weight": 1 + _r(rng, kvl),
                  p + "self_attn.kv_b_proj.weight": _r(rng, heads * (nope + vd), kvl),
                  p + "self_attn.o_proj.weight": _r(rng, h, heads * vd),
                  p + "mlp.gate_proj.weight": _r(rng, f, h),
                  p + "mlp.up_proj.weight": _r(rng, f, h),
                  p + "mlp.down_proj.weight": _r(rng, h, f),
                  p + "input_layernorm.weight": 1 + _r(rng, h),
                  p + "post_attention_layernorm.weight": 1 + _r(rng, h)})
    write_safetensors(os.path.join(path, "model.safetensors"), t)


def test_load_deepseek_mla_matches_jax(tmp_path):
    """load_deepseek_mla_w8a8: cfg equal, every array bit-identical (wdqkv
    rows [kv_a_proj_with_mqa | q_a_proj], kv_b_proj split into wuk and wuv
    transposed, qscale 0.05, a tied lm_head)."""
    _mla_checkpoint(str(tmp_path), np.random.default_rng(12))
    jcfg, jp = jl.load_deepseek_mla_w8a8(str(tmp_path))
    tcfg, tp = tl.load_deepseek_mla_w8a8(str(tmp_path), device="cpu")
    assert jcfg.__dict__ == tcfg.__dict__
    assert_trees_equal(jp, tp)


def test_mla_null_q_lora_rank_names_the_field(tmp_path):
    """A config.json whose q_lora_rank is null (DeepSeek-V2-Lite's): the JAX
    loader fails on it (it passes None on), the port raises a ValueError that
    names the field."""
    _config(str(tmp_path), **_mla_config(q_lora_rank=None))
    with pytest.raises(ValueError, match="q_lora_rank"):
        tl.config_mla_from_hf(str(tmp_path))
    write_safetensors(os.path.join(str(tmp_path), "model.safetensors"),
                      {"model.embed_tokens.weight": np.zeros((128, 64), np.float32)})
    with pytest.raises(Exception):
        jl.load_deepseek_mla_w8a8(str(tmp_path))


def test_load_moe_expert_bank_matches_jax(tmp_path):
    """load_moe_expert_bank: every bank, scale, router and shared-expert
    array bit-identical to the JAX loader's."""
    rng = np.random.default_rng(13)
    layers, e, h, f, fs = 2, 4, 32, 48, 16
    t = {}
    for i in range(layers):
        pre = f"model.layers.{i}.mlp."
        for j in range(e):
            ep = f"{pre}experts.{j}."
            t.update({ep + "gate_proj.weight": _r(rng, f, h), ep + "up_proj.weight": _r(rng, f, h),
                      ep + "down_proj.weight": _r(rng, h, f)})
        t[pre + "gate.weight"] = _r(rng, e, h, s=0.3)
        for nm, shp in (("gate_proj", (fs, h)), ("up_proj", (fs, h)), ("down_proj", (h, fs))):
            t[f"{pre}shared_experts.{nm}.weight"] = _r(rng, *shp)
    write_safetensors(str(tmp_path / "model.safetensors"), t)
    assert_trees_equal(jl.load_moe_expert_bank(str(tmp_path), layers, e),
                       tl.load_moe_expert_bank(str(tmp_path), layers, e, device="cpu"))


# --------------------------------------------------------------- Qwen3-Next


def _qwen_widths(**kw):
    base = dict(vocab_size=256, hidden_size=64, num_layers=4, full_attention_interval=4,
                num_qk_heads=2, num_v_heads=4, head_qk_dim=16, head_v_dim=16, num_heads=4,
                num_kv_heads=2, head_dim=16, num_experts=8, top_k=2,
                moe_intermediate_size=32, shared_intermediate_size=32, max_position=64)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [{}, dict(num_layers=8, full_attention_interval=2, num_loras=3),
                                dict(num_loras=0, num_layers=3)],
                         ids=["default", "interval2", "no-lora"])
def test_qwen_init_params_bit_equal_to_jax(kw):
    """The f32 init_params: same seed, same draws, every leaf equal to the JAX
    package's (the RoPE table within one f32 ulp)."""
    w = _qwen_widths(**kw)
    jp = jq.init_params(jq.QwenNextConfig(**w), 5)
    tp = tq.init_params(tq.QwenNextConfig(**w), 5, "cpu")
    assert_trees_equal(jp, tp, near=("/cos_sin",))


def test_qwen_template_drops_what_the_loader_replaces(monkeypatch):
    """load_qwen_next's template: the leaves it replaces are drawn a chunk at
    a time and dropped, and what it keeps (lora, cos_sin, final_norm) equals
    the whole draw's, with chunks that do not divide a leaf."""
    monkeypatch.setattr(tq, "_SKIP_CHUNK", 77)
    cfg = tq.QwenNextConfig(**_qwen_widths())
    full = tq.init_params(cfg, 0, "cpu")
    kept = tq._init_params(cfg, 0, torch.device("cpu"), drop=tl._QWEN_LOADED)
    assert set(kept) == {"final_norm", "cos_sin", "lora"}
    for name, t in leaves(kept):
        assert torch.equal(t, dict(leaves(full))[name]), name


def _qwen_hf(path):
    """test_qwen_loader.py's tiny HF Qwen3-Next (4 layers, 3:1), written f32."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.Qwen3NextConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=4,
        layer_types=["linear_attention"] * 3 + ["full_attention"], linear_num_key_heads=2,
        linear_num_value_heads=4, linear_key_head_dim=16, linear_value_head_dim=16,
        linear_conv_kernel_dim=4, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        partial_rotary_factor=0.25, rope_theta=10000.0, num_experts=8, num_experts_per_tok=2,
        norm_topk_prob=True, moe_intermediate_size=32, shared_expert_intermediate_size=32,
        intermediate_size=64, max_position_embeddings=512, rms_norm_eps=1e-6,
        attention_bias=False, tie_word_embeddings=False)
    model = transformers.Qwen3NextForCausalLM(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name and p.ndim == 1:
                p.add_(torch.randn_like(p) * 0.1)
    cfg.save_pretrained(str(path))
    write_safetensors(str(path / "model.safetensors"), model.state_dict())
    return model


def test_load_qwen_next_matches_jax(tmp_path):
    """load_qwen_next on the tiny HF checkpoint: cfg equal, every array of the
    f32 tree bit-identical to the JAX loader's (zero-centred norms + 1,
    out_norm_w tiled, in_proj_qkvz as stored; cos_sin within an ulp);
    `timings` filled."""
    _qwen_hf(tmp_path)
    jcfg, jp = jl.load_qwen_next(str(tmp_path))
    timings = {}
    tcfg, tp = tl.load_qwen_next(str(tmp_path), device="cpu", timings=timings)
    assert jcfg.__dict__ == tcfg.__dict__
    assert_trees_equal(jp, tp, near=("/cos_sin",))
    assert set(timings) == {"template_s", "load_s"}


def test_loaded_qwen_decode_step_q_matches_jax(tmp_path):
    """The loaded and quantised checkpoint through decode_step_q, three
    greedy steps of 4 sequences from position 0: the port's logits within
    calc_diff 8e-3 of the JAX package's decode_step_q on its own loaded and
    quantised tree (jitted without excess precision), and its greedy tokens
    equal wherever a pick clears its runner-up by more than the largest
    logit difference."""
    _qwen_hf(tmp_path)
    jcfg, jp = jl.load_qwen_next(str(tmp_path))
    tcfg, tp = tl.load_qwen_next(str(tmp_path), device="cpu")
    jp = jq.quantize_qwen_weights(jp, jcfg)
    tp = tq.quantize_qwen_weights(tp, tcfg)
    b, mp, ps = 4, 2, jcfg.page_size
    js = jq.init_state(jcfg, b, b * mp + 1, ssm_dtype=jnp.bfloat16)
    ts = tq.init_state(tcfg, b, b * mp + 1, ssm_dtype=torch.bfloat16, device="cpu")
    bt = np.arange(1, b * mp + 1, dtype=np.int32).reshape(b, mp)
    step = jax.jit(lambda p, s, *a: jq.decode_step_q(p, jcfg, s, *a), compiler_options=NO_EXCESS)
    ids = np.array([3, 17, 64, 100], np.int32)
    for t in range(3):
        pos = np.full(b, t, np.int32)
        slots = (bt[:, 0] * ps + pos).astype(np.int32)
        args = (ids, pos, pos + 1, bt, slots)
        jlg, js = step(jp, js, *(jnp.asarray(a) for a in args))
        tlg, ts = tq.decode_step_q(tp, tcfg, ts, *(torch.from_numpy(a) for a in args))
        jlg, tlg = np.asarray(jlg), tlg.numpy()
        assert np.all(np.isfinite(tlg)) and calc_diff(tlg, jlg) < 8e-3
        top2 = np.sort(tlg, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > np.abs(tlg - jlg).max()
        assert np.array_equal(jlg.argmax(-1)[clear], tlg.argmax(-1)[clear])
        ids = tlg.argmax(-1).astype(np.int32)


def test_loaded_llama_prefill_matches_hf(tmp_path):
    """tests/test_accuracy_vs_hf.py's tiny HF Llama, saved by transformers
    (safetensors), loaded by the port: prefill_step's logits over 12 tokens
    within calc_diff 5e-3 of HF's fp32 forward, greedy agreement >= 0.8."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, max_position_embeddings=128,
        rope_theta=10000.0, rms_norm_eps=1e-6, attention_bias=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    model.save_pretrained(tmp_path, safe_serialization=True)
    tcfg, params = tl.load_llama_w8a8(str(tmp_path), device="cpu")
    n = 12
    tokens = np.random.default_rng(1234).integers(0, 256, n)
    with torch.no_grad():
        hf = model(torch.tensor(tokens)[None]).logits[0].float().numpy()
    import dataclasses
    tcfg = dataclasses.replace(tcfg, page_size=16)
    kc, vc = tll.init_kv_cache(tcfg, 8, layout="hm", device="cpu")
    bt = torch.tensor([1, 2, 3], dtype=torch.int32)
    pos = torch.arange(n, dtype=torch.int32)
    slots = bt[pos // 16] * 16 + pos % 16
    logits = tll.prefill_step(params, tcfg, kc, vc, torch.from_numpy(tokens).int(), pos,
                              slots, 0)[0].numpy()
    assert calc_diff(logits, hf) < 5e-3
    assert (logits.argmax(-1) == hf.argmax(-1)).mean() >= 0.8
