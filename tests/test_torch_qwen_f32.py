"""The port's f32 Qwen3-Next paths against the JAX package on the CPU, at the
JAX package's default QwenNextConfig (4 layers: 3 GDN + 1 attention, hidden
256, GDN heads 4 qk / 8 v of 32, attention 8 / 4 heads of 32, 4 experts
top-2, 2 LoRA adapters): the f32 MoE block (_moe_mlp), decode_step with and
without lora_indices, prefill_gdn_layer, forward_full, decode_step_q with
lora_indices, and forward_full and decode_step against HF's
Qwen3NextForCausalLM through the port's load_qwen_next.

The JAX tree (init_params) is carried over to the port unchanged
(params_from_jax), so both sides hold the same bits. The JAX steps are
compiled with `xla_allow_excess_precision` off, as in
tests/test_torch_qwen.py. The JAX side runs its plain versions (SKT_IMPL's
default off the TPU); the port runs its plain versions (device="cpu"): K9's
delta_rule_step_ref on the f32 pool, decode_gqa's plain path at head dim 32
(as in both packages).

Tolerances, each with its reason: every product is f32 on both sides, but
torch's CPU GEMM and XLA's sum in other orders, and every rstd is the
port's float64 rule where XLA's CPU rsqrt approximates (ROADMAP Queue 3), so
the bounds are a few f32 ulps carried through the layers:
  * _moe_mlp: within 1e-5 of max|ref| (f32 products of 256 and 128 terms,
    router softmax and sigmoid a few ulps apart);
  * decode_step: logits within calc_diff 1e-7 and 1e-3 of max|logit|, the
    conv state and the SSM pool within 1e-5 of their max, the bf16 caches
    >= 99.9% bit-equal and within calc_diff 1e-9 (a k or v an f32 ulp
    apart can round to the other bf16 side, and a value left small by
    cancellation carries its row's absolute error). The random model
    carries such a flip on: at step 1 the logits sat within 1.5e-6 of
    max|logit|, at step 4 within 3.1e-4 (calc_diff 1.3e-8), the caches
    >= 99.98% bit-equal (calc_diff <= 6e-11) when this was measured;
  * prefill_gdn_layer within 5e-6 and forward_full within 5e-5 of max|ref|
    (the chunked rule's WY products compound the order differences,
    tests/test_torch_gdn.py, and forward_full carries them through 4
    layers; 2.8e-7 and 3.8e-6 when this was measured);
  * decode_step_q with LoRA: the bound of tests/test_torch_qwen.py's slice
    (logits calc_diff < 8e-3, the int8 requantisation of activations that
    sit a bf16 ulp apart);
  * against HF: calc_diff < 1e-3, tests/test_qwen_loader.py's bar.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.models import qwen_next as jq
from sgl_kernel_npu_tpu_torch.models import loader as tl
from sgl_kernel_npu_tpu_torch.models import qwen_next as tq

from .test_torch_loader import _qwen_hf
from .utils import calc_diff

NO_EXCESS = {"xla_allow_excess_precision": False}


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(_np(a)))


def _close(got, want, share, name=""):
    got, want = np.asarray(got, np.float32), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= share * np.abs(want).max(), (name, err, np.abs(want).max())


@functools.cache
def _model():
    """(JAX cfg, port cfg, JAX f32 params, the same tree carried to the
    port), the default config, seed 0."""
    jcfg, tcfg = jq.QwenNextConfig(), tq.QwenNextConfig()
    jp = jq.init_params(jcfg, 0)
    return jcfg, tcfg, jp, tq.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_moe_mlp_matches_jax():
    """The f32 MoE block of layer 2 on 24 tokens (every expert routed, the
    stable sort's ties between a token's slots kept in order)."""
    jcfg, tcfg, jp, tp = _model()
    x = np.random.default_rng(3).standard_normal((24, jcfg.hidden_size)).astype(np.float32)
    want = jax.jit(lambda p, x: jq._moe_mlp(x, jax.tree.map(lambda a: a[2], p["moe"]), jcfg),
                   compiler_options=NO_EXCESS)(jp, jnp.asarray(x))
    got = tq._moe_mlp(_t(x), tq._layer(tp["moe"], 2), tcfg)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)


def _state(rng, cfg, b, pages):
    """Seeded random decode state (f32 conv and SSM pool, bf16 caches)."""
    ng, na = cfg.num_gdn_layers, cfg.num_attn_layers
    conv_dim = cfg.num_qk_heads * 2 * cfg.head_qk_dim + cfg.num_v_heads * cfg.head_v_dim
    kv = (na, cfg.num_kv_heads, pages, cfg.page_size, cfg.head_dim)
    js = {"conv": jnp.asarray(rng.standard_normal((ng, b, conv_dim, cfg.conv_width - 1)),
                              jnp.float32),
          "ssm": jnp.asarray(rng.standard_normal((ng, b, cfg.num_v_heads, cfg.head_qk_dim,
                                                  cfg.head_v_dim)) * 0.1, jnp.float32),
          "k_cache": jnp.asarray(rng.standard_normal(kv), jnp.bfloat16),
          "v_cache": jnp.asarray(rng.standard_normal(kv), jnp.bfloat16)}
    ts = {k: _t(v).to(torch.bfloat16 if "cache" in k else torch.float32)
          for k, v in js.items()}
    return js, ts


def _assert_state(jstate, tstate):
    for k in ("conv", "ssm"):
        _close(tstate[k].numpy(), jstate[k], 1e-5, k)
    for k in ("k_cache", "v_cache"):
        got, want = tstate[k].float().numpy(), _np(jstate[k])
        assert (got == want).mean() >= 0.999 and calc_diff(got, want) < 1e-9, k


@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
def test_decode_step_matches_jax(lora):
    """decode_step at the default config, B = 4 at positions 0, 15, 16, 33
    (page edges of 16), 4 steps from the same seeded state, ids from the
    port's argmax after the first; with lora_indices 0, 1, -1, 1 over the
    config's 2 adapters. Logits and every state tensor at every step
    (module docstring); the port updates its state in place."""
    jcfg, tcfg, jp, tp = _model()
    rng = np.random.default_rng(5 + lora)
    b, mp, ps = 4, 4, jcfg.page_size
    pages = b * mp + 1
    jstate, tstate = _state(rng, jcfg, b, pages)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    li = np.array([0, 1, -1, 1], np.int32) if lora else None
    step = jax.jit(lambda p, s, *a: jq.decode_step(p, jcfg, s, *a), compiler_options=NO_EXCESS)
    pos = np.array([0, 15, 16, 33], np.int32)
    ids = rng.integers(0, jcfg.vocab_size, b).astype(np.int32)
    for _ in range(4):
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        args = (ids, pos, pos + 1, bt, slots) + ((li,) if lora else ())
        jlg, jstate = step(jp, jstate, *(jnp.asarray(a) for a in args))
        tlg, ts2 = tq.decode_step(tp, tcfg, tstate, *(_t(a) for a in args))
        assert ts2 is tstate and tlg.dtype == torch.float32
        jlg, tlg = np.asarray(jlg), tlg.numpy()
        assert calc_diff(tlg, jlg) < 1e-7
        _close(tlg, jlg, 1e-3, "logits")
        _assert_state(jstate, tstate)
        ids, pos = tlg.argmax(-1).astype(np.int32), pos + 1
    if lora:     # the adapters move the logits: the LoRA path is live
        base = tq.decode_step(tp, tcfg, _state(np.random.default_rng(6), jcfg, b, pages)[1],
                              *(_t(a) for a in args[:5]))[0]
        assert not torch.allclose(base, torch.from_numpy(tlg))


def test_prefill_gdn_layer_matches_jax():
    """GDN block 1 over B 2, T 37 (chunks of 16, the last partial): the
    block's output and its final state [B, HV, K, V]."""
    jcfg, tcfg, jp, tp = _model()
    x = np.random.default_rng(7).standard_normal((2, 37, jcfg.hidden_size)).astype(np.float32)
    jy, js = jax.jit(lambda p, x: jq.prefill_gdn_layer(p, jcfg, x, 1),
                     compiler_options=NO_EXCESS)(jp, jnp.asarray(x))
    ty, ts = tq.prefill_gdn_layer(tp, tcfg, _t(x), 1)
    assert ts.shape == (2, jcfg.num_v_heads, jcfg.head_qk_dim, jcfg.head_v_dim)
    _close(ty.numpy(), jy, 5e-6, "out")
    _close(ts.numpy(), js, 5e-6, "state")


def test_forward_full_matches_jax():
    """forward_full on B 2, T 21: logits at every position."""
    jcfg, tcfg, jp, tp = _model()
    ids = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    want = jax.jit(lambda p, i: jq.forward_full(p, jcfg, i), compiler_options=NO_EXCESS)(
        jp, jnp.asarray(ids))
    got = tq.forward_full(tp, tcfg, _t(ids))
    assert got.shape == (2, 21, jcfg.vocab_size)
    _close(got.numpy(), want, 5e-5)
    assert calc_diff(got.numpy(), np.asarray(want)) < 1e-9


def _decode_all(tcfg, tp, ids):
    """decode_step fed ids [B, T] a token at a time from an empty state:
    (logits [B, T, V], the state after the last token)."""
    b, t = ids.shape
    ps = tcfg.page_size
    mp = -(-t // ps)
    state = tq.init_state(tcfg, b, b * mp + 1, device="cpu")
    bt = torch.arange(1, b * mp + 1, dtype=torch.int32).reshape(b, mp)
    out = []
    for ti in range(t):
        pos = torch.full((b,), ti, dtype=torch.int32)
        slots = bt[torch.arange(b), pos // ps] * ps + pos % ps
        out.append(tq.decode_step(tp, tcfg, state, torch.from_numpy(ids[:, ti]), pos, pos + 1,
                                  bt, slots)[0])
    return torch.stack(out, 1), state


def test_decode_step_matches_forward_full():
    """The port alone, as chip_smoke.py's phase 19 (b) holds it on the card:
    decode_step fed B 2, T 20 a token at a time from an empty state gives
    forward_full's logits within calc_diff 1e-3 (its attention reads bf16
    pages), and GDN layer 0's SSM pool rows after T steps equal
    prefill_gdn_layer's final state on the same embeddings within 1e-3 of
    its max (the chunked rule against the recurrent one)."""
    _, tcfg, _, tp = _model()
    ids = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 20)).astype(np.int32)
    full = tq.forward_full(tp, tcfg, _t(ids))
    dec, state = _decode_all(tcfg, tp, ids)
    assert calc_diff(dec.numpy(), full.numpy()) < 1e-3
    _, final = tq.prefill_gdn_layer(tp, tcfg, tp["embed"][_t(ids).long()], 0)
    _close(state["ssm"][0].numpy(), final.numpy(), 1e-3)


def test_decode_step_q_lora_matches_jax():
    """decode_step_q with lora_indices 1, -1, 0, 1 on the default config's
    int8 banks (init_params_q, seed 0, as tests/test_torch_qwen.py) and a
    bf16 pool, 3 steps: logits within calc_diff 8e-3 of the JAX step's,
    greedy picks equal wherever one clears its runner-up by more than the
    largest logit difference, and the adapters move the logits."""
    jcfg, tcfg = jq.QwenNextConfig(), tq.QwenNextConfig()
    jp = jq.init_params_q(jcfg, 0)
    tp = tq.init_params_q(tcfg, 0, "cpu")
    rng = np.random.default_rng(13)
    b, mp, ps = 4, 3, jcfg.page_size
    pages = b * mp + 1
    js, ts = _state(rng, jcfg, b, pages)
    js["ssm"] = js["ssm"].astype(jnp.bfloat16)
    ts["ssm"] = ts["ssm"].to(torch.bfloat16)
    base = {k: v.clone() for k, v in ts.items()}
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    li = np.array([1, -1, 0, 1], np.int32)
    step = jax.jit(lambda p, s, *a: jq.decode_step_q(p, jcfg, s, *a),
                   compiler_options=NO_EXCESS)
    pos = np.array([0, 15, 16, 20], np.int32)
    ids = rng.integers(0, jcfg.vocab_size, b).astype(np.int32)
    for i in range(3):
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        args = (ids, pos, pos + 1, bt, slots, li)
        jlg, js = step(jp, js, *(jnp.asarray(a) for a in args))
        tlg = tq.decode_step_q(tp, tcfg, ts, *(_t(a) for a in args))[0].numpy()
        jlg = np.asarray(jlg)
        assert np.all(np.isfinite(tlg)) and calc_diff(tlg, jlg) < 8e-3
        top2 = np.sort(tlg, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > np.abs(tlg - jlg).max()
        assert np.array_equal(jlg.argmax(-1)[clear], tlg.argmax(-1)[clear])
        if i == 0:
            plain = tq.decode_step_q(tp, tcfg, base, *(_t(a) for a in args[:5]))[0].numpy()
            assert np.abs(plain - tlg)[li >= 0].max() > 0
            assert np.array_equal(plain[li < 0], tlg[li < 0])
        ids, pos = tlg.argmax(-1).astype(np.int32), pos + 1


# ------------------------------------------------------------------ HF


@pytest.fixture(scope="module")
def hf_model(tmp_path_factory):
    """tests/test_torch_loader.py's tiny HF Qwen3-Next (4 layers, 3:1),
    written f32 and loaded with the port's load_qwen_next."""
    path = tmp_path_factory.mktemp("qwen_hf")
    model = _qwen_hf(path)
    cfg, params = tl.load_qwen_next(str(path), device="cpu")
    return model, cfg, params


def test_forward_full_matches_hf(hf_model):
    """forward_full on B 2, T 12 tracks HF's f32 logits within calc_diff
    1e-3 (tests/test_qwen_loader.py's bar)."""
    model, cfg, params = hf_model
    ids = np.random.default_rng(1234).integers(0, cfg.vocab_size, (2, 12))
    with torch.no_grad():
        ref = model(torch.tensor(ids)).logits.numpy()
    got = tq.forward_full(params, cfg, torch.from_numpy(ids)).numpy()
    assert got.shape == ref.shape and calc_diff(got, ref) < 1e-3


def test_decode_step_matches_hf(hf_model):
    """decode_step fed B 1, T 10 a token at a time tracks HF's full-forward
    logits at every position within calc_diff 1e-3."""
    model, cfg, params = hf_model
    ids = np.random.default_rng(1235).integers(0, cfg.vocab_size, (1, 10))
    with torch.no_grad():
        ref = model(torch.tensor(ids)).logits.numpy()
    got = _decode_all(cfg, params, ids.astype(np.int32))[0].numpy()
    for ti in range(ids.shape[1]):
        assert calc_diff(got[:, ti], ref[:, ti]) < 1e-3, ti
