"""The port's models/quant_ref.py against the JAX package's on the CPU, at
tests/test_accuracy_delta.py's configs (and its seed, 3, and token stream).

Both packages draw the f32 weights with numpy from the seed, so the f32
trees are bit-equal, and so are the int8 banks and their scales: both
divide by 127 (the JAX package eagerly, the port by a tensor). The MLA
activation scales come from the f32 forward's maxima after an RMSNorm,
whose rsqrt XLA's CPU approximates: they are held within 2e-6 relative.

Tolerances. f32 logits: the same f32 math in another summation order (and
XLA's approximate rsqrt); held within 2e-5 of max|logit| (1.4e-6 and
2.6e-6 measured). The int8 engines are the two packages' own (the port's
RMSNorm takes its root in float64), so the port's delta is held to the
gates of tests/test_accuracy_delta.py and its f32 perplexity within 1e-5
relative of the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.models import deepseek_mla as jdm
from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu.models import quant_ref as jq
from sgl_kernel_npu_tpu_torch.models import deepseek_mla as tdm
from sgl_kernel_npu_tpu_torch.models import llama as tl
from sgl_kernel_npu_tpu_torch.models import quant_ref as tq

LLAMA = dict(vocab_size=512, hidden_size=256, num_layers=3, num_heads=8, num_kv_heads=4,
             head_dim=32, intermediate_size=512, page_size=32, max_position=512)
MLA = dict(vocab_size=512, hidden_size=256, num_layers=3, num_heads=4, kv_lora_rank=128,
           qk_rope_dim=32, qk_nope_dim=64, v_head_dim=64, q_lora_rank=192,
           intermediate_size=512, page_size=32, max_position=512)
T = 96
SEED = 3
LOGITS_SHARE = 2e-5
SCALE_RTOL = 2e-6
PPL_RTOL = 1e-5
# tests/test_accuracy_delta.py's gates: (ppl delta %, KL mean, greedy agreement)
GATES = {"llama": (2.0, 0.02, 0.85), "mla": (2.0, 0.05, 0.80)}


def _ids():
    """test_accuracy_delta.py's stream (its rng fixture's seed, 1234)."""
    return np.random.default_rng(1234).integers(0, 512, T + 1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _f32_logits_close(got, want):
    err = np.abs(got - want).max()
    assert err <= LOGITS_SHARE * np.abs(want).max(), (err, np.abs(want).max())


def _case(model):
    """(JAX config, port config, ids, JAX f32 tree, port f32 tree, JAX f32
    logits, port f32 logits) of one model, the forwards run once."""
    jcfg, tcfg = ((jl.LlamaConfig, tl.LlamaConfig) if model == "llama"
                  else (jdm.MlaConfig, tdm.MlaConfig))
    kw = LLAMA if model == "llama" else MLA
    jc, tc = jcfg(**kw), tcfg(**kw)
    ids = _ids()
    jparams, tparams, jfwd, tfwd = (
        (jq.llama_f32_params, tq.llama_f32_params, jq.llama_f32_forward, tq.llama_f32_forward)
        if model == "llama" else
        (jq.mla_f32_params, tq.mla_f32_params, jq.mla_f32_forward, tq.mla_f32_forward))
    jp, tp = jparams(jc, SEED), tparams(tc, SEED, device="cpu")
    return (jc, tc, ids, jp, tp, np.asarray(jfwd(jp, jc, jnp.asarray(ids[:-1], jnp.int32))),
            tfwd(tp, tc, torch.from_numpy(ids[:-1])))


@pytest.fixture(scope="module")
def llama_case():
    return _case("llama")


@pytest.fixture(scope="module")
def mla_case():
    return _case("mla")


@pytest.mark.parametrize("model", ["llama", "mla"])
def test_f32_params_bit_equal_to_jax(model, llama_case, mla_case):
    _, _, _, jp, tp, _, _ = llama_case if model == "llama" else mla_case
    jl_, tl_ = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl_.keys() == tl_.keys()
    for name, a in jl_.items():
        t = tl_[name]
        assert t.device.type == "cpu" and t.dtype == torch.float32, name
        assert np.array_equal(_np(a), t.numpy()), name


@pytest.mark.parametrize("model", ["llama", "mla"])
def test_f32_forward_matches_jax(model, llama_case, mla_case):
    _, tc, _, _, _, want, got = llama_case if model == "llama" else mla_case
    assert tuple(got.shape) == (T, tc.vocab_size)
    _f32_logits_close(got.numpy(), want)


def test_quantize_llama_banks_bit_equal_to_jax(llama_case):
    jc, tc, _, jp, tp, _, _ = llama_case
    jt, tt = dict(_leaves(jq.quantize_llama(jp, jc))), dict(_leaves(tq.quantize_llama(tp, tc)))
    assert jt.keys() == tt.keys()
    for name, a in jt.items():
        if name == "/cos_sin":          # XLA's CPU cos / sin: within an f32 ulp
            np.testing.assert_allclose(_tnp(tt[name]), _np(a), rtol=0, atol=2.4e-7)
            continue
        assert str(tt[name].dtype).split(".")[-1] == np.asarray(a).dtype.name, name
        assert np.array_equal(_tnp(tt[name]), _np(a)), name


def test_quantize_mla_banks_bit_equal_to_jax(mla_case):
    jc, tc, ids, jp, tp, _, _ = mla_case
    jt = dict(_leaves(jq.quantize_mla(jp, jc, jnp.asarray(ids[:-1], jnp.int32))))
    tt = dict(_leaves(tq.quantize_mla(tp, tc, torch.from_numpy(ids[:-1]))))
    assert jt.keys() == tt.keys()
    calibrated = ("/layers/qscale0", "/layers/qscale1", "/layers/wdqkv/descale",
                  "/layers/wuq/descale")
    for name, a in jt.items():
        assert str(tt[name].dtype).split(".")[-1] == np.asarray(a).dtype.name, name
        if name in calibrated:
            np.testing.assert_allclose(_tnp(tt[name]), _np(a), rtol=SCALE_RTOL, atol=0)
        else:
            assert np.array_equal(_tnp(tt[name]), _np(a)), name


@pytest.mark.parametrize("model", ["llama", "mla"])
def test_port_int8_engine_within_the_accuracy_gates(model, llama_case, mla_case):
    """tests/test_accuracy_delta.py's gates on the port's engine (its int8
    prefill_step on the quantised tree against its f32 forward, both on the
    CPU), and the f32 perplexity the JAX package's."""
    _, tc, ids, _, tp, jlogits32, logits32 = llama_case if model == "llama" else mla_case
    tok = torch.from_numpy(ids[:-1])
    ps = tc.page_size
    pages = -(-T // ps) + 1
    slots = torch.arange(T) + ps
    if model == "llama":
        kc, vc = tl.init_kv_cache(tc, pages, layout="hm", device="cpu")
        logits8, _, _ = tl.prefill_step(tq.quantize_llama(tp, tc), tc, kc, vc, tok,
                                        torch.arange(T), slots)
    else:
        ckv, kr = tdm.init_kv_cache(tc, pages, device="cpu")
        logits8, _, _ = tdm.prefill_step(tq.quantize_mla(tp, tc, tok), tc, ckv, kr, tok,
                                         torch.arange(T), slots)
    m = tq.delta_metrics(logits32, logits8, torch.from_numpy(ids[1:]))
    jm = jq.delta_metrics(jnp.asarray(jlogits32), jnp.asarray(logits32.numpy()),
                          jnp.asarray(ids[1:]))
    assert abs(m["ppl_f32"] / jm["ppl_f32"] - 1) <= PPL_RTOL, (m, jm)
    dppl, kl, agree = GATES[model]
    assert abs(m["ppl_delta_pct"]) <= dppl, m
    assert m["kl_mean"] <= kl, m
    assert m["greedy_agreement"] >= agree, m


def test_delta_metrics_matches_jax():
    """The same f32 log-softmaxes (in another summation order): every metric
    within 1e-5 relative; the perplexity change, a difference of two close
    values times 100, within 1e-4 percentage points; the KL sums of
    p * (lr - lq), differences of log-probabilities near 4 (an f32 ulp
    4.8e-7), within 1e-6."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((40, 64)).astype(np.float32)
    b = (a + rng.standard_normal((40, 64)) * 0.1).astype(np.float32)
    tgt = rng.integers(0, 64, 40)
    jm = jq.delta_metrics(jnp.asarray(a), jnp.asarray(b), jnp.asarray(tgt))
    tm = tq.delta_metrics(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(tgt))
    assert jm.keys() == tm.keys()
    for k in jm:
        tol = {"ppl_delta_pct": 1e-4, "kl_mean": 1e-6, "kl_max": 1e-6}.get(k, 1e-7)
        assert tm[k] == pytest.approx(jm[k], rel=1e-5, abs=tol), k
