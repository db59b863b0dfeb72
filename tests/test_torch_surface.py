"""The rest of the port's surface against the JAX package on the CPU:
mla_preprocess's "full" and "int8_nzcache" cache modes and
decode_mla_int8_ref (the MLA surface), batch_matmul_transpose,
fused_rope_qk_mqa and apply_rope in both pairings, decode_v8's one-layer
token-major int8 helpers, decode_v2's name for K10's wrapper,
get_device_properties and runtime.make_scheduler.

The same seeded numpy inputs go to both packages; the JAX Pallas kernels run
in interpret mode (SKT_IMPL=pallas) and mla_preprocess is compiled with
`xla_allow_excess_precision` off, as in tests/test_torch_mla.py; the port
runs its plain versions on CPU tensors.

Tolerances, each with its reason:
  * mla_preprocess: the JAX package takes rstd from XLA's CPU rsqrt of an f32
    sum, the port from torch.rsqrt (unfused) or correctly rounded from a
    float64 sum (fused, K2's formula), so a row's quant may flip (ROADMAP
    Queue 3): bf16 outputs within calc_diff 1e-4 with >= 99% of values
    equal (tests/test_torch_mla.py's bar); int8 codes at most 1 apart with
    >= 98% equal; the cache rows the same way, untouched rows zero;
  * decode_mla_int8_ref: its int8 sums are exact in both, the f32 epilogue
    sums in another order: within 1e-5 of max|out|;
  * batch_matmul_transpose: bf16 products are exact in f32, the sums in
    another order: within 1e-5 of max|out| in f32, one bf16 ulp in bf16;
  * RoPE: the same f32 arithmetic, bit-equal;
  * the token-major int8 scatter: exact (the scale divides by 127 in both);
  * decode_v2 against the interpreted JAX kernel: one bf16 ulp plus 1e-4 of
    max|out|, K10's bar in tests/test_torch_qwen.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.ops import matmul as jmm
from sgl_kernel_npu_tpu.ops import mla_preprocess as jmp
from sgl_kernel_npu_tpu.ops import rope as jrope
from sgl_kernel_npu_tpu.ops.attention import decode as jdec
from sgl_kernel_npu_tpu.ops.attention import decode_v2 as jv2
from sgl_kernel_npu_tpu.ops.attention import decode_v8 as jv8
from sgl_kernel_npu_tpu_torch import runtime as trt
from sgl_kernel_npu_tpu_torch.ops import matmul as tmm
from sgl_kernel_npu_tpu_torch.ops import mla_preprocess as tmp
from sgl_kernel_npu_tpu_torch.ops import rope as trope
from sgl_kernel_npu_tpu_torch.ops.attention import decode as tdec
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v2 as tv2
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v8 as tv8
from sgl_kernel_npu_tpu_torch.utils import H100, device as tdevice, get_device_properties

from .utils import calc_diff

NO_EXCESS = {"xla_allow_excess_precision": False}


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(_np(a)))


def _tnp(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _bf16(x):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, _t(j).to(torch.bfloat16)


# ----------------------------------------------------------- mla_preprocess


def _mla_inputs(rng, mode):
    """mla_preprocess inputs at small widths (tests/test_torch_mla.py's
    construction): 8 tokens, hidden 256, ctkv 64 + rope 16, q-LoRA 128,
    4 heads of 32 + 16; two slots dropped."""
    n, hid, kn, kp, qr, h, qn = 8, 256, 64, 16, 128, 4, 32
    mm1 = kn + kp + qr
    hidden = np.asarray(jnp.asarray(rng.uniform(-2, 2, (n, hid)), jnp.bfloat16))
    f32 = lambda *s: (rng.standard_normal(s) * 0.1 + 1).astype(np.float32)  # noqa: E731
    ops = [hidden, f32(hid), (rng.standard_normal(hid) * 0.05).astype(np.float32),
           rng.integers(-100, 101, (mm1, hid), dtype=np.int8),
           (rng.random(mm1) / 2000 + 1e-4).astype(np.float32),
           f32(qr), (rng.standard_normal(qr) * 0.05).astype(np.float32),
           rng.integers(-100, 101, (h * (qn + kp), qr), dtype=np.int8),
           (rng.random(h * (qn + kp)) / 2000 + 1e-4).astype(np.float32), f32(kn)]
    ang = rng.uniform(0, 6, (n, kp)).astype(np.float32)
    ops += [np.cos(ang), np.sin(ang), (rng.standard_normal((h, qn, kn)) * 0.05).astype(np.float32)]
    pages, ps = 4, 16
    slots = np.array([5, 17, 18, -1, 33, 40, 63, -1], np.int32)
    tail = [slots, np.array([0.05], np.float32), np.array([1.0], np.float32),
            rng.integers(-50, 50, mm1).astype(np.int32), np.array([0.03], np.float32),
            np.array([-2.0], np.float32), rng.integers(-50, 50, h * (qn + kp)).astype(np.int32)]
    if mode == "full":
        caches = [np.zeros((pages, ps, kn + kp), np.float32), None]
        dtypes = [jnp.bfloat16, None]
        scales = {}
    else:
        caches = [np.zeros((pages, ps, kn), np.int8), np.zeros((pages, ps, kp), np.float32)]
        dtypes = [jnp.int8, jnp.bfloat16]
        scales = {"ctkv_scale": np.array([0.02], np.float32),
                  "q_nope_scale": rng.uniform(1.5, 3.0, h).astype(np.float32)}
    return ops, caches, dtypes, tail, scales, slots, pages * ps


def _close_codes(got, want, name):
    """int8 codes (or their cache rows) at most 1 apart, >= 98% equal."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.98, (name, int(d.max()), (d == 0).mean())


def _close_bf16(got, want, name):
    assert got.shape == want.shape, name
    assert calc_diff(got, want) < 1e-4, (name, calc_diff(got, want))
    assert (got == want).mean() >= 0.99, (name, (got == want).mean())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", ["full", "int8_nzcache"])
def test_mla_preprocess_cache_modes_match_jax(monkeypatch, fused, mode):
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(150 + fused + 2 * (mode == "full"))
    ops, caches, dtypes, tail, scales, slots, rows = _mla_inputs(rng, mode)
    kn_w = (ops[3].T.copy(), ops[7].T.copy()) if fused else (None, None)

    def jfn(*a):
        return jmp.mla_preprocess(*a[:13], a[13], a[14], *a[15:22], cache_mode=mode,
                                  wdqkv_kn=a[22], wuq_kn=a[23], ctkv_scale=a[24],
                                  q_nope_scale=a[25])

    jc = [None if c is None else jnp.asarray(c, dt) for c, dt in zip(caches, dtypes)]
    js = [None if k not in scales else jnp.asarray(scales[k])
          for k in ("ctkv_scale", "q_nope_scale")]
    want = jax.jit(jfn, compiler_options=NO_EXCESS)(
        *(jnp.asarray(a) for a in ops), *jc, *(jnp.asarray(a) for a in tail),
        *(None if a is None else jnp.asarray(a) for a in kn_w), *js)
    tc = [None if c is None else _t(c).to(torch.bfloat16 if dt == jnp.bfloat16 else torch.int8)
          for c, dt in zip(caches, dtypes)]
    targs = [_t(a).to(torch.bfloat16) if i == 0 else _t(a) for i, a in enumerate(ops)]
    got = tmp.mla_preprocess(*targs, *tc, *(_t(a) for a in tail), cache_mode=mode,
                             wdqkv_kn=None if kn_w[0] is None else _t(kn_w[0]),
                             wuq_kn=None if kn_w[1] is None else _t(kn_w[1]),
                             **{k: _t(v) for k, v in scales.items()})
    assert got.kv_cache is tc[0]
    if mode == "full":
        assert got.krope_cache is None and want.krope_cache is None
        assert got.q_nope.dtype == torch.bfloat16 and got.q_nope.shape == (8, 4, 64 + 16)
        _close_bf16(_tnp(got.q_nope), _np(want.q_nope), "q packed")
        assert torch.equal(got.q_nope[..., 64:], got.q_pe)
        _close_bf16(_tnp(got.kv_cache), _np(want.kv_cache), "combined rows")
    else:
        assert got.krope_cache is tc[1]
        assert got.q_nope.dtype == torch.int8 and got.kv_cache.dtype == torch.int8
        _close_codes(got.q_nope.numpy(), np.asarray(want.q_nope), "q_nope codes")
        _close_codes(got.kv_cache.numpy(), np.asarray(want.kv_cache), "ctkv codes")
        _close_bf16(_tnp(got.krope_cache), _np(want.krope_cache), "krope rows")
        assert got.q_nope.abs().max() > 1 and got.kv_cache.abs().max() > 1
    _close_bf16(_tnp(got.q_pe), _np(want.q_pe), "q_pe")
    untouched = np.ones(rows, bool)
    untouched[slots[slots >= 0]] = False
    assert not got.kv_cache.reshape(rows, -1)[torch.from_numpy(untouched)].any()


@pytest.mark.parametrize("lens", [[10, 20], [1, 24]])
def test_decode_mla_int8_ref_matches_jax(lens):
    """tests/test_decode_attention.py's int8 latent decode case (B 2, 4
    heads, Lkv 64, Lrope 16, pages of 8), its codes quantised by the
    mla_preprocess formulas."""
    rng = np.random.default_rng(160 + lens[0])
    b, h, lkv, lrope, ps, mp = 2, 4, 64, 16, 8, 3
    pages = b * mp + 1
    ckv = rng.standard_normal((pages, ps, lkv)).astype(np.float32) * 0.5
    krope = rng.standard_normal((pages, ps, lrope)).astype(np.float32)
    bt = (rng.permutation(b * mp) + 1).reshape(b, mp).astype(np.int32)
    sl = np.array(lens, np.int32)
    qn = rng.standard_normal((b, h, lkv)).astype(np.float32) * 0.5
    qp = rng.standard_normal((b, h, lrope)).astype(np.float32)
    qns = rng.uniform(30, 50, h).astype(np.float32)
    cs = np.float32(0.01)
    qn_q = np.clip(np.round(qn * qns[None, :, None]), -128, 127).astype(np.int8)
    ckv_q = np.clip(np.round(ckv / cs), -128, 127).astype(np.int8)
    args = (qn_q, qp, ckv_q, krope, qns, np.array(cs), sl, bt)
    want = np.asarray(jdec.decode_mla_int8_ref(*(jnp.asarray(a) for a in args), 0.15, ps))
    got = tdec.decode_mla_int8_ref(*(_t(a) for a in args), 0.15, ps)
    assert got.dtype == torch.float32 and got.shape == (b, h, lkv)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_int8_scores_are_exact_int32_sums():
    rng = np.random.default_rng(7)
    q = rng.integers(-128, 128, (3, 5, 64), dtype=np.int8)
    k = rng.integers(-128, 128, (3, 40, 64), dtype=np.int8)
    got = tdec._int8_scores(_t(q), _t(k))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.einsum("bhd,bnd->bhn", q.astype(np.int64),
                                                 k.astype(np.int64)))


# ------------------------------------------------------------- small ops


@pytest.mark.parametrize("dtype,out_dtype", [("f32", None), ("bf16", None),
                                             ("bf16", "f32")])
def test_batch_matmul_transpose_matches_jax(dtype, out_dtype):
    """XLA's CPU runtime has no bf16 x bf16 -> f32 dot, so for bf16 inputs the
    JAX function takes their values widened to f32 (the same arithmetic: a
    bf16 product is exact in f32) and its result is cast to the port's out
    dtype."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((7, 3, 64)).astype(np.float32)
    w = rng.standard_normal((3, 64, 24)).astype(np.float32)
    if dtype == "bf16":
        (jx, tx), (jw, tw) = _bf16(x), _bf16(w)
        jx, jw = jx.astype(jnp.float32), jw.astype(jnp.float32)
    else:
        jx, tx, jw, tw = jnp.asarray(x), _t(x), jnp.asarray(w), _t(w)
    to = tmm.batch_matmul_transpose(tx, tw, None if out_dtype is None else torch.float32)
    jo = jmm.batch_matmul_transpose(jx, jw)
    assert to.dtype == (torch.float32 if dtype == "f32" or out_dtype else torch.bfloat16)
    if to.dtype == torch.bfloat16:
        jo = jo.astype(jnp.bfloat16)
    got, want = _tnp(to).astype(np.float64), _np(jo).astype(np.float64)
    bound = 1e-5 * np.abs(want).max() + (2.0 ** -7 * np.abs(want)
                                         if to.dtype == torch.bfloat16 else 0)
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("rotary_dim", [32, 16])
def test_fused_rope_qk_mqa_matches_jax(neox, rotary_dim):
    """Query [T, 4 heads * 32], the MQA key [T, 32], a packed table of
    rotary_dim (the whole head, or half of it, the rest passed through)."""
    rng = np.random.default_rng(9 + neox)
    t, h, d = 6, 4, 32
    table = np.asarray(jrope.make_cos_sin_cache(64, rotary_dim, 10000.0))
    cs = table[rng.integers(0, 64, t)]
    (jq, tq), (jk, tk) = _bf16(rng.standard_normal((t, h * d))), _bf16(rng.standard_normal((t, d)))
    jo = jax.jit(jrope.fused_rope_qk_mqa, static_argnums=(3, 4))(jq, jk, jnp.asarray(cs),
                                                                 rotary_dim, neox)
    to = trope.fused_rope_qk_mqa(tq, tk, _t(cs), rotary_dim, neox)
    for j, tt, shape in ((jo[0], to[0], (t, h * d)), (jo[1], to[1], (t, d))):
        assert tt.dtype == torch.bfloat16 and tuple(tt.shape) == shape
        assert np.array_equal(_tnp(tt), _np(j))
    if rotary_dim < d:
        assert torch.equal(to[1][:, rotary_dim:], tk[:, rotary_dim:])


@pytest.mark.parametrize("neox", [True, False])
def test_apply_rope_styles_match_jax(neox):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((5, 3, 16)).astype(np.float32)
    ang = rng.uniform(0, 6, (5, 1, 8)).astype(np.float32)
    # eagerly: a compiled f32 rotation may contract its products into FMAs
    jo = jrope.apply_rope(jnp.asarray(x), jnp.asarray(np.cos(ang)), jnp.asarray(np.sin(ang)),
                          neox)
    to = trope.apply_rope(_t(x), _t(np.cos(ang)), _t(np.sin(ang)), is_neox_style=neox)
    assert np.array_equal(to.numpy(), np.asarray(jo))
    if neox:    # the default is the neox pairing its callers had
        assert torch.equal(trope.apply_rope(_t(x), _t(np.cos(ang)), _t(np.sin(ang))), to)


def test_token_major_int8_helpers_match_jax():
    """init_cache_tm_int8 and reshape_and_cache_gqa_token_major_int8 over 5
    pages of 4 tokens x 2 heads: slots across pages, one past the pages and
    one dropped; written in place, bit-equal to the JAX function's result."""
    rng = np.random.default_rng(13)
    pages, hkv, ps, d = 5, 2, 4, 16
    jc = jv8.init_cache_tm_int8(pages, hkv, ps, d)
    tc = tv8.init_cache_tm_int8(pages, hkv, ps, d, device="cpu")
    for name in ("k", "v", "ks", "vs"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == jc[name].dtype.name
        assert not tc[name].any()
    k = (rng.standard_normal((6, hkv, d)) * 3).astype(np.float32)
    v = rng.standard_normal((6, hkv, d)).astype(np.float32)
    slots = np.array([0, 3, 4, 19, -1, 20], np.int32)
    want = jv8.reshape_and_cache_gqa_token_major_int8(
        jnp.asarray(k), jnp.asarray(v), jc["k"], jc["v"], jc["ks"], jc["vs"],
        jnp.asarray(slots))
    got = tv8.reshape_and_cache_gqa_token_major_int8(_t(k), _t(v), tc["k"], tc["v"], tc["ks"],
                                                     tc["vs"], _t(slots))
    for g, w, name in zip(got, want, ("k", "v", "ks", "vs")):
        assert g is tc[name]
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert tc["k"].abs().max() == 127


def test_decode_v2_is_k10s_wrapper_and_matches_jax(monkeypatch):
    """decode_gqa_pallas_v2 is decode_gqa_hm (one contract, no copy); on the
    CPU it holds to the interpreted JAX v2 kernel: B 3, 8 / 2 heads of 128,
    bf16 head-major pages of 16."""
    assert tv2.decode_gqa_pallas_v2 is tdec.decode_gqa_hm
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(14)
    b, hq, hkv, d, ps, mp = 3, 8, 2, 128, 16, 4
    (jq, tq) = _bf16(rng.standard_normal((b, hq, d)))
    (jk, tk) = _bf16(rng.standard_normal((hkv, b * mp + 1, ps, d)))
    (jv, tv) = _bf16(rng.standard_normal((hkv, b * mp + 1, ps, d)))
    bt = (rng.permutation(b * mp) + 1).reshape(b, mp).astype(np.int32)
    lens = np.array([1, 17, 64], np.int32)
    want = _np(jv2.decode_gqa_pallas_v2(jq, jk, jv, jnp.asarray(lens), jnp.asarray(bt),
                                        d ** -0.5, ps)).astype(np.float64)
    got = tv2.decode_gqa_pallas_v2(tq, tk, tv, _t(lens), _t(bt), d ** -0.5, ps)
    assert got.dtype == torch.bfloat16
    err = np.abs(_tnp(got) - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max()).all()


# --------------------------------------------------------- utils, runtime


def test_get_device_properties():
    cpu = get_device_properties("cpu")
    assert cpu.platform == "cpu" and cpu.hbm_bytes > 0 and cpu.num_sms == os.cpu_count()
    assert np.isnan(cpu.hbm_bytes_per_s) and np.isnan(cpu.bf16_flops)
    if torch.cuda.is_available():
        card = get_device_properties()
        props = torch.cuda.get_device_properties(0)
        assert (card.name, card.hbm_bytes, card.num_sms) == (
            props.name, props.total_memory, props.multi_processor_count)
        assert card.hbm_bytes_per_s == H100.hbm_bytes_per_s and card.platform == "gpu"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            get_device_properties()


@pytest.mark.parametrize("name, rated", [("NVIDIA H100 80GB HBM3", True),
                                         ("NVIDIA H100 PCIe", False),
                                         ("NVIDIA A100-SXM4-80GB", False)])
def test_get_device_properties_rates_only_an_h100_sxm(monkeypatch, name, rated):
    """The H100 data-sheet rates go only to the card they were written for;
    any other card gets NaN rates (a fake card's properties on the CPU)."""
    class Props:
        total_memory, multi_processor_count = 80 * 2**30, 114

    Props.name = name
    monkeypatch.setattr(tdevice, "resolve_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    card = get_device_properties()
    assert (card.name, card.hbm_bytes, card.num_sms, card.platform) == (
        name, 80 * 2**30, 114, "gpu")
    rates = (card.hbm_bytes_per_s, card.bf16_flops, card.int8_ops, card.f32_flops)
    if rated:
        assert rates == (H100.hbm_bytes_per_s, H100.bf16_flops, H100.int8_ops, H100.f32_flops)
    else:
        assert all(np.isnan(r) for r in rates)


def test_make_scheduler(monkeypatch):
    native = trt.make_scheduler(16, 4, max_batch=8, token_budget=32)
    assert isinstance(native, trt.NativeScheduler) and native.free_pages() == 16

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(trt, "build_native", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        trt.make_scheduler(16, 4)
