"""The port's ops/norm.py against the JAX package's on the CPU.

The same numpy inputs go to both packages. The JAX side runs with
SKT_IMPL=pallas, so add_rmsnorm_bias with quant on a 2-D x runs its Pallas
kernel (_add_rmsnorm_quant_pallas) in interpret mode, and is compiled with
`xla_allow_excess_precision` off so that it rounds x + residual to bf16
before the norm, as its code casts; the port runs its plain PyTorch versions
(K20's is add_rmsnorm_bias_ref); chip_smoke.py holds K20 against it on the
card.

Tolerances, each with its reason:
  * h = x + residual: exact (one rounding of the same sum);
  * int8: within 1 of the JAX value on at most QUANT_FLIP_SHARE of the
    entries: the port takes rstd in float64 and rounds it once, XLA's CPU
    rsqrt approximates and sums in f32, so a row's rstd can sit an ulp apart
    and a value on a rounding boundary flip;
  * bf16 outputs: one bf16 ulp of the JAX value plus 1e-6 of max|JAX| (the
    same ulp of rstd, and values near 0 after + bias);
  * f32 outputs: rtol 1e-6 plus 1e-6 of max|JAX| (that ulp, f32 sums taken in
    another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.ops import norm as jn
from sgl_kernel_npu_tpu_torch import _build
from sgl_kernel_npu_tpu_torch.ops import norm as tn

from .test_torch_mla import assert_bf16_close

NO_EXCESS = {"xla_allow_excess_precision": False}
QUANT_FLIP_SHARE = 1e-3
SHARE = 1e-6
EPS = 1e-6


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SKT_IMPL", "pallas")


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _close(got, want, name=""):
    """bf16: one ulp + SHARE of max; f32: rtol 1e-6 + SHARE of max."""
    w = _f32(want)
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        assert_bf16_close(_f32(got), w, SHARE, name)
    else:
        np.testing.assert_allclose(_f32(got), w, rtol=1e-6, atol=SHARE * np.abs(w).max(),
                                   err_msg=name)


def _inputs(rng, n, d, dtype, lead=()):
    x = jnp.asarray(rng.standard_normal(lead + (n, d)), dtype)
    r = jnp.asarray(rng.standard_normal(lead + (n, d)), dtype)
    w = jnp.asarray(rng.standard_normal(d), jnp.float32)
    b = jnp.asarray(rng.standard_normal(d) * 0.1, jnp.float32)
    qs = jnp.asarray(rng.random(d) * 20 + 10, jnp.float32)
    qo = jnp.asarray(rng.standard_normal(d), jnp.float32)
    return x, r, w, b, qs, qo


def _assert_quant(got, want, name=""):
    diff = np.abs(np.asarray(want, np.int32) - got.numpy().astype(np.int32))
    share = float((diff > 0).mean())
    assert diff.max() <= 1 and share <= QUANT_FLIP_SHARE, (name, int(diff.max()), share)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("n, d", [
    pytest.param(8, 512, id="8"), pytest.param(300, 512, id="300"),
    # K20's edges: one row, either side of a decode batch of 128, one
    # 8-column chunk, the widest row
    pytest.param(1, 512, id="1"), pytest.param(129, 512, id="129"),
    pytest.param(4, 8, id="4-d8"), pytest.param(4, 8192, id="4-d8192")])
def test_add_rmsnorm_bias_quant_matches_jax_kernel(rng, dtype, n, d):
    """The kernel path (quant, 2-D x): h exact, int8 within the flip bar of
    the interpreted Pallas kernel; 300 rows take two of its 256-row blocks."""
    x, r, w, b, qs, qo = _inputs(rng, n, d, dtype)
    jq, jh = jax.jit(lambda *a: jn.add_rmsnorm_bias(*a[:4], EPS, *a[4:]),
                     compiler_options=NO_EXCESS)(x, r, w, b, qs, qo)
    tq, th = tn.add_rmsnorm_bias(*(_t(a) for a in (x, r, w, b)), EPS, _t(qs), _t(qo))
    assert tq.dtype == torch.int8 and th.dtype == _t(x).dtype
    assert np.array_equal(_f32(jh), _f32(th))
    _assert_quant(tq, jq, f"{dtype} n={n}")


def test_add_rmsnorm_bias_quant_scalar_scale_and_3d(rng):
    """Below the kernel gate (a 3-D x) both packages run the plain form;
    scalar quant_scale / quant_offset broadcast."""
    x, r, w, b, _, _ = _inputs(rng, 6, 256, jnp.bfloat16, lead=(2,))
    qs, qo = jnp.float32(17.0), jnp.float32(-2.0)
    jq, jh = jax.jit(lambda *a: jn.add_rmsnorm_bias(*a[:4], EPS, *a[4:]),
                     compiler_options=NO_EXCESS)(x, r, w, b, qs, qo)
    tq, th = tn.add_rmsnorm_bias(*(_t(a) for a in (x, r, w, b)), EPS, _t(qs), _t(qo))
    assert tq.shape == (2, 6, 256)
    assert np.array_equal(_f32(jh), _f32(th))
    _assert_quant(tq, jq)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_add_rmsnorm_bias_unquantized(rng, dtype):
    x, r, w, b, _, _ = _inputs(rng, 40, 512, dtype)
    jo, jh = jax.jit(lambda *a: jn.add_rmsnorm_bias(*a, EPS),
                     compiler_options=NO_EXCESS)(x, r, w, b)
    to, th = tn.add_rmsnorm_bias(*(_t(a) for a in (x, r, w, b)), EPS)
    assert to.dtype == th.dtype == _t(x).dtype
    assert np.array_equal(_f32(jh), _f32(th))
    _close(to, jo, str(dtype))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_add_gemma_rms_norm(rng, dtype):
    x, r, w, _, _, _ = _inputs(rng, 40, 256, dtype)
    jo, jh = jax.jit(lambda *a: jn.add_gemma_rms_norm(*a, EPS),
                     compiler_options=NO_EXCESS)(x, r, w)
    to, th = tn.add_gemma_rms_norm(_t(x), _t(r), _t(w), EPS)
    assert np.array_equal(_f32(jh), _f32(th))
    _close(to, jo, str(dtype))


@pytest.mark.parametrize("quant", [False, True])
def test_rmsnorm_bias(rng, quant):
    x, _, w, b, qs, qo = _inputs(rng, 40, 512, jnp.bfloat16)
    extra = (qs, qo) if quant else ()
    want = jax.jit(lambda *a: jn.rmsnorm_bias(*a[:3], EPS, *a[3:]),
                   compiler_options=NO_EXCESS)(x, w, b, *extra)
    got = tn.rmsnorm_bias(_t(x), _t(w), _t(b), EPS, *(_t(a) for a in extra))
    if quant:
        _assert_quant(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_rmsnorm_split_and_without_weight(rng, dtype):
    """fused_variance, fused_rsqrt_mul (fed the JAX variance, so that only
    the second stage is compared), rmsnorm_without_weight."""
    x, _, w, _, _, _ = _inputs(rng, 40, 256, dtype)
    jv = jn.fused_variance(x)
    _close(tn.fused_variance(_t(x)), jv, "variance")
    _close(tn.fused_rsqrt_mul(_t(x), _t(jv), _t(w)), jn.fused_rsqrt_mul(x, jv, w), "rsqrt_mul")
    _close(tn.rmsnorm_without_weight(_t(x), EPS), jn.rmsnorm_without_weight(x, EPS),
           "without_weight")


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_l1_norm(rng, dtype):
    x = jnp.asarray(rng.standard_normal((24, 300)), dtype)
    got = tn.l1_norm(_t(x))
    assert got.dtype == torch.float32
    _close(got, jn.l1_norm(x))


@pytest.mark.parametrize("shift_kind", ["scalar", "hidden", "full"])
def test_fused_scale_shift(rng, shift_kind):
    n, d = 16, 128
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16)
    scale = jnp.asarray(rng.standard_normal(d), jnp.float32)
    shift = jnp.asarray(rng.standard_normal({"scalar": (1,), "hidden": (d,),
                                             "full": (n, d)}[shift_kind]), jnp.float32)
    want = jn.fused_scale_shift(x, scale, shift, 0.5)
    got = tn.fused_scale_shift(_t(x), _t(scale), _t(shift), 0.5)
    _close(got, want, shift_kind)


def test_cpu_tensors_launch_nothing(rng):
    """On CPU tensors the kernel path runs its plain version: no counter
    moves, and the plain version is what add_rmsnorm_bias returns."""
    x, r, w, b, qs, qo = (_t(a) for a in _inputs(rng, 8, 128, jnp.bfloat16))
    before = dict(_build.launches)
    got = tn.add_rmsnorm_bias(x, r, w, b, EPS, qs, qo)
    assert _build.launches == before
    want = tn.add_rmsnorm_bias_ref(x, r, w, b, EPS, qs, qo)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert _build.launches["add_rmsnorm_quant"] == 0
