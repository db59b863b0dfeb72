"""The port's soft-FP8 W8A16 GEMMs (kernel K21's plain versions and glue),
block fp8 quantisation and helloworld (K22's plain version) against the JAX
package on the CPU.

The same numpy inputs from a seed go to both packages; fp8 weights cross as
bytes (quant.fp8_from_jax). The JAX side runs its Pallas kernels in
interpret mode (SKT_IMPL=pallas) and its reference tier; the port runs its
plain PyTorch versions (device="cpu"); chip_smoke.py holds the CUDA kernels
against those on the card.

Tolerances, each with its reason:
  * per_block_quant_fp8 / dequant_fp8_block: bit-equal to eager JAX, which
    divides by 448 as the port does; the jitted JAX multiplies by f32(1/448)
    instead, so there a scale may sit one f32 ulp away and an e4m3 byte one
    step away, on at most 0.1% of the entries;
  * the GEMMs (`assert_gemm_close`): calc_diff <= 1e-5 and every value
    within one bf16 ulp (2^-7 of the larger magnitude) of the JAX value plus
    1e-4 * max|JAX|: the port adds per-block f32 partial sums as the Pallas
    kernel does (the JAX reference sums all of K at once), so only the order
    of f32 sums differs. Measured here: the port's plain version equals the
    interpreted dense Pallas kernel bit for bit at every shape below, and
    the grouped one but for two values one bf16 ulp apart (of 10,240; the
    products of a group's rows are taken as one CPU matmul);
  * helloworld: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu import version as jversion
from sgl_kernel_npu_tpu.ops import helloworld as jhw
from sgl_kernel_npu_tpu.ops import matmul as jmm
from sgl_kernel_npu_tpu.ops import quant as jq
from sgl_kernel_npu_tpu_torch import __version__
from sgl_kernel_npu_tpu_torch.ops import helloworld as thw
from sgl_kernel_npu_tpu_torch.ops import matmul as tmm
from sgl_kernel_npu_tpu_torch.ops import quant as tq

from .utils import calc_diff

GEMM_DIFF = 1e-5
GEMM_SHARE = 1e-4
FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SKT_IMPL", "pallas")


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    """numpy / jax array -> torch tensor (bf16 stays bf16, fp8 by its bytes)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return tq.fp8_from_jax(a, device="cpu")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_gemm_close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert calc_diff(got, want) <= GEMM_DIFF, (name, calc_diff(got, want))
    err = np.abs(got - want)
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + GEMM_SHARE * np.abs(want).max()
    assert (err <= bound).all(), (name, float(err.max()), int((err > bound).sum()))


def _spread(rng, rows, cols):
    """f32 rows whose 128-blocks span magnitudes 1e-5 .. 1e3."""
    mags = 10.0 ** rng.uniform(-5, 3, (rows, cols // 128, 1))
    x = rng.standard_normal((rows, cols // 128, 128)) * mags
    return x.reshape(rows, cols).astype(np.float32)


@pytest.mark.parametrize("compiled", [False, True])
def test_per_block_quant_fp8_matches_jax(rng, compiled):
    """Scales and e4m3 bytes of per_block_quant_fp8 against eager JAX
    (bit-equal) and jitted JAX (scales within one f32 ulp, bytes within one
    e4m3 step on at most 0.1% of the entries); dequant_fp8_block bit-equal."""
    x = _spread(rng, 64, 1024)
    fn = jax.jit(jq.per_block_quant_fp8) if compiled else jq.per_block_quant_fp8
    jqv, js = fn(jnp.asarray(x))
    tqv, ts = tq.per_block_quant_fp8(torch.from_numpy(x))
    jb = np.asarray(jqv).view(np.uint8).astype(np.int32)
    tb = tqv.view(torch.uint8).numpy().astype(np.int32)
    js, ts = np.asarray(js), ts.numpy()
    assert tqv.dtype == torch.float8_e4m3fn and ts.shape == js.shape == (64, 8)
    if not compiled:
        assert np.array_equal(ts, js) and np.array_equal(tb, jb)
    else:
        assert (np.abs(ts - js) <= np.spacing(js)).all()
        flips = tb != jb
        assert flips.mean() <= FLIP_SHARE, flips.mean()
        # same sign byte, codes one apart: one e4m3 step
        assert (((tb ^ jb) & 0x80)[flips] == 0).all() and (np.abs(tb - jb)[flips] <= 1).all()
    jd = jq.dequant_fp8_block(jqv, js if compiled else jnp.asarray(js), dtype=jnp.float32)
    td = tq.dequant_fp8_block(_t(jqv), torch.from_numpy(np.array(js)), dtype=torch.float32)
    assert np.array_equal(td.numpy(), np.asarray(jd))


def test_fp8_from_jax_is_bit_exact():
    """All 256 e4m3 codes (NaN 0x7F / 0xFF, signed zeros, subnormals, 448)
    carried into torch.float8_e4m3fn: the same bytes and the same values."""
    codes = np.arange(256, dtype=np.uint8)
    j = jnp.asarray(codes.view(jnp.float8_e4m3fn))
    t = tq.fp8_from_jax(np.asarray(j), device="cpu")
    assert np.array_equal(t.view(torch.uint8).numpy(), codes)
    jf, tf = np.asarray(j.astype(jnp.float32)), t.float().numpy()
    assert np.array_equal(np.isnan(jf), np.isnan(tf)) and np.isnan(tf[[0x7F, 0xFF]]).all()
    ok = ~np.isnan(jf)
    assert np.array_equal(jf[ok].view(np.uint32), tf[ok].view(np.uint32))
    with pytest.raises(TypeError):
        tq.fp8_from_jax(np.zeros(4, np.uint8), device="cpu")


def test_int8_helpers_match_jax(rng):
    """per_tensor_quant_int8_asymm and dequant_int8, the rest of quant.py."""
    x = rng.standard_normal((16, 256)).astype(np.float32) * 4
    want = jq.per_tensor_quant_int8_asymm(jnp.asarray(x), 0.05, 3.0)
    got = tq.per_tensor_quant_int8_asymm(torch.from_numpy(x), 0.05, 3.0)
    assert np.array_equal(got.numpy(), np.asarray(want))
    s = np.float32(0.013)
    assert np.array_equal(tq.dequant_int8(got, s, torch.float32).numpy(),
                          np.asarray(jq.dequant_int8(want, s, jnp.float32)))


def _weights(rng, shape):
    """fp8 e4m3 weights [..., K, N] (randn cast, as the JAX tests make
    them) and f32 block scales [..., ceil(K/128), ceil(N/128)]."""
    *lead, k, n = shape
    w = jnp.asarray(rng.standard_normal(shape) * 4, jnp.float8_e4m3fn)
    sc = rng.random((*lead, -(-k // 128), -(-n // 128)), dtype=np.float32) * 0.02 + 0.005
    return w, jnp.asarray(sc)


@pytest.mark.parametrize("m,k,n", [(8, 256, 256), (40, 384, 128), (3, 256, 576),
                                   (17, 200, 576), (33, 136, 200)])
def test_mm_wfp8a16_matches_jax(rng, m, k, n):
    """mm_wfp8a16 (plain on the CPU) against the JAX reference and, at K
    and N multiples of 128, the interpreted Pallas kernel; the
    ragged K / N (DeepSeek-V3's kv_a_proj_with_mqa has N 576) go to the JAX
    reference there, to K21 on the card."""
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    w, sc = _weights(rng, (k, n))
    got = tmm.mm_wfp8a16(_t(x), _t(w), _t(sc))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert torch.equal(got, tmm.mm_wfp8a16_ref(_t(x), _t(w), _t(sc)))
    assert_gemm_close(got.float(), _np(jmm.mm_wfp8a16_ref(x, w, sc)), "vs ref")
    if k % 128 == 0 and n % 128 == 0:
        pal = _np(jmm.mm_wfp8a16_pallas(x, w, sc, block_m=16))
        assert_gemm_close(got.float(), pal, "vs pallas")


def test_mm_wfp8a16_nan_weight_code_propagates(rng):
    """An e4m3 NaN code (0x7F) in the weights gives NaN in its output
    column, as JAX's astype(f32) gives it."""
    x = jnp.asarray(rng.standard_normal((4, 128)), jnp.bfloat16)
    w, sc = _weights(rng, (128, 128))
    wb = np.asarray(w).view(np.uint8).copy()
    wb[5, 7] = 0x7F
    w = jnp.asarray(wb.view(jnp.float8_e4m3fn))
    got = tmm.mm_wfp8a16(_t(x), _t(w), _t(sc)).float().numpy()
    want = _np(jmm.mm_wfp8a16_ref(x, w, sc))
    assert np.isnan(got[:, 7]).all() and np.array_equal(np.isnan(got), np.isnan(want))


GROUPS = {"every row": [10, 0, 20, 10], "one expert": [0, 40, 0, 0],
          "short of S": [10, 0, 20, 5], "ragged K, N": [7, 13, 0, 20]}


@pytest.mark.parametrize("case", list(GROUPS))
def test_gmm_wfp8a16_matches_jax(rng, case):
    """gmm_wfp8a16 (the aligned compaction around the grouped contract,
    plain on the CPU) against the JAX reference on every row, and against
    the interpreted JAX Pallas tier (block_m 16) on the rows the groups
    cover; S 40, G 4, empty groups, one expert with every row, a sum below
    S (rows past it zero, as the reference), and a ragged K / N (the JAX
    reference only)."""
    s, g, (k, n) = 40, 4, ((200, 136) if case == "ragged K, N" else (256, 256))
    x = jnp.asarray(rng.standard_normal((s, k)), jnp.bfloat16)
    w, sc = _weights(rng, (g, k, n))
    gl = jnp.asarray(GROUPS[case], jnp.int32)
    got = tmm.gmm_wfp8a16(_t(x), _t(w), _t(sc), _t(gl), block_m=16)
    assert got.dtype == torch.bfloat16 and got.shape == (s, n)
    ref = _np(jmm.gmm_wfp8a16_ref(x, w, sc, gl))
    assert_gemm_close(got.float(), ref, "vs ref")
    assert torch.equal(got, tmm.gmm_wfp8a16_ref(_t(x), _t(w), _t(sc), _t(gl)))
    total = int(np.sum(GROUPS[case]))
    assert not got[total:].float().abs().any()
    if k % 128 == 0 and n % 128 == 0:
        pal = _np(jmm.gmm_wfp8a16(x, w, sc, gl, block_m=16))
        assert_gemm_close(got[:total].float(), pal[:total], "vs pallas")


def test_gmm_wfp8a16_pallas_tier_fills_rows_past_the_groups(rng):
    """A standing difference of the reference: with sum(group_list) < S the
    JAX Pallas tier clips a tail row's group to G - 1 (matmul.py:439-446)
    and returns that expert's product there, where its reference
    (ragged_dot) returns zeros. The port gives the reference's zeros."""
    s, g, k, n = 40, 4, 256, 256
    x = jnp.asarray(rng.standard_normal((s, k)), jnp.bfloat16)
    w, sc = _weights(rng, (g, k, n))
    gl = jnp.asarray(GROUPS["short of S"], jnp.int32)
    pal = _np(jmm.gmm_wfp8a16(x, w, sc, gl, block_m=16))
    ref = _np(jmm.gmm_wfp8a16_ref(x, w, sc, gl))
    got = tmm.gmm_wfp8a16(_t(x), _t(w), _t(sc), _t(gl), block_m=16).float().numpy()
    assert np.abs(pal[35:]).max() > 1.0 and not np.abs(ref[35:]).any()
    assert not np.abs(got[35:]).any()
    assert_gemm_close(got[:35], pal[:35], "vs pallas")


def test_gmm_wfp8a16_aligned_contract_matches_jax(rng):
    """The grouped contract directly (gmm_wfp8a16_pallas_aligned): three
    32-row tiles on experts 2, 0, 3 of a [4, 256, 384] bank, one of them
    all zeros (a padding tile), against the interpreted JAX kernel."""
    m, g, k, n = 96, 4, 256, 384
    xn = rng.standard_normal((m, k))
    xn[32:64] = 0.0
    x = jnp.asarray(xn, jnp.bfloat16)
    w, sc = _weights(rng, (g, k, n))
    eid = jnp.asarray([2, 0, 3], jnp.int32)
    want = _np(jmm.gmm_wfp8a16_pallas_aligned(x, w, sc, eid, block_m=32))
    got = tmm.gmm_wfp8a16_aligned(_t(x), _t(w), _t(sc), _t(eid), block_m=32)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert_gemm_close(got.float(), want, "vs pallas")
    assert not got[32:64].float().abs().any()
    with pytest.raises(ValueError):
        tmm.gmm_wfp8a16_aligned(_t(x)[:80], _t(w), _t(sc), _t(eid), block_m=32)


def test_k21_wrapper_refuses_what_the_kernel_does_not_take(rng):
    """The launch path's checks (reached before any CUDA call): fp8 e4m3
    weights only, contiguous operands, scales of the weights' shape."""
    x = torch.zeros((4, 256), dtype=torch.bfloat16)
    w, sc = _weights(rng, (1, 256, 256))
    tw, tsc = _t(w), _t(sc)
    with pytest.raises(TypeError):
        tmm._wfp8a16_gemm(x, tw.view(torch.uint8), tsc, None, 0, 128)
    with pytest.raises(TypeError):
        tmm._wfp8a16_gemm(x.float(), tw, tsc, None, 0, 128)
    with pytest.raises(ValueError):
        tmm._wfp8a16_gemm(torch.zeros((256, 4), dtype=torch.bfloat16).t(), tw, tsc, None, 0,
                          128)
    with pytest.raises(ValueError):
        tmm._wfp8a16_gemm(x, tw, tsc[:, :1], None, 0, 128)


@pytest.mark.parametrize("shape", [(7, 33), (4096,), (2, 3, 40)])
def test_helloworld_matches_jax_exactly(rng, shape):
    """helloworld (plain on the CPU) against the interpreted JAX kernel:
    exact, at sizes with a tail past the kernel's 8-value vectors."""
    x = jnp.asarray(rng.standard_normal(shape) * 3, jnp.bfloat16)
    y = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    want = _np(jhw.helloworld(x, y))
    got = thw.helloworld(_t(x), _t(y))
    assert got.dtype == torch.bfloat16 and np.array_equal(got.float().numpy(), want)
    assert torch.equal(got, thw.helloworld_ref(_t(x), _t(y)))


def test_version_info():
    assert __version__ == jversion.__version__
    info = thw.version_info()
    assert info.startswith(f"sgl_kernel_npu_tpu_torch {__version__} (") and info.endswith(")")
