"""The port's MLA slice against the JAX package on the CPU: the weights, the
fused RMSNorm-quant GEMM in its per_tensor mode (K2), the combined-cache
decode (K5), the latent append and its glue (K6), the split-cache decode
(K7), mla_preprocess, the `bench.py --config mla` decode path
(decode_step_c) and MlaEngine.

The same numpy inputs go to both packages. The JAX side runs its Pallas
kernels in interpret mode (SKT_IMPL=pallas); its model functions are
compiled with `xla_allow_excess_precision` off, as in tests/test_torch_tm2.py,
so that it rounds where its code casts. The port runs its plain PyTorch
versions (device="cpu"); chip_smoke.py holds the CUDA kernels against those
on the card.

Tolerances, each with its reason:
  * the weights, K6, the latent quant and the scale update: exact (draws,
    copies, one rounding order);
  * K2: flip-aware (tests/test_rmsq_gemm.py::assert_quant_close): within 4
    quant flips per row and >= 90% of rows bit-exact, as K2's per_token
    tests; the quant step alone (an identity weight) is exact;
  * K5 and K7 (`assert_bf16_close`), on inputs that make O(1) outputs and a
    peaked softmax: each output within one bf16 ulp of the reference's (two
    f32 results a summation order apart round to neighbouring bf16 values)
    plus a share of max|ref|: 1e-4 for K7, whose math is all f32, and 2e-3
    for K5, whose p is rounded to bf16 and may land an ulp apart;
  * mla_preprocess and the model: the JAX package takes rstd from XLA's CPU
    rsqrt of an f32 sum, the port correctly rounded from a float64 sum
    (ROADMAP Queue 3), so a row's quant may flip; bounds below.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu import serving as jserving
from sgl_kernel_npu_tpu.models import deepseek_mla as jdm
from sgl_kernel_npu_tpu.ops import matmul as jmm
from sgl_kernel_npu_tpu.ops import mla_preprocess as jmp
from sgl_kernel_npu_tpu.ops import rmsq_gemm as jrq
from sgl_kernel_npu_tpu.ops.attention import decode as jdec
from sgl_kernel_npu_tpu.ops.attention import decode_mla_v2 as jv2
from sgl_kernel_npu_tpu_torch import serving as tserving
from sgl_kernel_npu_tpu_torch.models import deepseek_mla as tdm
from sgl_kernel_npu_tpu_torch.ops import matmul as tmm
from sgl_kernel_npu_tpu_torch.ops import mla_preprocess as tmp
from sgl_kernel_npu_tpu_torch.ops import rmsq_gemm as trq
from sgl_kernel_npu_tpu_torch.ops.attention import decode as tdec
from sgl_kernel_npu_tpu_torch.ops.attention import decode_mla_v2 as tv2

from .test_rmsq_gemm import assert_quant_close
from .utils import calc_diff

NO_EXCESS = {"xla_allow_excess_precision": False}
K5_ATOL = 2e-3          # of max|ref|, beside one bf16 ulp (module docstring)
K7_ATOL = 1e-4
LOGITS_DIFF = 8e-3


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(_np(a)))


def _bf16(rng, shape, scale=1.0):
    j = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    return j, _t(j).to(torch.bfloat16)


def assert_bf16_close(got, want, share, name=""):
    """Every value of `got` within one bf16 ulp of `want` (2^-7 of its
    magnitude) plus `share` * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    bad = err > 2.0 ** -7 * np.abs(want) + share * np.abs(want).max()
    assert not bad.any(), (name, float(err.max()), int(bad.sum()), float(np.abs(want).max()))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


# ------------------------------------------------------------------ weights


def test_init_params_bit_equal_to_jax():
    """Same seed, same draws: every leaf of the port's init_params equals the
    JAX package's bit for bit (embed rounded from float64 to bf16 alike),
    params_from_jax carries the JAX tree over unchanged, and the RoPE tables
    of make_mla_cos_sin are equal."""
    cfg = jdm.tiny_config()
    jp = jax.tree.map(np.asarray, jdm.init_params(cfg, 3))
    tp = tdm.init_params(cfg, 3, "cpu")
    carried = tdm.params_from_jax(jp, "cpu")
    for a, t in zip(jdm.make_mla_cos_sin(cfg), tdm.make_mla_cos_sin(cfg, device="cpu")):
        assert np.array_equal(np.asarray(a), t.numpy())
    jl, tl_, cl = dict(_leaves(jp)), dict(_leaves(tp)), dict(_leaves(carried))
    assert jl.keys() == tl_.keys() == cl.keys()
    for name, a in jl.items():
        t, c = tl_[name], cl[name]
        assert t.dtype == c.dtype and tuple(t.shape) == a.shape, name
        assert torch.equal(t, c), name
        if a.dtype.name == "bfloat16":
            assert np.array_equal(a.view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16)), name
        else:
            assert np.array_equal(a, t.numpy()), name


def test_pretile_and_fuse_mla_weights_match_jax():
    """fuse_mla_weights' [in, out] copies and pretile_mla_weights' banks
    (N and the intermediate zero-padded to the panel width) equal the JAX
    package's, leaf by leaf; the JAX contracted-axis-last copies of wuk / wuv
    are not made (SKT_WUKV_T is off)."""
    cfg = jdm.tiny_config(intermediate_size=320)
    jp = jdm.pretile_mla_weights(jdm.fuse_mla_weights(jdm.init_params(cfg, 4)), cfg,
                                 block_n=128)
    tp = tdm.pretile_mla_weights(tdm.fuse_mla_weights(tdm.init_params(cfg, 4, "cpu")),
                                 cfg, block_n=128)
    assert tp["fast"]["wdqkv"]["q"].shape[1] * 128 == 256     # N 176 -> 256
    assert tp["fast"]["w2"]["q"].shape[2] == 384               # f 320 -> 384
    jf = dict(_leaves(jax.tree.map(np.asarray, jp["fast"])))
    tf = dict(_leaves(tp["fast"]))
    assert set(tf) == set(jf) - {"/wuk_t", "/wuv_t"}
    for name, t in tf.items():
        assert np.array_equal(_np(jf[name]), _np(t.float() if t.dtype == torch.bfloat16
                                                   else t)), name
    for name in ("wdqkv", "wuq"):
        assert np.array_equal(np.asarray(jp["layers"][name]["kn"]),
                              tp["layers"][name]["kn"].numpy())


# ------------------------------------------------------------ K2 per_tensor


def _pt_case(rng, m, k, n, layers, x_dtype):
    x = rng.standard_normal((m, k)) * 0.5
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32)
    tx = _t(jx).to(getattr(torch, x_dtype))
    gamma = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    beta = (0.05 * rng.standard_normal(k)).astype(np.float32)
    w = rng.integers(-100, 101, (layers, k, n), dtype=np.int8)
    ds = (rng.random((layers, n)) / 100 + 1e-4).astype(np.float32)
    bias = rng.integers(-50, 50, (layers, n)).astype(np.int32)
    return jx, tx, gamma, beta, w, ds, bias


@pytest.mark.parametrize("layout", ["plain", "tiled"])
@pytest.mark.parametrize("apply_norm", [True, False])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_rmsq_gemm_per_tensor_matches_jax(monkeypatch, layout, apply_norm, x_dtype):
    """K2's per_tensor contract with the int32 bias and quant_cast="fp16",
    on a plain [K, N] weight and on a pretiled bank (both layers), bf16 or f32
    x (the MLA path's second stage takes an f32 column slice), against the
    JAX kernel compiled under jax.jit."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(100)
    layers, m, k, n, bn = 2, 32, 256, 384, 128
    jx, tx, gamma, beta, w, ds, bias = _pt_case(rng, m, k, n, layers, x_dtype)
    qs, qo = np.float32(0.07), np.float32(3.0)
    fused = jax.jit(lambda x, g, b, w_, d, bi, s, o, li: jrq.rmsnorm_quant_gemm(
        x, g, b, w_, d, bi, s, o, li=li, quant_mode="per_tensor", apply_norm=apply_norm,
        quant_cast="fp16"), compiler_options=NO_EXCESS)
    for li in (0, layers - 1):
        if layout == "tiled":
            jw, tw = jmm.pretile_weight_bank(jnp.asarray(w), bn), tmm.pretile_weight_bank(
                _t(w), bn)
            jd, td, jb, tb, jli = jnp.asarray(ds), _t(ds), jnp.asarray(bias), _t(bias), li
        else:
            jw, tw = jnp.asarray(w[li]), _t(w[li])
            jd, td, jb, tb, jli = (jnp.asarray(ds[li]), _t(ds[li]), jnp.asarray(bias[li]),
                                   _t(bias[li]), None)
        want = fused(jx, jnp.asarray(gamma), jnp.asarray(beta), jw, jd, jb,
                     jnp.asarray(qs), jnp.asarray(qo), jli)
        got = trq.rmsnorm_quant_gemm(tx, _t(gamma), _t(beta), tw, td, tb, torch.tensor(qs),
                                     torch.tensor(qo), li=jli, quant_mode="per_tensor",
                                     apply_norm=apply_norm, quant_cast="fp16")
        assert got.dtype == torch.float32 and got.shape == (m, n)
        assert_quant_close(got.numpy(), _np(want), w[li], ds[li], name=f"layer {li}")


def test_rmsq_gemm_fp16_quant_edges_match_jax(monkeypatch):
    """The per_tensor quant step alone, through an identity weight so that
    the output is the int8 value: v = x / 1 + 0 at the rounding edges of the
    fp16 cast and the clip (+-127.5, +-128.5, 3.4995 -> fp16 3.5 -> 4,
    fp16 overflow, fp16 subnormals), equal to the JAX kernel (its bit-trick
    fp16 rounding) and to the JAX reference (a real float16 cast)."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    vals = np.array([127.5, -127.5, 128.5, -128.5, 126.5, -126.49, 3.4995, -3.4995,
                     2.5, 0.5, -0.5, 65520.0, -7e4, 1e-6, -3e-5, 1e-9], np.float32)
    k = 64
    x = np.resize(vals, (4, k)).astype(np.float32)
    x[1] = np.roll(x[1], 3)
    x[2:] = rng_x = np.random.default_rng(7).uniform(-130, 130, (2, k))
    del rng_x
    w = np.eye(k, dtype=np.int8)
    one, zero = np.ones(k, np.float32), np.zeros(k, np.float32)
    ds = np.ones(k, np.float32)
    args = dict(quant_mode="per_tensor", apply_norm=False, quant_cast="fp16")
    want = jrq.rmsnorm_quant_gemm(jnp.asarray(x), jnp.asarray(one), jnp.asarray(zero),
                                  jnp.asarray(w), jnp.asarray(ds), None, jnp.float32(1.0),
                                  jnp.float32(0.0), **args)
    want_ref = jrq.rmsnorm_quant_gemm_ref(jnp.asarray(x), jnp.asarray(one),
                                          jnp.asarray(zero), jnp.asarray(w), jnp.asarray(ds),
                                          None, jnp.float32(1.0), jnp.float32(0.0), **args)
    got = trq.rmsnorm_quant_gemm(_t(x), _t(one), _t(zero), _t(w), _t(ds), None,
                                 torch.tensor(1.0), torch.tensor(0.0), **args)
    assert np.array_equal(np.asarray(want), np.asarray(want_ref))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[0, :6].tolist() == [127.0, -128.0, 127.0, -128.0, 126.0, -126.0]
    assert got[0, 6:8].tolist() == [4.0, -4.0]


def test_rmsq_gemm_takes_a_strided_f32_slice():
    """The second mla_preprocess stage feeds K2 a column slice of an f32
    output: the wrapper takes it as it is (rows further apart than K) and
    gives what a contiguous copy gives."""
    rng = np.random.default_rng(101)
    wide = torch.from_numpy(rng.standard_normal((16, 320)).astype(np.float32))
    x = wide[:, 64:320]
    assert not x.is_contiguous() and x.stride() == (320, 1)
    w = torch.from_numpy(rng.integers(-100, 101, (256, 128), dtype=np.int8))
    ds = torch.full((128,), 1e-3)
    g, b = torch.ones(256), torch.zeros(256)
    kw = dict(quant_scale=torch.tensor(0.05), quant_offset=torch.tensor(1.0),
              quant_mode="per_tensor", quant_cast="fp16")
    assert torch.equal(trq.rmsnorm_quant_gemm(x, g, b, w, ds, **kw),
                       trq.rmsnorm_quant_gemm(x.contiguous(), g, b, w, ds, **kw))


# --------------------------------------------------------------------- K5


def _mla_case(rng, b, h=4, lkv=64, lrope=16, ps=16, max_pages=6, layers=2, int8=False):
    c = lkv + lrope
    num_pages = b * max_pages + 1
    if int8:
        cache = rng.integers(-127, 128, (layers, num_pages, ps, c), dtype=np.int8)
        scales = (rng.random((layers, num_pages, 1, ps)) * 0.02 + 0.005).astype(np.float32)
    else:
        cache = np.asarray(jnp.asarray(rng.standard_normal(
            (layers, num_pages, ps, c)), jnp.bfloat16))
        scales = None
    # scores of about 3 standard deviations at sm_scale 0.1: a peaked softmax
    jq, tq = _bf16(rng, (b, h, c), 3.0)
    jn, tn = _bf16(rng, (b, c))
    bt = (rng.permutation(num_pages - 1)[: b * max_pages].reshape(b, max_pages) + 1
          ).astype(np.int32)
    # page and chunk boundaries (chunks of 4 pages), 0 and the whole table
    cached = np.array([0, 1, ps - 1, ps, ps + 1, 4 * ps, 4 * ps + 1, max_pages * ps],
                      np.int32)[:b]
    return jq, tq, jn, tn, cache, scales, bt, cached, ps, lkv


@pytest.mark.parametrize("kind,group,b", [("int8", 8, 8), ("int8", 4, 8), ("int8", 2, 6),
                                         ("bf16", 8, 8), ("bf16", 4, 8), ("bf16", 8, 5)])
def test_decode_mla_c_matches_jax(monkeypatch, kind, group, b):
    """Kernel K5's contract against decode_mla_pallas_v3_defer (groups of 8,
    4 and 2 sequences per TPU loop body; an odd batch of 5 falls back to
    decode_mla_pallas_v2_defer) at cached lengths 0, page and chunk
    boundaries and the full table, both layers."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(110 + group + b)
    int8 = kind == "int8"
    jq, tq, jn, tn, cache, scales, bt, cached, ps, lkv = _mla_case(rng, b, int8=int8)
    sm = 0.1
    jfn = jax.jit(functools.partial(jv2.decode_mla_pallas_v3_defer, sm_scale=sm,
                                    page_size=ps, lkv=lkv, group=group))
    for li in (0, 1):
        want = jfn(jq, jn, jnp.asarray(cache), jnp.asarray(cached), jnp.asarray(bt),
                   layer_idx=jnp.int32(li), kv_scales=jnp.asarray(scales) if int8 else None)
        got = tv2.decode_mla_v3_defer(tq, tn, _t(cache).to(torch.bfloat16) if not int8
                                      else _t(cache), _t(cached), _t(bt), sm, ps, lkv,
                                      layer_idx=li,
                                      kv_scales=_t(scales) if int8 else None)
        assert got.dtype == torch.bfloat16 and got.shape == (b, 4, lkv)
        assert_bf16_close(got.float().numpy(), _np(want), K5_ATOL, name=f"layer {li}")
        if not int8:
            ref = tv2.decode_mla_v2_ref(tq, _t(cache).to(torch.bfloat16), tn, _t(cached),
                                        _t(bt), sm, ps, lkv, layer_idx=li)
            assert torch.equal(ref, got)
    # cached = 0: the output is the current row (a softmax of one), exactly
    assert torch.equal(got[0], tn[0, :lkv].expand(4, lkv))


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_decode_mla_c_two_steps_match_jax(monkeypatch, kind):
    """K5's contract over two online-softmax steps (MP 8 pages at cp = 4, the
    JAX SKT_MLA_CP default): the plain version against
    decode_mla_pallas_v3_defer in interpret mode, at DeepSeek's 16 heads,
    with cached lengths that end in the first step, on its edge and in the
    second, within one bf16 ulp + K5_ATOL of max|JAX| (p rounded to bf16
    against each step's running maximum on both sides)."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(140 + (kind == "int8"))
    int8 = kind == "int8"
    b, mp, ps = 6, 8, 16
    jq, tq, jn, tn, cache, scales, bt, _, _, lkv = _mla_case(rng, b, h=16, ps=ps, max_pages=mp,
                                                             int8=int8)
    assert tv2._chunk_pages(mp) == 4 and jv2.CHUNK_PAGES == 4
    cached = np.array([3 * ps + 5, 4 * ps, 4 * ps + 1, 6 * ps + 7, mp * ps, 0], np.int32)
    sm = 0.1
    want = jv2.decode_mla_pallas_v3_defer(jq, jn, jnp.asarray(cache), jnp.asarray(cached),
                                          jnp.asarray(bt), sm, ps, lkv, layer_idx=1,
                                          kv_scales=jnp.asarray(scales) if int8 else None)
    tc = _t(cache) if int8 else _t(cache).to(torch.bfloat16)
    got = tv2.decode_mla_v3_defer(tq, tn, tc, _t(cached), _t(bt), sm, ps, lkv, layer_idx=1,
                                  kv_scales=_t(scales) if int8 else None)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 16, lkv)
    assert_bf16_close(got.float().numpy(), _np(want), K5_ATOL, name=f"two steps {kind}")


# ------------------------------------------------------- K6 and the glue


# K6's layouts: (layers, pages of each row, slot of each row); page 9 (P)
# drops its row
APPEND_LAYOUTS = {
    "mixed": (3, (1, 3, 8, 9, 5), (0, 15, 7, 3, 9)),
    "L1-B1": (1, (4,), (15,)),                       # one layer, one row, the last slot
    "all-dropped": (3, (9, 9, 9, 9, 9), (0, 15, 7, 3, 9)),
    "last-slot": (3, (2, 0, 8, 6, 4), (15, 0, 15, 7, 15)),
}


@pytest.mark.parametrize("dtype, layout", [
    pytest.param("int8", "mixed", id="int8"), pytest.param("bf16", "mixed", id="bf16"),
    pytest.param("int8", "L1-B1", id="int8-L1-B1"),
    pytest.param("bf16", "all-dropped", id="bf16-all-dropped"),
    pytest.param("int8", "last-slot", id="int8-last-slot")])
def test_append_mla_matches_jax(monkeypatch, dtype, layout):
    """Kernel K6's contract: exact pages, in place, with a dropped row (page
    P) that writes nothing; also one layer and one row, every row dropped,
    slots at ps - 1."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(120)
    layers, pg, off = APPEND_LAYOUTS[layout]
    b, c, ps, pages = len(pg), 80, 16, 9
    if dtype == "int8":
        cache = rng.integers(-127, 128, (layers, pages, ps, c), dtype=np.int8)
        new = rng.integers(-127, 128, (layers, b, c), dtype=np.int8)
        tc, tn = _t(cache), _t(new)
    else:
        cache = np.asarray(jnp.asarray(rng.standard_normal((layers, pages, ps, c)),
                                       jnp.bfloat16))
        new = np.asarray(jnp.asarray(rng.standard_normal((layers, b, c)), jnp.bfloat16))
        tc, tn = _t(cache).to(torch.bfloat16), _t(new).to(torch.bfloat16)
    pg, off = np.array(pg, np.int32), np.array(off, np.int32)
    want = jv2.append_mla_pallas(*(jnp.asarray(a) for a in (new, cache, pg, off)))
    out = tv2.append_mla(tn, tc, _t(pg), _t(off))
    assert out is tc
    assert np.array_equal(_np(want), _np(tc.float() if dtype == "bf16" else tc))
    changed = (_np(tc.float() if dtype == "bf16" else tc) != _np(cache)).any(axis=(0, 3))
    written = sorted((int(p), int(o)) for p, o in zip(pg, off) if p < pages)
    assert sorted(zip(*np.nonzero(changed))) == written
    if layout == "mixed":
        assert written == [(1, 0), (3, 15), (5, 9), (8, 7)]


def test_latent_quant_and_scales_match_jax(monkeypatch):
    """quant_latent_rows (compiled, as decode_step_c compiles it) and
    scatter_latent_scales: exact, the scale update in place, a dropped row
    writing nothing."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(121)
    layers, b, c, ps, pages = 3, 5, 80, 16, 9
    new = np.array(jnp.asarray(rng.standard_normal((layers, b, c)) * 0.7, jnp.bfloat16))
    new[1, 2] = 0                                           # an all-zero row
    jq, js = jax.jit(jv2.quant_latent_rows, compiler_options=NO_EXCESS)(jnp.asarray(new))
    tq, ts = tv2.quant_latent_rows(_t(new).to(torch.bfloat16))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    scales = (rng.random((layers, pages, 1, ps))).astype(np.float32)
    pg = np.array([1, 3, 8, pages, 5], np.int32)
    off = np.array([0, 15, 7, 3, 9], np.int32)
    want = jv2.scatter_latent_scales(jnp.asarray(scales), js, jnp.asarray(pg),
                                     jnp.asarray(off))
    tsc = _t(scales)
    assert tv2.scatter_latent_scales(tsc, ts, _t(pg), _t(off)) is tsc
    assert np.array_equal(np.asarray(want), tsc.numpy())


# --------------------------------------------------------------------- K7


def test_decode_mla_split_matches_jax(monkeypatch):
    """Kernel K7's contract against decode_mla_pallas (split ckv / krope
    caches, seq_lens including the current token) at page boundaries, and
    against the JAX package's one-softmax decode_mla_ref."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(130)
    b, h, lkv, lrope, ps, mp = 5, 4, 64, 16, 16, 5
    pages = b * mp + 1
    jck, tck = _bf16(rng, (pages, ps, lkv))
    jkr, tkr = _bf16(rng, (pages, ps, lrope))
    jq, tq = _bf16(rng, (b, h, lkv + lrope), 3.0)
    seq = np.array([1, ps, ps + 1, 3 * ps - 1, mp * ps], np.int32)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    sm = 0.1
    want = jdec.decode_mla_pallas(jq, jck, jkr, jnp.asarray(seq), jnp.asarray(bt), sm, ps)
    got = tdec.decode_mla(tq, tck, tkr, _t(seq), _t(bt), sm, ps)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, lkv)
    assert_bf16_close(got.float().numpy(), _np(want), K7_ATOL)
    one = jdec.decode_mla_ref(jq, jck, jkr, jnp.asarray(seq), jnp.asarray(bt), sm, ps)
    assert_bf16_close(got.float().numpy(), _np(one), K7_ATOL)


# ----------------------------------------------------------- mla_preprocess


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("quant_mode", ["per_tensor", "per_token"])
def test_mla_preprocess_matches_jax(monkeypatch, fused, quant_mode):
    """mla_preprocess in its krope_ctkv mode, the fused tier (the [in, out]
    copies given) and the unfused composition, against the JAX package
    compiled under jax.jit: q_nope and q_pe within calc_diff 1e-4 and >= 99%
    of their bf16 values equal, the written cache rows equal but for a
    quant flip's reach (the rstd hazard of the module docstring), untouched
    rows unchanged."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(140)
    n, hid, kn, kp, qr, h, qn = 8, 256, 64, 16, 128, 4, 32
    mm1 = kn + kp + qr
    hidden = np.asarray(jnp.asarray(rng.uniform(-2, 2, (n, hid)), jnp.bfloat16))
    f32 = lambda *s: (rng.standard_normal(s) * 0.1 + 1).astype(np.float32)  # noqa: E731
    gamma0, beta0 = f32(hid), (rng.standard_normal(hid) * 0.05).astype(np.float32)
    gamma1, beta1 = f32(qr), (rng.standard_normal(qr) * 0.05).astype(np.float32)
    gamma2 = f32(kn)
    wdqkv = rng.integers(-100, 101, (mm1, hid), dtype=np.int8)
    wuq = rng.integers(-100, 101, (h * (qn + kp), qr), dtype=np.int8)
    ds0 = (rng.random(mm1) / 2000 + 1e-4).astype(np.float32)
    ds1 = (rng.random(h * (qn + kp)) / 2000 + 1e-4).astype(np.float32)
    b0 = rng.integers(-50, 50, mm1).astype(np.int32)
    b1 = rng.integers(-50, 50, h * (qn + kp)).astype(np.int32)
    qs0, qo0 = np.array([0.05], np.float32), np.array([1.0], np.float32)
    qs1, qo1 = np.array([0.03], np.float32), np.array([-2.0], np.float32)
    ang = rng.uniform(0, 6, (n, kp)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    wuk = (rng.standard_normal((h, qn, kn)) * 0.05).astype(np.float32)
    pages, ps = 4, 16
    slots = np.array([5, 17, 18, -1, 33, 40, 63, -1], np.int32)
    ops = [hidden, gamma0, beta0, wdqkv, ds0, gamma1, beta1, wuq, ds1, gamma2, cos, sin,
           wuk]
    tail = [slots, qs0, qo0, b0, qs1, qo1, b1]
    kn_w = (wdqkv.T.copy(), wuq.T.copy()) if fused else (None, None)

    def jfn(*a):
        return jmp.mla_preprocess(*a[:13], a[13], a[14], *a[15:22], quant_mode=quant_mode,
                                  wdqkv_kn=a[22], wuq_kn=a[23])
    jit = jax.jit(jfn, compiler_options=NO_EXCESS)
    jc = [jnp.zeros((pages, ps, kn), jnp.bfloat16), jnp.zeros((pages, ps, kp), jnp.bfloat16)]
    want = jit(*(jnp.asarray(a) for a in ops), *jc, *(jnp.asarray(a) for a in tail),
               *(None if a is None else jnp.asarray(a) for a in kn_w))
    tc = [torch.zeros((pages, ps, kn), dtype=torch.bfloat16),
          torch.zeros((pages, ps, kp), dtype=torch.bfloat16)]
    targs = [_t(a).to(torch.bfloat16) if i == 0 else _t(a) for i, a in enumerate(ops)]
    got = tmp.mla_preprocess(*targs, *tc, *(_t(a) for a in tail), quant_mode=quant_mode,
                             wdqkv_kn=None if kn_w[0] is None else _t(kn_w[0]),
                             wuq_kn=None if kn_w[1] is None else _t(kn_w[1]))
    assert got.kv_cache is tc[0] and got.krope_cache is tc[1]
    for name, a, t in (("q_nope", want.q_nope, got.q_nope), ("q_pe", want.q_pe, got.q_pe),
                       ("ckv", want.kv_cache, got.kv_cache),
                       ("krope", want.krope_cache, got.krope_cache)):
        a, t = _np(a), t.float().numpy()
        assert a.shape == t.shape, name
        assert calc_diff(t, a) < 1e-4, (name, calc_diff(t, a))
        assert (a == t).mean() >= 0.99, (name, (a == t).mean())
    written = np.zeros(pages * ps, bool)
    written[slots[slots >= 0]] = True
    assert not got.kv_cache.reshape(pages * ps, kn)[torch.from_numpy(~written)].any()


def test_mla_preprocess_refuses_the_other_cache_modes():
    """Modes other than the reference's three (krope_ctkv, full,
    int8_nzcache; the last two in tests/test_torch_surface.py) raise."""
    for mode in ("nz", "combined"):
        with pytest.raises(ValueError, match="unknown cache_mode"):
            tmp.mla_preprocess(*([None] * 22), cache_mode=mode)


# ------------------------------------------------- the bench path (path a)


# Seeds of 70-81 whose three slice steps leave the strict cache bounds; each
# is named with its cause in test_mla_decode_slice_seed_sweep.
FLIP_SEEDS = ()


@functools.cache
def _slice():
    """(cfg, JAX params, port params, the JAX decode_step_c under jax.jit),
    built once per process: the tiny config with pretiled 128-wide banks."""
    cfg = jdm.tiny_config()
    jp = jdm.pretile_mla_weights(jdm.init_params(cfg, 0), cfg, block_n=128)
    tp = tdm.pretile_mla_weights(tdm.init_params(cfg, 0, "cpu"), cfg, block_n=128)
    jdec_c = jax.jit(lambda p, kv, *a: jdm.decode_step_c(p, cfg, kv, *a),
                     compiler_options=NO_EXCESS)
    return cfg, jp, tp, jdec_c


def _slice_start(seed, b=8):
    """B (default 8) sequences of 2 pages at position ps - 2 over an int8 combined
    cache pre-filled with the same seeded rows and scales on both sides (the
    JAX rows zero-padded to its 128-wide layout), and `step(jkv, ids, pos)`,
    one decode_step_c on each side -> (JAX logits, port logits, JAX cache)."""
    cfg, jp, tp, jdec_c = _slice()
    rng = np.random.default_rng(seed)
    mp, ps = 2, cfg.page_size
    pages = b * mp + 1
    c = tdm.combined_width(cfg)
    cpad = jdm.combined_width(cfg)
    rows = rng.integers(-127, 128, (cfg.num_layers, pages, ps, c), dtype=np.int8)
    scales = (rng.random((cfg.num_layers, pages, 1, ps)) * 0.02 + 0.001).astype(np.float32)
    jkv = {"kv": jnp.asarray(np.pad(rows, ((0, 0),) * 3 + ((0, cpad - c),))),
           "s": jnp.asarray(scales)}
    tkv = tdm.init_kv_cache_combined(cfg, pages, quant="int8", device="cpu")
    tkv["kv"].copy_(_t(rows))
    tkv["s"].copy_(_t(scales))
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)

    def step(jkv, ids, pos):
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        args = (ids.astype(np.int32), pos, pos + 1, bt, slots)
        jlg, jkv = jdec_c(jp, jkv, *(jnp.asarray(a) for a in args))
        tlg, tkv2 = tdm.decode_step_c(tp, cfg, tkv, *(_t(a) for a in args))
        assert tkv2 is tkv and tlg.shape == (b, cfg.vocab_size)
        return np.asarray(jlg), tlg.numpy(), jkv

    return cfg, rng, jkv, tkv, np.full(b, ps - 2, np.int32), step


def _cache_match(jkv, tkv):
    """(exact fraction of the int8 rows, their largest |diff|, exact fraction
    of the scales); the JAX pad columns must be zero."""
    c = tkv["kv"].shape[-1]
    a = np.asarray(jkv["kv"])
    assert not a[..., c:].any()
    a, t = a[..., :c].astype(np.int32), tkv["kv"].numpy().astype(np.int32)
    s_exact = (np.asarray(jkv["s"]) == tkv["s"].numpy()).mean()
    return (a == t).mean(), int(np.abs(a - t).max()), s_exact


def test_mla_decode_slice_matches_jax(monkeypatch):
    """decode_step_c on an int8 combined cache with pretiled banks, B = 8 (so
    both mla_preprocess stages take the fused K2 per_tensor, w13 the fused K2
    per_token, and v3 groups 8 sequences), from a pre-filled cache at
    position ps - 2: three steps that cross a page (logits calc_diff < 8e-3,
    the int8 latent cache >= 99.9% exact with |diff| <= 1, scales >= 99.9%
    exact), then four greedy steps with argmax feeding the next id on each
    side: the tokens are equal and every pick clears its runner-up by more
    than the largest logit difference seen."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg, rng, jkv, tkv, pos, step = _slice_start(71)
    for _ in range(3):
        jlg, tlg, jkv = step(jkv, rng.integers(0, cfg.vocab_size, len(pos)), pos)
        assert calc_diff(tlg, jlg) < LOGITS_DIFF
        exact, worst, sexact = _cache_match(jkv, tkv)
        assert exact >= 0.999 and worst <= 1 and sexact >= 0.999, (exact, worst, sexact)
        pos = pos + 1
    tids = rng.integers(0, cfg.vocab_size, len(pos))
    margins, diffs = [], []
    for _ in range(4):
        jlg, tlg, jkv = step(jkv, tids, pos)
        jids, tids = jlg.argmax(-1), tlg.argmax(-1)
        assert np.array_equal(jids, tids)
        top2 = np.sort(tlg, axis=-1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
        diffs.append(float(np.abs(tlg - jlg).max()))
        pos = pos + 1
    assert min(margins) > max(diffs), (margins, diffs)


@pytest.mark.parametrize("seed", range(70, 82))
def test_mla_decode_slice_seed_sweep(monkeypatch, seed):
    """The slice's first three steps on each seed of 70-81: logits within
    calc_diff 8e-3 at every step, and the strict cache bounds of
    test_mla_decode_slice_matches_jax on every seed outside FLIP_SEEDS."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg, rng, jkv, tkv, pos, step = _slice_start(seed)
    for _ in range(3):
        jlg, tlg, jkv = step(jkv, rng.integers(0, cfg.vocab_size, len(pos)), pos)
        assert calc_diff(tlg, jlg) < LOGITS_DIFF
        exact, worst, sexact = _cache_match(jkv, tkv)
        if seed in FLIP_SEEDS:
            assert exact >= 0.995 and worst <= 2 and sexact >= 0.995, (exact, worst, sexact)
        else:
            assert exact >= 0.999 and worst <= 1 and sexact >= 0.999, (exact, worst, sexact)
        pos = pos + 1


def test_mla_decode_slice_small_batch_matches_jax(monkeypatch):
    """The slice at B = 4, below the fused GEMMs' M >= 8 gate: the w13 stage
    runs the unfused RMSNorm and the stacked GEMM with f32 out on both sides,
    the two mla_preprocess stages K2's formula (the JAX package its unfused
    reference, the port K2's plain version). Two steps, the bounds of
    test_mla_decode_slice_matches_jax."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg, rng, jkv, tkv, pos, step = _slice_start(72, b=4)
    for _ in range(2):
        jlg, tlg, jkv = step(jkv, rng.integers(0, cfg.vocab_size, len(pos)), pos)
        assert calc_diff(tlg, jlg) < LOGITS_DIFF
        exact, worst, sexact = _cache_match(jkv, tkv)
        assert exact >= 0.999 and worst <= 1 and sexact >= 0.999, (exact, worst, sexact)
        pos = pos + 1


# ------------------------------------------------------ MlaEngine (path b)


def test_mla_prefill_step_matches_jax(monkeypatch):
    """prefill_step (single sequence, unfused stages, causal latent attention
    over the chunk's own rows) against the JAX package compiled under
    jax.jit: logits within calc_diff 8e-3 and the split caches within
    calc_diff 1e-4, untouched slots left zero."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg = jdm.tiny_config()
    jp = jdm.init_params(cfg, 5)
    tp = tdm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(150)
    t, pages, ps = 21, 6, cfg.page_size
    ids = rng.integers(0, cfg.vocab_size, t).astype(np.int32)
    pos = np.arange(t, dtype=np.int32)
    slots = (np.array([2, 4])[pos // ps] * ps + pos % ps).astype(np.int32)
    jck, jkr = jdm.init_kv_cache(cfg, pages)
    jfn = jax.jit(lambda p, c, k, *a: jdm.prefill_step(p, cfg, c, k, *a),
                  compiler_options=NO_EXCESS)
    jlg, jck, jkr = jfn(jp, jck, jkr, *(jnp.asarray(a) for a in (ids, pos, slots)))
    tck, tkr = tdm.init_kv_cache(cfg, pages, device="cpu")
    tlg, tck2, tkr2 = tdm.prefill_step(tp, cfg, tck, tkr, *(_t(a) for a in (ids, pos, slots)))
    assert tck2 is tck and tkr2 is tkr and tlg.shape == (t, cfg.vocab_size)
    assert calc_diff(tlg.numpy(), np.asarray(jlg)) < LOGITS_DIFF
    for a, b_ in ((jck, tck), (jkr, tkr)):
        assert calc_diff(b_.float().numpy(), _np(a)) < 1e-4
    assert not tck[:, [0, 1, 3, 5]].any()



def _engine_prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    first = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (37, 21)]
    shared = first[0][:32] + rng.integers(0, cfg.vocab_size, 5).tolist()
    return first, shared


def _serve(engine, first, late, new_tokens):
    """Serve `first`; add `late` once first[0] is prefilled, so its 32-token
    prefix (2 pages) comes from the radix cache."""
    rids = [engine.add_request(p, new_tokens) for p in first]
    while not engine.reqs[rids[0]]["out"]:
        engine.step()
    rids.append(engine.add_request(late, new_tokens))
    while engine.step():
        pass
    return [engine.reqs[r]["out"] for r in rids], engine.reqs[rids[-1]]["cached"]


ENGINE_SEED = 38


def test_mla_engine_matches_jax_engine(monkeypatch):
    """MlaEngine's greedy tokens equal the JAX MlaEngine's, with chunked
    prefill (token budget 16 < a 37-token prompt), radix prefix reuse of 32
    tokens and a padded decode batch, and every model call's logits agree
    within calc_diff 8e-3. The port fuses the two mla_preprocess stages (K2's
    plain version on the CPU), the JAX engine runs them unfused: the same
    formula but for the rstd hazard. (When this was written the logits of
    every call were bit-equal; with XLA's default excess precision the JAX
    engine's differ from the port's by up to 0.027.)"""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg = jdm.tiny_config()
    jp = jdm.init_params(cfg, 0)
    tp = tdm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    first, late = _engine_prompts(cfg, ENGINE_SEED)
    kw = dict(num_pages=64, decode_batch=4, token_budget=16)
    logits = {"jax": [], "port": []}

    def recorded(fn, key, to_np):
        def call(*a):
            out = fn(*a)
            logits[key].append(to_np(out[0]))
            return out
        return call

    je = jserving.MlaEngine(cfg, params=jp, **kw)
    jdec_ = jax.jit(lambda p, kv, i, po, sq, bt, sm, lid: (lambda r: (r[0], r[1:]))(
        jdm.decode_step(p, cfg, kv[0], kv[1], i, po, sq, bt, sm)), compiler_options=NO_EXCESS)

    def jpre(p, kv, ids, vl, pos, slots, bts, plens, lid):
        st, t = ids.shape
        mask = jnp.broadcast_to(jnp.tril(jnp.ones((t, t), bool)), (st, t, t))
        lg, c, k = jdm.decode_verify_step(p, cfg, kv[0], kv[1], ids, pos, mask, plens, bts,
                                          slots)
        return lg, (c, k)
    je._decode = recorded(jdec_, "jax", np.asarray)
    je._prefill_batch = recorded(jax.jit(jpre, compiler_options=NO_EXCESS), "jax",
                                 np.asarray)
    want, jreused = _serve(je, first, late, 6)

    te = tserving.MlaEngine(cfg, params=tp, device="cpu", **kw)
    assert "kn" in te.params["layers"]["wdqkv"]
    te._decode = recorded(te._decode, "port", lambda t: t.numpy())
    te._prefill_batch = recorded(te._prefill_batch, "port", lambda t: t.numpy())
    got, reused = _serve(te, first, late, 6)
    assert reused == jreused == 32
    assert all(len(o) == 6 for o in got)
    assert got == want
    assert len(logits["jax"]) == len(logits["port"])
    for a, t in zip(logits["jax"], logits["port"]):
        assert a.shape == t.shape and calc_diff(t, a) < LOGITS_DIFF
