"""The port's tm2 decode path (the bench.py path: head-major-within-page
"tm2" pages, pretiled weight banks, the fused RMSNorm-quant GEMM) against the
JAX package on the CPU, and the two held contracts of slice 1.

The same numpy inputs go to both packages. The JAX side runs its Pallas
kernels in interpret mode (SKT_IMPL=pallas); its model functions and the
fused GEMM are compiled with `xla_allow_excess_precision` off, as in
tests/test_torch_llama.py. The port runs its plain PyTorch versions
(device="cpu"); chip_smoke.py holds the CUDA kernels K1-K4 against those on
the card.

Tolerances, each with its reason:
  * K1, K4, the scales, pretile/untile and the L = 1 GEMM: exact (int32 sums,
    one epilogue order, copies);
  * K2: flip-aware (tests/test_rmsq_gemm.py::assert_quant_close): error
    within 4 quant flips per row and >= 90% of rows bit-exact. The compiled
    JAX code multiplies by f32(1/127) for the scale and divides x by it, as
    the port does; its f32 sum of squares may still round a row's rstd an ulp
    away from the port's float64 sum;
  * K3 and the v8 contract: atol 3e-2, that of kernel C's test (bf16 outputs
    of a few units, P.V summed in another order);
  * the slice: logits calc_diff < 8e-3 (tests/test_llama_model.py:376-377),
    int8 caches >= 99.9% exact with |diff| <= 1 and scales >= 99.9% exact:
    rounding-boundary flips are the only difference allowed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu.ops import matmul as jmm
from sgl_kernel_npu_tpu.ops import quant as jq
from sgl_kernel_npu_tpu.ops import rmsq_gemm as jrq
from sgl_kernel_npu_tpu.ops.attention import decode_v8 as jv8
from sgl_kernel_npu_tpu.ops.attention import decode_v11 as jv11
from sgl_kernel_npu_tpu.ops.attention import decode_v13 as jv13
from sgl_kernel_npu_tpu_torch.models import llama as tl
from sgl_kernel_npu_tpu_torch.ops import matmul as tmm
from sgl_kernel_npu_tpu_torch.ops import quant as tq
from sgl_kernel_npu_tpu_torch.ops import rmsq_gemm as trq
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v8 as tv8
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v11 as tv11
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v13 as tv13

from .test_rmsq_gemm import assert_quant_close
from .utils import assert_close, calc_diff

NO_EXCESS = {"xla_allow_excess_precision": False}
ATOL = 3e-2
LOGITS_DIFF = 8e-3


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(_np(a)))


def _bf16(rng, shape, scale=1.0):
    j = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    return j, _t(j).to(torch.bfloat16)


# ------------------------------------------------------------ K1 and A (L=1)


def _bank(rng, layers, k, n):
    w = rng.integers(-127, 128, (layers, k, n), dtype=np.int8)
    ws = (rng.random((layers, n)) * 1e-3).astype(np.float32)
    return w, ws


def test_pretile_untile_match_jax():
    rng = np.random.default_rng(0)
    w, _ = _bank(rng, 3, 64, 384)
    jt = jmm.pretile_weight_bank(jnp.asarray(w), 128)
    tt = tmm.pretile_weight_bank(_t(w), 128)
    assert tt.shape == (3, 3, 64, 128) and tt.is_contiguous()
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(jmm.untile_weight_bank(jt)),
                          tmm.untile_weight_bank(tt).numpy())
    assert np.array_equal(tmm.untile_weight_bank(tt).numpy(), w)


@pytest.mark.parametrize("m", [3, 8, 64])
def test_stacked_tiled_gemm_matches_jax(monkeypatch, m):
    """Kernel K1's contract: the port's quant_matmul_int8_stacked on a
    pretiled bank equals the JAX tiled Pallas kernel (m >= 8) and, at m = 3,
    the JAX sliced-and-untiled reference, exactly, at the first and last
    layer."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(10 + m)
    layers, k, n, bn = 3, 256, 384, 128
    w, ws = _bank(rng, layers, k, n)
    xq = rng.integers(-128, 128, (m, k), dtype=np.int8)
    xs = (rng.random((m, 1)) * 0.05).astype(np.float32)
    jw = jmm.pretile_weight_bank(jnp.asarray(w), bn)
    tw = tmm.pretile_weight_bank(_t(w), bn)
    for li in (0, layers - 1):
        args = (jnp.asarray(xq), jw, jnp.int32(li), jnp.asarray(xs), jnp.asarray(ws))
        want = (jmm.quant_matmul_int8_stacked(*args) if m < 8
                else jmm.quant_matmul_int8_stacked_tiled(*args))
        got = tmm.quant_matmul_int8_stacked(_t(xq), tw, li, _t(xs), _t(ws))
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        assert np.array_equal(_np(want), got.float().numpy()), li


@pytest.mark.parametrize("m", [8, 40])
def test_quant_matmul_int8_matches_jax_pallas(monkeypatch, m):
    """The contract of matmul.py:71 quant_matmul_int8_pallas (kernel A with
    L = 1 on the card): exact."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(20 + m)
    k, n = 256, 384
    w, ws = _bank(rng, 1, k, n)
    xq = rng.integers(-128, 128, (m, k), dtype=np.int8)
    xs = (rng.random((m, 1)) * 0.05).astype(np.float32)
    want = jmm.quant_matmul_int8_pallas(jnp.asarray(xq), jnp.asarray(w[0]),
                                        jnp.asarray(xs), jnp.asarray(ws[0]))
    got = tmm.quant_matmul_int8(_t(xq), _t(w[0]), _t(xs), _t(ws[0]))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert np.array_equal(_np(want), got.float().numpy())


# ----------------------------------------------------------------------- K2


@pytest.mark.parametrize("out_dtype,apply_norm", [("bfloat16", True),
                                                  ("float32", True),
                                                  ("bfloat16", False)])
def test_rmsnorm_quant_gemm_matches_jax(monkeypatch, out_dtype, apply_norm):
    """Kernel K2's contract on a pretiled bank in per_token mode, the JAX
    side compiled under jax.jit (flip-aware comparison, module docstring)."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(30)
    layers, m, k, n, bn = 2, 32, 256, 384, 128
    jx, tx = _bf16(rng, (m, k), 0.5)
    gamma = jnp.asarray(1.0 + 0.1 * rng.standard_normal(k), jnp.bfloat16)
    beta = np.zeros(k, np.float32)
    w, ds = _bank(rng, layers, k, n)
    jw = jmm.pretile_weight_bank(jnp.asarray(w), bn)
    tw = tmm.pretile_weight_bank(_t(w), bn)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    fused = jax.jit(lambda x, g, b, w_, d, li: jrq.rmsnorm_quant_gemm(
        x, g, b, w_, d, None, li=li, quant_mode="per_token",
        apply_norm=apply_norm, eps=1e-5, out_dtype=jdt), compiler_options=NO_EXCESS)
    for li in (0, layers - 1):
        want = fused(jx, gamma, jnp.asarray(beta), jw, jnp.asarray(ds), jnp.int32(li))
        got = trq.rmsnorm_quant_gemm(tx, _t(gamma).to(torch.bfloat16), _t(beta), tw,
                                     _t(ds), li=li, quant_mode="per_token",
                                     apply_norm=apply_norm, eps=1e-5, out_dtype=tdt)
        assert got.dtype == tdt and got.shape == (m, n)
        _, scale = trq._row_stats(tx, _t(gamma), _t(beta), apply_norm, 1e-5)
        assert_quant_close(got.float().numpy(), _np(want), w[li], ds[li],
                           outsc_max=float(scale.max()), name=f"layer {li}")


def test_rmsnorm_quant_gemm_refuses_the_mla_modes():
    """The MLA modes (per_tensor, the int32 bias, quant_cast="fp16") are
    served since the MLA slice (tests/test_torch_mla.py); what is still
    refused is a per_tensor call without its scale and an unknown mode or
    cast."""
    x = torch.zeros((8, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 128), dtype=torch.int8)
    one, ds = torch.ones(64), torch.ones(128)
    for kw in (dict(quant_mode="per_tensor"),
               dict(quant_mode="per_channel"),
               dict(quant_mode="per_token", quant_cast="bf16")):
        with pytest.raises(ValueError, match="per_tensor"):
            trq.rmsnorm_quant_gemm(x, one, one, w, ds, **kw)
    out = trq.rmsnorm_quant_gemm(x, one, one, w, ds, torch.zeros(128, dtype=torch.int32),
                                 torch.tensor(0.1), torch.tensor(0.0),
                                 quant_mode="per_tensor", quant_cast="fp16")
    assert out.shape == (8, 128) and bool(torch.isfinite(out).all())


# -------------------------------------------------------------- K3 and v8


def _tm2_cache(rng, layers, pages, hkv, ps, d):
    kc = rng.integers(-127, 128, (layers, pages, hkv, ps, d), dtype=np.int8)
    vc = rng.integers(-127, 128, (layers, pages, hkv, ps, d), dtype=np.int8)
    ks = (rng.random((layers, pages, hkv, ps)) * 0.02 + 0.001).astype(np.float32)
    vs = (rng.random((layers, pages, hkv, ps)) * 0.02 + 0.001).astype(np.float32)
    return kc, vc, ks, vs


@pytest.mark.parametrize("which", ["v13", "v11"])
def test_decode_tm2_matches_jax(monkeypatch, which):
    """Kernel K3's contract (v13 groups 4 sequences per TPU loop body, v11
    one) at the cached lengths of
    tests/test_decode_attention.py::test_decode_v13_grouped_live_fetch."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(40)
    b, hq, hkv, d, ps, mp, layers = 8, 8, 4, 32, 16, 3, 2
    pages = b * mp + 1
    kc, vc, ks, vs = _tm2_cache(rng, layers, pages, hkv, ps, d)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    cached = np.array([0, 1, ps, ps + 1, 2 * ps, 17, 30, mp * ps], np.int32)
    jq, tq = _bf16(rng, (b, hq, d))
    jk, tk = _bf16(rng, (b, hkv, d))
    jv, tv = _bf16(rng, (b, hkv, d))
    jfn, tfn = {"v13": (jv13.decode_gqa_pallas_v13_int8_defer,
                        tv13.decode_gqa_v13_int8_defer),
                "v11": (jv11.decode_gqa_pallas_v11_int8_defer,
                        tv11.decode_gqa_v11_int8_defer)}[which]
    sm = 1.0 / np.sqrt(d)
    for li in range(layers):
        want = jfn(jq, jk, jv, *(jnp.asarray(a) for a in (kc, vc, ks, vs, cached, bt)),
                   sm, ps, layer_idx=li)
        got = tfn(tq, tk, tv, *(_t(a) for a in (kc, vc, ks, vs, cached, bt)), sm, ps,
                  layer_idx=li)
        assert got.dtype == torch.bfloat16 and got.shape == (b, hq, d)
        assert_close(got.float().numpy(), _np(want), atol=ATOL, name=f"layer {li}")


def test_decode_v8_per_page_matches_jax(monkeypatch):
    """The per-page contract of decode_v8.py:388 (kernel C on the card) at
    page-boundary cached lengths, both layers."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(50)
    b, hq, hkv, d, ps, mp, pages = 4, 16, 4, 32, 16, 5, 24
    rows = ps * hkv
    kc = rng.integers(-127, 128, (2, pages, rows, d), dtype=np.int8)
    vc = rng.integers(-127, 128, (2, pages, rows, d), dtype=np.int8)
    ks = (rng.random((2, pages, 1, rows)) * .05).astype(np.float32)
    vs = (rng.random((2, pages, 1, rows)) * .05).astype(np.float32)
    cached = np.array([0, 2 * ps, 4 * ps + 4, 3 * ps - 1], np.int32)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    jq, tq = _bf16(rng, (b, hq, d))
    jk, tk = _bf16(rng, (b, hkv, d))
    jv, tv = _bf16(rng, (b, hkv, d))
    sm = 1.0 / np.sqrt(d)
    for li in (0, 1):
        want = jv8.decode_gqa_pallas_v8_int8_defer(
            jq, jk, jv, *(jnp.asarray(a) for a in (kc, vc, ks, vs, cached, bt)),
            sm, ps, layer_idx=li)
        got = tv8.decode_gqa_v8_int8_defer(
            tq, tk, tv, *(_t(a) for a in (kc, vc, ks, vs, cached, bt)), sm, ps,
            layer_idx=li)
        assert_close(got.float().numpy(), _np(want), atol=ATOL, name=f"layer {li}")


# ---------------------------------------------------------- K4 and scales


def test_append_tm2_and_scales_match_jax(monkeypatch):
    """Kernel K4's contract and the tm2 scale update: exact pages and scales,
    in place, with a padded row (page P) that writes nothing."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(60)
    layers, b, hkv, d, ps, pages = 2, 5, 4, 32, 16, 10
    kc, vc, ks, vs = _tm2_cache(rng, layers, pages, hkv, ps, d)
    kq = rng.integers(-127, 128, (layers, b, hkv, d), dtype=np.int8)
    vq = rng.integers(-127, 128, (layers, b, hkv, d), dtype=np.int8)
    ksn = rng.random((layers * b, hkv)).astype(np.float32)
    vsn = rng.random((layers * b, hkv)).astype(np.float32)
    pages_b = np.array([3, pages, 0, 7, 9], np.int32)      # row 1 is padded
    offs_b = np.array([5, 0, ps - 1, 0, 8], np.int32)
    jk, jv_ = jv11.append_tm2_int8_pallas(*(jnp.asarray(a) for a in
                                            (kq, vq, kc, vc, pages_b, offs_b)))
    jks, jvs = jv11.scatter_scales_tm2(*(jnp.asarray(a) for a in
                                         (ks, vs, ksn, vsn, pages_b, offs_b)))
    tk, tv_, tks, tvs = _t(kc), _t(vc), _t(ks), _t(vs)
    out = tv11.append_tm2_int8(_t(kq), _t(vq), tk, tv_, _t(pages_b), _t(offs_b))
    assert out[0] is tk and out[1] is tv_
    sout = tv11.scatter_scales_tm2(tks, tvs, _t(ksn), _t(vsn), _t(pages_b), _t(offs_b))
    assert sout[0] is tks and sout[1] is tvs
    for a, b_ in ((jk, tk), (jv_, tv_), (jks, tks), (jvs, tvs)):
        assert np.array_equal(np.asarray(a), b_.numpy())
    changed = (tk.numpy() != kc).any(axis=(0, 2, 4))            # [P, ps]
    assert sorted(zip(*np.nonzero(changed))) == [(0, ps - 1), (3, 5), (7, 0), (9, 8)]


# ---------------------------------------------------------------- the slice


SLICE_SEED = 0
# Seeds of 70-81 on which the JAX package's rstd flips a bf16 output of the
# slice's first three steps (test_tm2_decode_slice_seed_sweep).
FLIP_SEEDS = (70, 75)


@functools.cache
def _slice():
    """(cfg, JAX params, port params, the JAX decode step under jax.jit),
    built once per process."""
    cfg = jl.tiny_config(int8_kv=True, page_size=16)
    jp = jl.pretile_big_weights(jl.init_params(cfg, SLICE_SEED), block_n=128)
    tp = tl.pretile_big_weights(tl.init_params(cfg, SLICE_SEED, "cpu"), block_n=128)
    carried = tl.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for name in ("wqkv", "wo", "w13", "w2"):
        assert tp["layers"][name]["q"].dim() == 4
        assert torch.equal(tp["layers"][name]["q"], carried["layers"][name]["q"])
    assert torch.equal(tp["lm_head"]["q"], carried["lm_head"]["q"])
    jdec = jax.jit(lambda p, kv, *a: jl.decode_step_kv(p, cfg, kv, *a),
                   compiler_options=NO_EXCESS)
    return cfg, jp, tp, jdec


def _slice_start(seed, jdec=None):
    """The slice's start from `seed`: equal tm2 caches on both sides,
    pre-filled with seeded int8 rows and scales, B = 8 sequences of 2 pages
    at position ps - 2, and `step(jkv, ids, pos)`, one decode_step_kv on
    each side (the port's cache in place) -> (JAX logits, port logits, JAX
    cache). jdec: the JAX step to run (default the slice's jitted step)."""
    cfg, jp, tp, jdec0 = _slice()
    jdec = jdec or jdec0
    rng = np.random.default_rng(seed)
    b, mp, ps = 8, 2, cfg.page_size
    pages = b * mp + 1
    kc, vc, ks, vs = _tm2_cache(rng, cfg.num_layers, pages, cfg.num_kv_heads, ps,
                                cfg.head_dim)
    jkv = {"k": jnp.asarray(kc), "v": jnp.asarray(vc), "ks": jnp.asarray(ks),
           "vs": jnp.asarray(vs)}
    tkv = tl.init_kv_cache(cfg, pages, layout="tm2", device="cpu")
    for name, a in zip(("k", "v", "ks", "vs"), (kc, vc, ks, vs)):
        tkv[name].copy_(_t(a))
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)

    def step(jkv, ids, pos):
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        args = (ids.astype(np.int32), pos, pos + 1, bt, slots)
        jlg, jkv = jdec(jp, jkv, *(jnp.asarray(a) for a in args))
        tlg, tkv2 = tl.decode_step_kv(tp, cfg, tkv, *(_t(a) for a in args))
        assert tkv2 is tkv and tlg.shape == (b, cfg.vocab_size)
        return np.asarray(jlg), tlg.numpy(), jkv

    return cfg, rng, jkv, tkv, np.full(b, ps - 2, np.int32), step


def _cache_match(jkv, tkv, layers=slice(None)):
    """Over `layers`: (exact fraction of the int8 k and v, their largest
    |diff|, exact fraction of the scales)."""
    exact, worst, sexact = 1.0, 0, 1.0
    for name in ("k", "v"):
        a = np.asarray(jkv[name])[layers].astype(np.int32)
        t = tkv[name].numpy()[layers].astype(np.int32)
        exact, worst = min(exact, (a == t).mean()), max(worst, int(np.abs(a - t).max()))
    for name in ("ks", "vs"):
        sexact = min(sexact, (np.asarray(jkv[name])[layers] == tkv[name].numpy()[layers]).mean())
    return exact, worst, sexact


def test_tm2_decode_slice_matches_jax(monkeypatch):
    """decode_step_kv on tm2 pages with pretiled banks, B = 8 (so wqkv and
    w13 take the fused K2 and v13 groups 4 sequences), from a cache
    pre-filled with the same seeded rows and scales at position ps - 2:
    three steps that cross a page (logits and caches, module docstring),
    then bench.py's loop (bench.py:168-180) for 4 steps with argmax feeding
    the next id on each side: the greedy tokens are equal, and every pick
    clears its runner-up by more than the largest logit difference seen.

    The inputs come from seed 71. The JAX package's fused GEMM takes rstd
    from XLA's CPU rsqrt (an approximation) of an f32 sum; for most seeds
    that never changes a bf16 output and both packages agree exactly. For
    some (FLIP_SEEDS among 70-81), it flips one bf16 output and the caches
    go beyond the bounds above; test_tm2_decode_slice_seed_sweep holds every
    seed of 70-81 to what it shows. Seed 71 shows no such flip."""
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


_jax_row_stats = jax.jit(
    lambda x, g, b, eps: jrq._row_stats(x, g, b, None, None, "per_token", True, eps)[:2],
    static_argnums=3, compiler_options=NO_EXCESS)


def _row_stats_of_jax(x, gamma, beta, apply_norm, eps):
    """The port's `_row_stats` with rstd and scale taken from the JAX
    package's `_row_stats`, compiled alone."""
    assert apply_norm
    rstd, scale = _jax_row_stats(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(gamma.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(beta.float().numpy()), eps)
    return _t(rstd), _t(scale)


@pytest.mark.parametrize("seed", range(70, 82))
def test_tm2_decode_slice_seed_sweep(monkeypatch, seed):
    """The slice's first three steps (as test_tm2_decode_slice_matches_jax)
    on each seed of 70-81, once with the port as it is and once with the
    JAX package's row statistics in its fused GEMM's plain version.

    As it is: logits within calc_diff 8e-3 at every step of every seed, and
    the strict cache bounds (>= 99.9% exact, |diff| <= 1) on every seed but
    FLIP_SEEDS. On those, one rstd an ulp from the port's flips a bf16
    output (in layer 0 on seed 75, in layer 1 on seed 70) and the next layer
    carries it on: at most 0.25% of the int8 entries (|diff| <= 2) and 0.32%
    of the scales differed, and logits by calc_diff 2.2e-5, when this was
    measured; the bound is 0.5%.

    With the JAX row statistics, layer 0 is exact on every seed, and every
    seed but 70 is exact throughout, logits included: those differences all
    come from rstd. Seed 70 keeps a layer-1 difference at the third step
    that a JAX `_row_stats` compiled alone does not reproduce (in the
    jitted step XLA fuses that sum with its neighbours); it stays within
    the bound above."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    for jax_stats in (False, True):
        if jax_stats:
            monkeypatch.setattr(trq, "_row_stats", _row_stats_of_jax)
        cfg, rng, jkv, tkv, pos, step = _slice_start(seed)
        for _ in range(3):
            jlg, tlg, jkv = step(jkv, rng.integers(0, cfg.vocab_size, len(pos)), pos)
            assert calc_diff(tlg, jlg) < LOGITS_DIFF
            exact, worst, sexact = _cache_match(jkv, tkv)
            if jax_stats and seed != 70:
                assert np.array_equal(tlg, jlg) and (exact, worst, sexact) == (1, 0, 1)
            elif jax_stats or seed in FLIP_SEEDS:
                assert exact >= 0.995 and worst <= 2 and sexact >= 0.995, (exact, worst, sexact)
            else:
                assert exact >= 0.999 and worst <= 1 and sexact >= 0.999, (exact, worst, sexact)
            if jax_stats:
                assert _cache_match(jkv, tkv, 0) == (1, 0, 1)
            pos = pos + 1


def test_eager_jax_quant_divides_where_the_jitted_step_multiplies():
    """Why an op-by-op (eager) run of the JAX step cannot settle seed 70's
    layer-1 residual (test_tm2_decode_slice_seed_sweep): run op by op,
    per_token_quant_int8 divides by 127, where the compiled step multiplies
    by f32(1/127) (ROADMAP's first hazard) and the port follows the compiled
    form. So op by op the JAX scales leave the port's and the jitted ones
    alike (7 of these 256 rows); run under jax.disable_jit, the step differs
    from both from its first step at seeds 70 and 71 alike, and at 71 the
    port equals the jitted step bit for bit."""
    x = (np.random.default_rng(70).standard_normal((256, 512)) * 3).astype(np.float32)
    eager = np.asarray(jq.per_token_quant_int8(jnp.asarray(x))[1])
    jitted = np.asarray(jax.jit(jq.per_token_quant_int8)(jnp.asarray(x))[1])
    port = tq.per_token_quant_int8(torch.from_numpy(x))[1].numpy()
    assert np.array_equal(port, jitted)
    assert (eager != jitted).sum() == (eager != port).sum() > 0


def _decode_steps(cfg, params, layout, steps, b, mp):
    """`steps` decode steps from empty caches on the port, ids from seed 0."""
    ps = cfg.page_size
    kv = tl.init_kv_cache(cfg, b * mp + 1, layout=layout, device="cpu")
    bt = torch.arange(b * mp, dtype=torch.int32).reshape(b, mp) + 1
    pos = torch.zeros(b, dtype=torch.int32)
    hist = np.random.default_rng(0).integers(0, cfg.vocab_size, (steps, b))
    out = []
    for t in range(steps):
        slots = bt[torch.arange(b), pos // ps] * ps + pos % ps
        logits, kv = tl.decode_step_kv(params, cfg, kv, _t(hist[t].astype(np.int32)),
                                       pos, pos + 1, bt, slots)
        out.append(logits)
        pos = pos + 1
    return out


def test_port_tm2_matches_tm():
    """Mirror of tests/test_decode_attention.py::test_decode_tm2_matches_tm
    on the port: the layouts change, the logits do not (within 2e-2)."""
    cfg = tl.tiny_config(int8_kv=True, page_size=16)
    params = tl.pretile_big_weights(tl.init_params(cfg, 0, "cpu"), block_n=128)
    tm = _decode_steps(cfg, params, "tm", 4, 4, 4)
    tm2 = _decode_steps(cfg, params, "tm2", 4, 4, 4)
    for a, b_ in zip(tm, tm2):
        assert float((a - b_).abs().max()) < 2e-2


def test_port_pretiled_banks_give_equal_logits():
    """Mirror of tests/test_llama_model.py::test_pretile_big_weights_model_parity
    on the port's tm prefill and decode: pretiled and untiled banks give
    equal logits (the GEMMs are exact either way, and below M = 8 the decode
    takes the unfused pair on both)."""
    cfg = tl.tiny_config(int8_kv=True)
    flat = tl.init_params(cfg, 11, "cpu")
    tiled = tl.pretile_big_weights(tl.init_params(cfg, 11, "cpu"), block_n=128)
    assert tiled["lm_head"]["q"].shape == (1, 4, cfg.hidden_size, 128)
    rng = np.random.default_rng(80)
    b, n, ps = 2, 5, cfg.page_size
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    ids = _t(rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32))
    pos = torch.arange(n, dtype=torch.int32).expand(b, n).contiguous()
    slots = bt[torch.arange(b)[:, None], pos // ps] * ps + pos % ps
    dids = _t(rng.integers(0, cfg.vocab_size, b).astype(np.int32))
    p2 = torch.full((b,), n, dtype=torch.int32)
    dslots = bt[torch.arange(b), p2 // ps] * ps + p2 % ps
    logits = []
    for params in (flat, tiled):
        kv = tl.init_kv_cache(cfg, 8, device="cpu")
        lg, kv = tl.prefill_batch_step_kv(params, cfg, kv, ids, torch.full((b,), n),
                                          pos, slots, bt, torch.zeros(b, dtype=torch.int32))
        dg, _ = tl.decode_step_kv(params, cfg, kv, dids, p2, p2 + 1, bt, dslots)
        logits.append((lg, dg))
    assert torch.equal(logits[0][0], logits[1][0])
    assert torch.equal(logits[0][1], logits[1][1])


@pytest.mark.parametrize("knob", ["SKT_FUSED_LM", "SKT_FUSED_QGEMM"])
def test_fused_routes_match_jax(monkeypatch, knob):
    """decode_step_kv with SKT_FUSED_LM (lm_head through K2 per_token, f32
    out) or SKT_FUSED_QGEMM (wo and w2 through K2 with apply_norm=False) on
    the slice's pretiled banks, B = 8: the port's logits within calc_diff
    8e-3 of the JAX package's with the same flag (traced with it on), the
    caches to the slice's bounds, over three steps from seed 71; the port
    takes the route (K2's calls counted: one a step for lm_head, two a layer
    for wo and w2) and, with the flag off, does not."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg, jp, tp, _ = _slice()
    calls = []
    real = tl.rmsnorm_quant_gemm

    def counted(*a, **kw):
        calls.append((kw.get("apply_norm", True), kw.get("out_dtype")))
        return real(*a, **kw)
    monkeypatch.setattr(tl, "rmsnorm_quant_gemm", counted)
    monkeypatch.setenv(knob, "1")
    # traced anew with the flag on (the slice's jitted step was traced without)
    jdec = jax.jit(lambda p, kv, *a: jl.decode_step_kv(p, cfg, kv, *a),
                   compiler_options=NO_EXCESS)
    _, rng, jkv, tkv, pos, step = _slice_start(71, jdec)
    for _ in range(3):
        del calls[:]
        jlg, tlg, jkv = step(jkv, rng.integers(0, cfg.vocab_size, len(pos)), pos)
        assert calc_diff(tlg, jlg) < LOGITS_DIFF
        exact, worst, sexact = _cache_match(jkv, tkv)
        assert exact >= 0.999 and worst <= 1 and sexact >= 0.999, (exact, worst, sexact)
        routed = [c for c in calls if c[0] is False or c[1] == torch.float32]
        if knob == "SKT_FUSED_LM":
            assert routed == [(True, torch.float32)]
        else:
            assert routed == [(False, torch.bfloat16)] * (2 * cfg.num_layers)
        pos = pos + 1
    monkeypatch.delenv(knob)
    del calls[:]
    step(jkv, rng.integers(0, cfg.vocab_size, len(pos)), pos)
    assert len(calls) == 2 * cfg.num_layers           # wqkv and w13 only


def test_gemm_bk_changes_no_result(monkeypatch):
    """SKT_GEMM_BK, the JAX tiled kernel's K tile (ops/matmul.py:173), splits
    an int32 accumulation: the JAX output at SKT_GEMM_BK=1024 equals its
    default (7168, K whole), and the port, which reads no such knob, equals
    both, on a pretiled bank of K 2048 at M 8 and 40."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(24)
    k, n, bn = 2048, 256, 128
    w, ws = _bank(rng, 2, k, n)
    jw = jmm.pretile_weight_bank(jnp.asarray(w), bn)
    tw = tmm.pretile_weight_bank(_t(w), bn)
    for m in (8, 40):
        xq = rng.integers(-128, 128, (m, k), dtype=np.int8)
        xs = (rng.random((m, 1)) * 0.05).astype(np.float32)
        args = (jnp.asarray(xq), jw, jnp.int32(1), jnp.asarray(xs), jnp.asarray(ws))
        monkeypatch.delenv("SKT_GEMM_BK", raising=False)
        default = _np(jmm.quant_matmul_int8_stacked_tiled(*args))
        monkeypatch.setenv("SKT_GEMM_BK", "1024")
        split = _np(jmm.quant_matmul_int8_stacked_tiled(*args))
        got = tmm.quant_matmul_int8_stacked(_t(xq), tw, 1, _t(xs), _t(ws)).float().numpy()
        assert np.array_equal(default, split) and np.array_equal(got, default), m
