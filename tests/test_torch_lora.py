"""The port's multi-LoRA surface against the JAX package on the CPU: the
ops (ops/lora.py: bgmv, sgmv, sgemmv, sgemmc), llama.add_lora_adapters and
the BGMV hook on wo's output in decode_step_kv (tm, tm2 and hm pages, bf16
and int8) and prefill_batch_step_kv (tm and hm pages).

The same seeded numpy inputs go to both packages. The grouped products are
f32 sums taken in another order (JAX's ragged_dot against torch.matmul), so
an op's f32 output is held within rtol 1e-5 and a bf16 one within one bf16
ulp of the larger magnitude; ids of -1 give exact zeros. The adapters of
add_lora_adapters are bit-identical. The model steps run as in
tests/test_torch_hm_model.py (the JAX kernels interpreted, compiled with
`xla_allow_excess_precision` off): logits within calc_diff 8e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu.ops import lora as jlora
from sgl_kernel_npu_tpu_torch.models import llama as tl
from sgl_kernel_npu_tpu_torch.ops import lora as tlora

from .test_torch_llama import NO_EXCESS, _jax_params
from .utils import calc_diff

LOGITS_DIFF = 8e-3
BF16_ULP = 2.0 ** -8     # one bf16 ulp relative to the larger magnitude


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close(got, want, dtype):
    want = np.asarray(want).astype(np.float32)
    if dtype == "bf16":
        bar = BF16_ULP * np.maximum(np.abs(got), np.abs(want)) + 1e-30
        assert np.all(np.abs(got - want) <= bar), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return _bf16(x) if dtype == "bf16" else x


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_bgmv_shrink_expand_match_jax(dtype, scale):
    rng = np.random.default_rng(3)
    b, h, r, n_ad, o = 12, 64, 8, 3, 48
    x = _x(rng, (b, h), dtype)
    a_w = rng.standard_normal((n_ad, r, h)).astype(np.float32) * 0.1
    b_w = rng.standard_normal((n_ad, o, r)).astype(np.float32) * 0.1
    ids = np.array([0, -1, 2, 1, 1, -1, 0, 2, 2, -1, 1, 0], np.int32)
    y = _x(rng, (b, o + 16), dtype)

    js = jlora.bgmv_shrink(jnp.asarray(x), jnp.asarray(a_w), jnp.asarray(ids), scale)
    ts = tlora.bgmv_shrink(_t(x), _t(a_w), _t(ids), scale)
    assert ts.dtype == _t(x).dtype
    _close(_np(ts), js, dtype)
    assert not _np(ts)[ids < 0].any()

    # expand from the same (JAX's) shrunk rows, into a slice of y
    je = jlora.bgmv_expand(js, jnp.asarray(b_w), jnp.asarray(ids), jnp.asarray(y), 8, o)
    te = tlora.bgmv_expand(_t(np.asarray(js)), _t(b_w), _t(ids), _t(y), 8, o)
    _close(_np(te), je, dtype)
    ty = _np(te)
    np.testing.assert_array_equal(ty[ids < 0], np.asarray(y).astype(np.float32)[ids < 0])
    np.testing.assert_array_equal(ty[:, :8], np.asarray(y).astype(np.float32)[:, :8])


def _sgmv_case(rng, dtype, num_slices):
    n_ad, h, max_r = 4, 64, 8
    seq_len = np.array([5, 0, 7, 3, 6], np.int32)
    idx = np.array([2, 0, -1, 3, 1], np.int32)
    s = int(seq_len.sum()) + 4                       # 4 tokens past the sequences
    ranks = np.array([8, 3, 5, 1], np.int32)         # variable ranks
    scales = np.array([0.5, 1.0, 2.0, 0.75], np.float32)
    x = _x(rng, (s, h), dtype)
    w = rng.standard_normal((n_ad, num_slices * max_r, h)).astype(np.float32) * 0.1
    return x, w, idx, seq_len, ranks, scales


@pytest.mark.parametrize("name", ["sgmv", "sgemmv", "sgemmc"])
@pytest.mark.parametrize("num_slices", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_sgmv_shrink_matches_jax(name, num_slices, dtype):
    rng = np.random.default_rng(num_slices)
    x, w, idx, seq_len, ranks, scales = _sgmv_case(rng, dtype, num_slices)
    j = getattr(jlora, f"{name}_shrink")(*(jnp.asarray(a) for a in (x, w, idx, seq_len, ranks,
                                                                    scales)), num_slices)
    t = getattr(tlora, f"{name}_shrink")(*(_t(a) for a in (x, w, idx, seq_len, ranks, scales)),
                                         num_slices)
    _close(_np(t), j, dtype)
    assert not _np(t)[int(seq_len.sum()):].any()


@pytest.mark.parametrize("name", ["sgmv", "sgemmv", "sgemmc"])
@pytest.mark.parametrize("offsets", [(0, 48), (0, 16, 48), (8, 24, 32, 56)])
@pytest.mark.parametrize("base", [False, True])
def test_sgmv_expand_matches_jax(name, offsets, base):
    """Rank-packed input, a slice a pair of offsets, with and without a base
    output (bf16 out with one, f32 input's dtype without)."""
    rng = np.random.default_rng(len(offsets))
    ns = len(offsets) - 1
    n_ad, max_r = 4, 8
    seq_len = np.array([5, 0, 7, 3, 6], np.int32)
    idx = np.array([2, 0, -1, 3, 1], np.int32)
    ranks = np.array([8, 3, 5, 1], np.int32)
    s = int(seq_len.sum()) + 2
    x = rng.standard_normal((s, ns * max_r)).astype(np.float32)
    o = max(offsets[i + 1] - offsets[i] for i in range(ns))
    w = rng.standard_normal((n_ad, offsets[-1], max_r)).astype(np.float32) * 0.1
    assert o <= offsets[-1]
    bo = _bf16(rng.standard_normal((s, offsets[-1]))) if base else None
    args = (x, w, idx, seq_len, ranks)
    j = getattr(jlora, f"{name}_expand")(*(jnp.asarray(a) for a in args), offsets,
                                         None if bo is None else jnp.asarray(bo))
    t = getattr(tlora, f"{name}_expand")(*(_t(a) for a in args), offsets,
                                         None if bo is None else _t(bo))
    assert t.dtype == (torch.bfloat16 if base else torch.float32)
    _close(_np(t), j, "bf16" if base else "f32")


def test_add_lora_adapters_bit_identical():
    cfg = jl.tiny_config()
    jp, tp = _jax_params(cfg, 0)
    ja = jl.add_lora_adapters(jp, cfg, num_adapters=3, rank=4, seed=5, scale=0.3)
    ta = tl.add_lora_adapters(tp, cfg, num_adapters=3, rank=4, seed=5, scale=0.3)
    for name, shape in (("lora_wo_A", (cfg.num_layers, 3, 4, cfg.q_size)),
                        ("lora_wo_B", (cfg.num_layers, 3, cfg.hidden_size, 4))):
        got = ta["layers"][name]
        assert got.shape == shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ja["layers"][name]))
    assert "lora_wo_A" not in tp["layers"], "the input params are left as they are"
    assert ta["layers"]["wqkv"] is tp["layers"]["wqkv"]


PAGES = 12


def _seeded_kv(cfg, layout, rng):
    """A JAX cache of `layout` filled with seeded rows, as numpy."""
    kv = jl.init_kv_cache(cfg, PAGES, layout=layout)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape, dtype=np.int8)
        if a.dtype == np.float32:
            return rng.random(a.shape, dtype=np.float32) * 0.02 + 0.005
        return _bf16(rng.standard_normal(a.shape))
    return jax.tree.map(fill, kv)


LAYOUTS = {"tm": (True, "tm"), "tm2": (True, "tm2"), "hm_bf16": (False, "hm"),
           "hm_int8": (True, "hm")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_step_kv_lora_matches_jax(monkeypatch, layout):
    """Two decode_step_kv steps with lora_ids (-1, 0, 2, 1 over a batch of
    4, row 3 padded): logits within calc_diff 8e-3 of the JAX step's; the -1
    row equals the same step without adapters bit for bit, and the adapters
    move the other rows' logits."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    int8, lay = LAYOUTS[layout]
    cfg = jl.tiny_config(int8_kv=int8)
    jp, tp = _jax_params(cfg, 0)
    jp = jl.add_lora_adapters(jp, cfg, num_adapters=3, rank=4, seed=3, scale=0.3)
    tp = tl.add_lora_adapters(tp, cfg, num_adapters=3, rank=4, seed=3, scale=0.3)
    rng = np.random.default_rng(7)
    kv0 = _seeded_kv(cfg, lay, rng)
    jkv = jax.tree.map(jnp.asarray, kv0)
    tkv = tl.kv_from_jax(kv0, "cpu")
    tkv_plain = tl.kv_from_jax(kv0, "cpu")
    jdec = jax.jit(lambda p, kv, *a: jl.decode_step_kv(p, cfg, kv, *a[:5], lora_ids=a[5]),
                   compiler_options=NO_EXCESS)
    ps, b = cfg.page_size, 4
    bt = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [0, 0, 0]], np.int32)
    pos = np.array([14, 15, 31, 0], np.int32)
    lids = np.array([-1, 0, 2, 1], np.int32)
    for _ in range(2):
        ids = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
        seq = pos + 1
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        slots[3] = -1
        args = (ids, pos, seq, bt, slots)
        jlg, jkv = jdec(jp, jkv, *(jnp.asarray(a) for a in args + (lids,)))
        tlg, _ = tl.decode_step_kv(tp, cfg, tkv, *(_t(a) for a in args), lora_ids=_t(lids))
        plain, _ = tl.decode_step_kv(tp, cfg, tkv_plain, *(_t(a) for a in args))
        assert calc_diff(tlg[:3].numpy(), np.asarray(jlg)[:3]) < LOGITS_DIFF, layout
        assert torch.equal(tlg[0], plain[0])
        assert calc_diff(tlg[1:3].numpy(), plain[1:3].numpy()) > 1e-4
        pos = pos + np.array([1, 1, 1, 0], np.int32)


@pytest.mark.parametrize("layout", ["tm", "hm_bf16", "hm_int8"])
def test_prefill_batch_lora_matches_jax(monkeypatch, layout):
    """prefill_batch_step_kv with lora_ids (1, -1, 0: the second chunk after
    a cached prefix): logits within calc_diff 8e-3 of the JAX step's; the -1
    chunk equals the call without adapters bit for bit."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    int8, lay = LAYOUTS[layout]
    cfg = jl.tiny_config(int8_kv=int8)
    jp, tp = _jax_params(cfg, 0)
    jp = jl.add_lora_adapters(jp, cfg, num_adapters=2, rank=4, seed=3, scale=0.3)
    tp = tl.add_lora_adapters(tp, cfg, num_adapters=2, rank=4, seed=3, scale=0.3)
    rng = np.random.default_rng(41)
    kv0 = _seeded_kv(cfg, lay, rng)
    jkv = jax.tree.map(jnp.asarray, kv0)
    tkv = tl.kv_from_jax(kv0, "cpu")
    ps, s, t = cfg.page_size, 3, 16
    lens, plens = [13, 9, 16], [0, 20, 0]
    bts = np.array([[1, 2, 0, 0], [4, 5, 6, 7], [8, 9, 0, 0]], np.int32)
    ids = np.zeros((s, t), np.int32)
    slp = np.full((s, t), -1, np.int32)
    pos = np.zeros((s, t), np.int32)
    for si, (n, p0) in enumerate(zip(lens, plens)):
        p = p0 + np.arange(n)
        ids[si, :n] = rng.integers(0, cfg.vocab_size, n)
        pos[si, :n] = p
        slp[si, :n] = bts[si, p // ps] * ps + p % ps
    lids = np.array([1, -1, 0], np.int32)
    args = (ids, np.array(lens, np.int32), pos, slp, bts, np.array(plens, np.int32))
    jpre = jax.jit(lambda p, kv, *a: jl.prefill_batch_step_kv(p, cfg, kv, *a[:6],
                                                              lora_ids=a[6]),
                   compiler_options=NO_EXCESS)
    jlg, _ = jpre(jp, jkv, *(jnp.asarray(a) for a in args + (lids,)))
    tlg, _ = tl.prefill_batch_step_kv(tp, cfg, tkv, *(_t(a) for a in args),
                                      lora_ids=_t(lids))
    plain, _ = tl.prefill_batch_step_kv(tp, cfg, tl.kv_from_jax(kv0, "cpu"),
                                        *(_t(a) for a in args))
    for si, n in enumerate(lens):
        assert calc_diff(tlg[si, :n].numpy(), np.asarray(jlg)[si, :n]) < LOGITS_DIFF, si
    assert torch.equal(tlg[1, :9], plain[1, :9])
    assert calc_diff(tlg[0, :13].numpy(), plain[0, :13].numpy()) > 1e-4
