"""The port's Qwen3-Next slice (the `bench.py --config qwen` decode path)
against the JAX package on the CPU: the seeded int8 weights and the
quantise-at-load transform, the grouped expert GEMM (K8), the recurrent
gated-delta-rule step (K9), the head-major paged decode (K10), the conv
update, the cache scatter, the GDN glue, the MoE block and decode_step_q.

The same numpy inputs go to both packages. The JAX side runs its Pallas
kernels in interpret mode (SKT_IMPL=pallas); its MoE block and decode step
are compiled with `xla_allow_excess_precision` off, as in
tests/test_torch_tm2.py, so that it rounds where its code casts. The port
runs its plain PyTorch versions (device="cpu"); chip_smoke.py holds the CUDA
kernels against those on the card.

Tolerances, each with its reason:
  * the weights, the quantised banks, K8 (both references), the cache
    scatter, the split and the conv state: exact (draws, int32 sums,
    copies). The one exception is the RoPE table, whose f32 cos and sin
    differ by at most one ulp: XLA's CPU cos / sin and torch's approximate
    differently;
  * the gating, the gated RMSNorm and the conv output: a few f32 ulps
    (rtol 2e-6): XLA's CPU exp, log1p, logistic and rsqrt approximate, and
    compiled XLA fuses the conv's products into its sum;
  * K9: o within 1e-5 of max|o| (f32 sums of 128 products in another
    order), the pool's written rows >= 99.9% bit-equal to the JAX kernel's
    and within one bf16 ulp plus 1e-6 of max|pool| (an f32 value near 0
    carries the absolute error of its larger terms), every other row
    untouched;
  * K10 (`assert_bf16_close`, as K7 in tests/test_torch_mla.py): one bf16
    ulp plus 1e-4 of max|ref|, its math being all f32;
  * the MoE block: one bf16 ulp plus 1e-3 of max|ref| (router products and
    the gating's sigmoid a few f32 ulps apart, then int8 requantisation);
  * the slice: logits calc_diff < 8e-3 (tests/test_llama_model.py:376-377)
    and equal greedy tokens wherever a pick clears its runner-up by more
    than the largest logit difference; the conv state, the SSM pool and the
    caches within calc_diff 1e-8 with >= 99.9% of their entries bit-equal
    (the pool's bf16 roundings of f32 values a few ulps apart). A seed on
    which an RMSNorm output flips a bf16 value (the JAX package's rstd comes
    from XLA's CPU rsqrt, ROADMAP Queue 3) is held to calc_diff 1e-5 and
    90% bit-equal (test_qwen_decode_slice_seed_sweep).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.models import qwen_next as jq
from sgl_kernel_npu_tpu.ops import gdn as jgdn
from sgl_kernel_npu_tpu.ops import kvcache as jkv
from sgl_kernel_npu_tpu.ops import mamba as jmamba
from sgl_kernel_npu_tpu.ops import matmul as jmm
from sgl_kernel_npu_tpu.ops.attention import decode as jdec
from sgl_kernel_npu_tpu.ops.attention import decode_v2 as jv2
from sgl_kernel_npu_tpu_torch.models import qwen_next as tq
from sgl_kernel_npu_tpu_torch.ops import gdn as tgdn
from sgl_kernel_npu_tpu_torch.ops import kvcache as tkv
from sgl_kernel_npu_tpu_torch.ops import mamba as tmamba
from sgl_kernel_npu_tpu_torch.ops import matmul as tmm
from sgl_kernel_npu_tpu_torch.ops.attention import decode as tdec

from .test_torch_mla import assert_bf16_close
from .utils import calc_diff

NO_EXCESS = {"xla_allow_excess_precision": False}
LOGITS_DIFF = 8e-3
ULPS = 2e-6             # a few f32 ulps (module docstring)


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(_np(a)))


def _bf16(rng, shape, scale=1.0):
    j = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    return j, _t(j).to(torch.bfloat16)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _small(**kw):
    """Qwen3-Next's kernel widths at a small size: head dims 128, GQA in both
    attention kinds (1 qk head for 2 v heads; 4 query heads for 2 kv heads),
    4 layers (3 GDN, 1 attention), 8 experts top-2, 16-token pages; the same
    config in both packages."""
    base = dict(vocab_size=512, hidden_size=256, num_layers=4, full_attention_interval=4,
                num_qk_heads=1, num_v_heads=2, head_qk_dim=128, head_v_dim=128,
                num_heads=4, num_kv_heads=2, head_dim=128, page_size=16, num_experts=8,
                top_k=2, moe_intermediate_size=128, shared_intermediate_size=128,
                max_position=256, num_loras=0)
    base.update(kw)
    return jq.QwenNextConfig(**base), tq.QwenNextConfig(**base)


# ------------------------------------------------------------------ weights


def test_init_params_q_bit_equal_to_jax():
    """Same seed, same draws: every leaf of the port's init_params_q equals
    the JAX package's bit for bit, but the RoPE table (within one f32 ulp,
    module docstring); params_from_jax carries the JAX tree over unchanged;
    init_state has the JAX package's shapes and dtypes."""
    jcfg, tcfg = _small()
    jp = jax.tree.map(np.asarray, jq.init_params_q(jcfg, 0))
    tp = tq.init_params_q(tcfg, 0, "cpu")
    carried = tq.params_from_jax(jp, "cpu")
    jl, tl_, cl = dict(_leaves(jp)), dict(_leaves(tp)), dict(_leaves(carried))
    assert jl.keys() == tl_.keys() == cl.keys()
    for name, a in jl.items():
        t, c = tl_[name], cl[name]
        assert t.dtype == c.dtype and tuple(t.shape) == a.shape, name
        if a.dtype.name == "bfloat16":
            assert np.array_equal(a.view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16)), name
            assert torch.equal(t, c), name
        elif name == "/cos_sin":
            np.testing.assert_allclose(t.numpy(), a, rtol=0, atol=6e-8)
            assert np.array_equal(c.numpy(), a)
        else:
            assert np.array_equal(a, t.numpy()) and np.array_equal(a, c.numpy()), name
    js = jq.init_state(jcfg, 3, 7, ssm_dtype=jnp.bfloat16)
    ts = tq.init_state(tcfg, 3, 7, ssm_dtype=torch.bfloat16, device="cpu")
    for k, a in js.items():
        assert tuple(ts[k].shape) == a.shape and str(ts[k].dtype).split(".")[1] == str(a.dtype)
        assert not ts[k].any()


def test_quantize_qwen_weights_matches_jax():
    """quantize_qwen_weights on the JAX package's f32 init_params tree
    (carried over by params_from_jax): every bank and scale equal to the
    JAX package's, the f32 originals dropped."""
    jcfg, tcfg = _small()
    p32 = jq.init_params(jcfg, 2)
    np32 = jax.tree.map(np.asarray, p32)
    jf = jq.quantize_qwen_weights(jax.tree.map(jnp.array, p32), jcfg)["fast"]
    tp = tq.quantize_qwen_weights(tq.params_from_jax(np32, "cpu"), tcfg)
    assert tp["gdn"]["wqkvz"] is None and tp["lm_head"] is None
    assert jf.keys() == tp["fast"].keys()
    for name, bank in jf.items():
        for part in ("q", "scale"):
            assert np.array_equal(np.asarray(bank[part]), tp["fast"][name][part].numpy()), name


def test_rms_matches_jax():
    """The model's RMSNorm (f32 result, cast to bf16 as decode_step_q casts
    it) on 20,000 random bf16 rows of 256 against the JAX package's `_rms`
    compiled without excess precision: >= 99.8% of rows bit-equal, the rest
    within one bf16 ulp in at most 8 of their 256 values. The port takes
    rstd by the float64 rule, XLA's CPU rsqrt approximates (ROADMAP Queue
    3); 0.04% of rows differed, in at most 4 values, when this was
    measured."""
    rng = np.random.default_rng(37)
    jx, tx = _bf16(rng, (20000, 256), 3.0)
    w = np.ones(256, np.float32)
    want = _np(jax.jit(lambda x, w: jq._rms(x, w, 1e-6).astype(jnp.bfloat16),
                       compiler_options=NO_EXCESS)(jx, jnp.asarray(w)))
    got = tq._rms(tx, _t(w), 1e-6).to(torch.bfloat16).float().numpy()
    diff = got != want
    assert diff.any(-1).mean() <= 2e-3 and diff.sum(-1).max() <= 8
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))


# ------------------------------------------------------------------ K8


def _routes(rng, t, e, k, skip):
    """topi [t, k] of distinct experts, never one of `skip` (empty experts)."""
    allowed = np.array([x for x in range(e) if x not in skip])
    return np.stack([rng.choice(allowed, k, replace=False) for _ in range(t)]).astype(np.int64)


@pytest.mark.parametrize("tiled", [True, False])
def test_grouped_matmul_int8_matches_jax(monkeypatch, tiled):
    """Kernel K8's contract: real routing (13 tokens top-2 over 8 experts,
    experts 3 and 6 empty) through the port's aligned compaction, 32-row
    tiles with tail tiles past the last group, experts of layer 1 of a
    2-layer flat bank, pretiled (bn 128) or plain: the port's
    grouped_matmul_int8 equals grouped_matmul_int8_pallas exactly, and the
    padding rows are zero."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(5 + tiled)
    t, e, k, kd, n, li = 13, 8, 2, 256, 384, 1
    ok, src, eid = tq.align_routes(torch.from_numpy(_routes(rng, t, e, k, (3, 6))), e, 32)
    eid = eid + li * e
    assert eid.shape == (9,) and not bool(ok[-32:].any())           # tail tiles
    tok = (src // k).numpy()
    xq = rng.integers(-128, 128, (t, kd), dtype=np.int8)
    xs = (rng.random((t, 1)) * 0.05).astype(np.float32)
    okn = ok.numpy()
    xg = np.where(okn[:, None], xq[tok], 0).astype(np.int8)
    xsg = np.where(okn[:, None], xs[tok], 0.0).astype(np.float32)
    w = rng.integers(-127, 128, (2 * e, kd, n), dtype=np.int8)
    ws = (rng.random((2 * e, n)) * 1e-3).astype(np.float32)
    jw = jmm.pretile_weight_bank(jnp.asarray(w), 128) if tiled else jnp.asarray(w)
    tw = tmm.pretile_weight_bank(_t(w), 128) if tiled else _t(w)
    want = jmm.grouped_matmul_int8_pallas(jnp.asarray(xg), jw, jnp.asarray(xsg),
                                          jnp.asarray(ws), jnp.asarray(eid.numpy()),
                                          block_m=32, block_n=128, block_k=256)
    got = tmm.grouped_matmul_int8(_t(xg), tw, _t(xsg), _t(ws), eid, 32)
    assert got.dtype == torch.bfloat16 and got.shape == (xg.shape[0], n)
    assert np.array_equal(_np(want), got.float().numpy())
    assert not got[~ok].any() and got[ok].abs().sum() > 0


def test_grouped_matmul_int8_ref_matches_jax():
    """The ragged reference (the JAX package's grouped_matmul_int8_ref, rows
    tightly grouped by group_list, empty groups and rows past the last
    group): exact."""
    rng = np.random.default_rng(9)
    g, kd, n = 5, 128, 256
    group_list = np.array([3, 0, 7, 2, 0], np.int32)
    s = int(group_list.sum()) + 4
    xq = rng.integers(-128, 128, (s, kd), dtype=np.int8)
    xs = (rng.random((s, 1)) * 0.05).astype(np.float32)
    w = rng.integers(-127, 128, (g, kd, n), dtype=np.int8)
    ws = (rng.random((g, n)) * 1e-3).astype(np.float32)
    want = jmm.grouped_matmul_int8_ref(*(jnp.asarray(a) for a in (xq, w, xs, ws, group_list)))
    got = tmm.grouped_matmul_int8_ref(*(_t(a) for a in (xq, w, xs, ws, group_list)))
    assert np.array_equal(_np(want), got.float().numpy())
    assert not got[-4:].any()


# ------------------------------------------------------------------ K9


def _gdn_inputs(rng, b, h, hv, pool_rows, d=128, pool_dtype=jnp.bfloat16):
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    v = rng.standard_normal((b, 1, hv, d)).astype(np.float32)
    a = (rng.standard_normal((b, 1, hv)) * 2).astype(np.float32)
    bb = rng.standard_normal((b, 1, hv)).astype(np.float32)
    a_log = (rng.standard_normal(hv) * 0.2).astype(np.float32)
    dt = (rng.standard_normal(hv) * 0.2).astype(np.float32)
    pool = jnp.asarray(rng.standard_normal((pool_rows, hv, d, d)) * 0.1, pool_dtype)
    return q, k, v, a, bb, a_log, dt, pool


@pytest.mark.parametrize("rep,d,pool_dtype", [
    pytest.param(2, 128, "bfloat16", id="2"), pytest.param(1, 128, "bfloat16", id="1"),
    pytest.param(2, 32, "bfloat16", id="2-d32"), pytest.param(2, 32, "float32", id="2-d32-f32"),
    pytest.param(1, 128, "float32", id="1-f32"), pytest.param(2, 64, "float32", id="2-d64-f32")])
def test_gdn_recurrent_matches_jax(monkeypatch, rep, d, pool_dtype):
    """Kernel K9's contract, through the port's
    fused_sigmoid_gating_delta_rule_update, against the JAX package's
    fused_sigmoid_gating_delta_rule_update_pallas in interpret mode: kd = vd
    = d (128; 32, the default QwenNextConfig's; 64), HV = 4 value heads over
    4 / rep qk heads (rep 2: replication), qk l2norm, a bf16 or f32 pool of
    8 rows, 6 sequences, two with idx -1 (they read the clamped row 0, which
    no sequence writes, and write nothing). The port updates the pool in
    place. Tolerances in the module docstring; an f32 pool's written rows
    are within 1e-6 of max|pool| (the f32 state itself, its sums in another
    order)."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(11 + rep + (d != 128) * d + (pool_dtype == "float32") * 7)
    q, k, v, a, bb, a_log, dt, jpool = _gdn_inputs(rng, 6, 4 // rep, 4, 8, d,
                                                  getattr(jnp, pool_dtype))
    idx = np.array([5, -1, 2, 7, -1, 3], np.int32)
    jo, jnew = jgdn.fused_sigmoid_gating_delta_rule_update_pallas(
        *(jnp.asarray(x) for x in (a_log, a, dt)), 1.0, 20.0,
        *(jnp.asarray(x) for x in (q, k, v, bb)), jpool, jnp.asarray(idx),
        use_qk_l2norm_in_kernel=True)
    tpool = _t(jpool).to(getattr(torch, pool_dtype))
    to, tnew = tgdn.fused_sigmoid_gating_delta_rule_update(
        *(_t(x) for x in (a_log, a, dt)), 1.0, 20.0, *(_t(x) for x in (q, k, v, bb)), tpool,
        _t(idx), use_qk_l2norm_in_kernel=True)
    assert tnew is tpool and to.shape == (6, 1, 4, d) and to.dtype == torch.float32
    jo = _np(jo)
    assert np.abs(to.numpy() - jo).max() <= 1e-5 * np.abs(jo).max()
    old, want, got = _np(jpool), _np(jnew), tpool.float().numpy()
    written = [5, 2, 7, 3]
    rest = [r for r in range(8) if r not in written]
    assert np.array_equal(got[rest], old[rest]) and np.array_equal(want[rest], old[rest])
    if pool_dtype == "float32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        assert (got[written] == want[written]).mean() >= 0.999
        assert_bf16_close(got, want, 1e-6, "pool")


def test_gdn_glue_matches_jax():
    """fused_gdn_gating, layernorm_gated (RMS form, group size 128, silu(z)
    gate), l2norm and fused_qkvzba_split_reshape_cat against the JAX
    package's: the split exact, the rest within a few f32 ulps."""
    rng = np.random.default_rng(13)
    a_log, a, b, dt = (rng.standard_normal(s).astype(np.float32) * np.float32(m)
                       for s, m in (((4,), 0.2), ((6, 4), 10.0), ((6, 4), 1.0), ((4,), 0.2)))
    for j, t in zip(jgdn.fused_gdn_gating(*(jnp.asarray(x) for x in (a_log, a, b, dt))),
                    tgdn.fused_gdn_gating(*(_t(x) for x in (a_log, a, b, dt)))):
        np.testing.assert_allclose(t.numpy(), _np(j), rtol=ULPS, atol=1e-7)
    x, z = (rng.standard_normal((5, 256)).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    want = jgdn.layernorm_gated(jnp.asarray(x), jnp.asarray(w), None, jnp.asarray(z), 1e-6,
                                group_size=128, is_rms_norm=True)
    got = tgdn.layernorm_gated(_t(x), _t(w), None, _t(z), 1e-6, group_size=128,
                               is_rms_norm=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=ULPS, atol=1e-7)
    np.testing.assert_allclose(tgdn.l2norm(_t(x)).numpy(), _np(jgdn.l2norm(jnp.asarray(x))),
                               rtol=ULPS, atol=1e-8)
    hqk, hv, dqk, dv = 2, 4, 16, 8
    qkvz = rng.standard_normal((3, hqk * (2 * dqk + 2 * (hv // hqk) * dv))).astype(np.float32)
    ba = rng.standard_normal((3, hqk * 2 * (hv // hqk))).astype(np.float32)
    for j, t in zip(jgdn.fused_qkvzba_split_reshape_cat(jnp.asarray(qkvz), jnp.asarray(ba),
                                                        hqk, hv, dqk, dv),
                    tgdn.fused_qkvzba_split_reshape_cat(_t(qkvz), _t(ba), hqk, hv, dqk, dv)):
        assert np.array_equal(_np(j), t.numpy())


# ------------------------------------------------------------------ K10


@pytest.mark.parametrize("which,g", [("v1", 4), ("v2", 4), ("v1", 1), ("v2", 1), ("v1", 16),
                                     ("v2", 16)],
                         ids=["v1", "v2", "v1-G1", "v2-G1", "v1-G16", "v2-G16"])
def test_decode_gqa_matches_jax(monkeypatch, which, g):
    """Kernel K10's contract at D = 128 against decode_gqa_pallas (v1, one
    page per grid step) and decode_gqa_pallas_v2 (the one decode_gqa runs),
    in interpret mode: 8 sequences of 0, 1, ps - 1, ps, ps + 1, 2 ps + 5, 3
    ps and 20 tokens over head-major bf16 pages, G = 4, 1 and 16 query heads
    per kv head."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(17)
    b, hkv, d, ps, mp = 8, 2, 128, 16, 3
    hq = hkv * g
    pages = b * mp + 1
    jk, tk = _bf16(rng, (hkv, pages, ps, d))
    jv, tv = _bf16(rng, (hkv, pages, ps, d))
    jqv, tqv = _bf16(rng, (b, hq, d), 1.5)
    seq = np.array([0, 1, ps - 1, ps, ps + 1, 2 * ps + 5, 3 * ps, 20], np.int32)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    sm = d ** -0.5
    jfn = jdec.decode_gqa_pallas if which == "v1" else jv2.decode_gqa_pallas_v2
    want = jfn(jqv, jk, jv, jnp.asarray(seq), jnp.asarray(bt), sm, ps)
    got = tdec.decode_gqa(tqv, tk, tv, _t(seq), _t(bt), sm, ps)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, d)
    assert_bf16_close(got.float().numpy(), _np(want), 1e-4, which)


@pytest.mark.parametrize("which", ["v1", "v2"])
def test_decode_gqa_d256_matches_jax(monkeypatch, which):
    """K10's contract at head dim 256, G 8 (Qwen3-Next-80B-A3B's full
    attention: 16 query heads over 2 kv heads), against decode_gqa_pallas
    and decode_gqa_pallas_v2 in interpret mode: 8 sequences of 0, 1, ps - 1,
    ps, ps + 1, 2 ps + 5, 3 ps and 20 tokens; the port's decode_gqa routes
    D 256 to decode_gqa_hm (K10's plain version here, decode_hm256 on the
    card), as the JAX dispatcher does."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(19)
    b, hkv, g, d, ps, mp = 8, 2, 8, 256, 16, 3
    pages = b * mp + 1
    jk, tk = _bf16(rng, (hkv, pages, ps, d))
    jv, tv = _bf16(rng, (hkv, pages, ps, d))
    jqv, tqv = _bf16(rng, (b, hkv * g, d), 1.5)
    seq = np.array([0, 1, ps - 1, ps, ps + 1, 2 * ps + 5, 3 * ps, 20], np.int32)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    sm = d ** -0.5
    jfn = jdec.decode_gqa_pallas if which == "v1" else jv2.decode_gqa_pallas_v2
    want = jfn(jqv, jk, jv, jnp.asarray(seq), jnp.asarray(bt), sm, ps)
    got = tdec.decode_gqa(tqv, tk, tv, _t(seq), _t(bt), sm, ps)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hkv * g, d)
    assert_bf16_close(got.float().numpy(), _np(want), 1e-4, which)
    assert_bf16_close(got.float().numpy(), _np(jdec.decode_gqa(
        jqv, jk, jv, jnp.asarray(seq), jnp.asarray(bt), sm, ps)), 1e-4, "decode_gqa")


def test_decode_gqa_ref_matches_jax():
    """Below a head dim of 128 decode_gqa takes its reference (one softmax
    over all keys) in both packages: D = 32, within one bf16 ulp plus 1e-4
    of max|ref|."""
    rng = np.random.default_rng(19)
    b, hq, hkv, d, ps, mp = 4, 8, 4, 32, 16, 2
    pages = b * mp + 1
    jk, tk = _bf16(rng, (hkv, pages, ps, d))
    jv, tv = _bf16(rng, (hkv, pages, ps, d))
    jqv, tqv = _bf16(rng, (b, hq, d), 1.5)
    seq = np.array([1, ps, ps + 1, 2 * ps], np.int32)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    want = jdec.decode_gqa_ref(jqv, jk, jv, jnp.asarray(seq), jnp.asarray(bt), d ** -0.5, ps)
    got = tdec.decode_gqa(tqv, tk, tv, _t(seq), _t(bt), d ** -0.5, ps)
    assert_bf16_close(got.float().numpy(), _np(want), 1e-4)


# ------------------------------------------------------- conv and cache glue


def test_causal_conv1d_update_matches_jax():
    """The decode form with conv_state_indices and two pad_slot_id rows (their
    lines keep their state): output within a few f32 ulps, state exact."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    st = rng.standard_normal((8, 64, 3)).astype(np.float32)
    w = rng.standard_normal((64, 4)).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    ci = np.array([3, -1, 0, 5, -1, 7], np.int32)
    jy, jst = jmamba.causal_conv1d_update(jnp.asarray(x), jnp.asarray(st), jnp.asarray(w),
                                          jnp.asarray(bias), activation="silu",
                                          conv_state_indices=jnp.asarray(ci))
    tst = _t(st)
    ty, tst2 = tmamba.causal_conv1d_update(_t(x), tst, _t(w), _t(bias), activation="silu",
                                           conv_state_indices=_t(ci))
    assert tst2 is tst and np.array_equal(_np(jst), tst.numpy())
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=ULPS, atol=1e-7)
    assert np.array_equal(tst.numpy()[[1, 2, 4, 6]], st[[1, 2, 4, 6]])


def test_reshape_and_cache_gqa_matches_jax():
    """The head-major scatter, in place, with two slots of -1: exact."""
    rng = np.random.default_rng(29)
    hkv, pages, ps, d = 2, 5, 16, 128
    jk, tk = _bf16(rng, (4, hkv, d))
    jv, tv = _bf16(rng, (4, hkv, d))
    jkc, tkc = _bf16(rng, (hkv, pages, ps, d))
    jvc, tvc = _bf16(rng, (hkv, pages, ps, d))
    slots = np.array([17, -1, 3 * ps + 15, -1], np.int32)
    wk, wv = jkv.reshape_and_cache_gqa(jk, jv, jkc, jvc, jnp.asarray(slots))
    gk, gv = tkv.reshape_and_cache_gqa(tk, tv, tkc, tvc, _t(slots))
    assert gk is tkc and gv is tvc
    assert np.array_equal(_np(wk), gk.float().numpy())
    assert np.array_equal(_np(wv), gv.float().numpy())


# ------------------------------------------------------------------ MoE


def test_moe_mlp_q_matches_jax(monkeypatch):
    """The quantised MoE block of layer 2 on 10 tokens, the JAX side's aligned
    tier (SKT_IMPL=pallas, K8's interpret-mode kernel) compiled without
    excess precision: within one bf16 ulp plus 1e-3 of max|ref|."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    jcfg, tcfg = _small()
    jp = jq.init_params_q(jcfg, 1)
    tp = tq.init_params_q(tcfg, 1, "cpu")
    rng = np.random.default_rng(31)
    jx, tx = _bf16(rng, (10, jcfg.hidden_size))
    want = jax.jit(lambda p, x: jq._moe_mlp_q(x, p, jcfg, 2), compiler_options=NO_EXCESS)(jp, jx)
    got = tq._moe_mlp_q(tx, tp, tcfg, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (10, jcfg.hidden_size)
    assert_bf16_close(got.float().numpy(), _np(want), 1e-3)


# ---------------------------------------------------------------- the slice


@functools.cache
def _slice():
    """(JAX cfg, port cfg, JAX params, port params, the JAX decode step
    under jax.jit), built once per process; the port's weights are its own
    init_params_q's."""
    jcfg, tcfg = _small()
    jp = jq.init_params_q(jcfg, 0)
    tp = tq.init_params_q(tcfg, 0, "cpu")
    jdec_ = jax.jit(lambda p, s, *a: jq.decode_step_q(p, jcfg, s, *a),
                    compiler_options=NO_EXCESS)
    return jcfg, tcfg, jp, tp, jdec_


def _slice_start(seed):
    """The same seeded state on both sides (conv N(0, 1), the bf16 SSM pool
    0.1 N(0, 1), bf16 caches N(0, 1), where bench.py leaves zeros), B = 8
    sequences at positions that cross page edges, and `step(jstate, ids,
    pos)`: one decode_step_q on each side -> (JAX logits, port logits, JAX
    state, port state)."""
    jcfg, tcfg, jp, tp, jdec_ = _slice()
    rng = np.random.default_rng(seed)
    b, mp, ps = 8, 3, jcfg.page_size
    pages = b * mp + 1
    ng, na = jcfg.num_gdn_layers, jcfg.num_attn_layers
    conv = rng.standard_normal((ng, b, tcfg.conv_dim, jcfg.conv_width - 1)).astype(np.float32)
    jstate = {"conv": jnp.asarray(conv),
              "ssm": jnp.asarray(rng.standard_normal((ng, b, 2, 128, 128)) * 0.1, jnp.bfloat16),
              "k_cache": jnp.asarray(rng.standard_normal((na, 2, pages, ps, 128)), jnp.bfloat16),
              "v_cache": jnp.asarray(rng.standard_normal((na, 2, pages, ps, 128)), jnp.bfloat16)}
    tstate = {k: _t(v).to(torch.bfloat16 if k != "conv" else torch.float32)
              for k, v in jstate.items()}
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)

    def step(jstate, ids, pos):
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        args = (ids.astype(np.int32), pos, pos + 1, bt, slots)
        jlg, jstate = jdec_(jp, jstate, *(jnp.asarray(a) for a in args))
        tlg, tst = tq.decode_step_q(tp, tcfg, tstate, *(_t(a) for a in args))
        assert tst is tstate and tlg.shape == (b, jcfg.vocab_size) and tlg.dtype == torch.float32
        return np.asarray(jlg), tlg.numpy(), jstate

    pos = np.array([0, ps - 1, ps, 2 * ps - 2, 5, 17, 30, 2 * ps + 3], np.int32)
    return jcfg, rng, jstate, tstate, pos, step


def _state_match(jstate, tstate):
    """{name: (calc_diff, bit-equal fraction)} of the four state arrays."""
    out = {}
    for k, t in tstate.items():
        a, g = _np(jstate[k]), t.float().numpy()
        out[k] = (calc_diff(g, a), float((a == g).mean()))
    return out


# Seeds of the sweep (40-45) on which an RMSNorm output flips a bf16 value
# in the first three steps (test_qwen_decode_slice_seed_sweep).
FLIP_SEEDS = (45,)


def _assert_step(jlg, tlg, jstate, tstate, flip=False):
    """One step's bounds (module docstring). Greedy tokens must be equal
    wherever the port's pick clears its runner-up by more than the step's
    largest logit difference (everywhere when the logits are equal)."""
    assert np.all(np.isfinite(tlg)) and calc_diff(tlg, jlg) < LOGITS_DIFF
    top2 = np.sort(tlg, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0] > np.abs(tlg - jlg).max()) | (tlg == jlg).all(-1)
    assert np.array_equal(jlg.argmax(-1)[clear], tlg.argmax(-1)[clear])
    m = _state_match(jstate, tstate)
    for k, (diff, exact) in m.items():
        if flip:
            assert diff < 1e-5 and exact >= 0.9, m
        else:
            assert diff < 1e-8 and exact >= 0.999, m


def test_qwen_decode_slice_matches_jax(monkeypatch):
    """decode_step_q at the small config (3 GDN layers on the bf16 pool
    through K9's contract, 1 attention layer through K10's, every MoE block
    through K8's), B = 8, three steps from the same seeded state with ids
    from the previous step's argmax after the first: logits, equal greedy
    tokens (no near-tie on seed 0) and the whole state at every step, to the
    strict bounds (module docstring)."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg, rng, jstate, tstate, pos, step = _slice_start(0)
    ids = rng.integers(0, cfg.vocab_size, len(pos))
    for _ in range(3):
        jlg, tlg, jstate = step(jstate, ids, pos)
        _assert_step(jlg, tlg, jstate, tstate)
        assert np.array_equal(jlg.argmax(-1), tlg.argmax(-1))
        ids, pos = tlg.argmax(-1), pos + 1


@pytest.mark.parametrize("seed", range(40, 46))
def test_qwen_decode_slice_seed_sweep(monkeypatch, seed):
    """The slice's three steps (as test_qwen_decode_slice_matches_jax) from
    the states and ids of seeds 40-45. On every seed but FLIP_SEEDS the
    strict bounds hold and logits and greedy tokens were equal when this was
    measured. On seed 45 an RMSNorm output an ulp apart (the JAX package
    takes rstd from XLA's CPU rsqrt, which approximates; ROADMAP Queue 3;
    test_rms_matches_jax) changes a K1 input's int8 quant
    at the second step and the next layers carry it on: 97% of the conv
    state and the SSM pool and 99.5% of the caches stayed bit-equal, logits
    within calc_diff 5.2e-5, and one greedy pick, 0.0078 ahead of its
    runner-up, changed where the logits differed by up to 0.0166; the bound
    for such a seed is calc_diff 1e-5 and 90% bit-equal."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg, rng, jstate, tstate, pos, step = _slice_start(seed)
    for _ in range(3):
        jlg, tlg, jstate = step(jstate, rng.integers(0, cfg.vocab_size, len(pos)), pos)
        _assert_step(jlg, tlg, jstate, tstate, flip=seed in FLIP_SEEDS)
        pos = pos + 1


def test_bench_config_shapes():
    """bench.py --config qwen's configuration (bench.py:515-523) gives the
    same layer split, conv width and bank shapes in both packages (checked
    from the configs alone: the banks are not drawn)."""
    kw = dict(vocab_size=32768, hidden_size=2048, num_layers=12, full_attention_interval=4,
              num_qk_heads=8, num_v_heads=8, head_qk_dim=128, head_v_dim=128, conv_width=4,
              chunk_size=64, num_heads=16, num_kv_heads=2, head_dim=128, page_size=128,
              num_experts=128, top_k=10, moe_intermediate_size=512,
              shared_intermediate_size=512, max_position=8192, num_loras=0, lora_rank=8)
    jcfg, tcfg = jq.QwenNextConfig(**kw), tq.QwenNextConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.num_gdn_layers, tcfg.num_attn_layers, tcfg.rotary_dim) == (9, 3, 32)
    assert tcfg.conv_dim == 2 * 8 * 128 + 8 * 128
