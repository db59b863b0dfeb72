"""The port's head-major ("hm") attention modules against the JAX package on
the CPU: the page-major cache scatters (decode_v3.py), the v3 decode in its
four contracts (kernel K16), the v6 deferred decode (K14), the int8
head-major decode of decode.py (K16's decode_int8kv contract) and the paged
chunk prefill (K15).

The same numpy inputs go to both packages. The JAX side runs its Pallas
kernels in interpret mode (SKT_IMPL=pallas); the port runs its plain PyTorch
versions (device="cpu"); chip_smoke.py holds the CUDA kernels against those
on the card.

Tolerances, each with its reason (`assert_bf16_close`: one bf16 ulp of the
JAX value plus a share of max|JAX|):
  * the scatters: exact (copies; the int8 quantisation takes the same f32
    steps, with f32(1/127) as compiled XLA: the JAX scatter is jitted, as
    the models run it; run op by op it divides by 127);
  * every attention contract: share 1e-4, the math being the TPU kernel's
    in its page order (all f32 for v3, decode_int8kv and the prefill; for
    v6 bf16 products and p rounded to bf16 before P.V on both sides), only
    the order of the f32 sums differing. At this share v3's output fails
    v6's check (test_decode_v6_and_v3_agree_but_round_apart): the test sees
    v6's rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.ops.attention import decode as jdec
from sgl_kernel_npu_tpu.ops.attention import decode_v3 as jv3
from sgl_kernel_npu_tpu.ops.attention import decode_v6 as jv6
from sgl_kernel_npu_tpu.ops.attention import paged_prefill as jpp
from sgl_kernel_npu_tpu_torch import _build
from sgl_kernel_npu_tpu_torch.ops.attention import decode as tdec
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v3 as tv3
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v6 as tv6
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v11 as tv11
from sgl_kernel_npu_tpu_torch.ops.attention import paged_prefill as tpp
from sgl_kernel_npu_tpu_torch.utils import env

from .test_torch_mla import assert_bf16_close

SHARE = 1e-4
B, HQ, HKV, D, PS, MP = 5, 8, 2, 128, 16, 3
SM = D ** -0.5


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SKT_IMPL", "pallas")


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    """numpy / jax array -> torch tensor (bf16 stays bf16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


def _pages(rng, int8, pages=B * MP + 1, layout="page", ps=PS):
    """Seeded caches: bf16 rows of randn, or int8 rows with f32 scales of
    0.005..0.025, page-major [P, Hkv, ps, D] (layout "page") or head-major
    [Hkv, P, ps, D] ("head"). Returns a dict of jax arrays."""
    shape = (pages, HKV, ps, D) if layout == "page" else (HKV, pages, ps, D)
    sshape = shape[:2] + (1, ps)
    if not int8:
        return {"k": _bf16(rng, shape), "v": _bf16(rng, shape)}
    return {"k": jnp.asarray(rng.integers(-127, 128, shape, dtype=np.int8)),
            "v": jnp.asarray(rng.integers(-127, 128, shape, dtype=np.int8)),
            "ks": jnp.asarray(rng.random(sshape, dtype=np.float32) * 0.02 + 0.005),
            "vs": jnp.asarray(rng.random(sshape, dtype=np.float32) * 0.02 + 0.005)}


def _decode_inputs(rng, defer):
    """q of 1.5 randn (scores of about 1.5 standard deviations: O(1)
    outputs), a block table over distinct pages, lengths on page edges: with
    `defer` cached lengths (-1 is a padded row, clamped to 0) and the new
    token's k / v, else lengths including the current token."""
    q = _bf16(rng, (B, HQ, D), 1.5)
    bt = jnp.asarray(rng.permutation(B * MP)[: B * MP].reshape(B, MP) + 1, jnp.int32)
    lens = [-1, 15, 16, 17, 47] if defer else [1, 16, 17, 33, 48]
    new = (_bf16(rng, (B, HKV, D)), _bf16(rng, (B, HKV, D))) if defer else None
    return q, bt, jnp.asarray(lens, jnp.int32), new


@pytest.mark.parametrize("int8", [False, True])
def test_reshape_and_cache_page_major_exact(rng, int8):
    """The in-place scatters equal the JAX ones bit for bit: slot -1 and a
    slot past the pool drop their row; rows cross pages."""
    cache = _pages(rng, int8)
    t = 7
    k, v = _bf16(rng, (t, HKV, D), 3.0), _bf16(rng, (t, HKV, D), 3.0)
    slots = jnp.asarray([0, 17, -1, 31, 32, (B * MP + 1) * PS, 5 * PS + 3], jnp.int32)
    port = {n: _t(a).clone() for n, a in cache.items()}
    if int8:
        want = jax.jit(jv3.reshape_and_cache_gqa_page_major_int8)(
            k, v, cache["k"], cache["v"], cache["ks"], cache["vs"], slots)
        got = tv3.reshape_and_cache_gqa_page_major_int8(
            _t(k), _t(v), port["k"], port["v"], port["ks"], port["vs"], _t(slots))
    else:
        want = jv3.reshape_and_cache_gqa_page_major(k, v, cache["k"], cache["v"], slots)
        got = tv3.reshape_and_cache_gqa_page_major(_t(k), _t(v), port["k"], port["v"],
                                                   _t(slots))
    for name, w, g in zip(port, want, got):
        assert g is port[name]
        assert np.array_equal(_np(w), _np(g.float() if g.dtype == torch.bfloat16 else g)), \
            name
    assert not np.array_equal(_np(want[0]), _np(cache["k"]))


@pytest.mark.parametrize("contract", ["v3", "v3_int8", "v3_defer", "v3_int8_defer"])
def test_decode_v3_matches_jax_kernel(rng, contract):
    """Every v3 contract of K16 (plain version) against the JAX kernel,
    interpreted: pages past the length skipped, a length of 0 (deferred,
    only the new token) and lengths on page edges."""
    int8, defer = "int8" in contract, "defer" in contract
    cache = _pages(rng, int8)
    q, bt, lens, new = _decode_inputs(rng, defer)
    sc = (cache["ks"], cache["vs"]) if int8 else ()
    jfn = {"v3": jv3.decode_gqa_pallas_v3, "v3_int8": jv3.decode_gqa_pallas_v3_int8,
           "v3_defer": jv3.decode_gqa_pallas_v3_defer,
           "v3_int8_defer": jv3.decode_gqa_pallas_v3_int8_defer}[contract]
    tfn = getattr(tv3, f"decode_gqa_{contract}")
    head = (q, *new) if defer else (q,)
    want = jfn(*head, cache["k"], cache["v"], *sc, lens, bt, SM, PS)
    got = tfn(*(_t(a) for a in head), _t(cache["k"]), _t(cache["v"]),
              *(_t(a) for a in sc), _t(lens), _t(bt), SM, PS)
    assert got.dtype == torch.bfloat16 and got.shape == (B, HQ, D)
    assert_bf16_close(got.float(), _np(want), SHARE, contract)


def _three_parts(x):
    """decode_tm_core.cuh's P_F32 split of f32 x: hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each step in f32."""
    parts = []
    for _ in range(3):
        part = x.to(torch.bfloat16)
        parts.append(part)
        x = x - part.float()
    return parts


def test_three_bf16_parts_hold_f32_p_exactly():
    """hi + mid + lo == p exactly for f32 p over [1e-30, 1] (log-uniform,
    seeded): the three products of P_F32 carry all of p's 24 bits."""
    rng = np.random.default_rng(1703)
    p = torch.from_numpy(np.exp(rng.uniform(np.log(1e-30), 0.0, 200_000)).astype(np.float32))
    p = torch.cat([p, torch.tensor([1.0, 1e-30, 0.5 + 2.0 ** -24, 1.0 - 2.0 ** -24])])
    hi, mid, lo = _three_parts(p)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, p.double())
    # two parts do not: the point of the third
    assert not torch.equal(hi.double() + mid.double(), p.double())


def _p_f32_model(q, k, v, ks, vs, lens, sm, ps, new=None, splits=1):
    """decode_v3.cu's arithmetic (P_F32 in csrc/decode_tm_core.cuh), in
    torch on gathered rows k, v [B, Hkv, n, D] of raw values (bf16 or int8,
    in f32) with scales ks, vs [B, Hkv, n] (None for bf16): s = (q . k) *
    k_scale * sm_scale; one page a step; p = exp(s - m) unrounded against the
    running maximum of the split's own pages; p * v_scale rounded once in
    f32 and split in three bf16 parts whose products with V are summed 16
    tokens at a time (lo, mid, then hi) before that sum is added to acc in
    f32; l sums the unrounded p; `splits` page-aligned splits merged in
    split order; the current token `new` (k, v [B, Hkv, D]) folded in with
    its p unrounded; out = acc / max(l, 1e-37) in bf16."""
    b, hq, d = q.shape
    hkv, n = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d)
    clen = lens.long().clamp_min(0).clamp_max(n)
    out = torch.zeros((b, hkv, g, d))
    for i in range(b):
        npg = (int(clen[i]) + ps - 1) // ps
        parts = []
        for sp in range(splits):
            m = torch.full((hkv, g), -1e30)
            l = torch.zeros((hkv, g))
            acc = torch.zeros((hkv, g, d))
            for pg in range(npg * sp // splits, npg * (sp + 1) // splits):
                t0, t1 = pg * ps, min(int(clen[i]), (pg + 1) * ps)
                s = torch.einsum("hgd,htd->hgt", qf[i], k[i, :, t0:t1])
                if ks is not None:
                    s = s * ks[i, :, None, t0:t1]
                s = s * sm
                mn = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - mn)
                p = torch.exp(s - mn[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None]
                pv = p * vs[i, :, None, t0:t1] if vs is not None else p
                for u0 in range(0, t1 - t0, 16):
                    sl = slice(u0, min(u0 + 16, t1 - t0))
                    vv = v[i, :, t0:t1][:, sl]
                    part = torch.zeros((hkv, g, d))
                    for x in reversed(_three_parts(pv[..., sl])):
                        part = part + torch.einsum("hgt,htd->hgd", x.float(), vv)
                    acc = acc + part
                m = mn
            parts.append((m, l, acc))
        mx = torch.stack([x[0] for x in parts]).amax(0)
        o, ls = torch.zeros((hkv, g, d)), torch.zeros((hkv, g))
        for m, l, acc in parts:                             # split order
            w = torch.exp(m - mx)
            ls = ls + w * l
            o = o + w[..., None] * acc
        if new is not None:
            sc = torch.einsum("hgd,hd->hg", qf[i], new[0][i].float()) * sm
            mn = torch.maximum(mx, sc)
            alpha = torch.exp(mx - mn)
            p = torch.exp(sc - mn)
            ls = ls * alpha + p
            o = o * alpha[..., None] + p[..., None] * new[1][i].float()[:, None, :]
        out[i] = o / ls.clamp_min(1e-37)[..., None]
    return out.reshape(b, hq, d).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("qscale", [1.5, 3.0])
@pytest.mark.parametrize("contract", ["v3", "v3_int8", "v3_defer", "v3_int8_defer"])
@pytest.mark.parametrize("splits", [1, 3])
def test_p_f32_model_matches_v3_plain(seed, qscale, contract, splits):
    """K16's and K23's arithmetic on the card (scale after the dot, p in
    three bf16 parts, f32 sums, splits merged in split order; _p_f32_model)
    stays within one bf16 ulp + 1e-4 of max|plain| of decode_gqa_v3_ref, the
    bar chip_smoke.py holds the kernels to, with peaked scores (q of 1.5 and
    3 randn)."""
    rng = np.random.default_rng(1700 + seed)
    int8, defer = "int8" in contract, "defer" in contract
    mp = 4
    cache = _pages(rng, int8, pages=B * mp + 1)
    q = _t(_bf16(rng, (B, HQ, D), qscale))
    bt = torch.from_numpy((rng.permutation(B * mp).reshape(B, mp) + 1).astype(np.int32))
    lens = torch.tensor([0 if defer else 1, 15, 16, 33, 64], dtype=torch.int32)
    new = (_t(_bf16(rng, (B, HKV, D))), _t(_bf16(rng, (B, HKV, D)))) if defer else None
    kc, vc = _t(cache["k"]), _t(cache["v"])
    ks = _t(cache["ks"]) if int8 else None
    vs = _t(cache["vs"]) if int8 else None
    want = tv3.decode_gqa_v3_ref(q, kc, vc, lens, bt, SM, k_scales=ks, v_scales=vs,
                                 k_new=new[0] if defer else None,
                                 v_new=new[1] if defer else None)
    rows = [tv3._gather_pm(c, None, bt) for c in (kc, vc)]
    srows = [tv3._gather_pm(c.transpose(-1, -2), None, bt)[..., 0] if c is not None else None
             for c in (ks, vs)]
    got = _p_f32_model(q, *rows, *srows, lens, SM, PS, new, splits)
    assert_bf16_close(got.float(), want.float(), SHARE, f"{contract} q {qscale} S {splits}")


@pytest.mark.parametrize("int8", [False, True])
def test_decode_v6_matches_jax_kernel(rng, int8):
    """K14's plain version (bf16 products, P rounded to bf16) against the
    JAX v6 kernel, interpreted, with a padded row (cached -1) and lengths
    on page edges."""
    cache = _pages(rng, int8)
    q, bt, lens, (kn, vn) = _decode_inputs(rng, True)
    if int8:
        want = jv6.decode_gqa_pallas_v6_int8_defer(q, kn, vn, cache["k"], cache["v"],
                                                   cache["ks"], cache["vs"], lens, bt, SM,
                                                   PS)
        got = tv6.decode_gqa_v6_int8_defer(_t(q), _t(kn), _t(vn), _t(cache["k"]),
                                           _t(cache["v"]), _t(cache["ks"]), _t(cache["vs"]),
                                           _t(lens), _t(bt), SM, PS)
    else:
        want = jv6.decode_gqa_pallas_v6_defer(q, kn, vn, cache["k"], cache["v"], lens, bt,
                                              SM, PS)
        got = tv6.decode_gqa_v6_defer(_t(q), _t(kn), _t(vn), _t(cache["k"]), _t(cache["v"]),
                                      _t(lens), _t(bt), SM, PS)
    assert got.dtype == torch.bfloat16 and got.shape == (B, HQ, D)
    assert_bf16_close(got.float(), _np(want), SHARE, f"v6 int8={int8}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_v6_int8_is_k3s_contract(seed):
    """K14's int8 route on the card is K3's loop: its plain version equals
    K3's (decode_v11's, one page per step) on the same page-major cache seen
    as one layer of head-major pages [1, P, Hkv, ps, D], scales [1, P, Hkv,
    ps], bit for bit, with a padded row (cached -1) and lengths on page
    edges."""
    rng = np.random.default_rng(300 + seed)
    cache = _pages(rng, True)
    q, bt, lens, (kn, vn) = _decode_inputs(rng, True)
    k, v, ks, vs = (_t(cache[n]) for n in ("k", "v", "ks", "vs"))
    pages = k.shape[0]
    got = tv6.decode_gqa_v6_defer_ref(_t(q), _t(kn), _t(vn), k, v, _t(lens), _t(bt), SM,
                                      k_scales=ks, v_scales=vs)
    want = tv11.decode_gqa_v11_int8_defer_ref(
        _t(q), _t(kn), _t(vn), k[None], v[None], ks.reshape(1, pages, HKV, PS),
        vs.reshape(1, pages, HKV, PS), _t(lens), _t(bt), SM, PS)
    assert torch.equal(got, want)


def test_decode_v6_int8_matches_jax_kernel_at_g16(rng):
    """K14's widest head group (16 query heads a kv head, two blocks of 8 on
    the card): the plain version against the JAX int8 v6 kernel,
    interpreted, within one bf16 ulp + SHARE of max|JAX| (bf16 products and
    p rounded to bf16 on both sides; only the f32 sums' order differs)."""
    g = 16
    cache = _pages(rng, True)
    q = _bf16(rng, (B, HKV * g, D), 1.5)
    _, bt, lens, (kn, vn) = _decode_inputs(rng, True)
    want = jv6.decode_gqa_pallas_v6_int8_defer(q, kn, vn, cache["k"], cache["v"], cache["ks"],
                                               cache["vs"], lens, bt, SM, PS)
    got = tv6.decode_gqa_v6_int8_defer(_t(q), _t(kn), _t(vn), _t(cache["k"]), _t(cache["v"]),
                                       _t(cache["ks"]), _t(cache["vs"]), _t(lens), _t(bt), SM,
                                       PS)
    assert got.dtype == torch.bfloat16 and got.shape == (B, HKV * g, D)
    assert_bf16_close(got.float(), _np(want), SHARE, "v6 int8 G 16")


def test_decode_v6_and_v3_agree_but_round_apart(rng):
    """v6 rounds p to bf16 before P.V, v3 does not: the two deferred
    contracts agree within 2e-2 of max|out|, but not within the tolerance
    the tests hold each contract to."""
    cache = _pages(rng, False)
    q, bt, lens, (kn, vn) = _decode_inputs(rng, True)
    args = (_t(q), _t(kn), _t(vn), _t(cache["k"]), _t(cache["v"]), _t(lens), _t(bt), SM, PS)
    a = tv6.decode_gqa_v6_defer(*args).float()
    b = tv3.decode_gqa_v3_defer(*args).float()
    assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())
    with pytest.raises(AssertionError):
        assert_bf16_close(b, a.numpy(), SHARE)


def test_decode_int8kv_matches_jax_kernel(rng):
    """K16's decode_int8kv contract (int8 head-major pages) against the JAX
    decode_gqa_int8kv_pallas, interpreted, and its one-softmax reference."""
    cache = _pages(rng, True, layout="head")
    q, bt, lens, _ = _decode_inputs(rng, False)
    args = (cache["k"], cache["v"], cache["ks"], cache["vs"], lens, bt, SM, PS)
    want = jdec.decode_gqa_int8kv(q, *args)
    got = tdec.decode_gqa_int8kv(_t(q), *(_t(a) for a in args[:-2]), SM, PS)
    assert got.dtype == torch.bfloat16 and got.shape == (B, HQ, D)
    assert_bf16_close(got.float(), _np(want), SHARE, "int8kv")
    assert_bf16_close(got.float(), _np(jdec.decode_gqa_int8kv_ref(q, *args)), 1e-3,
                      "int8kv vs one softmax")


def _prefill_case(rng, int8, t, prefix, mp=6, ps=PS):
    """A chunk of t tokens after `prefix` cached ones of one sequence, the
    cache holding seeded rows everywhere (the chunk is already written)."""
    cache = _pages(rng, int8, pages=2 * mp + 1, ps=ps)
    kv = (cache["k"], cache["v"]) if not int8 else cache
    tkv = (tuple(_t(a) for a in kv) if not int8 else {n: _t(a) for n, a in kv.items()})
    q = _bf16(rng, (t, HQ, D), 1.5)
    bt = jnp.asarray(rng.permutation(2 * mp)[:mp] + 1, jnp.int32)
    return kv, tkv, q, bt


@pytest.mark.parametrize("case", [("bf16", 24, 0, 8), ("bf16", 21, 7, 8), ("bf16", 33, 16, 16),
                                  ("int8", 21, 7, 8), ("int8", 40, 0, 128),
                                  ("bf16", 150, 133, 128, 128), ("int8", 150, 133, 128, 128),
                                  ("bf16", 100, 256, 64, 128), ("int8", 100, 256, 64, 128)])
def test_paged_prefill_dense_causal_matches_jax_kernel(rng, case):
    """The dense causal schedule at prefix 0, mid-page (7) and on a page
    boundary (16), a chunk that is not a multiple of block_q (the last tile
    padded), bf16 pages and the int8 dict; block_q 128 gives one tile. The
    engine's 128-token pages at G 4, off a page edge (prefix 133) and on one
    (256), bf16 and int8, take a fifth entry (ps)."""
    kind, t, prefix, bq, *page = case
    ps = page[0] if page else PS
    kv, tkv, q, bt = _prefill_case(rng, kind == "int8", t, prefix, ps=ps)
    want = jpp.paged_prefill_attention(q, kv, bt, prefix, SM, ps, block_q=bq)
    got = tpp.paged_prefill_attention(_t(q), tkv, _t(bt), prefix, SM, ps, block_q=bq)
    assert got.dtype == torch.bfloat16 and got.shape == (t, HQ, D)
    assert_bf16_close(got.float(), _np(want), SHARE, str(case))


@pytest.mark.parametrize("per_head", [False, True])
def test_paged_prefill_page_sel_matches_jax_kernel(rng, per_head):
    """The page_sel / page_cnt drive: selected logical pages out of order,
    a tile whose list is empty (output 0), a tile whose first page hides
    every column from some rows (they take p = 1 there, as the TPU kernel
    does, until a visible page comes), per tile or per kv head."""
    t, prefix, bq = 24, 20, 8
    kv, tkv, q, bt = _prefill_case(rng, False, t, prefix)
    nq = t // bq
    sel = np.array([[3, 0, 1, 0], [0, 0, 0, 0], [2, 1, 0, 0]], np.int32)
    cnt = np.array([3, 0, 2], np.int32)
    if per_head:
        sel = np.stack([sel, np.array([[1, 0, 0, 0], [2, 3, 0, 0], [0, 1, 2, 3]], np.int32)])
        cnt = np.stack([cnt, np.array([1, 2, 4], np.int32)])
    assert sel.shape[-2] == nq
    want = jpp.paged_prefill_attention(q, kv, bt, prefix, SM, PS, page_sel=jnp.asarray(sel),
                                       page_cnt=jnp.asarray(cnt), block_q=bq)
    got = tpp.paged_prefill_attention(_t(q), tkv, _t(bt), prefix, SM, PS,
                                      page_sel=torch.from_numpy(sel),
                                      page_cnt=torch.from_numpy(cnt), block_q=bq)
    assert_bf16_close(got.float(), _np(want), SHARE, f"per_head={per_head}")
    assert float(got[bq:2 * bq, :HQ // HKV].float().abs().max()) == 0.0   # empty list


@pytest.mark.parametrize("per_head", [False, True])
def test_paged_prefill_int8_page_sel_matches_jax_kernel(rng, per_head):
    """The page_sel / page_cnt drive over int8 pages: pages out of order, an
    empty list (output 0), a first page that hides every column from some
    rows, per tile or per kv head."""
    t, prefix, bq = 24, 20, 8
    kv, tkv, q, bt = _prefill_case(rng, True, t, prefix)
    sel = np.array([[3, 0, 1, 0], [0, 0, 0, 0], [2, 1, 0, 0]], np.int32)
    cnt = np.array([3, 0, 2], np.int32)
    if per_head:
        sel = np.stack([sel, np.array([[1, 0, 0, 0], [2, 3, 0, 0], [0, 1, 2, 3]], np.int32)])
        cnt = np.stack([cnt, np.array([1, 2, 4], np.int32)])
    want = jpp.paged_prefill_attention(q, kv, bt, prefix, SM, PS, page_sel=jnp.asarray(sel),
                                       page_cnt=jnp.asarray(cnt), block_q=bq)
    got = tpp.paged_prefill_attention(_t(q), tkv, _t(bt), prefix, SM, PS,
                                      page_sel=torch.from_numpy(sel),
                                      page_cnt=torch.from_numpy(cnt), block_q=bq)
    assert_bf16_close(got.float(), _np(want), SHARE, f"int8 per_head={per_head}")
    assert float(got[bq:2 * bq, :HQ // HKV].float().abs().max()) == 0.0   # empty list


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_prefill_all_invisible_list_matches_jax_kernel(rng, kind):
    """A tile whose whole selected list lies past its rows' positions: every
    score is masked, p = 1 over the masked columns, so each row keeps the
    mean of V over them, as the TPU kernel gives it; the next tile sees its
    pages."""
    t, prefix, bq = 16, 4, 8
    kv, tkv, q, bt = _prefill_case(rng, kind == "int8", t, prefix)
    sel = np.array([[2, 3, 0], [0, 1, 0]], np.int32)      # tile 0: positions 4..11
    cnt = np.array([2, 2], np.int32)
    want = jpp.paged_prefill_attention(q, kv, bt, prefix, SM, PS, page_sel=jnp.asarray(sel),
                                       page_cnt=jnp.asarray(cnt), block_q=bq)
    got = tpp.paged_prefill_attention(_t(q), tkv, _t(bt), prefix, SM, PS,
                                      page_sel=torch.from_numpy(sel),
                                      page_cnt=torch.from_numpy(cnt), block_q=bq)
    assert_bf16_close(got.float(), _np(want), SHARE, kind)
    v = _np(kv["v"] if kind == "int8" else kv[1]).astype(np.float64)
    if kind == "int8":
        v = v * _np(kv["vs"])[:, :, 0, :, None]
    rows = v[np.asarray(bt)[[2, 3]]]                      # [2, Hkv, ps, D]
    mean = rows.transpose(1, 0, 2, 3).reshape(HKV, 2 * PS, D).mean(1)
    assert_bf16_close(got[:bq].float(), np.repeat(mean, HQ // HKV, 0)[None].repeat(bq, 0),
                      1e-3, f"{kind} mean of V")


def test_paged_prefill_batch_stacks_chunks(rng):
    """paged_prefill_attention_batch over 3 chunks of one padded length
    equals one call per chunk."""
    kv, tkv, _, bt = _prefill_case(rng, True, 16, 0)
    q = torch.from_numpy(rng.standard_normal((3, 16, HQ, D)).astype(np.float32)).to(
        torch.bfloat16)
    bts = torch.stack([_t(bt)] * 3)
    plens = torch.tensor([0, 5, 16], dtype=torch.int32)
    got = tpp.paged_prefill_attention_batch(q, tkv, bts, plens, SM, PS, block_q=8)
    for si in range(3):
        one = tpp.paged_prefill_attention(q[si], tkv, bts[si], int(plens[si]), SM, PS,
                                          block_q=8)
        assert torch.equal(got[si], one)


def test_cpu_tensors_launch_nothing(rng):
    """On CPU tensors every new wrapper runs its plain version: no launch
    counter moves."""
    before = dict(_build.launches)
    test_decode_v6_and_v3_agree_but_round_apart(rng)
    kv, tkv, q, bt = _prefill_case(rng, False, 8, 3)
    tpp.paged_prefill_attention(_t(q), tkv, _t(bt), 3, SM, PS)
    assert _build.launches == before
    for name in ("decode_v6_defer", "decode_v6_int8_defer", "prefill_hm", "decode_v3",
                 "decode_v3_int8", "decode_v3_defer", "decode_v3_int8_defer", "decode_int8kv"):
        assert name in _build.KERNELS and name in _build.launches


def test_decode_attn_flag(monkeypatch):
    """SKT_DECODE_ATTN takes v6 (default) or v3, and refuses anything else."""
    monkeypatch.delenv("SKT_DECODE_ATTN", raising=False)
    assert env.decode_attn() == "v6"
    monkeypatch.setenv("SKT_DECODE_ATTN", "v3")
    assert env.decode_attn() == "v3"
    monkeypatch.setenv("SKT_DECODE_ATTN", "v5")
    with pytest.raises(ValueError):
        env.decode_attn()
