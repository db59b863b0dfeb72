"""The port's attic (sgl_kernel_npu_tpu_torch/attic/ops_attention: the
retired v4, v5 and v7 decodes, kernels K23 and K24, and their plain glue)
against the repository's attic/ops_attention on the CPU.

attic/ is not a package; each file is loaded under a name inside the JAX
package (sgl_kernel_npu_tpu.ops.attention._attic_<file>), so that its
relative imports resolve, and nothing in attic/ changes. Its Pallas kernels
run in interpret mode, as off a TPU they do by themselves. The same numpy
inputs go to both sides; the port runs its plain PyTorch versions
(device="cpu"); chip_smoke.py holds the CUDA kernels against those on the
card. Heads are Llama-like and narrow: Hq 8, Hkv 2, D 128; pages of 16
(64 for v7, whose window of 64 flushes into whole pages); 2 layers.

Tolerances, each with its reason (`assert_bf16_close`: one bf16 ulp of the
JAX value plus a share of max|JAX|, as tests/test_torch_hm.py holds K14
and K16):
  * every attention: share 1e-4, the TPU kernel's arithmetic in its page
    order on both sides (v4 and v5 all f32; v7 with bf16 products and p
    rounded to bf16), only the order of the f32 sums differing; over the 70
    steps of the two-tier loop (140 decodes) share 2e-3, chip_smoke.py's
    bar for K14: where p is rounded to bf16, a score an f32 ulp apart can
    move one p across a bf16 rounding boundary, 2^-8 of one term (one value
    of the loop's 143,360 moved so, by 0.0078 of max 4.56);
  * the caches and scales written (the scatters, the fused v4 write, the
    sidecar append, the window flush): bit-equal, the JAX side jitted as a
    model runs it (compiled XLA multiplies by f32(1/127), as the port does;
    ROADMAP's first hazard).
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgl_kernel_npu_tpu.ops.attention  # noqa: F401  (the attic's parent package)
from sgl_kernel_npu_tpu_torch.attic.ops_attention import decode_v4 as tv4
from sgl_kernel_npu_tpu_torch.attic.ops_attention import decode_v5 as tv5
from sgl_kernel_npu_tpu_torch.attic.ops_attention import decode_v7 as tv7

from .test_torch_mla import assert_bf16_close

SHARE = 1e-4
LOOP_SHARE = 2e-3
B, HQ, HKV, D, PS, MP, L = 5, 8, 2, 128, 16, 3, 2
SM = D ** -0.5
ATTIC = pathlib.Path(__file__).resolve().parents[1] / "attic" / "ops_attention"


def _attic(name):
    """attic/ops_attention/<name>.py, loaded under the JAX package."""
    modname = f"sgl_kernel_npu_tpu.ops.attention._attic_{name}"
    if modname not in sys.modules:
        spec = importlib.util.spec_from_file_location(modname, ATTIC / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
    return sys.modules[modname]


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


def _pages(rng, int8, lead=(), pages=B * MP + 1, ps=PS):
    """Seeded page-major caches [*lead, P, Hkv, ps, D]: bf16 randn rows, or
    int8 rows with f32 scales [*lead, P, Hkv, 1, ps] of 0.005..0.025."""
    shape = (*lead, pages, HKV, ps, D)
    sshape = (*lead, pages, HKV, 1, ps)
    if not int8:
        return {"k": _bf16(rng, shape), "v": _bf16(rng, shape)}
    return {"k": jnp.asarray(rng.integers(-127, 128, shape, dtype=np.int8)),
            "v": jnp.asarray(rng.integers(-127, 128, shape, dtype=np.int8)),
            "ks": jnp.asarray(rng.random(sshape, dtype=np.float32) * 0.02 + 0.005),
            "vs": jnp.asarray(rng.random(sshape, dtype=np.float32) * 0.02 + 0.005)}


def _table(rng, b=B, mp=MP):
    return jnp.asarray(rng.permutation(b * mp)[: b * mp].reshape(b, mp) + 1, jnp.int32)


def _same(port, want, name):
    """A cache the port wrote in place, bit-equal to the JAX one."""
    got = port.float() if port.dtype == torch.bfloat16 else port
    assert np.array_equal(got.numpy(), _np(want)), name


# ------------------------------------------------------------------- v5


@pytest.mark.parametrize("int8", [False, True])
def test_decode_v5_matches_jax_kernel(rng, int8):
    """K23's v5 contracts (plain) against the interpreted v5 kernels:
    cached lengths 0, ps - 1, ps, ps + 1 and 40, a padded row (-1)."""
    jv5 = _attic("decode_v5")
    cache = _pages(rng, int8)
    q = _bf16(rng, (B, HQ, D), 1.5)
    kn, vn = _bf16(rng, (B, HKV, D)), _bf16(rng, (B, HKV, D))
    bt = _table(rng)
    for lens in ([0, PS - 1, PS, PS + 1, 40], [-1, 1, 2 * PS, 47, 3]):
        lens = jnp.asarray(lens, jnp.int32)
        sc = (cache["ks"], cache["vs"]) if int8 else ()
        jfn = jv5.decode_gqa_pallas_v5_int8_defer if int8 else jv5.decode_gqa_pallas_v5_defer
        tfn = tv5.decode_gqa_v5_int8_defer if int8 else tv5.decode_gqa_v5_defer
        want = jfn(q, kn, vn, cache["k"], cache["v"], *sc, lens, bt, SM, PS)
        got = tfn(_t(q), _t(kn), _t(vn), _t(cache["k"]), _t(cache["v"]), *(_t(a) for a in sc),
                  _t(lens), _t(bt), SM, PS)
        assert got.dtype == torch.bfloat16 and got.shape == (B, HQ, D)
        assert_bf16_close(got.float(), _np(want), SHARE, f"v5 int8={int8}")


# ------------------------------------------------------------------- v4


def _slots(bt, seq_lens, ps=PS):
    """The slot of each row's current token (position seq_len - 1)."""
    bt, pos = np.asarray(bt), np.asarray(seq_lens) - 1
    return jnp.asarray(bt[np.arange(len(pos)), pos // ps] * ps + pos % ps, jnp.int32)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_scatter_stacked_int8_matches_jax(rng, as_tensor):
    """The in-place stacked scatter equals the jitted JAX one bit for bit
    (layer 1; a slot of -1 and one past the pool dropped); the layer as an
    int or a 0-dim tensor."""
    jv4 = _attic("decode_v4")
    cache = _pages(rng, True, lead=(L,))
    t = 6
    k, v = _bf16(rng, (t, HKV, D), 3.0), _bf16(rng, (t, HKV, D), 3.0)
    slots = jnp.asarray([0, 17, -1, 31, (B * MP + 1) * PS, 5 * PS + 3], jnp.int32)
    want = jax.jit(jv4.scatter_stacked_int8)(k, v, cache["k"], cache["v"], cache["ks"],
                                             cache["vs"], 1, slots)
    port = {n: _t(a) for n, a in cache.items()}
    li = torch.tensor(1) if as_tensor else 1
    got = tv4.scatter_stacked_int8(_t(k), _t(v), port["k"], port["v"], port["ks"], port["vs"],
                                   li, _t(slots))
    for name, w, g in zip(port, want, got):
        assert g is port[name]
        _same(g, w, name)
    assert not np.array_equal(_np(want[0][1]), _np(cache["k"][1]))
    assert np.array_equal(port["k"][0].numpy(), _np(cache["k"][0]))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_decode_v4b_int8_matches_jax_kernel(rng, as_tensor):
    """K23's decode_v4b_int8 contract (plain) against the interpreted v4b
    kernel at layer 1 of stacked int8 caches, the current token already in
    the cache (seq_lens 0, ps - 1, ps, ps + 1, 40); the caches untouched."""
    jv4 = _attic("decode_v4")
    cache = _pages(rng, True, lead=(L,))
    q, bt = _bf16(rng, (B, HQ, D), 1.5), _table(rng)
    lens = jnp.asarray([0, PS - 1, PS, PS + 1, 40], jnp.int32)
    want = jv4.decode_v4b_int8(q, cache["k"], cache["v"], cache["ks"], cache["vs"], lens, bt,
                               1, SM, PS)
    port = {n: _t(a) for n, a in cache.items()}
    li = torch.tensor(1, dtype=torch.int32) if as_tensor else 1
    got = tv4.decode_v4b_int8(_t(q), port["k"], port["v"], port["ks"], port["vs"], _t(lens),
                              _t(bt), li, SM, PS)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (B, HQ, D)
    assert_bf16_close(got[0].float(), _np(want[0]), SHARE, "v4b")
    for name, g in zip(port, got[1:]):
        assert g is port[name]
        _same(g, cache[name], name)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_decode_fused_v4_matches_jax_kernel(rng, int8, as_tensor):
    """K23's fused contracts (plain: the write, then the pages with the new
    position masked and the token folded in from the values written)
    against the interpreted fused v4 kernels, jitted: the output within the
    bar, the stacked caches (and scales) written bit-equal; seq_lens 1
    (only the new token; its slot -1, a padded row that writes nothing),
    ps - 1, ps, ps + 1 and 41."""
    jv4 = _attic("decode_v4")
    cache = _pages(rng, int8, lead=(L,))
    q, bt = _bf16(rng, (B, HQ, D), 1.5), _table(rng)
    kn, vn = _bf16(rng, (B, HKV, D), 2.0), _bf16(rng, (B, HKV, D), 2.0)
    lens = jnp.asarray([1, PS - 1, PS, PS + 1, 41], jnp.int32)
    slots = _slots(bt, lens).at[0].set(-1)
    names = ("k", "v", "ks", "vs") if int8 else ("k", "v")
    jfn = jv4.decode_fused_v4_int8 if int8 else jv4.decode_fused_v4
    want = jax.jit(jfn, static_argnums=(len(names) + 7, len(names) + 8))(
        q, kn, vn, *(cache[n] for n in names), lens, bt, slots, 1, SM, PS)
    port = {n: _t(cache[n]) for n in names}
    tfn = tv4.decode_fused_v4_int8 if int8 else tv4.decode_fused_v4
    li = torch.tensor(1) if as_tensor else 1
    got = tfn(_t(q), _t(kn), _t(vn), *(port[n] for n in names), _t(lens), _t(bt), _t(slots),
              li, SM, PS)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (B, HQ, D)
    assert_bf16_close(got[0].float(), _np(want[0]), SHARE, f"fused int8={int8}")
    for name, w, g in zip(names, want[1:], got[1:]):
        assert g is port[name]
        _same(g, w, name)
    assert np.array_equal(port["k"][0].float().numpy(), _np(cache["k"][0]))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("splits", [1, 3])
def test_fused_v4_in_p_f32_arithmetic_matches_jax_kernel(rng, int8, splits):
    """K23's fused contracts in the card's arithmetic (csrc/decode_v3.cu,
    P_F32: test_torch_hm._p_f32_model over the pages before the current
    token, in `splits` page-aligned splits, then the token as the cache holds
    it once written, int8 dequantised in f32, folded in with p unrounded)
    against the interpreted fused v4 kernels, within the bar."""
    from sgl_kernel_npu_tpu_torch.ops.attention import decode_v3 as tv3
    from sgl_kernel_npu_tpu_torch.ops.attention.decode_v8 import quant_rows_int8

    from .test_torch_hm import _p_f32_model
    jv4 = _attic("decode_v4")
    cache = _pages(rng, int8, lead=(L,))
    q, bt = _bf16(rng, (B, HQ, D), 2.0), _table(rng)
    kn, vn = _bf16(rng, (B, HKV, D), 2.0), _bf16(rng, (B, HKV, D), 2.0)
    lens = jnp.asarray([1, PS - 1, PS, PS + 1, 41], jnp.int32)
    slots = _slots(bt, lens)
    names = ("k", "v", "ks", "vs") if int8 else ("k", "v")
    jfn = jv4.decode_fused_v4_int8 if int8 else jv4.decode_fused_v4
    want = jax.jit(jfn, static_argnums=(len(names) + 7, len(names) + 8))(
        q, kn, vn, *(cache[n] for n in names), lens, bt, slots, 1, SM, PS)
    written = {n: _t(w)[1] for n, w in zip(names, want[1:])}      # layer 1, as written
    tbt = _t(bt)
    rows = [tv3._gather_pm(written[n], None, tbt) for n in ("k", "v")]
    srows = ([tv3._gather_pm(written[n].transpose(-1, -2), None, tbt)[..., 0]
              for n in ("ks", "vs")] if int8 else [None, None])
    if int8:
        kq, vq, ks, vs = quant_rows_int8(_t(kn), _t(vn))
        new = (kq.float() * ks[..., None], vq.float() * vs[..., None])
    else:
        new = (_t(kn), _t(vn))
    got = _p_f32_model(_t(q), *rows, *srows, _t(lens) - 1, SM, PS, new, splits)
    assert_bf16_close(got.float(), _np(want[0]), SHARE, f"fused int8={int8} S {splits}")


# ------------------------------------------------------------------- v7

W = 64          # the reference's WINDOW
PS7, MP7 = 64, 3


def test_make_q_blockdiag_exact(rng):
    jv7 = _attic("decode_v7")
    q = _bf16(rng, (3, HQ, D), 1.5)
    got = tv7.make_q_blockdiag(_t(q), HKV)
    assert got.shape == (3, HQ, HKV * D)
    _same(got, jv7.make_q_blockdiag(q, HKV), "q_blockdiag")


def test_sidecar_append_matches_jax(rng):
    """One row per entry into the bf16 sidecar, in place: a row of -1 wraps
    to the last row, as JAX's .at[] takes it; an offset past the window
    drops its entry."""
    jv7 = _attic("decode_v7")
    s = 4
    ks, vs = _bf16(rng, (s, W, HKV * D)), _bf16(rng, (s, W, HKV * D))
    kn, vn = _bf16(rng, (5, HKV, D)), _bf16(rng, (5, HKV, D))
    rows = jnp.asarray([0, 2, -1, 1, 3], jnp.int32)
    offs = jnp.asarray([0, 63, 5, W, 17], jnp.int32)
    want = jax.jit(jv7.sidecar_append)(ks, vs, kn, vn, rows, offs)
    port = (_t(ks), _t(vs))
    got = tv7.sidecar_append(*port, _t(kn), _t(vn), _t(rows), _t(offs))
    for p, w, g in zip(port, want, got):
        assert g is p
        _same(g, w, "sidecar")


def test_window_flush_matches_jax(rng):
    """Sidecar windows quantised into int8 pages, in place, bit-equal to
    the jitted JAX scatter: one entry not flushing, one whose window would
    leave its page (dropped whole), one page past the pool (dropped)."""
    jv7 = _attic("decode_v7")
    cache = _pages(rng, True, pages=6, ps=2 * W)
    ks, vs = _bf16(rng, (5, W, HKV * D), 2.0), _bf16(rng, (5, W, HKV * D), 2.0)
    rows = jnp.asarray([0, 3, 1, 4, 2], jnp.int32)
    pages = jnp.asarray([1, 4, 2, 0, 9], jnp.int32)
    offs = jnp.asarray([0, W, W, 100, 0], jnp.int32)
    flush = jnp.asarray([True, True, False, True, True])
    names = ("k", "v", "ks", "vs")
    want = jax.jit(jv7.window_flush)(*(cache[n] for n in names), ks, vs, rows, pages, offs,
                                     flush)
    port = {n: _t(cache[n]) for n in names}
    got = tv7.window_flush(*(port[n] for n in names), _t(ks), _t(vs), _t(rows), _t(pages),
                           _t(offs), _t(flush))
    for name, w, g in zip(names, want, got):
        assert g is port[name]
        _same(g, w, name)
    assert not np.array_equal(_np(want[0][1]), _np(cache["k"][1]))


def _v7_case(rng, b, cached, hq=HQ):
    cache = _pages(rng, True, pages=b * MP7 + 1, ps=PS7)
    side = (_bf16(rng, (b + 1, W, HKV * D)), _bf16(rng, (b + 1, W, HKV * D)))
    q = _bf16(rng, (b, hq, D), 1.5)
    new = (_bf16(rng, (b, HKV, D)), _bf16(rng, (b, HKV, D)))
    rows = jnp.asarray(rng.permutation(b + 1)[:b], jnp.int32)
    return cache, side, q, new, rows, _table(rng, b, MP7), jnp.asarray(cached, jnp.int32)


@pytest.mark.parametrize("g", [4, 1, 8])
def test_decode_v7_matches_jax_kernel(rng, g):
    """K24's plain version (per-head dots from q) against the interpreted
    v7 kernel (its sidecar dots from the block-diagonal q) at G = 4, 1 and 8
    query heads a kv head: cached lengths 0, ps - 1 (all in the sidecar),
    ps, ps + 1 and the window edges 63, 64, 65, 127, 128, 130 (pages up to
    the last flush, the rest in the sidecar). The JAX kernel runs two
    sequences a call, where its sidecar ring is right
    (test_v7_tpu_kernel_reads_the_sidecar_row_two_sequences_ahead)."""
    jv7 = _attic("decode_v7")
    cached = [0, PS7 - 1, PS7, PS7 + 1, 63, 64, 65, 127, 128, 130]
    cache, (ks, vs), q, (kn, vn), rows, bt, lens = _v7_case(rng, len(cached), cached, HKV * g)
    qbd = jv7.make_q_blockdiag(q, HKV)
    pages = (cache["k"], cache["v"], cache["ks"], cache["vs"], ks, vs)
    got = tv7.decode_gqa_v7_int8(_t(q), _t(qbd), _t(kn), _t(vn), *(_t(a) for a in pages),
                                 _t(rows), _t(lens), _t(bt), SM, PS7)
    assert got.dtype == torch.bfloat16 and got.shape == (len(cached), HKV * g, D)
    for i in range(0, len(cached), 2):
        two = slice(i, i + 2)
        want = jv7.decode_gqa_pallas_v7_int8(q[two], qbd[two], kn[two], vn[two], *pages,
                                             rows[two], lens[two], bt[two], SM, PS7)
        assert_bf16_close(got[two].float(), _np(want), SHARE, f"v7 rows {i}, {i + 1}")


def test_v7_tpu_kernel_reads_the_sidecar_row_two_sequences_ahead(rng):
    """A standing difference of the reference: the v7 kernel starts the copy
    of sequence b + 2's sidecar row into the ring slot it is about to read
    for sequence b (decode_v7.py:155-162), so with more than two sequences,
    b < B - 2 attends over b + 2's sidecar tokens (in interpret mode always;
    on the TPU when the copy wins the race). The port reads side_rows[b]:
    the JAX output of sequence 0 equals the port's with sequence 0 given
    sequence 2's sidecar row, and not the port's own."""
    jv7 = _attic("decode_v7")
    cache, (ks, vs), q, (kn, vn), rows, bt, lens = _v7_case(rng, 3, [40, 10, 30])
    pages = (cache["k"], cache["v"], cache["ks"], cache["vs"], ks, vs)
    want = _np(jv7.decode_gqa_pallas_v7_int8(q, jv7.make_q_blockdiag(q, HKV), kn, vn, *pages,
                                             rows, lens, bt, SM, PS7))
    port = [_t(a) for a in (q, None, kn, vn) if a is not None]
    args = [*(_t(a) for a in pages)]
    right = tv7.decode_gqa_v7_int8(port[0], None, port[1], port[2], *args, _t(rows), _t(lens),
                                   _t(bt), SM, PS7).float()
    ahead = _t(rows).clone()
    ahead[0] = ahead[2]
    shifted = tv7.decode_gqa_v7_int8(port[0], None, port[1], port[2], *args, ahead, _t(lens),
                                     _t(bt), SM, PS7).float()
    assert_bf16_close(shifted[0], want[0], SHARE, "row 0 over row 2's sidecar")
    assert_bf16_close(right[1:], want[1:], SHARE, "rows 1, 2")
    assert float((right[0] - torch.from_numpy(want[0])).abs().max()) > 0.1


def test_two_tier_loop_matches_jax(rng):
    """70 steps of the two-tier cache on both sides: decode (K24's plain
    version against the interpreted, jitted v7 kernel), append the token to
    the sidecar, and flush a window into its page each time a sequence's
    count reaches a multiple of 64. Two sequences from 0 and 40 cached
    tokens each cross one flush; every step's output within the bar, the
    pages, scales and sidecars bit-equal at the end."""
    jv7 = _attic("decode_v7")
    b, steps = 2, 70
    cached = np.array([0, 40])
    cache, side, _, _, rows, bt, _ = _v7_case(rng, b, cached)
    names = ("k", "v", "ks", "vs")
    jc = dict(cache, kside=side[0], vside=side[1])
    tc = {n: _t(a) for n, a in jc.items()}
    dec = jax.jit(lambda *a: jv7.decode_gqa_pallas_v7_int8(*a, SM, PS7))
    app = jax.jit(jv7.sidecar_append)
    flush = jax.jit(jv7.window_flush)
    btn = np.asarray(bt)
    for step in range(steps):
        q = _bf16(rng, (b, HQ, D), 1.5)
        kn, vn = _bf16(rng, (b, HKV, D), 2.0), _bf16(rng, (b, HKV, D), 2.0)
        lens = jnp.asarray(cached, jnp.int32)
        want = dec(q, jv7.make_q_blockdiag(q, HKV), kn, vn, *(jc[n] for n in names),
                   jc["kside"], jc["vside"], rows, lens, bt)
        got = tv7.decode_gqa_v7_int8(_t(q), None, _t(kn), _t(vn), *(tc[n] for n in names),
                                     tc["kside"], tc["vside"], _t(rows), _t(lens), _t(bt), SM,
                                     PS7)
        assert_bf16_close(got.float(), _np(want), LOOP_SHARE, f"step {step}")
        offs = jnp.asarray(cached % W, jnp.int32)
        jc["kside"], jc["vside"] = app(jc["kside"], jc["vside"], kn, vn, rows, offs)
        tv7.sidecar_append(tc["kside"], tc["vside"], _t(kn), _t(vn), _t(rows), _t(offs))
        cached = cached + 1
        do = cached % W == 0
        if do.any():
            start = np.where(do, cached - W, 0)
            pages = jnp.asarray(btn[np.arange(b), start // PS7], jnp.int32)
            poffs = jnp.asarray(start % PS7, jnp.int32)
            out = flush(*(jc[n] for n in names), jc["kside"], jc["vside"], rows, pages, poffs,
                        jnp.asarray(do))
            jc.update(zip(names, out))
            tv7.window_flush(*(tc[n] for n in names), tc["kside"], tc["vside"], _t(rows),
                             _t(pages), _t(poffs), _t(do))
    assert (cached == [70, 110]).all()
    for name in jc:
        _same(tc[name], jc[name], name)
